"""Functional fidelity: execute the borrowing schedule numerically.

The scheduler decides *when and where* every effectual multiply runs; this
module checks that the decision is hardware-legal and that executing it
reproduces the exact GEMM:

  - every nonzero operand is executed exactly once;
  - no multiplier slot is double-booked in a cycle;
  - every borrow respects the (d1, d2, d3) windows (one-sided lanes,
    ring cross-PE, bounded time span per cycle);
  - accumulating the scheduled multiplies equals A @ B bit-for-bit in f64.

These are the invariants the hypothesis property suite sweeps.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .evaluate import _pack_stream
from .scheduler import Schedule, schedule, shuffle_lanes
from .spec import CoreConfig, SparseSpec


def verify_schedule(mask: np.ndarray, sched: Schedule, d1: int, d2: int,
                    d3: int) -> None:
    """Assert every hardware invariant of a recorded schedule."""
    assert sched.cyc is not None, "schedule must be recorded"
    ntiles, T, K0, G = mask.shape
    placed = sched.cyc >= 0
    # 1. completeness: each effectual element placed exactly once
    np.testing.assert_array_equal(placed, mask)
    if not mask.any():
        return
    ti, ts, ls, gs = np.nonzero(mask)
    cyc = sched.cyc[ti, ts, ls, gs].astype(np.int64)
    lt = sched.lane[ti, ts, ls, gs].astype(np.int64)
    gt = sched.grp[ti, ts, ls, gs].astype(np.int64)
    # 2. routing windows
    dl = ls - lt
    assert (dl >= 0).all() and (dl <= d2).all(), "lane window violated"
    dg = (gs - gt) % G
    assert (dg <= d3).all() or G == 1, "cross-PE window violated"
    # 3. no slot double-booking
    slot_ids = ((ti * (cyc.max() + 1) + cyc) * K0 + lt) * G + gt
    assert len(np.unique(slot_ids)) == len(slot_ids), "slot double-booked"
    # 4. per-cycle time span within the (1+d1)-chunk window
    order = np.lexsort((ts, cyc, ti))
    key = ti[order] * (cyc.max() + 1) + cyc[order]
    tso = ts[order]
    first = np.r_[True, key[1:] != key[:-1]]
    starts = np.flatnonzero(first)
    ends = np.r_[starts[1:], len(key)]
    for s, e in zip(starts, ends):
        assert tso[s:e].max() - tso[s:e].min() <= d1, "time window violated"
    # 5. cycle count covers all placements
    assert (cyc < sched.cycles[ti]).all()


def execute_b_sparse(a: np.ndarray, b: np.ndarray, spec: SparseSpec,
                     core: CoreConfig = CoreConfig()
                     ) -> Tuple[np.ndarray, int]:
    """Run the Sparse.B pipeline end-to-end: preprocess B (schedule with
    metadata), then execute cycle-by-cycle multiplies and accumulate.

    Returns (C, executed_ops).  C must equal a @ b exactly (f64).
    """
    M, K = a.shape
    K2, N = b.shape
    assert K == K2
    k0, n0 = core.k0, core.n0
    sub = min(1 + spec.db3, n0)
    bt = _pack_stream(b != 0, k0, sub)                 # (ngrp, T, K0, sub)
    bv = _pack_values(b, k0, sub)
    if spec.shuffle:
        bt = shuffle_lanes(bt)
        bv = shuffle_lanes(bv)
    sched = schedule(bt, spec.db1, spec.db2, spec.db3, shuffle=False,
                     record=True)
    verify_schedule(bt, sched, spec.db1, spec.db2, spec.db3)
    # Execute: each placed element (tile g-group, t, l, g) multiplies
    # A[:, k(t,l)] with its B value and accumulates into column n(tile, g).
    # Source k is recovered through the same (shuffled) packing of the k
    # index grid, so the A operand selection is exactly what the AMUX does.
    kidx = _pack_values(
        np.broadcast_to(np.arange(k0 * (-(-K // k0)), dtype=np.int64)[:, None],
                        (k0 * (-(-K // k0)), b.shape[1])).copy(),
        k0, sub)
    if spec.shuffle:
        kidx = shuffle_lanes(kidx)
    c = np.zeros((M, -(-N // sub) * sub), dtype=np.float64)
    ti, ts, ls, gs = np.nonzero(bt)
    col = ti * sub + gs                                # original column id
    ks = kidx[ti, ts, ls, gs]
    vals = bv[ti, ts, ls, gs].astype(np.float64)
    a_pad = np.zeros((M, int(kidx.max()) + 1), dtype=np.float64)
    a_pad[:, :K] = a
    # accumulate per element: C[:, col] += A[:, k] * v   (duplicates summed)
    contrib = a_pad[:, ks] * vals[None, :]             # (M, nels)
    np.add.at(c.T, col, contrib.T)
    return c[:, :N], len(ks)


def _pack_values(x: np.ndarray, k0: int, g0: int) -> np.ndarray:
    """Same packing as _pack_stream but for value (or index) arrays."""
    K, Gt = x.shape
    T = -(-K // k0)
    nt = -(-Gt // g0)
    pad = np.zeros((k0 * T, nt * g0), dtype=x.dtype)
    pad[:K, :Gt] = x
    return pad.reshape(k0, T, nt, g0).transpose(2, 1, 0, 3)
