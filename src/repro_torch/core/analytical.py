"""Closed-form analytical speedup model (paper Section I: "we create an
analytical model, verified by a simulator").

For a stream of T chunks with i.i.d.-ish per-slot density p, a window of
``1 + d1`` chunks and per-slot service rate 1/cycle, the achievable
steady-state advance rate v (chunks/cycle) is bounded by:

  - window cap:      v <= 1 + d1
  - service cap:     v <= 1 / p_hot          (hottest fungible slot group)
  - burst cap:       v <= (r + d1) / (r * p_run^[r-1] ...) — approximated
                     by the two-element burst bound (2 + d1) / 2 weighted
                     by the burst probability.

``p_hot`` folds in the load-balancing state: lanes are fungible within a
group of w = (4 if shuffle else 1) * (1 + d2) slots (and (1+d3) cross-PE
neighbours), so the binding density is the mean of the top group rather
than the top slot.  The model is calibration-free: its only inputs are the
mask statistics the simulator also sees.  ``verify`` in
tests/test_analytical.py checks it tracks the simulator within a stated
band across densities and windows — exactly the paper's model-vs-simulator
role (fast DSE pre-screening; the simulator remains the scorer of record).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .spec import CoreConfig, SparseSpec


def _group_hot_density(mask: np.ndarray, w: int, g: int) -> float:
    """Mean density of the hottest fungible slot group.

    mask: (T, K0, G_cols).  Slots are fungible within lane groups of w and
    across g neighbouring columns; the busiest group gates service.
    """
    T, K0, GC = mask.shape
    w = max(1, min(w, K0))
    g = max(1, min(g, GC))
    dens = mask.mean(axis=0)                       # (K0, GC)
    kg = K0 // w
    cg = GC // g
    pooled = dens[:kg * w, :cg * g].reshape(kg, w, cg, g).mean(axis=(1, 3))
    return float(pooled.max()) if pooled.size else float(dens.max())


def predicted_speedup_b(spec: SparseSpec, b_mask: np.ndarray,
                        core: CoreConfig = CoreConfig()) -> float:
    """Closed-form Sparse.B speedup for one (K, N) weight mask."""
    K, N = b_mask.shape
    k0, n0 = core.k0, core.n0
    T = -(-K // k0)
    # column-major lane segments (evaluate.py packing)
    pk = T * k0
    pad = np.zeros((pk, N), dtype=bool)
    pad[:K] = b_mask
    stream = pad.reshape(k0, T, N).transpose(1, 0, 2)      # (T, K0, N)
    win = 1 + spec.db1
    w = (4 if spec.shuffle else 1) * (1 + spec.db2)
    p_hot = _group_hot_density(stream, w, 1 + spec.db3)
    v_service = 1.0 / max(p_hot, 1.0 / win, 1e-9)
    # burst cap: a same-slot pair within the window forces >= 2 cycles for
    # 2 + d1 chunks of travel; weight by how often the hot group bursts
    p2 = min(1.0, p_hot * p_hot * win)
    v_burst = (2.0 + spec.db1) / 2.0
    v = min(win, v_service * (1 - p2) + min(v_service, v_burst) * p2)
    # output sync: the max over the tile's N0 columns — approximate with
    # the hottest column's density relative to the mean
    col_d = stream.reshape(T * k0, N).mean(axis=0)
    mean_d = max(float(col_d.mean()), 1e-9)
    tiles = col_d[:(N // n0) * n0].reshape(-1, n0) if N >= n0 else \
        col_d.reshape(1, -1)
    sync = float((tiles.max(axis=1) / mean_d).mean()) if tiles.size else 1.0
    # cross-PE borrowing relaxes the sync penalty
    sync = 1.0 + (sync - 1.0) / (1.0 + spec.db3)
    return float(max(1.0, min(win, v / max(sync, 1.0))))


@dataclasses.dataclass
class AnalyticalCheck:
    predicted: float
    simulated: float

    @property
    def ratio(self) -> float:
        return self.predicted / max(self.simulated, 1e-9)


def verify(spec: SparseSpec, b_mask: np.ndarray, m: int = 64,
           core: CoreConfig = CoreConfig()) -> AnalyticalCheck:
    from .evaluate import sparse_b_gemm_cycles
    sim = sparse_b_gemm_cycles(spec, b_mask, m, core).speedup
    return AnalyticalCheck(predicted=predicted_speedup_b(spec, b_mask, core),
                           simulated=sim)
