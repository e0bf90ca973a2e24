"""The borrowing scheduler: the paper's cycle model.

The dense core executes a GEMM output tile by streaming T = ceil(K/K0)
*K-chunks*; each cycle one chunk's worth of MACs executes.  A sparse
architecture keeps a window of ``1 + d1`` consecutive chunks resident in the
operand buffer (ABUF/BBUF); each cycle every multiplier slot may execute one
effectual operation *borrowed* from anywhere in that window subject to the
routing limits:

  - time     (d1): the window spans chunks [f, f + d1]; the front f may
                   advance by at most ``1 + d1`` chunks per cycle (this is
                   also why the paper's ideal speedup is ``1 + d1`` and why
                   SRAM bandwidth must scale with speedup, Section V);
  - lane     (d2): an element in lane ``l`` may execute on lane ``l - dl``
                   for ``dl in [0, d2]`` (one-sided window; the MUX fan-in
                   formulas in Table II count ``1 + d2`` candidates);
  - cross-PE (d3): an element belonging to PE-group coordinate ``g`` may
                   execute on PE ``g - dg`` for ``dg in [0, d3]``, which
                   requires an extra adder tree to route the partial sum back.

Placement is greedy with the priority mechanism of Bit-Tactical [13]: oldest
chunk first (so the window can slide), then smallest lane distance, then
cross-PE.  The window cannot slide past an incomplete chunk (its buffer entry
is still live), which reproduces the stalls the paper attributes to
ABUF/BBUF fullness.

This single primitive scores every architecture family in the paper:
``Sparse.B`` runs it over the weight mask (G = N0 columns), ``Sparse.A`` over
the activation mask (G = M0 rows), and ``Sparse.AB`` runs it twice (offline B
compaction, then on-the-fly scheduling of the A side over the compacted
stream) — see :mod:`repro_torch.core.evaluate`.

Everything is vectorized over a leading ``tiles`` axis with numpy, and — for
design-space exploration — additionally over a *stacked configuration axis*:
:func:`schedule_batched` and :func:`static_pack_cycles_batched` accept
per-row / per-config ``(d1, d2, d3, shuffle)`` parameter vectors so that
hundreds of ``SparseSpec`` points share one vectorized sweep instead of one
Python loop each.  The scalar :func:`schedule` / :func:`static_pack_cycles`
entry points are thin wrappers over the batched core and stay bit-exact.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

ParamLike = Union[int, Sequence[int], np.ndarray]


@dataclasses.dataclass
class Schedule:
    """Result of scheduling one batch of tiles.

    cycles:   (tiles,) int  — executed cycles per tile.
    placement (optional, when ``record=True``): for every source element
      (tiles, T, K0, G):
        cyc:  executed cycle index (-1 where mask is False / unplaced)
        lane: target lane it executes on
        grp:  target PE-group coordinate it executes on
    """

    cycles: np.ndarray
    cyc: Optional[np.ndarray] = None
    lane: Optional[np.ndarray] = None
    grp: Optional[np.ndarray] = None


def shuffle_lanes(mask: np.ndarray, chunk_axis: int = 1, lane_axis: int = 2,
                  rot: int = 4) -> np.ndarray:
    """Paper Section III 'Load Balancing': local rotation shuffling.

    Element at (chunk t, lane l) relocates to lane
    ``rot*(l//rot) + (l + t) % rot`` — a t-dependent rotation inside groups of
    ``rot`` consecutive lanes, implementable with (K0/rot) rot x rot
    crossbars.  Both A and B are shuffled identically along K, so correctness
    is preserved; the point is to spread a persistently-hot lane (a dense
    input channel) over its rotation group.
    """
    k0 = mask.shape[lane_axis]
    rot = min(rot, k0)
    t_idx = np.arange(mask.shape[chunk_axis])
    l_idx = np.arange(k0)
    new_lane = (l_idx[None, :] // rot) * rot + (l_idx[None, :] + t_idx[:, None]) % rot
    out = np.empty_like(mask)
    mask_m = np.moveaxis(mask, (chunk_axis, lane_axis), (0, 1))
    out_m = np.moveaxis(out, (chunk_axis, lane_axis), (0, 1))
    t_b = np.broadcast_to(t_idx[:, None], new_lane.shape)
    out_m[t_b, new_lane] = mask_m
    return out


def _offsets(d2: int, d3: int) -> List[Tuple[int, int]]:
    offs = [(dl, dg) for dg in range(d3 + 1) for dl in range(d2 + 1)]
    offs.sort(key=lambda o: (o[1], o[0]))  # own slot, then lane, then cross-PE
    return offs


def _param_vec(x: ParamLike, n: int, dtype=np.int64) -> np.ndarray:
    """Broadcast a scalar-or-vector config parameter to a (n,) array."""
    arr = np.asarray(x, dtype=dtype)
    if arr.ndim == 0:
        return np.full(n, arr, dtype=dtype)
    if arr.shape != (n,):
        raise ValueError(f"parameter vector must have shape ({n},), "
                         f"got {arr.shape}")
    return arr


def schedule_batched(mask: np.ndarray, d1: ParamLike, d2: ParamLike,
                     d3: ParamLike, shuffle: ParamLike = False,
                     record: bool = False,
                     t_len: Optional[ParamLike] = None,
                     backend: str = "numpy") -> Schedule:
    """Greedy sliding-window scheduling, vectorized over rows *and* configs.

    mask: (rows, T, K0, G) boolean — True where an effectual operation
    exists.  ``d1/d2/d3/shuffle`` may be scalars or per-row vectors, so one
    call can schedule the stacked tile streams of many ``SparseSpec``
    configurations at once; rows never interact, so the result is bit-exact
    with per-config scalar calls.  ``t_len`` optionally gives each row its
    own logical chunk count (rows are zero-padded up to the shared T); the
    trailing-stream accounting then uses the row's own length, which is what
    the dual-sparse stage-2 composition needs when stage-1 compaction depths
    differ per config.

    ``backend="torch"`` routes a homogeneous (scalar-config, cycles-only)
    call through the card's kernel in :mod:`repro_torch.kernels.batch_eval`;
    the numpy engine stays the general path.  Returns per-row
    executed-cycle counts (and placements if ``record``).
    """
    if mask.ndim != 4:
        raise ValueError(f"mask must be (tiles, T, K0, G), got {mask.shape}")
    if backend == "torch":
        if record or t_len is not None:
            raise ValueError("backend='torch' supports cycles-only "
                             "scheduling of full-length streams")
        params = [np.unique(np.asarray(p)) for p in (d1, d2, d3, shuffle)]
        if any(len(p) != 1 for p in params):
            raise ValueError("backend='torch' needs one shared config; "
                             "per-row parameter vectors are numpy-only")
        from ..kernels.batch_eval.ops import schedule_cycles
        return Schedule(cycles=schedule_cycles(
            mask, int(params[0][0]), int(params[1][0]), int(params[2][0]),
            shuffle=bool(params[3][0])))
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    ntiles, T, K0, G = mask.shape
    d1v = _param_vec(d1, ntiles)
    d2v = _param_vec(d2, ntiles)
    d3v = _param_vec(d3, ntiles)
    shv = _param_vec(shuffle, ntiles, dtype=bool)
    tl = _param_vec(T if t_len is None else t_len, ntiles)
    # A row pays every other row's (1 + d1) x offsets placement steps in the
    # shared per-cycle pass, but splitting the batch also undoes the
    # iteration merging that makes batching fast (one max-trip loop instead
    # of summed per-config loops).  Compromise: bucket the window tuples by
    # per-cycle unroll cost so rows only share a loop with rows within 8x of
    # their own cost — deep windows (Cnvlutin-style lookahead-15) split off,
    # ordinary DSE neighbourhoods stay merged.  Rows never interact, so any
    # partition is bit-exact with the per-row result.
    unroll = (d1v + 1) * (1 + d2v) * (1 + d3v)
    order = np.argsort(unroll, kind="stable")
    buckets: List[np.ndarray] = []
    start = 0
    for i in range(1, ntiles + 1):
        if i == ntiles or unroll[order[i]] > 8 * unroll[order[start]]:
            buckets.append(np.sort(order[start:i]))
            start = i
    if len(buckets) > 1:
        cycles = np.zeros(ntiles, dtype=np.int64)
        rec = [np.full(mask.shape, -1, dtype=dt)
               for dt in (np.int32, np.int16, np.int16)] if record else None
        for sel in buckets:
            sub = _schedule_rows(mask[sel], d1v[sel], d2v[sel], d3v[sel],
                                 shv[sel], record, tl[sel], t_len is not None)
            cycles[sel] = sub.cycles
            if record:
                rec[0][sel], rec[1][sel], rec[2][sel] = \
                    sub.cyc, sub.lane, sub.grp
        if record:
            return Schedule(cycles=cycles, cyc=rec[0], lane=rec[1],
                            grp=rec[2])
        return Schedule(cycles=cycles)
    return _schedule_rows(mask, d1v, d2v, d3v, shv, record, tl,
                          t_len is not None)


def _schedule_rows(mask: np.ndarray, d1v: np.ndarray, d2v: np.ndarray,
                   d3v: np.ndarray, shv: np.ndarray, record: bool,
                   tl: np.ndarray, has_t_len: bool) -> Schedule:
    """Mixed-window scheduling core over one cost bucket of rows."""
    ntiles, T, K0, G = mask.shape
    t_len = tl if has_t_len else None
    if T == 0 or ntiles == 0:
        return Schedule(cycles=np.zeros(ntiles, dtype=np.int64))
    if shv.any():
        shuffled = shuffle_lanes(mask, chunk_axis=1, lane_axis=2)
        mask = np.where(shv[:, None, None, None], shuffled, mask)

    R = mask.copy()                                    # remaining elements
    if t_len is not None:
        R &= (np.arange(T)[None, :] < tl[:, None])[:, :, None, None]
    chunk_any = R.any(axis=(2, 3))                     # (tiles, T)
    rem = chunk_any.any(axis=1)                        # tiles still working
    f = np.zeros(ntiles, dtype=np.int64)               # window front
    cycles = np.zeros(ntiles, dtype=np.int64)
    win = d1v + 1                                      # (tiles,)
    max_win = int(win.max())
    t_grid = np.arange(T)
    orig = np.arange(ntiles)                           # row -> output slot
    out_cycles = np.zeros(ntiles, dtype=np.int64)

    def offsets_for(d2a: np.ndarray, d3a: np.ndarray
                    ) -> List[Tuple[int, int, Optional[np.ndarray]]]:
        # per-offset row gating is loop-invariant between compactions
        out = []
        for (dl, dg) in _offsets(int(d2a.max()), int(d3a.max())):
            allow = (dl <= d2a) & (dg <= d3a)
            if allow.any():
                out.append((dl, dg,
                            None if allow.all() else allow[:, None, None]))
        return out

    offs = offsets_for(d2v, d3v)

    if record:
        rec_cyc = np.full(mask.shape, -1, dtype=np.int32)
        rec_lane = np.full(mask.shape, -1, dtype=np.int16)
        rec_grp = np.full(mask.shape, -1, dtype=np.int16)

    def finalize(sel: np.ndarray) -> None:
        # trailing (and fully-zero) chunk runs still stream the window
        tail = np.maximum(tl[sel] - f[sel], 0)
        out_cycles[orig[sel]] = cycles[sel] + -(-tail // win[sel])

    t_grid32 = t_grid.astype(np.int32)

    # fast-forward leading all-zero chunks (they cost ceil(run/win) cycles)
    def _advance(front: np.ndarray, active: np.ndarray) -> np.ndarray:
        """Next front: earliest incomplete chunk, at most ``win`` ahead."""
        cand = np.where(chunk_any & (t_grid[None, :] >= front[:, None]),
                        t_grid32[None, :], tl[:, None].astype(np.int32))
        nxt = cand.min(axis=1).astype(np.int64)
        return np.where(active, np.minimum(nxt, front + win), front)

    # initial leading-zeros jump is folded into the main loop accounting: the
    # first cycle's window starts at chunk 0 like the hardware's.
    while rem.any():
        # Rows finish at very different cycles (that spread is the whole
        # point of the cycle model); once the finished majority would
        # dominate the per-iteration cost, retire them and keep looping
        # over the survivors only.  Pure reindexing — bit-exact.
        nact = R.shape[0]
        if nact > 64 and int(rem.sum()) * 2 < nact:
            finalize(np.flatnonzero(~rem))
            keep = np.flatnonzero(rem)
            orig, R, chunk_any = orig[keep], R[keep], chunk_any[keep]
            f, cycles, rem = f[keep], cycles[keep], rem[keep]
            win, tl, d2v, d3v = win[keep], tl[keep], d2v[keep], d3v[keep]
            max_win = int(win.max())
            offs = offsets_for(d2v, d3v)
            nact = R.shape[0]
        tile_ix = np.arange(nact)
        occ = np.zeros((nact, K0, G), dtype=bool)
        occ[~rem] = True                               # freeze finished tiles
        for dt in range(max_win):                      # oldest chunk first
            tt = f + dt
            valid = rem & (tt < tl) & (dt < win)
            if not valid.any():
                break
            ttc = np.minimum(tt, T - 1)
            chunk = R[tile_ix, ttc] & valid[:, None, None]   # (rows, K0, G)
            if not chunk.any():
                continue
            for (dl, dg, allow) in offs:
                # source element (l, g) -> slot (l - dl, (g - dg) mod G):
                # lanes are a one-sided window (Table II fan-in 1 + d2), PE
                # borrowing is a ring within the window group (column n
                # borrows from n+dg mod G, one adder-tree hop).  Rows whose
                # config does not reach this offset are gated out (``allow``).
                src = chunk[:, dl:, :] if dl else chunk
                src = np.roll(src, -dg, axis=2) if dg and G > 1 else src
                occ_v = occ[:, :K0 - dl, :] if dl else occ
                put = src & ~occ_v
                if allow is not None:
                    put &= allow
                if not put.any():
                    continue
                if dl:
                    occ[:, :K0 - dl, :] |= put
                else:
                    occ |= put
                taken = np.roll(put, dg, axis=2) if dg and G > 1 else put
                if dl:
                    chunk[:, dl:, :] &= ~taken
                else:
                    chunk &= ~taken
                if record:
                    ti, lt, gt = np.nonzero(put)     # target coords
                    ls, gs = lt + dl, (gt + dg) % G  # source coords
                    rec_cyc[orig[ti], ttc[ti], ls, gs] = \
                        cycles[ti].astype(np.int32)
                    rec_lane[orig[ti], ttc[ti], ls, gs] = lt.astype(np.int16)
                    rec_grp[orig[ti], ttc[ti], ls, gs] = gt.astype(np.int16)
            R[tile_ix[valid], ttc[valid]] = chunk[valid]
            chunk_any[tile_ix[valid], ttc[valid]] = chunk[valid].any(axis=(1, 2))
        cycles[rem] += 1
        f = _advance(f, rem)
        rem = rem & chunk_any.any(axis=1)

    finalize(np.arange(R.shape[0]))
    if record:
        return Schedule(cycles=out_cycles, cyc=rec_cyc, lane=rec_lane,
                        grp=rec_grp)
    return Schedule(cycles=out_cycles)


def schedule(mask: np.ndarray, d1: int, d2: int, d3: int,
             shuffle: bool = False, record: bool = False) -> Schedule:
    """Greedy sliding-window scheduling of a nonzero mask (one config).

    mask: (tiles, T, K0, G) boolean — True where an effectual operation exists.
    Thin wrapper over :func:`schedule_batched` with a single shared config.
    Returns per-tile executed-cycle counts (and placements if ``record``).
    """
    return schedule_batched(mask, d1, d2, d3, shuffle=shuffle, record=record)


def dense_cycles(T: int) -> int:
    """Cycles the dense baseline needs for the same stream."""
    return T


def static_pack_cycles_batched(mask: np.ndarray, d1: ParamLike, d2: ParamLike,
                               d3: ParamLike, shuffle: ParamLike = False,
                               max_chunk_elems: int = 1 << 24) -> np.ndarray:
    """Offline packing bound, vectorized over a stacked config axis.

    mask: (tiles, T, K0, G) — the *shared* tile streams (G is the window
    group).  ``d1/d2/d3/shuffle`` are scalars or (configs,)-vectors; because
    the offline bound only reads the mask through per-interval pool counts,
    the (tiles x intervals) tables are computed once per distinct
    lane-fungibility width and shared by every config with that width —
    that sharing is where the DSE batching wins.  Returns (configs, tiles)
    cycle counts, bit-exact with per-config :func:`static_pack_cycles`.

    See :func:`static_pack_cycles` for the model itself.
    """
    ntiles, T, K0, G = mask.shape
    nconf = max(np.asarray(d1).shape[0] if np.asarray(d1).ndim else 1,
                np.asarray(d2).shape[0] if np.asarray(d2).ndim else 1,
                np.asarray(d3).shape[0] if np.asarray(d3).ndim else 1,
                np.asarray(shuffle).shape[0] if np.asarray(shuffle).ndim else 1)
    d1v = _param_vec(d1, nconf)
    d2v = _param_vec(d2, nconf)
    d3v = _param_vec(d3, nconf)
    shv = _param_vec(shuffle, nconf, dtype=bool)
    out = np.zeros((nconf, ntiles), dtype=np.int64)
    if T == 0 or ntiles == 0:
        return out
    win = d1v + 1                                       # (configs,)
    # fungibility width along lanes, per config
    w_all = np.minimum(K0, np.where(shv, 4, 1) * (1 + d2v))
    travel_total = -(-T // win)                         # (configs,)
    stride = 1 if T <= 32 else 3
    us = np.unique(np.concatenate([np.arange(0, T, stride), [0]]))
    vs = np.unique(np.concatenate([np.arange(stride, T + 1, stride), [T]]))
    spanv = vs[None, :] - us[:, None]                   # (nu, nv) chunk spans
    # The travel term depends on an interval only through its span, and the
    # ceil-divide commutes with max, so the per-config reduction collapses
    # the (nu, nv, ngrp) interval grid to the distinct positive spans:
    #   best = max over spans s:  ceil(maxcnt(tile, s) / cap) + trav(s).
    spans = np.unique(spanv[spanv > 0])                 # (nspan,)
    span_sel = [np.nonzero((spanv == s).ravel())[0] for s in spans]
    for wv in np.unique(w_all):
        conf_ix = np.flatnonzero(w_all == wv)
        ngrp = -(-K0 // int(wv))
        pad_k = ngrp * int(wv)
        m = np.zeros((ntiles, T, pad_k, G), dtype=np.int32)
        m[:, :, :K0, :] = mask
        # pool counts per (tile, chunk, lane-group); d3 pools the whole G axis
        counts = m.reshape(ntiles, T, ngrp, int(wv), G).sum(axis=(3, 4))
        cap = int(wv) * G
        # prefix sums over chunks for all interval counts
        P = np.concatenate([np.zeros((ntiles, 1, ngrp), np.int32),
                            np.cumsum(counts, axis=1, dtype=np.int32)], axis=1)
        # count_g([u,v]) = P[v+1] - P[u].  The full (T x T) interval grid is
        # O(T^2); a strided grid (always including u=0 and v=T) finds the
        # binding interval to within the stride while keeping the lane-total
        # and travel bounds exact.  The interval table is config-independent
        # (shared by every config with this fungibility width); max over the
        # lane groups streams one group at a time to bound peak memory.
        cntmax = np.full((ntiles, len(us) * len(vs)), np.iinfo(np.int32).min,
                         dtype=np.int32)
        buf = np.empty((ntiles, len(us), len(vs)), dtype=np.int32)
        for g in range(ngrp):
            Pg = P[:, :, g]
            np.subtract(Pg[:, None, vs], Pg[:, us, None], out=buf)
            np.maximum(cntmax, buf.reshape(ntiles, -1), out=cntmax)
        # reduce intervals to their span before the config loop
        cnt_span = np.empty((ntiles, len(spans)), dtype=np.int32)
        for si, sel in enumerate(span_sel):
            cnt_span[:, si] = cntmax[:, sel].max(axis=1)
        need_span = -(-cnt_span.astype(np.int64) // cap)  # (tiles, nspan)
        # per config: travel for the chunks outside the binding interval
        rest = T - (spans[None, :] + d1v[conf_ix, None])
        trav = np.where(rest > 0, -(-rest // win[conf_ix, None]), 0)
        step = max(1, max_chunk_elems // max(1, ntiles * len(spans)))
        for lo in range(0, len(conf_ix), step):
            sel = conf_ix[lo:lo + step]
            tot = need_span[None] + trav[lo:lo + step, None, :]
            out[sel] = tot.max(axis=2)
    return np.maximum(out, travel_total[:, None])


def static_pack_cycles(mask: np.ndarray, d1: int, d2: int, d3: int,
                       shuffle: bool = False) -> np.ndarray:
    """Offline (preprocessing-time) packing model for the static B stream.

    Bit-Tactical-style preprocessing schedules each lane's *compressed*
    stream offline; a lane therefore never idles while it still has work,
    except when the activation window pins it: every element executed at
    cycle c must have its original chunk within ``1 + d1`` chunks of the
    cycle's window base, and bases advance monotonically.  The achievable
    makespan is the classic window-capacity bound:

      cycles = max(  ceil(T / (1+d1)),                           # travel
                     max over chunk intervals I, lane groups g:
                        ceil(count_g(I) / cap_g) + travel(T - span(I)) )

    where lanes are *fungible* within a group when the shuffler (rotation
    groups of 4) and/or lane borrowing (d2) can move work between them, and
    d3 additionally pools the (1+d3) columns of the window group.

    mask: (tiles, T, K0, G) — G is the (1+d3)-column window group.
    Returns per-tile cycle counts.  This is a tight *achievable* bound for
    offline packing (it is what the paper's preprocessing step computes),
    whereas :func:`schedule` models the on-the-fly datapath.  Thin wrapper
    over :func:`static_pack_cycles_batched` with one config.
    """
    return static_pack_cycles_batched(mask, int(d1), int(d2), int(d3),
                                      bool(shuffle))[0]


def sparten_tile_cycles(eff_counts: np.ndarray, pe_m: int = 32, pe_n: int = 32
                        ) -> np.ndarray:
    """SparTen-style per-PE intersection model.

    SparTen [18] assigns one output-stationary MAC per (m, n) output and skips
    to the next effectual (both-nonzero) pair with (very deep) prefix-sum
    buffers — no lane or cross-PE routing.  A wave of pe_m x pe_n outputs
    finishes when its slowest PE drains, so

      cycles(wave) = max_{(m,n) in wave} popcount(Amask[m] & Bmask[:, n]).

    eff_counts: (M, N) effectual-pair counts.  Returns per-wave cycles.
    """
    M, N = eff_counts.shape
    mt, nt = -(-M // pe_m), -(-N // pe_n)
    pad = np.zeros((mt * pe_m, nt * pe_n), dtype=eff_counts.dtype)
    pad[:M, :N] = eff_counts
    waves = pad.reshape(mt, pe_m, nt, pe_n).transpose(0, 2, 1, 3)
    return np.maximum(waves.max(axis=(2, 3)), 1)
