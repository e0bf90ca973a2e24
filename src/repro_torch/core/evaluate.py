"""Cycle evaluation of GEMMs and networks under sparse architectures.

Implements the performance side of the paper:

  - ``Sparse.B``  : offline compaction of the weight stream (preprocessing),
                    one schedule per N0-column group, reused by every M-tile.
  - ``Sparse.A``  : on-the-fly compaction of the activation stream, one
                    schedule per M0-row group, reused by every N-tile.
  - ``Sparse.AB`` : the 7-step dual pipeline (Fig. 3): stage 1 compacts B
                    offline with (db1,db2,db3); stage 2 schedules, per PE
                    column, the effectual (A nonzero AND B-slot filled) mask
                    over the *compacted* cycle base with (da1,da2,da3).  The
                    ABUF depth (1+da1)(1+db1) of Section IV-A is exactly the
                    original-chunk span this composition can reach.
  - ``joint``     : TensorDash-style dual sparsity WITHOUT preprocessing: a
                    single on-the-fly schedule of the pairwise-effectual mask
                    (used for TDash.AB; paper Section VI-C notes these designs
                    "do not exploit the benefits of weight preprocessing").
  - ``sparten``   : per-PE intersection model with very deep buffers.

Cycle counts include the paper's output-synchronization stalls (max over the
PE columns of a tile) and are exact for the greedy priority mechanism; SRAM
bandwidth is assumed scaled with speedup as in Section V.

Every evaluation level has a *batched* twin (``gemm_cycles_batched``,
``network_speedup_batched``, ``category_speedup_batched``) that scores a
whole stack of ``SparseSpec`` configurations in one vectorized pass: masks
are generated once per (workload, layer, seed) and the scheduler runs over
the stacked config axis (see :mod:`repro_torch.core.scheduler`).  The batched
twins are bit-exact with per-spec scalar loops — ``tests/test_torch_core``
asserts this — and are what :func:`repro_torch.core.dse.sweep` drives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .scheduler import (Schedule, schedule, schedule_batched, shuffle_lanes,
                        sparten_tile_cycles, static_pack_cycles,
                        static_pack_cycles_batched)
from .spec import CoreConfig, Mode, SparseSpec

# ---------------------------------------------------------------------------
# mask utilities
# ---------------------------------------------------------------------------


def random_mask(shape: Tuple[int, ...], density: float, rng: np.random.Generator
                ) -> np.ndarray:
    return rng.random(shape) < density


def _scales(n: int, cv: float, rng: np.random.Generator, block: int = 1,
            period: int = 0) -> np.ndarray:
    """Mean-1 lognormal scale factors; ``block`` repeats values in runs,
    ``period`` tiles a short pattern (for lane-periodic imbalance)."""
    if cv <= 0 or n == 0:
        return np.ones(n)
    s = float(np.sqrt(np.log1p(cv * cv)))
    if period:
        pat = rng.lognormal(mean=-0.5 * s * s, sigma=s, size=period)
        return np.tile(pat, -(-n // period))[:n]
    nb = -(-n // block)
    v = rng.lognormal(mean=-0.5 * s * s, sigma=s, size=nb)
    return np.repeat(v, block)[:n]


@dataclasses.dataclass(frozen=True)
class MaskModel:
    """Synthetic sparsity-pattern model for pruned weights / ReLU activations.

    Real pruned tensors are not i.i.d.: nonzeros cluster by input channel
    (blocks of q*q spatial taps share a channel's importance), by k-position
    within the dot-product unit (the "load imbalance between different k
    indices" the paper's shuffler targets — e.g. spatial-center taps survive
    magnitude pruning far more often than corners, and activation features
    fire with very different frequencies), and by output channel.  The cv_*
    knobs control those three coefficient of variations; they are calibrated
    once in EXPERIMENTS.md Section "Paper-validation" against the paper's own
    reported speedups and then frozen for every experiment.
    """

    chan_cv: float = 1.2    # per input-channel (k-block) importance: strong
                            # clustering of surviving weights / firing features;
                            # with lane-segment streaming this is exactly the
                            # "load imbalance between k indices" shuffle fixes
    lane_cv: float = 0.0    # extra periodic k-index imbalance (unused by default)
    col_cv: float = 0.30    # per output-channel imbalance (weights)
    row_cv_a: float = 0.10  # per-token/pixel activation imbalance (ReLU kills
                            # roughly uniformly across positions)

    def weight_mask(self, k: int, n: int, density: float,
                    rng: np.random.Generator, q: int = 1) -> np.ndarray:
        r = _scales(k, self.chan_cv, rng, block=max(q, 1))
        if self.lane_cv > 0:
            r = r * _scales(k, self.lane_cv, rng, period=16)
        c = _scales(n, self.col_cv, rng)
        return self._bern((k, n), density, r, c, rng)

    def act_mask(self, m: int, k: int, density: float,
                 rng: np.random.Generator, q: int = 1) -> np.ndarray:
        feat = _scales(k, self.chan_cv, rng, block=max(q, 1))
        if self.lane_cv > 0:
            feat = feat * _scales(k, self.lane_cv, rng, period=16)
        row = _scales(m, self.row_cv_a, rng)
        return self._bern((m, k), density, row, feat, rng)

    @staticmethod
    def _bern(shape, density, r, c, rng) -> np.ndarray:
        if density >= 0.999:
            return np.ones(shape, dtype=bool)
        p = np.clip(density * r[:, None] * c[None, :], 0.0, 1.0)
        mean = p.mean()
        if mean > 1e-9:
            p = np.clip(p * (density / mean), 0.0, 1.0)
        return rng.random(shape) < p


DEFAULT_MASK_MODEL = MaskModel()


def _pack_stream(mask: np.ndarray, k0: int, g0: int) -> np.ndarray:
    """Pack a (K, G_total) nonzero mask into (tiles, T, K0, G0) tile streams.

    Lane l of the dot-product unit streams its own *contiguous K segment*
    (k = l*T + t), exactly like Bit-Tactical's independent weight lanes;
    under output-stationary accumulation any K order is valid.  This packing
    is what gives the paper's load-balancing observations their bite: a run
    of surviving weights inside one channel becomes a same-lane burst, which
    shuffling (t-dependent lane rotation) spreads over the rotation group.
    G_total is tiled into groups of G0 (PE columns for B / rows for A).
    Padding is False (zeros), which is exact: padded positions are
    ineffectual.
    """
    K, Gt = mask.shape
    T = -(-K // k0)
    nt = -(-Gt // g0)
    pad = np.zeros((k0 * T, nt * g0), dtype=bool)
    pad[:K, :Gt] = mask
    # (K0, T, nt, G0) -> (nt, T, K0, G0)
    return pad.reshape(k0, T, nt, g0).transpose(2, 1, 0, 3)


@dataclasses.dataclass
class GemmCycles:
    dense: float
    sparse: float

    @property
    def speedup(self) -> float:
        return self.dense / max(self.sparse, 1e-9)


# ---------------------------------------------------------------------------
# single-sparse families
# ---------------------------------------------------------------------------


def _grouped_cycles(mask_2d: np.ndarray, k0: int, tile_g: int, sub_g: int,
                    d1: int, d2: int, d3: int, shuffle: bool,
                    static: bool = False) -> np.ndarray:
    """Schedule a (K, G_total) stream in window-groups of ``sub_g`` PEs.

    The operand buffer window (front) is private to each group of
    ``1 + d3`` PEs (a column's BBUF / a row's ABUF is its own; cross-PE
    borrowing couples only the d3-adjacent PEs into one window group).  The
    PEs of a tile re-synchronize at the tile boundary (paper: output
    synchronization stalls), so per-tile cycles are the max over its groups.
    Returns per-tile cycle counts.
    """
    tiles = _pack_stream(mask_2d, k0, sub_g)            # (ngroups, T, K0, sub)
    if static:
        # offline preprocessing packs optimally within the window (the
        # paper's Sparse.B preprocessing step); see static_pack_cycles.
        cycles = static_pack_cycles(tiles, d1, d2, d3, shuffle=shuffle)
    else:
        cycles = schedule(tiles, d1, d2, d3, shuffle=shuffle).cycles
    per_tile = -(-tile_g // sub_g)                      # groups per tile
    ngroups = tiles.shape[0]
    pad = -(-ngroups // per_tile) * per_tile
    padded = np.zeros(pad, dtype=np.int64)
    padded[:ngroups] = cycles
    return padded.reshape(-1, per_tile).max(axis=1)


def sparse_b_gemm_cycles(spec: SparseSpec, b_mask: np.ndarray, m: int,
                         core: CoreConfig) -> GemmCycles:
    """Weight-only sparsity.  b_mask: (K, N)."""
    K, N = b_mask.shape
    sub = min(1 + spec.db3, core.n0)
    per_tile = _grouped_cycles(b_mask, core.k0, core.n0, sub,
                               spec.db1, spec.db2, spec.db3, spec.shuffle,
                               static=True)
    m_tiles = -(-m // core.m0)
    T = -(-K // core.k0)
    dense = T * per_tile.shape[0] * m_tiles
    return GemmCycles(dense=dense, sparse=float(per_tile.sum()) * m_tiles)


def sparse_a_gemm_cycles(spec: SparseSpec, a_mask: np.ndarray, n: int,
                         core: CoreConfig) -> GemmCycles:
    """Activation-only sparsity.  a_mask: (M, K)."""
    M, K = a_mask.shape
    sub = min(1 + spec.da3, core.m0)
    per_tile = _grouped_cycles(a_mask.T, core.k0, core.m0, sub,
                               spec.da1, spec.da2, spec.da3, spec.shuffle)
    n_tiles = -(-n // core.n0)
    T = -(-K // core.k0)
    dense = T * per_tile.shape[0] * n_tiles
    return GemmCycles(dense=dense, sparse=float(per_tile.sum()) * n_tiles)


# ---------------------------------------------------------------------------
# dual sparsity (two-stage, Fig. 3) and joint (TensorDash-style)
# ---------------------------------------------------------------------------


def _slot_maps(sched: Schedule, tiles_b: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Invert stage-1 placement records into per-slot source coordinates.

    Returns (filled, src_t, src_l): arrays of shape (tiles, C, K0, G) where
    slot (c, lane, col) of the compacted stream holds B element
    (src_t, src_l, col_src) — col_src is not needed downstream because the A
    operand of a pair depends only on (t, k-lane, m).
    """
    nt, T, K0, G = tiles_b.shape
    C = int(sched.cycles.max())
    filled = np.zeros((nt, C, K0, G), dtype=bool)
    src_t = np.zeros((nt, C, K0, G), dtype=np.int32)
    src_l = np.zeros((nt, C, K0, G), dtype=np.int16)
    ti, ts, ls, gs = np.nonzero(sched.cyc >= 0)
    c = sched.cyc[ti, ts, ls, gs].astype(np.int64)
    lt = sched.lane[ti, ts, ls, gs].astype(np.int64)
    gt = sched.grp[ti, ts, ls, gs].astype(np.int64)
    filled[ti, c, lt, gt] = True
    src_t[ti, c, lt, gt] = ts
    src_l[ti, c, lt, gt] = ls
    return filled, src_t, src_l


def dual_gemm_cycles(spec: SparseSpec, a_mask: np.ndarray, b_mask: np.ndarray,
                     core: CoreConfig, rng: np.random.Generator,
                     sample_mt: int = 4, sample_nt: int = 4,
                     preprocess_b: bool = True) -> GemmCycles:
    """Dual sparsity.  a_mask: (M, K), b_mask: (K, N).

    Stage 1 compacts B offline per window group of (1+db3) columns; stage 2
    schedules, per PE column and per (1+da3)-row window group, the effectual
    (A nonzero AND B-slot filled) mask over the *compacted* cycle base.  The
    tile's columns re-synchronize at the tile boundary (max).

    ``preprocess_b=False`` gives the joint (TensorDash-style) model: stage 1
    is the identity and the da-windows must skip both kinds of zeros on the
    fly over the pairwise-effectual mask.
    """
    M, K = a_mask.shape
    _, N = b_mask.shape
    k0, n0, m0 = core.k0, core.n0, core.m0
    sub_b = min(1 + spec.db3, n0)
    sub_a = min(1 + spec.da3, m0)
    per_tile_b = -(-n0 // sub_b)                       # column groups per tile
    row_subs = -(-m0 // sub_a)                         # row groups per m-tile
    # Shuffle both matrices identically up front (stage schedules then run
    # with shuffle=False so lane coordinates stay consistent across stages).
    a_tiles_all = _pack_stream(a_mask.T, k0, m0)       # (MT, T, K0, M0)
    b_subs_all = _pack_stream(b_mask, k0, sub_b)       # (NT*ptb, T, K0, sub_b)
    if spec.shuffle:
        a_tiles_all = shuffle_lanes(a_tiles_all)
        b_subs_all = shuffle_lanes(b_subs_all)
    MT, T = a_tiles_all.shape[0], a_tiles_all.shape[1]
    NT = -(-N // n0)
    # pad the column-group axis out to whole tiles, then sample whole tiles
    nsub_tot = NT * per_tile_b
    if b_subs_all.shape[0] < nsub_tot:
        padb = np.zeros((nsub_tot, T, k0, sub_b), dtype=bool)
        padb[:b_subs_all.shape[0]] = b_subs_all
        b_subs_all = padb
    b_by_tile = b_subs_all.reshape(NT, per_tile_b, T, k0, sub_b)
    mt_idx = rng.choice(MT, size=min(sample_mt, MT), replace=False)
    nt_idx = rng.choice(NT, size=min(sample_nt, NT), replace=False)
    a_tiles = a_tiles_all[mt_idx]                      # (mt, T, K0, M0)
    b_subs = b_by_tile[nt_idx].reshape(-1, T, k0, sub_b)   # (nt*ptb, T, K0, sub)
    mt, nsub = a_tiles.shape[0], b_subs.shape[0]

    if preprocess_b:
        s1 = schedule(b_subs, spec.db1, spec.db2, spec.db3,
                      shuffle=False, record=True)
        filled, src_t, src_l = _slot_maps(s1, b_subs)   # (nsub, C, K0, sub_b)
    else:
        filled = b_subs
        src_t = np.broadcast_to(
            np.arange(T, dtype=np.int32)[None, :, None, None], filled.shape)
        src_l = np.broadcast_to(
            np.arange(k0, dtype=np.int16)[None, None, :, None], filled.shape)
    C = filled.shape[1]

    # Stage 2 effectual mask: eff[c, l, col, m] = filled & A[src_t, src_l, m],
    # gathered for every m of the M0 group via fancy indexing.
    st = np.broadcast_to(src_t[None], (mt,) + src_t.shape).astype(np.int64)
    sl = np.broadcast_to(src_l[None], (mt,) + src_l.shape).astype(np.int64)
    mt_ax = np.arange(mt)[:, None, None, None, None]
    a_vals = a_tiles[mt_ax, st, sl]                    # (mt, nsub, C, K0, sub_b, M0)
    eff = filled[None, ..., None] & a_vals
    # scheduling unit: one PE column x one row group -> (C, K0, sub_a)
    eff = eff.transpose(0, 1, 4, 2, 3, 5).reshape(
        mt * nsub * sub_b, C, k0, row_subs, sub_a)
    eff = eff.transpose(0, 3, 1, 2, 4).reshape(
        mt * nsub * sub_b * row_subs, C, k0, sub_a)
    s2 = schedule(eff, spec.da1, spec.da2, spec.da3, shuffle=False)
    nt = len(nt_idx)
    per_unit = s2.cycles.reshape(mt, nt, per_tile_b * sub_b * row_subs)
    per_tile = per_unit.max(axis=2)                    # output-sync stall
    mean_tile = float(per_tile.mean())
    dense = T * MT * NT
    return GemmCycles(dense=dense, sparse=mean_tile * MT * NT)


def sparten_gemm_cycles(mode: Mode, a_mask: np.ndarray, b_mask: np.ndarray
                        ) -> GemmCycles:
    """SparTen / SparTen.A / SparTen.B (per-PE intersection, Section V).

    SparTen performs *offline greedy balancing* of the (static) weight
    columns in software [18]; we model it by snake-assigning density-sorted
    columns to the PE waves, which equalizes per-wave maxima.
    """
    M, K = a_mask.shape
    _, N = b_mask.shape
    a = a_mask.astype(np.int32)
    b = b_mask.astype(np.int32)
    if mode in (Mode.B, Mode.AB) and N > 32:
        order = np.argsort(b.sum(axis=0))
        nwaves = -(-N // 32)
        snake = np.concatenate([order[i::2 * nwaves] for i in range(nwaves)] +
                               [order[2 * nwaves - 1 - i::2 * nwaves]
                                for i in range(nwaves)])
        # interleave so each wave receives a balanced density mix
        b = b[:, np.sort(snake.reshape(nwaves, -1), axis=0).T.reshape(-1)]             if False else b[:, snake]
    if mode == Mode.AB:
        counts = a @ b                                  # effectual pairs per output
    elif mode == Mode.B:
        counts = np.broadcast_to(b.sum(axis=0)[None, :], (M, N)).copy()
    elif mode == Mode.A:
        counts = np.broadcast_to(a.sum(axis=1)[:, None], (M, N)).copy()
    else:
        counts = np.full((M, N), K, dtype=np.int32)
    waves = sparten_tile_cycles(counts)
    # dense baseline with the same 1024 MACs: each 32x32 wave takes K cycles
    return GemmCycles(dense=float(waves.size * K), sparse=float(waves.sum()))


# ---------------------------------------------------------------------------
# dispatch: score one GEMM under (spec, mode)
# ---------------------------------------------------------------------------


def gemm_cycles(spec: SparseSpec, mode: Mode, a_mask: np.ndarray,
                b_mask: np.ndarray, core: CoreConfig,
                rng: Optional[np.random.Generator] = None,
                sample_mt: int = 4, sample_nt: int = 4) -> GemmCycles:
    """Cycles for C = A @ B on architecture ``spec`` running category ``mode``.

    The mode is the *model* category; the architecture only exploits the
    sparsity its windows support (Definition III.1/III.2/IV.1).
    """
    rng = rng or np.random.default_rng(0)
    M, K = a_mask.shape
    _, N = b_mask.shape
    if spec.name and spec.name.startswith("SparTen"):
        supported = {"SparTen.AB": Mode.AB, "SparTen.A": Mode.A,
                     "SparTen.B": Mode.B}[spec.name]
        eff_mode = _intersect_mode(mode, supported)
        return sparten_gemm_cycles(eff_mode, a_mask, b_mask)

    use_a = spec.supports_a and mode in (Mode.A, Mode.AB)
    use_b = spec.supports_b and mode in (Mode.B, Mode.AB)
    if use_a and use_b:
        preprocess = not (spec.name == "TDash.AB")
        return dual_gemm_cycles(spec, a_mask, b_mask, core, rng,
                                sample_mt, sample_nt, preprocess_b=preprocess)
    if use_b:
        return sparse_b_gemm_cycles(spec, b_mask, M, core)
    if use_a:
        return sparse_a_gemm_cycles(spec, a_mask, N, core)
    T = -(-K // core.k0)
    dense = T * -(-N // core.n0) * -(-M // core.m0)
    return GemmCycles(dense=dense, sparse=float(dense))


def _intersect_mode(model: Mode, supported: Mode) -> Mode:
    if supported == Mode.AB:
        return model
    if model in (supported, Mode.AB):
        return supported
    return Mode.DENSE


# ---------------------------------------------------------------------------
# network-level evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """One GEMM of a workload: C[M,N] += A[M,K] @ B[K,N].

    ``b_static`` is False for activation x activation GEMMs (attention scores
    / context), where weight preprocessing is impossible (DESIGN.md Section 5).
    """

    m: int
    k: int
    n: int
    count: int = 1        # how many times this GEMM occurs
    b_static: bool = True
    q: int = 1            # spatial-tap period of the im2col K axis (RxS; 1 for FC/1x1)
    depthwise: bool = False  # block-diagonal B: column c only draws from rows [q*c, q*(c+1))


@dataclasses.dataclass(frozen=True)
class Workload:
    """A network benchmark: GEMM list + tensor sparsity levels (Table IV)."""

    name: str
    gemms: Tuple[GemmShape, ...]
    a_sparsity: float     # activation sparsity (0 = dense)
    b_sparsity: float     # weight sparsity    (0 = dense)

    @property
    def mode(self) -> Mode:
        return Mode.of(self.a_sparsity > 0.05, self.b_sparsity > 0.05)

    def dense_cycles(self, core: CoreConfig) -> float:
        tot = 0.0
        for g in self.gemms:
            tot += g.count * (-(-g.k // core.k0)) * (-(-g.n // core.n0)) * \
                (-(-g.m // core.m0))
        return tot


# Keep evaluation tractable on one CPU: cap the K-chunks per scheduled stream
# and the sampled tiles; this is statistical sampling over an i.i.d. mask, so
# the estimate is unbiased.
MAX_CHUNKS = 96


def _layer_jitter(base: float, rng: np.random.Generator, lo=0.75, hi=1.15
                  ) -> float:
    return float(np.clip(base * rng.uniform(lo, hi), 0.0, 0.98))


def allocate_layer_densities(gemms: Sequence["GemmShape"], net_sparsity: float,
                             beta: float = 0.25, floor: float = 0.02,
                             cap: float = 1.0) -> np.ndarray:
    """Per-layer weight densities consistent with a *network-level* ratio.

    Published pruning ratios (Table IV) are parameter-weighted: larger layers
    are pruned much harder (Deep Compression prunes AlexNet's FC6 to ~4%
    density while conv1 keeps most weights).  We allocate density_i
    proportional to size_i^-beta and renormalize so the parameter-weighted
    mean density equals ``1 - net_sparsity``.
    """
    sizes = np.array([max(g.k * g.n, 1) * g.count for g in gemms],
                     dtype=np.float64)
    target = 1.0 - net_sparsity
    if target >= 0.999:
        return np.ones(len(sizes))
    rel = (sizes / sizes.mean()) ** (-beta)
    lam = target * sizes.sum() / (sizes * rel).sum()
    d = np.clip(lam * rel, floor, cap)
    # one correction pass for the clipped mass
    err = (sizes * d).sum() / sizes.sum() - target
    free = (d > floor) & (d < cap)
    if free.any() and abs(err) > 1e-6:
        d[free] = np.clip(d[free] - err * sizes.sum() / sizes[free].sum(),
                          floor, cap)
    return d


def network_speedup(spec: SparseSpec, wl: Workload, core: CoreConfig,
                    seed: int = 0, mode: Optional[Mode] = None,
                    sample_mt: int = 4, sample_nt: int = 4,
                    mask_model: MaskModel = DEFAULT_MASK_MODEL) -> float:
    """End-to-end speedup of ``wl`` on ``spec`` vs the dense baseline.

    Per-layer weight density follows the size-aware allocation above (plus
    jitter); activation sparsity is jittered around the network ratio; masks
    follow the structured ``MaskModel``.
    """
    rng = np.random.default_rng(seed)
    mode = mode or wl.mode
    b_dens = allocate_layer_densities(wl.gemms, wl.b_sparsity)
    dense_total, sparse_total = 0.0, 0.0
    for li, g in enumerate(wl.gemms):
        lrng = np.random.default_rng(seed * 7919 + li)
        a_d = 1.0 - _layer_jitter(wl.a_sparsity, lrng)
        b_d = float(np.clip(b_dens[li] * lrng.uniform(0.9, 1.1), 0.02, 1.0)) \
            if g.b_static else 1.0 - _layer_jitter(wl.a_sparsity, lrng)
        k_eff = min(g.k, MAX_CHUNKS * core.k0)
        m_eff = min(g.m, 64 * core.m0)
        n_eff = min(g.n, 64 * core.n0)
        g_mode = mode if g.b_static else (
            Mode.A if mode in (Mode.A, Mode.AB) and wl.a_sparsity > 0.05
            else Mode.DENSE)
        a_mask = mask_model.act_mask(m_eff, k_eff, a_d, lrng, q=g.q)
        b_mask = mask_model.weight_mask(k_eff, n_eff, b_d, lrng, q=g.q)
        if g.depthwise:
            allowed = (np.arange(k_eff)[:, None] // g.q) == np.arange(n_eff)[None, :]
            b_mask &= allowed
        res = gemm_cycles(spec, g_mode, a_mask, b_mask, core, lrng,
                          sample_mt, sample_nt)
        # scale sampled cycles back to the full layer, weighted by count
        full = g.count * (-(-g.k // core.k0)) * (-(-g.n // core.n0)) * \
            (-(-g.m // core.m0))
        dense_total += full
        sparse_total += full * (res.sparse / res.dense)
    return dense_total / max(sparse_total, 1e-9)


def category_speedup(spec: SparseSpec, workloads: Sequence[Workload],
                     core: CoreConfig, seed: int = 0,
                     mode: Optional[Mode] = None) -> float:
    """Geometric-mean speedup over a benchmark category (Section V)."""
    sp = [network_speedup(spec, w, core, seed=seed + i, mode=mode)
          for i, w in enumerate(workloads)]
    return float(np.exp(np.mean(np.log(sp))))


# ---------------------------------------------------------------------------
# batched evaluation: one vectorized pass over a stack of SparseSpec configs
# ---------------------------------------------------------------------------


def _side_params(specs: Sequence[SparseSpec], side: str
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(d1, d2, d3, shuffle) vectors for the A or B window of each spec."""
    if side == "a":
        d = [(s.da1, s.da2, s.da3) for s in specs]
    else:
        d = [(s.db1, s.db2, s.db3) for s in specs]
    arr = np.asarray(d, dtype=np.int64).reshape(len(specs), 3)
    sh = np.asarray([s.shuffle for s in specs], dtype=bool)
    return arr[:, 0], arr[:, 1], arr[:, 2], sh


def sparse_b_gemm_cycles_batched(specs: Sequence[SparseSpec],
                                 b_mask: np.ndarray, m: int, core: CoreConfig
                                 ) -> List[GemmCycles]:
    """Weight-only sparsity for a stack of specs.  b_mask: (K, N).

    Specs are grouped by their cross-PE window width (the packing
    granularity); within a group the tile stream is packed once and the
    offline bound runs over the stacked config axis.
    """
    K, N = b_mask.shape
    m_tiles = -(-m // core.m0)
    T = -(-K // core.k0)
    results: List[Optional[GemmCycles]] = [None] * len(specs)
    groups: Dict[int, List[int]] = {}
    for i, sp in enumerate(specs):
        groups.setdefault(min(1 + sp.db3, core.n0), []).append(i)
    for sub, idxs in groups.items():
        tiles = _pack_stream(b_mask, core.k0, sub)     # (ngroups, T, K0, sub)
        sub_specs = [specs[i] for i in idxs]
        d1, d2, d3, sh = _side_params(sub_specs, "b")
        per = static_pack_cycles_batched(tiles, d1, d2, d3, sh)
        per_tile_g = -(-core.n0 // sub)                # groups per tile
        ngroups = tiles.shape[0]
        pad = -(-ngroups // per_tile_g) * per_tile_g
        padded = np.zeros((len(idxs), pad), dtype=np.int64)
        padded[:, :ngroups] = per
        per_tile = padded.reshape(len(idxs), -1, per_tile_g).max(axis=2)
        dense = T * per_tile.shape[1] * m_tiles
        for j, i in enumerate(idxs):
            results[i] = GemmCycles(dense=dense,
                                    sparse=float(per_tile[j].sum()) * m_tiles)
    return results  # type: ignore[return-value]


def sparse_a_gemm_cycles_batched(specs: Sequence[SparseSpec],
                                 a_mask: np.ndarray, n: int, core: CoreConfig
                                 ) -> List[GemmCycles]:
    """Activation-only sparsity for a stack of specs.  a_mask: (M, K)."""
    M, K = a_mask.shape
    n_tiles = -(-n // core.n0)
    T = -(-K // core.k0)
    results: List[Optional[GemmCycles]] = [None] * len(specs)
    groups: Dict[int, List[int]] = {}
    for i, sp in enumerate(specs):
        groups.setdefault(min(1 + sp.da3, core.m0), []).append(i)
    for sub, idxs in groups.items():
        tiles = _pack_stream(a_mask.T, core.k0, sub)   # (ngroups, T, K0, sub)
        ngroups = tiles.shape[0]
        sub_specs = [specs[i] for i in idxs]
        d1, d2, d3, sh = _side_params(sub_specs, "a")
        big = np.broadcast_to(tiles[None], (len(idxs),) + tiles.shape)
        big = big.reshape((-1,) + tiles.shape[1:])
        cycles = schedule_batched(
            big, np.repeat(d1, ngroups), np.repeat(d2, ngroups),
            np.repeat(d3, ngroups), shuffle=np.repeat(sh, ngroups)
        ).cycles.reshape(len(idxs), ngroups)
        per_tile_g = -(-core.m0 // sub)
        pad = -(-ngroups // per_tile_g) * per_tile_g
        padded = np.zeros((len(idxs), pad), dtype=np.int64)
        padded[:, :ngroups] = cycles
        per_tile = padded.reshape(len(idxs), -1, per_tile_g).max(axis=2)
        dense = T * per_tile.shape[1] * n_tiles
        for j, i in enumerate(idxs):
            results[i] = GemmCycles(dense=dense,
                                    sparse=float(per_tile[j].sum()) * n_tiles)
    return results  # type: ignore[return-value]


def dual_gemm_cycles_batched(specs: Sequence[SparseSpec],
                             preprocess: Sequence[bool], a_mask: np.ndarray,
                             b_mask: np.ndarray, core: CoreConfig,
                             mt_idx: np.ndarray, nt_idx: np.ndarray
                             ) -> List[GemmCycles]:
    """Dual sparsity for a stack of specs sharing one (mt_idx, nt_idx) sample.

    Stage-1 B compaction is batched across all specs of a (sub_a, sub_b,
    preprocess) group; stage-2 effectual masks are stacked (padded to the
    deepest compacted stream, each row carrying its own ``t_len``) so the
    expensive on-the-fly schedule runs once per group.
    """
    M, K = a_mask.shape
    _, N = b_mask.shape
    k0, n0, m0 = core.k0, core.n0, core.m0
    base_a = _pack_stream(a_mask.T, k0, m0)            # (MT, T, K0, M0)
    MT, T = base_a.shape[0], base_a.shape[1]
    NT = -(-N // n0)
    a_var = {False: base_a}                            # keyed by shuffle
    b_var: Dict[Tuple[int, bool], np.ndarray] = {}     # keyed by (sub_b, sh)

    def a_tiles_for(sh: bool) -> np.ndarray:
        if sh not in a_var:
            a_var[sh] = shuffle_lanes(base_a)
        return a_var[sh][mt_idx]

    def b_by_tile_for(sub_b: int, sh: bool) -> np.ndarray:
        if (sub_b, sh) not in b_var:
            bs = _pack_stream(b_mask, k0, sub_b)
            if sh:
                bs = shuffle_lanes(bs)
            per_tile_b = -(-n0 // sub_b)
            nsub_tot = NT * per_tile_b
            if bs.shape[0] < nsub_tot:
                padb = np.zeros((nsub_tot, T, k0, sub_b), dtype=bool)
                padb[:bs.shape[0]] = bs
                bs = padb
            b_var[(sub_b, sh)] = bs.reshape(NT, per_tile_b, T, k0, sub_b)
        return b_var[(sub_b, sh)]

    results: List[Optional[GemmCycles]] = [None] * len(specs)
    groups: Dict[Tuple[int, int, bool], List[int]] = {}
    for i, sp in enumerate(specs):
        key = (min(1 + sp.da3, m0), min(1 + sp.db3, n0), bool(preprocess[i]))
        groups.setdefault(key, []).append(i)

    for (sub_a, sub_b, prep), all_idxs in groups.items():
        per_tile_b = -(-n0 // sub_b)
        row_subs = -(-m0 // sub_a)
        mt, nt = len(mt_idx), len(nt_idx)
        nsub = nt * per_tile_b
        # Cap the stacked stage-2 rows per scheduling call: past a few
        # thousand rows the per-cycle working set falls out of cache and
        # the batch turns memory-bound, which costs more than the Python
        # overhead it saves.
        group_units = mt * nsub * sub_b * row_subs
        step = max(1, 6144 // max(group_units, 1))
        chunks = [all_idxs[lo:lo + step]
                  for lo in range(0, len(all_idxs), step)]
        for idxs in chunks:
            _dual_group(specs, idxs, prep, sub_a, sub_b, per_tile_b,
                        row_subs, mt, nt, nsub, T, MT, NT, k0, nt_idx,
                        a_tiles_for, b_by_tile_for, results)
    return results  # type: ignore[return-value]


def _dual_group(specs, idxs, prep, sub_a, sub_b, per_tile_b, row_subs, mt,
                nt, nsub, T, MT, NT, k0, nt_idx, a_tiles_for, b_by_tile_for,
                results) -> None:
    """Score one (sub_a, sub_b, preprocess) chunk of dual-sparse specs."""
    b_subs_all = [
        b_by_tile_for(sub_b, specs[i].shuffle)[nt_idx].reshape(
            -1, T, k0, sub_b) for i in idxs]
    if prep:
        stack = np.concatenate(b_subs_all, axis=0)
        d1, d2, d3, _ = _side_params([specs[i] for i in idxs], "b")
        s1 = schedule_batched(stack, np.repeat(d1, nsub),
                              np.repeat(d2, nsub), np.repeat(d3, nsub),
                              shuffle=False, record=True)
    # stage-2 effectual masks, one per spec, padded to the chunk's C_max
    effs, clens = [], []
    for j, i in enumerate(idxs):
        b_subs = b_subs_all[j]
        if prep:
            sl = slice(j * nsub, (j + 1) * nsub)
            sub_sched = Schedule(cycles=s1.cycles[sl], cyc=s1.cyc[sl],
                                 lane=s1.lane[sl], grp=s1.grp[sl])
            filled, src_t, src_l = _slot_maps(sub_sched, b_subs)
        else:
            filled = b_subs
            src_t = np.broadcast_to(
                np.arange(T, dtype=np.int32)[None, :, None, None],
                filled.shape)
            src_l = np.broadcast_to(
                np.arange(k0, dtype=np.int16)[None, None, :, None],
                filled.shape)
        C = filled.shape[1]
        a_tiles = a_tiles_for(specs[i].shuffle)
        st = np.broadcast_to(src_t[None], (mt,) + src_t.shape
                             ).astype(np.int64)
        slx = np.broadcast_to(src_l[None], (mt,) + src_l.shape
                              ).astype(np.int64)
        mt_ax = np.arange(mt)[:, None, None, None, None]
        a_vals = a_tiles[mt_ax, st, slx]  # (mt, nsub, C, K0, sub_b, M0)
        eff = filled[None, ..., None] & a_vals
        eff = eff.transpose(0, 1, 4, 2, 3, 5).reshape(
            mt * nsub * sub_b, C, k0, row_subs, sub_a)
        eff = eff.transpose(0, 3, 1, 2, 4).reshape(
            mt * nsub * sub_b * row_subs, C, k0, sub_a)
        effs.append(eff)
        clens.append(C)
    c_max = max(clens)
    units = mt * nsub * sub_b * row_subs
    stack2 = np.zeros((len(idxs) * units, c_max, k0, sub_a), dtype=bool)
    for j, eff in enumerate(effs):
        stack2[j * units:(j + 1) * units, :clens[j]] = eff
    da1, da2, da3, _ = _side_params([specs[i] for i in idxs], "a")
    s2 = schedule_batched(stack2, np.repeat(da1, units),
                          np.repeat(da2, units), np.repeat(da3, units),
                          shuffle=False,
                          t_len=np.repeat(np.asarray(clens), units))
    dense = T * MT * NT
    for j, i in enumerate(idxs):
        per_unit = s2.cycles[j * units:(j + 1) * units].reshape(
            mt, nt, per_tile_b * sub_b * row_subs)
        per_tile = per_unit.max(axis=2)                # output-sync stall
        results[i] = GemmCycles(dense=dense,
                                sparse=float(per_tile.mean()) * MT * NT)


def gemm_cycles_batched(specs: Sequence[SparseSpec], mode: Mode,
                        a_mask: np.ndarray, b_mask: np.ndarray,
                        core: CoreConfig,
                        rng: Optional[np.random.Generator] = None,
                        sample_mt: int = 4, sample_nt: int = 4
                        ) -> List[GemmCycles]:
    """Cycles of C = A @ B for every spec of a stack, in one vectorized pass.

    Bit-exact with ``[gemm_cycles(s, mode, ...) for s in specs]`` where each
    scalar call receives an identically-seeded ``rng`` — which is exactly how
    :func:`network_speedup` consumes it, so batched and scalar DSE sweeps
    produce identical numbers.
    """
    rng = rng or np.random.default_rng(0)
    M, K = a_mask.shape
    _, N = b_mask.shape
    results: List[Optional[GemmCycles]] = [None] * len(specs)
    sparten_ix, dual_ix, b_ix, a_ix, dense_ix = [], [], [], [], []
    for i, spec in enumerate(specs):
        if spec.name and spec.name.startswith("SparTen"):
            sparten_ix.append(i)
            continue
        use_a = spec.supports_a and mode in (Mode.A, Mode.AB)
        use_b = spec.supports_b and mode in (Mode.B, Mode.AB)
        if use_a and use_b:
            dual_ix.append(i)
        elif use_b:
            b_ix.append(i)
        elif use_a:
            a_ix.append(i)
        else:
            dense_ix.append(i)
    by_mode: Dict[Mode, GemmCycles] = {}
    for i in sparten_ix:
        supported = {"SparTen.AB": Mode.AB, "SparTen.A": Mode.A,
                     "SparTen.B": Mode.B}[specs[i].name]
        eff_mode = _intersect_mode(mode, supported)
        if eff_mode not in by_mode:
            by_mode[eff_mode] = sparten_gemm_cycles(eff_mode, a_mask, b_mask)
        results[i] = by_mode[eff_mode]
    if dual_ix:
        # the one rng-consuming path: every scalar call draws the same
        # sample from an identically-seeded generator, so draw once here
        MT, NT = -(-M // core.m0), -(-N // core.n0)
        mt_idx = rng.choice(MT, size=min(sample_mt, MT), replace=False)
        nt_idx = rng.choice(NT, size=min(sample_nt, NT), replace=False)
        dres = dual_gemm_cycles_batched(
            [specs[i] for i in dual_ix],
            [specs[i].name != "TDash.AB" for i in dual_ix],
            a_mask, b_mask, core, mt_idx, nt_idx)
        for i, r in zip(dual_ix, dres):
            results[i] = r
    if b_ix:
        for i, r in zip(b_ix, sparse_b_gemm_cycles_batched(
                [specs[i] for i in b_ix], b_mask, M, core)):
            results[i] = r
    if a_ix:
        for i, r in zip(a_ix, sparse_a_gemm_cycles_batched(
                [specs[i] for i in a_ix], a_mask, N, core)):
            results[i] = r
    if dense_ix:
        T = -(-K // core.k0)
        dense = T * -(-N // core.n0) * -(-M // core.m0)
        for i in dense_ix:
            results[i] = GemmCycles(dense=dense, sparse=float(dense))
    return results  # type: ignore[return-value]


def network_speedup_batched(specs: Sequence[SparseSpec], wl: Workload,
                            core: CoreConfig, seed: int = 0,
                            mode: Optional[Mode] = None,
                            sample_mt: int = 4, sample_nt: int = 4,
                            mask_model: MaskModel = DEFAULT_MASK_MODEL
                            ) -> np.ndarray:
    """End-to-end speedups of ``wl`` for a stack of specs (one mask draw).

    The per-layer masks depend only on (workload, seed), not on the spec —
    the scalar path regenerates them per design; here they are drawn once
    and shared, which with the stacked-config scheduler is where the DSE
    batching speedup comes from.  Returns a (len(specs),) array, bit-exact
    with per-spec :func:`network_speedup` calls.
    """
    mode = mode or wl.mode
    b_dens = allocate_layer_densities(wl.gemms, wl.b_sparsity)
    dense_total = 0.0
    sparse_totals = np.zeros(len(specs), dtype=np.float64)
    for li, g in enumerate(wl.gemms):
        lrng = np.random.default_rng(seed * 7919 + li)
        a_d = 1.0 - _layer_jitter(wl.a_sparsity, lrng)
        b_d = float(np.clip(b_dens[li] * lrng.uniform(0.9, 1.1), 0.02, 1.0)) \
            if g.b_static else 1.0 - _layer_jitter(wl.a_sparsity, lrng)
        k_eff = min(g.k, MAX_CHUNKS * core.k0)
        m_eff = min(g.m, 64 * core.m0)
        n_eff = min(g.n, 64 * core.n0)
        g_mode = mode if g.b_static else (
            Mode.A if mode in (Mode.A, Mode.AB) and wl.a_sparsity > 0.05
            else Mode.DENSE)
        a_mask = mask_model.act_mask(m_eff, k_eff, a_d, lrng, q=g.q)
        b_mask = mask_model.weight_mask(k_eff, n_eff, b_d, lrng, q=g.q)
        if g.depthwise:
            allowed = (np.arange(k_eff)[:, None] // g.q) == np.arange(n_eff)[None, :]
            b_mask &= allowed
        res = gemm_cycles_batched(specs, g_mode, a_mask, b_mask, core, lrng,
                                  sample_mt, sample_nt)
        full = g.count * (-(-g.k // core.k0)) * (-(-g.n // core.n0)) * \
            (-(-g.m // core.m0))
        dense_total += full
        sparse_totals += full * np.array([r.sparse / r.dense for r in res])
    return dense_total / np.maximum(sparse_totals, 1e-9)


def category_speedup_batched(specs: Sequence[SparseSpec],
                             workloads: Sequence[Workload], core: CoreConfig,
                             seed: int = 0, mode: Optional[Mode] = None,
                             mask_model: MaskModel = DEFAULT_MASK_MODEL
                             ) -> np.ndarray:
    """Geometric-mean category speedups for a stack of specs."""
    logs = np.zeros((len(workloads), len(specs)))
    for i, w in enumerate(workloads):
        logs[i] = np.log(network_speedup_batched(
            specs, w, core, seed=seed + i, mode=mode, mask_model=mask_model))
    return np.exp(logs.mean(axis=0))


def dense_cycles_batched(workloads: Sequence[Workload], core: CoreConfig
                         ) -> np.ndarray:
    """Dense-baseline cycle totals for many workloads in one numpy pass
    (vectorized twin of :meth:`Workload.dense_cycles`)."""
    wi, kk, nn, mm, cc = [], [], [], [], []
    for i, w in enumerate(workloads):
        for g in w.gemms:
            wi.append(i)
            kk.append(g.k)
            nn.append(g.n)
            mm.append(g.m)
            cc.append(g.count)
    if not wi:
        return np.zeros(len(workloads))
    kk, nn, mm, cc = (np.asarray(x, dtype=np.int64) for x in (kk, nn, mm, cc))
    per = cc * (-(-kk // core.k0)) * (-(-nn // core.n0)) * (-(-mm // core.m0))
    out = np.zeros(len(workloads), dtype=np.float64)
    np.add.at(out, np.asarray(wi), per.astype(np.float64))
    return out
