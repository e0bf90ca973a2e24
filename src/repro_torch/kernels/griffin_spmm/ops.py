"""Public ops of Griffin sparse execution (K2): the compacted weight format,
its offline preprocessing, and the block-sparse GEMM wrapper.

The counterpart of ``repro/kernels/griffin_spmm/ops.py``.  Preprocessing is
pure data movement, done with torch ops on the weights' own device (the card
at full width): its metadata and ``b_comp`` are bitwise equal to the
reference's numpy preprocessing on the same weights, clamp-padded dead
entries included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from . import kernel
from ...core.hybrid import select_mode
from ...core.spec import Mode
from ..dense_gemm.ops import check_dtypes, dense_matmul
from ..sparse_a.ops import sparse_a_matmul
from .ref import griffin_spmm_ref

DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 128


@dataclasses.dataclass
class GriffinWeights:
    """Block-compacted weights + metadata (tensors on one device).

    Tensor fields may carry a leading axis (stacked layers); the trailing
    axes are the single-matrix layout:

    * ``b_comp`` (..., max_cnt * block_k, N_padded): per N tile j, rows
      ``[kc * block_k, (kc + 1) * block_k)`` hold its kc-th live K block;
    * ``kidx`` (..., n_tiles, max_cnt) int32: source K-block ids, dead
      entries (kc >= cnt) clamp-repeating the last live id;
    * ``cnt`` (..., n_tiles) int32: live blocks per N tile;
    * ``inv_perm`` (..., N_padded) int32 or None: undoes the balance
      shuffle's column permutation;
    * ``perm`` (..., N_padded) int32 or None: the shuffle itself, column p
      of ``b_comp`` holding original column ``perm[p]`` — where the card's
      kernel stores each column.  Derived once from ``inv_perm`` when not
      given (the reference has no such field), never per call.
    """

    b_comp: torch.Tensor
    kidx: torch.Tensor
    cnt: torch.Tensor
    inv_perm: Optional[torch.Tensor]
    k: int                   # original K (padded)
    n: int                   # original N (unpadded)
    block_k: int
    block_n: int
    # per-GEMM Mode-selection threshold override (a tuned plan's); None
    # keeps the scope's threshold
    a_thr: Optional[float] = None
    perm: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.perm is None and self.inv_perm is not None:
            self.perm = torch.argsort(self.inv_perm, dim=-1).to(torch.int32)

    @property
    def density(self) -> float:
        """Fraction of surviving (bk x bn) blocks.  Reads ``cnt`` back to
        the host, so it is memoized and read only at engine construction,
        never on the decode path."""
        memo = self.__dict__.get("_density_memo")
        if memo is None:
            total = (self.k // self.block_k) * self.cnt.numel()
            memo = float(self.cnt.sum().item()) / max(total, 1)
            self.__dict__["_density_memo"] = memo
        return memo

    @property
    def compaction(self) -> float:
        """Grid-depth compaction vs dense: max_cnt / nb_k (lower is better)."""
        return self.kidx.shape[-1] / (self.k // self.block_k)

    def __getitem__(self, i) -> "GriffinWeights":
        """Slice a stacked instance along its leading axis (views)."""
        return dataclasses.replace(
            self, b_comp=self.b_comp[i], kidx=self.kidx[i], cnt=self.cnt[i],
            inv_perm=None if self.inv_perm is None else self.inv_perm[i],
            perm=None if self.perm is None else self.perm[i])


def balance_columns(w_padded: torch.Tensor, block_k: int, block_n: int,
                    unit: int) -> torch.Tensor:
    """Unit-column permutation that groups units with similar K-block
    patterns (the paper's load-balancing shuffle at tile granularity).

    Equal to the reference's ``np.lexsort`` of the unit pattern bitmaps:
    a stable least-significant-key-first radix sort over the K blocks, with
    block 0 the primary key and False before True."""
    pk, pn = w_padded.shape
    nb_k, nu = pk // block_k, pn // unit
    pat = (w_padded.reshape(nb_k, block_k, nu, unit) != 0) \
        .any(dim=3).any(dim=1).T                           # (nu, nb_k)
    order = torch.arange(nu, device=w_padded.device)
    for kb in range(nb_k - 1, -1, -1):
        key = pat[order, kb].to(torch.int32)
        order = order[torch.sort(key, stable=True).indices]
    unit_cols = torch.arange(unit, device=w_padded.device)
    return (order[:, None] * unit + unit_cols[None, :]).reshape(-1)


def _tiles(w: torch.Tensor, block_k: int, block_n: int, balance: bool,
           unit: Optional[int]):
    """(padded and balanced w, perm, inv_perm, live-block map (nb_k,
    nb_n), live blocks per N tile) of :func:`preprocess_weights`."""
    k, n = w.shape
    pk = -(-k // block_k) * block_k
    pn = -(-n // block_n) * block_n
    wp = w.new_zeros((pk, pn))
    wp[:k, :n] = w
    nb_k, nb_n = pk // block_k, pn // block_n
    unit = unit or max(8, block_n // 4)
    perm = inv_perm = None
    if balance and pn > block_n and pn % unit == 0:
        full_perm = balance_columns(wp, block_k, block_n, unit)
        wp = wp[:, full_perm]
        perm = full_perm.to(torch.int32)
        inv_perm = torch.argsort(full_perm).to(torch.int32)
    blocks = wp.reshape(nb_k, block_k, nb_n, block_n)
    blk_nz = (blocks != 0).any(dim=3).any(dim=1)          # (nb_k, nb_n)
    cnt = blk_nz.sum(dim=0).to(torch.int32)                # (nb_n,)
    return wp, perm, inv_perm, blk_nz, cnt


def grid_depth(w: torch.Tensor, *, block_k: int = DEFAULT_BLOCK_K,
               block_n: int = DEFAULT_BLOCK_N, balance: bool = True,
               unit: Optional[int] = None) -> int:
    """The grid depth (``max_cnt``) ``preprocess_weights`` gives ``w``,
    without compacting it.  Reads it back to the host."""
    return max(int(_tiles(w, block_k, block_n, balance, unit)[4].max()), 1)


def preprocess_weights(w: torch.Tensor, *, block_k: int = DEFAULT_BLOCK_K,
                       block_n: int = DEFAULT_BLOCK_N, balance: bool = True,
                       unit: Optional[int] = None) -> GriffinWeights:
    """Offline B preprocessing: drop all-zero (bk x bn) blocks, build the
    per-N-tile metadata, optionally balance unit-columns across tiles.
    ``unit`` is the pruning granularity along N (default block_n / 4, min
    8).  Reads one scalar (the grid depth, a shape) back to the host."""
    dev = w.device
    wp, perm, inv_perm, blk_nz, cnt = _tiles(w, block_k, block_n, balance,
                                              unit)
    (pk, pn), (nb_k, nb_n) = wp.shape, blk_nz.shape
    blocks = wp.reshape(nb_k, block_k, nb_n, block_n)
    max_cnt = max(int(cnt.max().item()), 1)
    ids = torch.arange(nb_k, device=dev)[:, None]
    live_ids = torch.sort(torch.where(blk_nz, ids, nb_k), dim=0).values
    kc = torch.arange(max_cnt, device=dev)[:, None]
    last = (cnt.long() - 1).clamp(min=0)[None, :]
    kidx_t = torch.gather(live_ids, 0, torch.minimum(kc, last))
    kidx_t = torch.where(cnt[None, :] > 0, kidx_t, 0)      # (max_cnt, nb_n)
    tiles = torch.arange(nb_n, device=dev)[None, :]
    gathered = blocks[kidx_t, :, tiles, :]      # (max_cnt, nb_n, bk, bn)
    live = (kc < cnt[None, :])[:, :, None, None]
    gathered = torch.where(live, gathered, torch.zeros((), dtype=w.dtype,
                                                       device=dev))
    b_comp = gathered.permute(0, 2, 1, 3).reshape(max_cnt * block_k, pn)
    return GriffinWeights(
        b_comp=b_comp.contiguous(), kidx=kidx_t.T.contiguous().to(torch.int32),
        cnt=cnt, inv_perm=inv_perm, k=pk, n=w.shape[1], block_k=block_k,
        block_n=block_n, perm=perm)


def stack_weights(gws: Sequence[GriffinWeights]) -> GriffinWeights:
    """Stack per-layer compacted weights along a new leading axis, padding
    every member to the common grid depth: dead ``kidx`` entries
    clamp-repeat the member's last id and their ``b_comp`` rows are zero."""
    if not gws:
        raise ValueError("empty stack")
    g0 = gws[0]
    for g in gws[1:]:
        if (g.k, g.n, g.block_k, g.block_n, g.a_thr) != \
                (g0.k, g0.n, g0.block_k, g0.block_n, g0.a_thr):
            raise ValueError("heterogeneous stack")
        if (g.inv_perm is None) != (g0.inv_perm is None):
            raise ValueError("mixed balanced/unbalanced stack")
    max_cnt = max(g.kidx.shape[-1] for g in gws)
    bk = g0.block_k

    def padded(g: GriffinWeights):
        pad_c = max_cnt - g.kidx.shape[-1]
        if not pad_c:
            return g.kidx, g.b_comp
        kidx = torch.cat([g.kidx, g.kidx[:, -1:].expand(-1, pad_c)], dim=1)
        b_comp = torch.cat([g.b_comp, g.b_comp.new_zeros(
            (pad_c * bk, g.b_comp.shape[1]))], dim=0)
        return kidx, b_comp

    ks, bs = zip(*[padded(g) for g in gws])
    return GriffinWeights(
        b_comp=torch.stack(bs), kidx=torch.stack(ks),
        cnt=torch.stack([g.cnt for g in gws]),
        inv_perm=(None if g0.inv_perm is None
                  else torch.stack([g.inv_perm for g in gws])),
        k=g0.k, n=g0.n, block_k=g0.block_k, block_n=g0.block_n,
        a_thr=g0.a_thr,
        perm=(None if g0.perm is None
              else torch.stack([g.perm for g in gws])))


def decompact_weights(gw: GriffinWeights) -> torch.Tensor:
    """The (padded K, n) block-pruned dense matrix a single (non-stacked)
    ``GriffinWeights`` denotes: the compacted blocks scattered back to
    their K rows, then the balance shuffle undone.  Dead entries add zero
    blocks, so every surviving value is reconstructed exactly."""
    if gw.b_comp.dim() != 2:
        raise ValueError("decompact a per-layer slice, not a stack")
    bk = gw.block_k
    nb_k = gw.k // bk
    nt, mc = gw.kidx.shape
    pn = gw.b_comp.shape[-1]
    bn = pn // nt
    vals = gw.b_comp.reshape(mc, bk, nt, bn).permute(0, 2, 1, 3)
    w = gw.b_comp.new_zeros((nb_k, nt, bk, bn))
    tiles = torch.arange(nt, device=gw.kidx.device)[None, :].expand(mc, nt)
    w.index_put_((gw.kidx.T.long(), tiles), vals, accumulate=True)
    w = w.permute(0, 2, 1, 3).reshape(nb_k * bk, pn)
    if gw.inv_perm is not None:
        w = w[:, gw.inv_perm.long()]
    return w[:, :gw.n]


def _check(a: torch.Tensor, gw: GriffinWeights) -> None:
    if gw.b_comp.dim() != 2:
        raise ValueError("griffin_matmul takes a per-layer slice, not a stack")
    if a.dim() != 2 or a.shape[1] > gw.k or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"griffin_matmul A {tuple(a.shape)} vs padded K "
                         f"{gw.k}")
    check_dtypes("griffin_matmul", a, gw.b_comp)
    nt, mc = gw.kidx.shape
    if gw.kidx.dtype != torch.int32 or gw.cnt.dtype != torch.int32 or \
            gw.cnt.shape != (nt,) or gw.b_comp.shape != (mc * gw.block_k,
                                                        nt * gw.block_n):
        raise ValueError("griffin_matmul metadata does not match b_comp")
    if gw.perm is not None and (gw.perm.dtype != torch.int32 or
                                gw.perm.shape != (nt * gw.block_n,)):
        raise ValueError("griffin_matmul perm does not match b_comp")
    for t in (gw.b_comp, gw.kidx, gw.cnt) + \
            (() if gw.perm is None else (gw.perm,)):
        if t.device != a.device:
            raise ValueError(f"griffin_matmul operands on {t.device} and "
                             f"{a.device}")
        if not t.is_contiguous():
            raise ValueError("griffin_matmul needs contiguous operands")
    if not a.is_contiguous():
        raise ValueError("griffin_matmul needs a contiguous A")


@dataclasses.dataclass
class GriffinShard(GriffinWeights):
    """One model rank's share of a compacted weight on a serving mesh
    (``runtime.sharding.shard_params``): ``b_comp``, ``kidx`` and ``cnt``
    hold a contiguous run of N tiles, ``n_tiles / shards`` of them, a
    complete kernel problem of its own (``kidx`` holds global K-block ids
    and the contraction is never split).  ``k``, ``n`` and ``a_thr`` are
    the whole weight's; ``inv_perm`` and ``perm`` stay None (the balance
    shuffle is a global column permutation): ``gather_inv``, the whole
    weight's inverse shuffle, is applied by the caller after the shards'
    columns are gathered (``models.common.griffin_linear``)."""

    gather_inv: Optional[torch.Tensor] = None
    n_tiles: int = 0
    shards: int = 1

    def __getitem__(self, i) -> "GriffinShard":
        out = super().__getitem__(i)
        if self.gather_inv is not None:
            out.gather_inv = self.gather_inv[i]
        return out


def shardable(gw: GriffinWeights, n_shards: int) -> bool:
    """True when the compacted operands split into ``n_shards`` groups of
    whole N tiles (the reference's predicate; the stacked axes, if any,
    are the layers, each split alike)."""
    return gw.kidx.dim() >= 2 and n_shards >= 1 and \
        gw.kidx.shape[-2] % n_shards == 0


def shard_specs(axis: str = "model"):
    """(in specs, out spec) of :func:`griffin_matmul_shard`'s operands
    (A, ``b_comp``, ``kidx``, ``cnt``) over mesh axis ``axis``, one entry
    per tensor axis (None: whole): A whole, ``b_comp`` split on its padded
    N, ``kidx`` and ``cnt`` on their N tiles, the output on N — the
    reference's ``shard_specs`` as tuples."""
    return ((), (None, axis), (axis, None), (axis,)), (None, axis)


def griffin_matmul_shard(a: torch.Tensor, gw: GriffinShard, *,
                         dual: bool = False) -> torch.Tensor:
    """The shard entry: (M, tiles x block_n) = A @ this rank's N tiles, in
    the shard's own (balanced) column order with its padding; the caller
    gathers every rank's columns, then applies ``gather_inv`` and drops the
    padding (the reference's ``_shard_map_run``).  On a CUDA ``a`` the
    kernel launches with the whole weight's plan and route
    (``kernel.full_plan``), so no output's summation order depends on the
    mesh; on a CPU ``a`` the plain version runs."""
    if not isinstance(gw, GriffinShard):
        raise TypeError("griffin_matmul_shard takes a GriffinShard")
    local = dataclasses.replace(gw, n=gw.b_comp.shape[-1])
    _check(a, local)
    if a.device.type == "cpu":
        return griffin_spmm_ref(a, local)
    if a.device.type != "cuda":
        raise ValueError(f"griffin_matmul_shard runs on cuda or cpu, not "
                         f"{a.device}")
    return kernel.griffin_spmm(a, gw.b_comp, gw.kidx, gw.cnt, None,
                               n=local.n, block_k=gw.block_k,
                               block_n=gw.block_n, dual=dual,
                               full=(gw.n, gw.n_tiles))


def griffin_matmul(a: torch.Tensor, gw: GriffinWeights, *,
                   dual: bool = False) -> torch.Tensor:
    """C = A @ W_pruned (M, gw.n) from the compacted representation, in
    ``a.dtype`` (a bf16 weight takes an fp32 ``a`` too).  ``dual`` also
    skips all-zero A blocks (Mode.AB); it never changes the result.  A
    CUDA ``a`` launches the kernel, which stores the balance shuffle's
    columns back in place and drops the padding (no gather follows); a CPU
    ``a`` runs the plain version."""
    if isinstance(gw, GriffinShard):
        raise TypeError("a GriffinShard runs through griffin_matmul_shard")
    _check(a, gw)
    if a.device.type == "cpu":
        return griffin_spmm_ref(a, gw)
    if a.device.type != "cuda":
        raise ValueError(f"griffin_matmul runs on cuda or cpu, not {a.device}")
    return kernel.griffin_spmm(a, gw.b_comp, gw.kidx, gw.cnt, gw.perm,
                               n=gw.n, block_k=gw.block_k,
                               block_n=gw.block_n, dual=dual)


def auto_matmul(a: torch.Tensor, w: torch.Tensor,
                gw: Optional[GriffinWeights] = None, *,
                a_sparsity: float = 0.0, b_sparsity: float = 0.0
                ) -> torch.Tensor:
    """Hybrid morphing at the op level: pick the Mode from the declared
    sparsities (``select_mode``) and run its kernel — DENSE -> dense_gemm,
    A -> sparse_a (runtime-compacted A, dense ``w``), B -> griffin_spmm,
    AB -> griffin_spmm dual.  A sparse B with no compacted ``gw`` has
    nothing to walk and takes the dense or Sparse.A route."""
    mode = select_mode(a_sparsity, b_sparsity)
    if mode in (Mode.B, Mode.AB) and gw is not None:
        return griffin_matmul(a, gw, dual=mode == Mode.AB)
    if mode in (Mode.A, Mode.AB):
        return sparse_a_matmul(a, w)
    return dense_matmul(a, w)
