"""Public ops of Sparse.A (activation-sparse) execution (K3): the runtime
compaction of the activations and the GEMM wrapper.

The counterpart of ``repro/kernels/sparse_a/ops.py``.  Nothing about the
activations is known before they exist, so ``compact_activations`` lists,
per call, the K blocks each M tile must visit.  It takes the form of the
reference's traced (under ``jit``) branch: full K depth, built on the
activations' own device (one kernel launch on the card), with no value
read back to the host — the decode path calls it once per GEMM and must
never synchronise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import kernel
from ..dense_gemm.kernel import DTYPE_CODES
from ..dense_gemm.ops import DenseShard, check_dtypes
from .ref import compact_activations_ref, sparse_a_ref

DEFAULT_BLOCK_M = 128
DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 128


@dataclasses.dataclass
class ActivationMeta:
    """Per-M-tile live-K-block metadata for one activation matrix.

    * ``kidx`` (m_tiles, max_cnt) int32: per M tile, its live K-block ids
      in ascending order, then the dead ones (valid ids, never visited);
    * ``cnt`` (m_tiles,) int32: live blocks per M tile.
    """

    kidx: torch.Tensor
    cnt: torch.Tensor
    m: int                   # padded M
    k: int                   # padded K
    block_m: int
    block_k: int

    @property
    def density(self) -> float:
        """Fraction of live (block_m x block_k) A blocks.  Reads ``cnt``
        back to the host: never called on the serving path."""
        mt, kt = self.m // self.block_m, self.k // self.block_k
        return float(self.cnt.sum().item()) / max(mt * kt, 1)

    @property
    def compaction(self) -> float:
        """Grid depth against dense: max_cnt / k_tiles (1.0 here, where the
        depth is always the full K)."""
        return self.kidx.shape[1] / (self.k // self.block_k)


def _rup(x: int, base: int = 8) -> int:
    return max(base, -(-x // base) * base)


def _blocks(m: int, k: int, block_m: int, block_k: int):
    """(bm, bk, padded M, padded K) with the reference's clamping: a block
    is never wider than its dimension rounded up to 8."""
    bm = min(block_m, _rup(m))
    bk = min(block_k, _rup(k))
    return bm, bk, -(-m // bm) * bm, -(-k // bk) * bk


def compact_activations(a: torch.Tensor, *, block_m: int = DEFAULT_BLOCK_M,
                        block_k: int = DEFAULT_BLOCK_K) -> ActivationMeta:
    """List the K blocks each M tile must visit, with no host sync: on the
    card one launch of the metadata kernel, on the CPU its plain version.
    ``kidx`` is the stable argsort of the dead-block mask, so each tile's
    live blocks come first in ascending order and the dead entries after
    them are valid ids — the reference's traced metadata, bit for bit."""
    m, k = a.shape
    bm, bk, pm, pk = _blocks(m, k, block_m, block_k)
    if a.device.type == "cpu":
        kidx, cnt = compact_activations_ref(a, block_m=bm, block_k=bk)
    else:
        if a.dtype not in DTYPE_CODES or min(m, k) < 1 or a.stride(1) != 1:
            raise ValueError(f"compact_activations on {a.device}: A "
                             f"{tuple(a.shape)} {a.dtype} must be float32 or "
                             "bfloat16, non-empty, with unit column stride")
        kidx, cnt = kernel.sparse_a_meta(a, block_m=bm, block_k=bk,
                                         m_tiles=pm // bm, k_tiles=pk // bk)
    return ActivationMeta(kidx=kidx, cnt=cnt, m=pm, k=pk, block_m=bm,
                          block_k=bk)


def _check_meta(a: torch.Tensor, w: torch.Tensor,
                meta: ActivationMeta) -> None:
    m, k = a.shape
    bm, bk = meta.block_m, meta.block_k
    mt = -(-m // max(bm, 1))
    if bm < 1 or bk < 1 or (meta.m, meta.k) != (mt * bm, -(-k // bk) * bk):
        raise ValueError(f"activation metadata (m {meta.m}, k {meta.k}, "
                         f"blocks {bm}x{bk}) does not describe A "
                         f"{tuple(a.shape)}")
    if meta.kidx.dtype != torch.int32 or meta.cnt.dtype != torch.int32 or \
            meta.kidx.dim() != 2 or meta.kidx.shape[0] != mt or \
            meta.kidx.shape[1] < 1 or meta.cnt.shape != (mt,):
        raise ValueError("sparse_a_matmul metadata: kidx (m_tiles, max_cnt) "
                         "and cnt (m_tiles,), both int32")
    for t in (w, meta.kidx, meta.cnt):
        if t.device != a.device:
            raise ValueError(f"sparse_a_matmul operands on {t.device} and "
                             f"{a.device}")
    if not (a.is_contiguous() and meta.kidx.is_contiguous()
            and meta.cnt.is_contiguous()):
        raise ValueError("sparse_a_matmul needs a contiguous A and metadata")


def sparse_a_matmul(a: torch.Tensor, w: torch.Tensor, *,
                    block_m: int = DEFAULT_BLOCK_M,
                    block_k: int = DEFAULT_BLOCK_K,
                    block_n: int = DEFAULT_BLOCK_N,
                    meta: Optional[ActivationMeta] = None) -> torch.Tensor:
    """C = A @ W visiting only the live A blocks (Sparse.A), fp32
    accumulator, C in ``a.dtype``.

    ``a``: contiguous (M, K); ``w``: (K, N) of the same dtype (or bf16
    against an fp32 ``a``) and device, any strides — the tied unembedding
    passes the view ``embed.T``, which is read in place: nothing is padded
    or copied, the kernel masks ragged edges.  ``meta`` defaults to
    ``compact_activations(a)``.  ``block_n`` is the reference's N tile; the
    card's kernel picks its own column slices, so it only has to be
    positive.  A CUDA ``a`` launches the
    kernel; a CPU ``a`` runs the plain version.
    """
    _check(a, w, block_m, block_k, block_n)
    if meta is None:
        meta = compact_activations(a, block_m=block_m, block_k=block_k)
    _check_meta(a, w, meta)
    return _run(a, w, meta)


def _check(a: torch.Tensor, w: torch.Tensor, block_m: int, block_k: int,
           block_n: int = DEFAULT_BLOCK_N) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"sparse_a_matmul shapes {tuple(a.shape)} x "
                         f"{tuple(w.shape)}")
    check_dtypes("sparse_a_matmul", a, w)
    if min(a.shape[0], a.shape[1], w.shape[1]) < 1 or \
            max(a.shape[0], a.shape[1], w.shape[1]) >= 2 ** 31 or \
            min(block_m, block_k, block_n) < 1:
        raise ValueError(f"sparse_a_matmul dims out of range: "
                         f"{tuple(a.shape)} x {tuple(w.shape)}, blocks "
                         f"{block_m}/{block_k}/{block_n}")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sparse_a_matmul runs on cuda or cpu, not "
                         f"{a.device}")


def _run(a: torch.Tensor, w: torch.Tensor, meta: ActivationMeta,
         full_n: Optional[int] = None) -> torch.Tensor:
    if a.device.type == "cpu":
        return sparse_a_ref(a, w, meta.kidx, meta.cnt, block_m=meta.block_m,
                            block_k=meta.block_k)
    return kernel.sparse_a_gemm(a, w, meta.kidx, meta.cnt,
                                block_m=meta.block_m, block_k=meta.block_k,
                                full_n=full_n)


def shardable(w, n_shards: int) -> bool:
    """True when the dense weight's output axis splits evenly (the
    reference's predicate)."""
    return w.dim() == 2 and n_shards >= 1 and w.shape[1] % n_shards == 0


def shard_specs(axis: str = "model"):
    """(in specs, out spec) of :func:`sparse_a_matmul_shard`'s operands
    (A, W, kidx, cnt): only the weight and the output split, on N; A and
    its per-M-tile metadata stay whole (the reference's ``shard_specs``
    as tuples)."""
    return ((), (None, axis), (), ()), (None, axis)


def sparse_a_matmul_shard(a: torch.Tensor, w: DenseShard, *,
                          block_m: int = DEFAULT_BLOCK_M,
                          block_k: int = DEFAULT_BLOCK_K,
                          meta: Optional[ActivationMeta] = None
                          ) -> torch.Tensor:
    """The shard entry: (M, N / shards) = A @ this rank's columns of the
    dense weight, visiting only A's live blocks.  A and its metadata are
    the whole A on every rank (the metadata is per M tile, which an N split
    never touches, so every rank skips the same blocks).  On a CUDA ``a``
    the kernel takes the whole (K, N) weight's route and split
    (``kernel.route`` with ``full_n``), so no output's summation order
    depends on the mesh; on a CPU ``a`` the plain version runs."""
    b = w.local
    if b.dim() != 2 or w.n != b.shape[1] * w.shards:
        raise ValueError(f"sparse_a_matmul_shard takes one matrix's shard, "
                         f"got {tuple(b.shape)} of N {w.n} / {w.shards}")
    _check(a, b, block_m, block_k)
    if meta is None:
        meta = compact_activations(a, block_m=block_m, block_k=block_k)
    _check_meta(a, b, meta)
    return _run(a, b, meta, w.n)
