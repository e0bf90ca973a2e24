"""Launch of the hand-written Sparse.A GEMM and its activation metadata
(``csrc/sparse_a.cu``), the card's replacement for
``repro/kernels/sparse_a/kernel.py``'s ``sparse_a_gemm_kernel`` and for the
traced metadata of ``repro/kernels/sparse_a/ops.py``."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import build
from ..dense_gemm.kernel import DTYPE_CODES, PAIR_CODES
from ..griffin_spmm.kernel import MIN_BLOCKS, least_split

NAME = "sparse_a"
META = "sparse_a_meta"
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
_META_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
MAX_RANK_BLOCKS = 4096    # K blocks one rank may own (its lists fit)
META_THREADS = 1024       # threads of a metadata block (kMetaThreads)
META_UNIT = 16            # bytes a metadata thread loads at once
# the metadata cluster's largest split: 16, a non-portable cluster (the
# portable limit is 8); on the card 16 beat 8 at 32 x 4096 and 128 x 8192
MAX_META_SLICES = 16
# a tile's slab below this many bytes is one block: on the card a cluster
# adds ~1.1 us of barriers and launch, more than spreading these loads saves
META_MIN_SPLIT_BYTES = 128 << 10

# routes of the C interface
CORE, ROWS, KMAJOR = 0, 1, 2
ROUTE_NAMES = {CORE: "cuda-core", ROWS: "tensor-core rows",
               KMAJOR: "tensor-core k-major"}


class SplitPlan(NamedTuple):
    """The tensor-core route's work split: each ``cols``-wide slice of the
    output is a cluster of ``splits`` blocks, rank r owning the absolute K
    blocks ``ranges(K, block_k)[r]``, streamed in chunks of ``chunk`` rows
    of K."""
    splits: int
    cols: int
    chunk: int

    def ranges(self, k: int, block_k: int) -> Tuple[range, ...]:
        """The K blocks each rank owns, as the kernel computes them."""
        kb = -(-k // block_k)
        return tuple(range(r * kb // self.splits,
                           (r + 1) * kb // self.splits)
                     for r in range(self.splits))


@functools.lru_cache(maxsize=None)
def split_plan(k: int, n: int, block_k: int, kmajor: bool = False
               ) -> Optional[SplitPlan]:
    """The split for a (K, N) weight read in K blocks of ``block_k``, or
    None where the tensor-core route does not apply (bk not a multiple of
    16).  A function of the weight's shape and layout alone, never of M or
    of the data: every output's summation order follows from it, so a
    row's bits never depend on the rows beside it.  The widest slice (128
    columns for k-major B, else 64; then 32) where a power-of-two split up
    to 8, no finer than one K block per rank, gives MIN_BLOCKS blocks; else
    16 columns.  Chunks of 64 rows of K (or the largest of 32 and 16 that
    divides bk)."""
    if block_k % 16:
        return None
    chunk = next(c for c in (64, 32, 16) if block_k % c == 0)
    kb = -(-k // block_k)
    for cols in ((128,) if kmajor else ()) + (64, 32):
        slices = -(-n // cols)
        splits = least_split(slices, kb)
        if slices * splits >= MIN_BLOCKS:
            return SplitPlan(splits, cols, chunk)
    return SplitPlan(least_split(-(-n // 16), kb), 16, chunk)


def meta_slices(rows: int, k: int, block_k: int, itemsize: int,
                cap: int = MAX_META_SLICES) -> int:
    """The metadata kernel's split S of one M tile across a thread block
    cluster: 1 (a plain launch) for a ``rows`` x ``k`` slab under
    ``META_MIN_SPLIT_BYTES``; else the largest power of two up to ``cap``
    that leaves each block at least one 16-byte unit of the slab a thread
    and each rank at least one whole K block.  A function of the shapes
    alone; the flags it yields are a pure function of A whatever S is."""
    if rows * k * itemsize < META_MIN_SPLIT_BYTES:
        return 1
    units = rows * -(-k * itemsize // META_UNIT)
    kt = -(-k // block_k)
    slices = 1
    while slices * 2 <= min(cap, kt) and \
            units // (slices * 2) >= META_THREADS:
        slices *= 2
    return slices


def meta_ranges(kt: int, slices: int) -> Tuple[range, ...]:
    """The K blocks each rank of a metadata cluster owns, as the kernel
    computes them: rank r takes the whole blocks [r kt / S, (r + 1) kt /
    S)."""
    return tuple(range(r * kt // slices, (r + 1) * kt // slices)
                 for r in range(slices))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def route(a: torch.Tensor, b: torch.Tensor, block_k: int,
          full_n: Optional[int] = None) -> Tuple[int, Optional[SplitPlan]]:
    """Which body runs ``A @ B``, and its plan: the tensor-core rows route
    for bf16 with row-major B, the tensor-core k-major route for bf16 with
    k-contiguous B (``embed.T``), the CUDA-core route for fp32 A (against
    an fp32 or a bf16 B) and for what
    the tensor cores cannot take (bk not a multiple of 16; K, a row stride
    or a pointer not 16-byte aligned).  Depends on the dtype, the shapes,
    strides and alignment, never on M or the data.  ``full_n``: the whole
    weight's N when ``b`` is a shard of its columns; the route and plan
    are then the whole weight's (a shard that cannot take them is refused
    by the launch)."""
    k, n = b.shape
    n = full_n or n
    if a.dtype != torch.bfloat16 or k % 8 or a.stride(0) % 8 or \
            not (_aligned(a) and _aligned(b)):
        return CORE, None
    if b.stride(1) == 1 and n % 8 == 0 and b.stride(0) % 8 == 0:
        path = ROWS
    elif b.stride(0) == 1 and b.stride(1) % 8 == 0:
        path = KMAJOR
    else:
        return CORE, None
    plan = split_plan(k, n, block_k, path == KMAJOR)
    if plan is None or -(-k // block_k) > MAX_RANK_BLOCKS * plan.splits:
        return CORE, None
    return path, plan


def _fn(symbol: str, argtypes):
    fn = getattr(build.library(NAME), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def sparse_a_gemm(a: torch.Tensor, b: torch.Tensor, kidx: torch.Tensor,
                  cnt: torch.Tensor, *, block_m: int, block_k: int,
                  full_n: Optional[int] = None) -> torch.Tensor:
    """(M, N) = A @ B over the K blocks ``kidx[i, :cnt[i]]`` of each M tile
    i, on the current stream, in ``a.dtype`` (``b`` bf16 against an fp32
    ``a``, or ``a``'s dtype).  ``b`` may have any strides
    (``embed.T`` is read in place).  ``full_n``: as in :func:`route`.  The
    caller (``ops.sparse_a_matmul`` or ``ops.sparse_a_matmul_shard``) has
    validated every operand."""
    m, k = a.shape
    n = b.shape[1]
    m_tiles, max_cnt = kidx.shape
    path, plan = route(a, b, block_k, full_n)
    splits, cols, chunk = plan or (0, 0, 0)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn("sparse_a_gemm", _ARGTYPES)(
        PAIR_CODES[(a.dtype, b.dtype)], a.data_ptr(), b.data_ptr(),
        kidx.data_ptr(), cnt.data_ptr(), out.data_ptr(), m, n, k, block_m,
        block_k, m_tiles, max_cnt, a.stride(0), b.stride(0), b.stride(1),
        out.stride(0), path, splits, cols, chunk, stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out


def sparse_a_meta(a: torch.Tensor, *, block_m: int, block_k: int,
                  m_tiles: int, k_tiles: int, slices: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kidx (m_tiles, k_tiles), cnt (m_tiles,)) int32 of ``a`` in one
    launch on the current stream, no host sync; each M tile a cluster of
    ``slices`` blocks (default ``meta_slices``).  The caller
    (``ops.compact_activations``) has validated ``a``."""
    m, k = a.shape
    if slices is None:
        slices = meta_slices(min(m, block_m), k, block_k, a.element_size())
    kidx = torch.empty((m_tiles, k_tiles), dtype=torch.int32,
                       device=a.device)
    cnt = torch.empty((m_tiles,), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn("sparse_a_meta", _META_ARGTYPES)(
        DTYPE_CODES[a.dtype], a.data_ptr(), kidx.data_ptr(), cnt.data_ptr(),
        m, k, block_m, block_k, m_tiles, k_tiles, a.stride(0), slices,
        stream)
    build.check_launch(META, err)
    build.count_launch(META)
    return kidx, cnt
