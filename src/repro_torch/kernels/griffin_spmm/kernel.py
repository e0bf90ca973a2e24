"""Launch of the hand-written Griffin block-sparse GEMM
(``csrc/griffin_spmm.cu``), the card's replacement for
``repro/kernels/griffin_spmm/kernel.py``'s ``griffin_spmm_kernel``."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import build
from ..dense_gemm.kernel import PAIR_CODES

NAME = "griffin_spmm"
_ARGTYPES = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + \
    [ctypes.c_int] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p]
MAX_SPLITS = 8      # the portable cluster size
MIN_BLOCKS = 256    # about two blocks per SM of an H100 SXM (132 SMs)
SPLIT_ROWS = 64     # rank r owns the groups of 64 K rows = r mod splits


class SplitPlan(NamedTuple):
    """The bf16 route's work split: each ``cols``-wide slice of an N tile
    is a cluster of ``splits`` blocks (a power of two), rank r walking the
    tile's compacted chunks of ``chunk_rows`` rows whose SPLIT_ROWS-row
    group of absolute K is r mod ``splits``."""
    splits: int
    cols: int
    chunk_rows: int


def least_split(blocks: int, chunks: int) -> int:
    """The least power-of-two split up to MAX_SPLITS that gives MIN_BLOCKS
    blocks, no finer than one chunk per rank."""
    splits = 1
    while splits < MAX_SPLITS and blocks * splits < MIN_BLOCKS and \
            2 * splits <= chunks:
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def split_plan(k: int, n: int, n_tiles: int, block_k: int,
               block_n: int) -> Optional[SplitPlan]:
    """The split for a (k, n) weight compacted into ``n_tiles`` N tiles of
    (block_k x block_n) blocks, or None where the tensor-core route does
    not apply (bk or bn not a multiple of 16).

    The cluster split S is a function of (k, n) alone: the least that
    gives MIN_BLOCKS blocks over 64-column slices, no finer than one
    SPLIT_ROWS group of K per rank.  With the kernel's rank shares fixed
    by absolute K and its warp per 16-row step, every output's summation
    order follows from (k, n) alone, so its bits depend neither on the
    rows beside it nor on the compaction granularity.  The slice width
    and chunk depth only lay out the work: slices of 64 columns, or 32,
    where the split fills the card with MIN_BLOCKS blocks, else 16; chunks
    of 64 rows, or the largest of 32 and 16 that divides bk."""
    if block_k % 16 or block_n % 16:
        return None
    splits = least_split(-(-n // 64), -(-k // SPLIT_ROWS))
    chunk = next(c for c in (64, 32, 16) if block_k % c == 0)
    for cols in (64, 32):
        if block_n % cols == 0 and \
                n_tiles * (block_n // cols) * splits >= MIN_BLOCKS:
            return SplitPlan(splits, cols, chunk)
    return SplitPlan(splits, 16, chunk)


def _fn():
    fn = build.library(NAME).griffin_spmm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def griffin_spmm(a: torch.Tensor, b_comp: torch.Tensor, kidx: torch.Tensor,
                 cnt: torch.Tensor, perm: Optional[torch.Tensor], *, n: int,
                 block_k: int, block_n: int, dual: bool) -> torch.Tensor:
    """(M, n) = A @ W_pruned from the compacted operands, on the current
    stream, in ``a.dtype`` (``b_comp`` bf16 against an fp32 ``a``, or
    ``a``'s dtype): the kernel stores each column where ``perm``
    (the balance shuffle, or None) sends it and drops the padding.  ``a``
    (M, K) may be narrower than the padded K the metadata counts; the
    kernel masks the missing columns.  The caller (``ops.griffin_matmul``)
    has validated every operand."""
    m, k = a.shape
    n_tiles, max_cnt = kidx.shape
    npad = b_comp.shape[1]
    # the tensor-core route takes bf16 A and weight; fp32 A (against either
    # weight dtype) runs on the CUDA cores
    plan = split_plan(k, n, n_tiles, block_k, block_n) \
        if a.dtype == torch.bfloat16 else None
    splits, cols, chunk = plan or (0, 0, 0)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn()(PAIR_CODES[(a.dtype, b_comp.dtype)], int(dual),
                a.data_ptr(), b_comp.data_ptr(), kidx.data_ptr(),
                cnt.data_ptr(),
                None if perm is None else perm.data_ptr(), out.data_ptr(),
                m, k, n, npad, n_tiles, block_k, block_n, max_cnt,
                a.stride(0), splits, cols, chunk, stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
