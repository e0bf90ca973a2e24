"""Launch of the hand-written Griffin block-sparse GEMM
(``csrc/griffin_spmm.cu``), the card's replacement for
``repro/kernels/griffin_spmm/kernel.py``'s ``griffin_spmm_kernel``."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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
# the tensor-core route's shared-memory layout (csrc/griffin_spmm.cu
# TcLayout, chunk_cap, tc_smem; gemm_tile.cuh kTcWarps, kMaxSmem): what
# route() mirrors, so a change there changes these too
TC_WARPS = 4
TC_PASS_TILES = 2   # tc_smem sizes the 32-row pass: two m16 tiles
MAX_SMEM = 232_448  # a block's shared memory on sm_90


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


class Route(NamedTuple):
    """Which of K2's routes a launch takes (``"tc"``: the bf16 tensor-core
    route, ``spmm_tc_kernel``; ``"core"``: the CUDA-core route,
    ``spmm_core_kernel``) and the shared memory in bytes that the
    tensor-core route's block would need for it (0 where no plan
    applies)."""
    name: str
    smem: int


def chunk_cap(k: int, max_cnt: int, block_k: int, plan: SplitPlan) -> int:
    """Most compacted chunks one rank stages (``chunk_cap`` in
    ``csrc/griffin_spmm.cu``): its ceil(G / S) of the G SPLIT_ROWS-row
    groups of K in chunks, no more than the tile holds."""
    groups = -(-k // SPLIT_ROWS)
    span = -(-groups // plan.splits) * (SPLIT_ROWS // plan.chunk_rows)
    return min(span, max_cnt * (block_k // plan.chunk_rows))


def tc_smem(k: int, max_cnt: int, block_k: int, plan: SplitPlan) -> int:
    """Bytes of shared memory a tensor-core block takes at its largest
    pass (``tc_smem`` and ``TcLayout`` in ``csrc/griffin_spmm.cu``, which
    name this function): the B ring (3 stages of chunk x cols bf16) and
    the staged A (``chunk_cap`` chunks of 32 x chunk bf16), or the warps'
    and the block's fp32 partial tiles where larger, then the int lists
    (the slice's columns, the tile's kidx row, three lists of ``cap``)
    and two counts.  A function of the weight's (K, N), its grid depth
    ``max_cnt`` and the compaction, never of M."""
    cw, kc, mp = plan.cols, plan.chunk_rows, 16 * TC_PASS_TILES
    cap = chunk_cap(k, max_cnt, block_k, plan)
    staged = 3 * kc * cw * 2 + cap * mp * kc * 2
    body = TC_WARPS * mp * (cw + 8) * 4 + mp * cw * 4
    return max(staged, body) + cw * 4 + max_cnt * 4 + 3 * cap * 4 + 2 * 4


def route(a: torch.Tensor, b_comp: torch.Tensor, kidx: torch.Tensor, *,
          n: int, block_k: int, block_n: int) -> Route:
    """The route the launch of :func:`griffin_spmm` on these operands
    takes, as ``griffin_spmm`` in ``csrc/griffin_spmm.cu`` chooses it
    (the C++ decides; this mirror only says it, and the two change
    together): the tensor-core route for bf16 A and weight with a plan,
    16-byte aligned A and ``b_comp``, A's row stride and K multiples of
    8, and :func:`tc_smem` within ``MAX_SMEM``; else the CUDA-core
    route."""
    k = a.shape[1]
    n_tiles, max_cnt = kidx.shape[-2:]
    plan = split_plan(k, n, n_tiles, block_k, block_n) \
        if a.dtype == b_comp.dtype == torch.bfloat16 else None
    if plan is None:
        return Route("core", 0)
    smem = tc_smem(k, max_cnt, block_k, plan)
    tc = _tc_aligned(a, b_comp) and smem <= MAX_SMEM
    return Route("tc" if tc else "core", smem)


def _tc_aligned(a: torch.Tensor, b_comp: torch.Tensor) -> bool:
    """The tensor-core route's alignment terms in ``csrc/griffin_spmm.cu``:
    16-byte aligned A and ``b_comp``, A's row stride and K multiples of
    8."""
    return a.data_ptr() % 16 == 0 and b_comp.data_ptr() % 16 == 0 and \
        a.stride(0) % 8 == 0 and a.shape[1] % 8 == 0


def route_launches() -> dict:
    """Launches of each route (``"tc"``, ``"core"``) the loaded library
    has made so far, counted in ``csrc/griffin_spmm.cu`` where it chooses
    the route: what :func:`route` is held against on the card."""
    fn = build.library(NAME).griffin_spmm_route_launches
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_longlong * 2)()
    fn(out)
    return {"tc": out[0], "core": out[1]}


def _fn():
    fn = build.library(NAME).griffin_spmm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def full_plan(k: int, max_cnt: int, full_n: int, full_tiles: int,
              block_k: int, block_n: int, dtype: torch.dtype
              ) -> Optional[SplitPlan]:
    """The plan a launch of the whole (k, ``full_n``) weight in
    ``full_tiles`` N tiles takes, or None where it takes the CUDA-core
    route: fp32 A, no plan, or a tensor-core block that would not fit
    (:func:`tc_smem`, which no shard of the weight changes; the launch
    also checks the alignment terms, :func:`_tc_aligned`).  A shard of
    the weight's N tiles launches with this plan, so each output's
    summation order is the whole weight's on every mesh."""
    if dtype != torch.bfloat16:
        return None
    plan = split_plan(k, full_n, full_tiles, block_k, block_n)
    if plan is None or tc_smem(k, max_cnt, block_k, plan) > MAX_SMEM:
        return None
    return plan


def griffin_spmm(a: torch.Tensor, b_comp: torch.Tensor, kidx: torch.Tensor,
                 cnt: torch.Tensor, perm: Optional[torch.Tensor], *, n: int,
                 block_k: int, block_n: int, dual: bool,
                 full: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(M, n) = A @ W_pruned from the compacted operands, on the current
    stream, in ``a.dtype`` (``b_comp`` bf16 against an fp32 ``a``, or
    ``a``'s dtype): the kernel stores each column where ``perm``
    (the balance shuffle, or None) sends it and drops the padding.  ``a``
    (M, K) may be narrower than the padded K the metadata counts; the
    kernel masks the missing columns.  ``full``: (N, N tiles) of the whole
    weight when these operands are a shard of its N tiles; the launch then
    takes the whole weight's plan and route (:func:`full_plan`).  The
    caller (``ops.griffin_matmul`` or ``ops.griffin_matmul_shard``) has
    validated every operand."""
    m, k = a.shape
    n_tiles, max_cnt = kidx.shape
    npad = b_comp.shape[1]
    # the tensor-core route takes bf16 A and weight; fp32 A (against either
    # weight dtype) runs on the CUDA cores
    if full is not None:
        plan = full_plan(k, max_cnt, full[0], full[1], block_k, block_n,
                         a.dtype) if _tc_aligned(a, b_comp) else None
    else:
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
