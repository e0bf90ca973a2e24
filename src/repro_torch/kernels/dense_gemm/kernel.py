"""Launch of the hand-written dense GEMM (``csrc/dense_gemm.cu``), the
card's replacement for ``repro/kernels/dense_gemm/kernel.py``'s
``dense_matmul_kernel``."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import build

NAME = "dense_gemm"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (A, weight) dtype pairs of the C interfaces of K1, K2 and K3 and their
# codes: equal dtypes, or fp32 activations against a bf16 weight (the mLSTM
# block's w_down input, fp32 as in the reference), whose output is fp32
PAIR_CODES = {(torch.float32, torch.float32): 0,
              (torch.bfloat16, torch.bfloat16): 1,
              (torch.float32, torch.bfloat16): 2}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p]
SKINNY_MAX_N = 8      # outputs at most this wide take the skinny route
SKINNY_THREADS = 128  # threads of a skinny block: one 8-row chunk each a step
SKINNY_CHUNK = 8      # K rows of a chunk
MAX_SLICES = 8        # the portable cluster size


def skinny_slices(k: int) -> int:
    """The skinny route's split S of K: the least power of two up to
    MAX_SLICES that leaves a slice no more 8-row chunks than a block has
    threads.  A function of K alone, so an output's summation order is
    one too."""
    chunks = -(-k // SKINNY_CHUNK)
    slices = 1
    while slices < MAX_SLICES and -(-chunks // slices) > SKINNY_THREADS:
        slices *= 2
    return slices


def slice_chunks(k: int, slices: int) -> Tuple[range, ...]:
    """The 8-row chunks of K each slice owns, as the kernel computes them:
    slice r takes the consecutive chunks [r C / S, (r + 1) C / S)."""
    chunks = -(-k // SKINNY_CHUNK)
    return tuple(range(r * chunks // slices, (r + 1) * chunks // slices)
                 for r in range(slices))


def route(n: int) -> str:
    """Which body runs a product with ``n`` output columns: ``skinny`` (K
    split across a cluster, N <= SKINNY_MAX_N) or ``wide`` (a warp per 4
    columns).  Never a function of M or of the data."""
    return "skinny" if n <= SKINNY_MAX_N else "wide"


def _fn():
    fn = build.library(NAME).dense_gemm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def dense_gemm(a: torch.Tensor, b: torch.Tensor, *,
               full_n: Optional[int] = None) -> torch.Tensor:
    """C = A @ B on the current stream, C in ``a.dtype``.  ``a`` is a
    contiguous CUDA (M, K) matrix; ``b`` a (K, N) matrix of a dtype in
    ``PAIR_CODES`` with ``a``'s, any strides (``embed.T`` is read in
    place).  ``full_n``: the output width of the whole weight when ``b`` is
    one shard of its columns, whose route the launch then takes (default
    N).  The caller (``ops.dense_matmul``) has validated both."""
    m, k = a.shape
    n = b.shape[1]
    slices = skinny_slices(k) if route(full_n or n) == "skinny" else 0
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn()(PAIR_CODES[(a.dtype, b.dtype)], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
                b.stride(1), out.stride(0), slices, stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
