"""Launch of the hand-written dense GEMM (``csrc/dense_gemm.cu``), the
card's replacement for ``repro/kernels/dense_gemm/kernel.py``'s
``dense_matmul_kernel``."""
from __future__ import annotations

import ctypes

import torch

from .. import build

NAME = "dense_gemm"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p]


def _fn():
    fn = build.library(NAME).dense_gemm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def dense_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the current stream, C in ``a.dtype``.  ``a`` is a
    contiguous CUDA (M, K) matrix; ``b`` a (K, N) matrix of the same dtype
    with any strides (``embed.T`` is read in place).  The caller
    (``ops.dense_matmul``) has validated both."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn()(DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, a.stride(0), b.stride(0),
                b.stride(1), out.stride(0), stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
