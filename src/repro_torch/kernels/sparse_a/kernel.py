"""Launch of the hand-written Sparse.A GEMM (``csrc/sparse_a.cu``), the
card's replacement for ``repro/kernels/sparse_a/kernel.py``'s
``sparse_a_gemm_kernel``."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..dense_gemm.kernel import DTYPE_CODES

NAME = "sparse_a"
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])


def _fn():
    fn = build.library(NAME).sparse_a_gemm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def sparse_a_gemm(a: torch.Tensor, b: torch.Tensor, kidx: torch.Tensor,
                  cnt: torch.Tensor, *, block_m: int, block_k: int
                  ) -> torch.Tensor:
    """(M, N) = A @ B over the K blocks ``kidx[i, :cnt[i]]`` of each M tile
    i, on the current stream, in ``a.dtype``.  ``b`` may have any strides
    (``embed.T`` is read in place).  The caller (``ops.sparse_a_matmul``)
    has validated every operand."""
    m, k = a.shape
    n = b.shape[1]
    m_tiles, max_cnt = kidx.shape
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn()(DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
                kidx.data_ptr(), cnt.data_ptr(), out.data_ptr(), m, n, k,
                block_m, block_k, m_tiles, max_cnt, a.stride(0), b.stride(0),
                b.stride(1), out.stride(0), stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
