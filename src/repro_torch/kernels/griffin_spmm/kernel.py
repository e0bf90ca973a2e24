"""Launch of the hand-written Griffin block-sparse GEMM
(``csrc/griffin_spmm.cu``), the card's replacement for
``repro/kernels/griffin_spmm/kernel.py``'s ``griffin_spmm_kernel``."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..dense_gemm.kernel import DTYPE_CODES

NAME = "griffin_spmm"
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def _fn():
    fn = build.library(NAME).griffin_spmm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def griffin_spmm(a: torch.Tensor, b_comp: torch.Tensor, kidx: torch.Tensor,
                 cnt: torch.Tensor, *, block_k: int, block_n: int,
                 dual: bool) -> torch.Tensor:
    """(M, N_padded) = A @ W_pruned from the compacted operands, on the
    current stream, in ``a.dtype``.  ``a`` (M, K) may be narrower than the
    padded K the metadata counts; the kernel masks the missing columns.
    The caller (``ops.griffin_matmul``) has validated every operand."""
    m, k = a.shape
    n_tiles, max_cnt = kidx.shape
    npad = b_comp.shape[1]
    out = torch.empty((m, npad), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _fn()(DTYPE_CODES[a.dtype], int(dual), a.data_ptr(),
                b_comp.data_ptr(), kidx.data_ptr(), cnt.data_ptr(),
                out.data_ptr(), m, k, npad, n_tiles, block_k, block_n,
                max_cnt, a.stride(0), stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
