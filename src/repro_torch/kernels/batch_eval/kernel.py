"""Launch of the hand-written schedule kernel (``csrc/batch_eval.cu``), the
card's replacement for ``repro/kernels/batch_eval/ops.py``'s
``_schedule_cycles``."""
from __future__ import annotations

import ctypes

import torch

from .. import build

NAME = "batch_eval"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.library(NAME)
    if lib.batch_eval.argtypes is None:
        lib.batch_eval.argtypes = _ARGTYPES
        lib.batch_eval.restype = ctypes.c_int
        lib.batch_eval_smem_bytes.argtypes = [ctypes.c_int]
        lib.batch_eval_smem_bytes.restype = ctypes.c_int
    return lib


def batch_eval(mask: torch.Tensor, d1: int, d2: int, d3: int
               ) -> torch.Tensor:
    """Executed cycles per tile on the current stream.  ``mask`` is a
    contiguous CUDA (tiles, T, K0, G) bool tensor, lanes already shuffled,
    tiles and T nonzero, K0 * G <= 64; the caller (``ops.schedule_cycles``)
    has validated it.  Returns (tiles,) int64 on the card."""
    tiles, T, K0, G = mask.shape
    lib = _lib()
    out = torch.empty(tiles, dtype=torch.int64, device=mask.device)
    # a tile's words live in shared memory unless T is too long for it
    scratch = None if lib.batch_eval_smem_bytes(T) else torch.empty(
        tiles * T, dtype=torch.int64, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = lib.batch_eval(mask.data_ptr(), out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         tiles, T, K0, G, d1, d2, d3, stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
