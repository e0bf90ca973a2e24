"""Public wrapper of the dense GEMM kernel (K1): checks, then the kernel on
CUDA tensors or its plain version on CPU tensors."""
from __future__ import annotations

import torch

from . import kernel
from .ref import dense_matmul_ref


def check_dtypes(op: str, a: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless (A, weight) is a dtype pair the kernels take: both
    float32, both bfloat16, or float32 A with a bfloat16 weight."""
    if (a.dtype, w.dtype) not in kernel.PAIR_CODES:
        raise TypeError(f"{op} dtypes {a.dtype} x {w.dtype}: both float32, "
                        "both bfloat16, or float32 x bfloat16")


def dense_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with an fp32 accumulator, C in ``a.dtype``.

    ``a``: contiguous (M, K); ``b``: (K, N) of the same dtype, or bf16
    against an fp32 ``a``, on the same device, any strides (the tied
    unembedding passes the view ``embed.T``).  Unlike the TPU wrapper
    nothing is padded: the kernel masks ragged edges.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dense_matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    check_dtypes("dense_matmul", a, b)
    if a.device != b.device:
        raise ValueError(f"dense_matmul devices {a.device} x {b.device}")
    if not a.is_contiguous():
        raise ValueError("dense_matmul needs a contiguous A")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1 or \
            max(a.shape[0], a.shape[1], b.shape[1]) >= 2 ** 31:
        raise ValueError(f"dense_matmul dims out of range: {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return dense_matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"dense_matmul runs on cuda or cpu, not {a.device}")
    return kernel.dense_gemm(a, b)
