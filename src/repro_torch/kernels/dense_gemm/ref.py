"""Plain PyTorch version of the dense GEMM kernel: what the wrapper runs on
CPU tensors, and what the kernel is held against on the card."""
import torch


def dense_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)
