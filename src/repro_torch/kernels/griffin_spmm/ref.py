"""Plain PyTorch version of the Griffin block-sparse GEMM: what the wrapper
runs on CPU tensors, and what the kernel is held against on the card.  The
compacted product must equal the dense product with the block-pruned
weights; dual mode never changes it (skipped A blocks are exact zeros)."""
from __future__ import annotations

import torch


def griffin_spmm_ref(a: torch.Tensor, gw) -> torch.Tensor:
    from .ops import decompact_weights
    w = decompact_weights(gw)
    return (a.float() @ w[:a.shape[1]].float()).to(a.dtype)
