"""Plain PyTorch version of the Sparse.A GEMM: what the wrapper runs on CPU
tensors, and what the kernel is held against on the card.

It computes what the kernel computes *from the metadata*: only the A blocks
listed live for their M tile, ``kidx[i, :cnt[i]]``, take part in the
product.  With metadata from ``compact_activations`` every nonzero A block
is listed, so this is the dense product; with metadata that leaves a live
block out, that block's products are missing here as in the kernel.
"""
from __future__ import annotations

import torch


def sparse_a_ref(a: torch.Tensor, b: torch.Tensor, kidx: torch.Tensor,
                 cnt: torch.Tensor, *, block_m: int, block_k: int
                 ) -> torch.Tensor:
    """(A masked to its listed blocks) @ B in fp32, cast to ``a.dtype``."""
    m, k = a.shape
    mt, max_cnt = kidx.shape
    kt = -(-k // block_k)
    live = torch.arange(max_cnt, device=a.device)[None, :] < cnt[:, None]
    listed = torch.zeros((mt, kt), dtype=torch.int32, device=a.device)
    # scatter_add: dead entries may repeat a live id, and must not unlist it
    listed.scatter_add_(1, kidx.long(), live.to(torch.int32))
    mask = (listed > 0).repeat_interleave(block_m, 0)[:m] \
        .repeat_interleave(block_k, 1)[:, :k]
    masked = torch.where(mask, a.float(), torch.zeros((), device=a.device))
    return (masked @ b.float()).to(a.dtype)
