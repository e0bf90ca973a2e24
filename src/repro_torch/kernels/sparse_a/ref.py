"""Plain PyTorch version of the Sparse.A GEMM: what the wrapper runs on CPU
tensors, and what the kernel is held against on the card.

It computes what the kernel computes *from the metadata*: only the A blocks
listed live for their M tile, ``kidx[i, :cnt[i]]``, take part in the
product.  With metadata from ``compact_activations`` every nonzero A block
is listed, so this is the dense product; with metadata that leaves a live
block out, that block's products are missing here as in the kernel.

``compact_activations_ref`` is the plain version of the metadata kernel:
the reference's traced (jit) metadata in torch ops, bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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


def compact_activations_ref(a: torch.Tensor, *, block_m: int, block_k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kidx, cnt) int32 of ``a`` (M, K) in (block_m x block_k) blocks, M
    and K zero-padded to whole blocks: ``cnt[i]`` live blocks of M tile i,
    ``kidx[i]`` the stable argsort of its dead-block mask (the live ids
    ascending, then the dead ones)."""
    m, k = a.shape
    pm, pk = -(-m // block_m) * block_m, -(-k // block_k) * block_k
    nz = a != 0
    if (pm, pk) != (m, k):
        nz = F.pad(nz, (0, pk - k, 0, pm - m))
    nz = nz.reshape(pm // block_m, block_m, pk // block_k,
                    block_k).any(dim=(1, 3))
    cnt = nz.sum(dim=1, dtype=torch.int32)
    kidx = torch.argsort(~nz, dim=1, stable=True).to(torch.int32)
    return kidx, cnt
