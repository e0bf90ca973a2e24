"""Losses — the counterpart of ``repro/models/losses.py``.  Cross entropy
is computed in sequence chunks so the full (B, S, vocab) logits tensor is
never materialised: only one (B, chunk, vocab) block lives at a time,
forward and backward (each chunk's logits are recomputed in the backward
pass, the reference's ``jax.checkpoint`` of its scan body)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import griffin_linear


def _chunk_nll(h: torch.Tensor, unembed, labels: torch.Tensor
               ) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk's unmasked labels."""
    logits = griffin_linear(h, unembed).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return ((lse - gold) * (labels >= 0)).sum()


def chunked_cross_entropy(hidden: torch.Tensor, unembed,
                          labels: torch.Tensor, chunk: int = 512
                          ) -> torch.Tensor:
    """Mean cross entropy over the unmasked labels.  hidden: (B, S, D);
    unembed: (D, V) tensor (the tied ``embed.T`` view too) or
    ``GriffinWeights``; labels: (B, S) with -1 = masked.  S is cut into
    chunks of ``min(chunk, S)``; a ragged S is padded with masked
    positions."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    labels = labels.long()
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    grad = torch.is_grad_enabled()
    total = torch.zeros((), device=hidden.device)
    for i in range(nc):
        cs = slice(i * c, (i + 1) * c)
        h, lab = hidden[:, cs], labels[:, cs]
        total = total + (checkpoint(_chunk_nll, h, unembed, lab,
                                    use_reentrant=False)
                         if grad else _chunk_nll(h, unembed, lab))
    return total / (labels >= 0).sum().clamp(min=1)
