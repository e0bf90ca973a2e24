"""GQA attention for the dense decoder — the counterpart of
``repro/models/attention.py``'s ``attention`` (causal prefill) and
``decode_attention``.

Plain torch in fp32 (no Pallas kernel stands behind these in the
reference).  Scores and weighted sums are broadcast products reduced with
``common.tree_sum``, so a row's result does not depend on how many rows are
decoded together; the sizes are small (head_dim 64, a cache of tens to
hundreds of positions).  Queries are grouped onto KV heads by reshape; KV is
never repeated in memory.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .common import tree_sum

NEG_INF = -1e30


def _attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """qg (B, Sq, KVH, G, hd); k, v (B, Sk, KVH, hd); valid broadcastable to
    (B, KVH, G, Sq, Sk).  Returns (B, KVH, G, Sq, hd) in fp32."""
    hd = qg.shape[-1]
    q = qg.float().permute(0, 2, 3, 1, 4)[:, :, :, :, None, :]
    kk = k.float().permute(0, 2, 1, 3)[:, :, None, None, :, :]
    logits = tree_sum(q * kk) / math.sqrt(hd)
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / tree_sum(p)[..., None]
    vv = v.float().permute(0, 2, 1, 3)[:, :, None, None, :, :]
    return tree_sum(p[..., None] * vv, dim=-2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd).  Returns (B, S, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (qpos >= kpos)
    if window is not None:
        valid = valid & (qpos - kpos < window)
    out = _attend(q.reshape(B, Sq, KVH, H // KVH, hd), k, v, valid)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-step attention against a (B, S, KVH, hd) cache.  ``pos`` is
    the current position, a scalar or a (B,) vector of per-row positions.
    q: (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    idx = torch.arange(S, device=q.device)[None, :]
    p = pos.reshape(-1, 1)
    valid = idx <= p
    if window is not None:
        valid = valid & (idx > p - window)
    valid = valid[:, None, None, None, :]             # (B|1, 1, 1, 1, S)
    out = _attend(q.reshape(B, 1, KVH, H // KVH, hd), k_cache, v_cache,
                  valid)
    return out.reshape(B, 1, H, hd).to(q.dtype)
