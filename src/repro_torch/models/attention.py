"""GQA attention for the dense decoder and the hybrid family's local
attention — the counterpart of ``repro/models/attention.py``'s
``attention`` (causal prefill), ``local_attention`` (banded causal
prefill) and ``decode_attention``.

Plain torch in fp32 (no Pallas kernel stands behind these in the
reference).  Scores and weighted sums are broadcast products reduced with
``common.tree_sum``, so a row's result does not depend on how many rows are
computed together.  Queries are grouped onto KV heads by reshape; KV is
never repeated in memory.

Prefill never forms the (Sq x Sk) score matrix.  As in the reference's
``_flash_fwd_scan``, the KV axis is walked in ``kv_chunk`` chunks with an
online softmax (running max ``m``, normaliser ``l``, accumulator ``acc``).
The query axis is tiled too, because the broadcast product keeps the
head_dim axis: one (q tile x KV chunk) product holds at most
``TILE_BYTES``, so the transient memory grows linearly in the prompt
length.  Tile and chunk boundaries depend only on the shapes and
``kv_chunk``, never on the data.  A chunk a row cannot see leaves that
row's ``m``, ``l`` and ``acc`` exactly unchanged (its probabilities are
zeroed after the ``exp``), so chunks past a tile's causal frontier or
before its window are skipped without changing a bit.  Decode attends one
query against the whole cache as one chunk, as the reference does in one
shot.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .common import tree_sum

NEG_INF = -1e30
# the most one (q tile x KV chunk) fp32 product may hold: 64 query rows
# against a 512-key chunk at llama3.2-1b's width (32 heads of 64)
TILE_BYTES = 256 << 20


def _chunk_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor):
    """One (q tile, KV chunk) block of the online softmax.  q (B, KVH, G,
    T, hd), k and v (B, KVH, C, hd), all fp32; valid broadcastable to (B,
    KVH, G, T, C).  Returns the unnormalised output (B, KVH, G, T, hd), the
    chunk's row max and its row sum of probabilities (B, KVH, G, T)."""
    hd = q.shape[-1]
    logits = tree_sum(q[..., :, None, :] * k[:, :, None, None]) / \
        math.sqrt(hd)
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    o = tree_sum(p[..., None] * v[:, :, None, None], dim=-2)
    return o, m, tree_sum(p)


def q_tile(batch: int, heads: int, chunk: int, hd: int) -> int:
    """Query rows per tile: the most whose (rows x chunk x hd) fp32 product
    over every head fits ``TILE_BYTES``, at least one."""
    return max(1, TILE_BYTES // (4 * batch * heads * chunk * hd))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              kv_chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KVH, hd).  Returns (B, Sq, H, hd).

    Chunks start at absolute multiples of ``kv_chunk`` (at most Sk); a
    ragged tail is zero-padded and masked by position (``kpos < Sk``)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    C = min(kv_chunk, Sk)
    nchunks = -(-Sk // C)
    pad = nchunks * C - Sk
    qg = q.float().reshape(B, Sq, KVH, G, hd).permute(0, 2, 3, 1, 4)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    if pad:
        kf, vf = (F.pad(x, (0, 0, 0, pad)) for x in (kf, vf))
    pos = torch.arange(max(Sq, nchunks * C), device=q.device)
    kpos = pos[None, :nchunks * C]
    outs = []
    rows = q_tile(B, H, C, hd)
    for q0 in range(0, Sq, rows):
        q1 = min(Sq, q0 + rows)
        qpos = pos[q0:q1, None]
        if causal:
            # keys past the last query are masked already when Sq <= Sk
            valid = qpos >= kpos
            if pad and Sq > Sk:
                valid = valid & (kpos < Sk)
        else:
            valid = kpos < Sk
        if window is not None:
            valid = valid & (qpos - kpos < window)
        last = min(nchunks, (q1 - 1) // C + 1) if causal else nchunks
        first = 0 if window is None else \
            min(last - 1, max(0, (q0 - window + 1) // C))
        for c in range(first, last):
            ck = slice(c * C, (c + 1) * C)
            o, mc, lc = _chunk_attn(qg[:, :, :, q0:q1], kf[:, :, ck],
                                    vf[:, :, ck], valid[:, ck])
            if c == first:
                # the update below from m = NEG_INF, l = acc = 0 gives
                # exactly these values
                m, l, acc = mc, lc, o
                continue
            m_new = torch.maximum(m, mc)
            a_prev = torch.exp(m - m_new)
            a_cur = torch.exp(mc - m_new)
            l = l * a_prev + lc * a_cur
            acc = acc * a_prev[..., None] + o * a_cur[..., None]
            m = m_new
        outs.append(acc / l.clamp(min=1e-30)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, kv_chunk: int = 256) -> torch.Tensor:
    """Banded causal attention: each query attends to itself and the
    ``window - 1`` keys before it (recurrentgemma's local-attention
    layers).  The reference tiles the sequence into window-sized blocks
    that attend to their own and the previous block; this is the same
    function as :func:`attention` with ``causal=True`` and ``window``,
    which skips every KV chunk wholly before a query tile's window, so
    its work and its transient memory stay linear in the sequence
    length.  ``kv_chunk``: the KV chunk of the online softmax."""
    return attention(q, k, v, causal=True, window=window,
                     kv_chunk=kv_chunk)


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
    qg = q.float().reshape(B, KVH, H // KVH, 1, hd)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k_cache, v_cache))
    o, _, l = _chunk_attn(qg, kf, vf, valid[:, None, None, None, :])
    return (o / l[..., None]).reshape(B, 1, H, hd).to(q.dtype)
