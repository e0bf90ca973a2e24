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

Training differentiates prefill attention through the reference's flash
backward (:class:`_FlashAttention`): only the output and each row's
log-sum-exp are kept, and the backward recomputes every chunk's
probabilities, so its memory too is linear in the sequence.  The backward
needs no batch invariance and multiplies with plain matmuls.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import tree_sum

NEG_INF = -1e30
# the most one (q tile x KV chunk) fp32 product may hold: 64 query rows
# against a 512-key chunk at llama3.2-1b's width (32 heads of 64)
TILE_BYTES = 256 << 20
# the most one (q tile x KV chunk) block of fp32 scores may hold in the
# backward (its probabilities, their gradient and the product beside it)
BWD_TILE_BYTES = 32 << 20


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


def _valid(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
           window: Optional[int], sk: int, ragged: bool) -> torch.Tensor:
    """Which keys (``kpos``, (1, n)) each query (``qpos``, (T, 1)) sees:
    causal or not, within ``window``, never a padded key past ``sk``
    (``ragged``: the key axis was padded and a query may sit past it)."""
    if causal:
        # keys past the last query are masked already when Sq <= Sk
        valid = qpos >= kpos
        if ragged:
            valid = valid & (kpos < sk)
    else:
        valid = kpos < sk
    if window is not None:
        valid = valid & (qpos - kpos < window)
    return valid


def _chunk_range(q0: int, q1: int, chunk: int, nchunks: int, causal: bool,
                 window: Optional[int]) -> Tuple[int, int]:
    """[first, last) of the KV chunks the queries q0..q1-1 can see: none
    past the tile's causal frontier, none wholly before its window."""
    last = min(nchunks, (q1 - 1) // chunk + 1) if causal else nchunks
    first = 0 if window is None else \
        min(last - 1, max(0, (q0 - window + 1) // chunk))
    return first, last


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: Optional[int], kv_chunk: int,
               want_lse: bool = False):
    """The online-softmax forward.  Returns the fp32 output (B, KVH, G, Sq,
    hd) and, with ``want_lse``, each row's log-sum-exp ``m + log(l)`` (B,
    KVH, G, Sq), which the backward recomputes the probabilities from."""
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
    outs, lses = [], []
    rows = q_tile(B, H, C, hd)
    for q0 in range(0, Sq, rows):
        q1 = min(Sq, q0 + rows)
        valid = _valid(pos[q0:q1, None], kpos, causal=causal, window=window,
                       sk=Sk, ragged=bool(pad) and Sq > Sk)
        first, last = _chunk_range(q0, q1, C, nchunks, causal, window)
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
        l = l.clamp(min=1e-30)
        outs.append(acc / l[..., None])
        if want_lse:
            lses.append(m + torch.log(l))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    if not want_lse:
        return out, None
    return out, lses[0] if len(lses) == 1 else torch.cat(lses, dim=3)


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, hd) -> the (B, KVH, G, S, hd) fp32 view of its heads
    grouped onto KV heads."""
    B, S, H, hd = x.shape
    return x.float().reshape(B, S, kvh, H // kvh, hd).permute(0, 2, 3, 1, 4)


class _FlashAttention(torch.autograd.Function):
    """:func:`_flash_fwd` with the reference's flash backward
    (``_flash_bwd`` under ``jax.custom_vjp``): the forward keeps only q,
    k, v, the fp32 output and the row log-sum-exp; the backward walks the
    same KV chunks, recomputes each chunk's probabilities ``exp(s - lse)``
    under the same masks and accumulates dq, dk and dv.  Nothing
    (Sq x Sk)-sized is stored: a (q tile x KV chunk) block of scores holds
    at most ``BWD_TILE_BYTES``.  Returns the fp32 (B, Sq, H, hd) output,
    which :func:`attention` casts."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_chunk):
        out, lse = _flash_fwd(q, k, v, causal, window, kv_chunk,
                              want_lse=True)
        B, Sq, H, hd = q.shape
        out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, kv_chunk = ctx.opts
        B, Sq, H, hd = q.shape
        Sk, KVH = k.shape[1], k.shape[2]
        G = H // KVH
        C = min(kv_chunk, Sk)
        nchunks = -(-Sk // C)
        pad = nchunks * C - Sk
        root = math.sqrt(hd)
        qg, do = _grouped(q, KVH), _grouped(dout, KVH)
        Dv = (do * _grouped(out, KVH)).sum(dim=-1)          # (B,KVH,G,Sq)
        kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))
        if pad:
            kf, vf = (F.pad(x, (0, 0, 0, pad)) for x in (kf, vf))
        dq = torch.zeros_like(qg)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        pos = torch.arange(max(Sq, nchunks * C), device=q.device)
        kpos = pos[None, :nchunks * C]
        rows = max(1, BWD_TILE_BYTES // (4 * B * H * C))
        for q0 in range(0, Sq, rows):
            q1 = min(Sq, q0 + rows)
            T = q1 - q0
            valid = _valid(pos[q0:q1, None], kpos, causal=causal,
                           window=window, sk=Sk,
                           ragged=bool(pad) and Sq > Sk)
            qt = qg[:, :, :, q0:q1].reshape(B, KVH, G * T, hd)
            dot = do[:, :, :, q0:q1].reshape(B, KVH, G * T, hd)
            lt = lse[:, :, :, q0:q1, None]
            dvt = Dv[:, :, :, q0:q1, None]
            first, last = _chunk_range(q0, q1, C, nchunks, causal, window)
            for c in range(first, last):
                ck = slice(c * C, (c + 1) * C)
                kc, vc = kf[:, :, ck], vf[:, :, ck]
                # p = exp(s - lse) where valid, 0 elsewhere, and ds = p (dp
                # - Dv), each made in place in one (q tile x chunk) block
                p = (qt @ kc.transpose(-1, -2)).reshape(B, KVH, G, T, C)
                p = p.div_(root).sub_(lt).exp_().masked_fill_(
                    ~valid[:, ck], 0.0)
                ds = (dot @ vc.transpose(-1, -2)).reshape(B, KVH, G, T, C)
                ds = ds.sub_(dvt).mul_(p).reshape(B, KVH, G * T, C)
                p = p.reshape(B, KVH, G * T, C)
                dv[:, :, ck] += p.transpose(-1, -2) @ dot
                dk[:, :, ck] += (ds.transpose(-1, -2) @ qt) / root
                dq[:, :, :, q0:q1] += (ds @ kc).reshape(B, KVH, G, T, hd) \
                    / root
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
        dk, dv = (x[:, :, :Sk].permute(0, 2, 1, 3).to(t.dtype)
                  for x, t in ((dk, k), (dv, v)))
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              kv_chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KVH, hd).  Returns (B, Sq, H, hd).

    Chunks start at absolute multiples of ``kv_chunk`` (at most Sk); a
    ragged tail is zero-padded and masked by position (``kpos < Sk``).
    Where a gradient is wanted (grad mode on, an input requiring grad) the
    same forward runs under :class:`_FlashAttention`, whose backward keeps
    the memory linear in the sequence; the output's bits are the same
    either way."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window,
                                     kv_chunk).to(q.dtype)
    B, Sq, H, hd = q.shape
    out, _ = _flash_fwd(q, k, v, causal, window, kv_chunk)
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
