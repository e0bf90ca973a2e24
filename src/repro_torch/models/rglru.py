"""RecurrentGemma [arXiv:2402.19427] — the counterpart of
``repro/models/rglru.py``: RG-LRU recurrent blocks and local attention
(MQA, window 2048) in a (rec, rec, attn) pattern, GeGLU MLPs.

Parameters keep the reference's layout: ``groups`` holds one nested dict
per block kind of a (rec, rec, attn) group (``rec1``, ``mlp1``, ``rec2``,
``mlp2``, ``attn``, ``mlp3``), every leaf stacked along the group axis,
and ``tail`` the trailing (rec, mlp) blocks the pattern leaves over
(none in the reduced config: its leaves have a zero-length lead).  Every
weight GEMM goes through ``common.griffin_linear``; the rec blocks'
``w_gate`` is a weight GEMM the pruning compacts, ``w_x``, ``w_rg``,
``w_ig`` and ``w_out`` stay dense and run through the dense kernels
inside a kernel scope.  ``lax.scan`` over groups becomes a Python loop.

The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t`` is evaluated on (a, b)
pairs, as the reference's associative scan, but in a shape the serving
engine needs: the sequence is cut into ``SCAN_CHUNK``-step chunks aligned
at position 0, each chunk is scanned by a Hillis-Steele doubling (step d
combines position t with t - d), and a carried state crosses the chunk
boundaries.  So the value at position t is built from positions <= t in
an order fixed by t alone: it does not depend on the sequence length, on
right padding or on the batch, and a right-padded bucket's state, read at
each row's last real token, equals the exact-length prefill's bit for bit
(the reference's tree shape depends on S).  Pad steps are (a, b) = (1, 0),
the exact identity, as in the reference.

Cache: ``{"rec_h" (G, 2, B, R) fp32, "rec_conv" (G, 2, B, cw-1, R),
"tail_h" (T, B, R) fp32, "tail_conv" (T, B, cw-1, R), "k"/"v" (G, B, clen,
KVH, hd), "pos"}`` with ``clen = min(cache_len, window)``: a rolling
window cache, position p at slot ``p % clen``.  While ``cache_len <=
window`` k/v track ``cache_len`` and the engine may page them
(``runtime/paging.py``: ``"pages"`` and ``k``/``v`` pools of (G,
num_pages, page_size, KVH, hd), int8 beside ``k_scale``/``v_scale``); the
recurrent leaves stay fixed either way.  ``decode_step`` writes the new
state and K/V rows into the cache tensors in place (the reference's
donated update) and returns the cache with the advanced position.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .attention import decode_attention, local_attention
from .common import (act_fn, dense_init, griffin_linear, length_mask,
                     paged_slot, paged_view, paged_write, remat_fn, rms_norm,
                     rope, shared_activation_meta, stack_layers, stack_slice,
                     take_last, unstack, write_kv_slot)

Params = Dict[str, Any]
LRU_C = 8.0
# steps of one chunk of the RG-LRU scan (a power of two): the doubling
# walks log2(SCAN_CHUNK) steps over every chunk at once, then the carried
# state crosses the chunks one after another
SCAN_CHUNK = 64


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# RG-LRU + conv
# ---------------------------------------------------------------------------

def init_rec_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt, dev = _dtype(cfg), gen.device
    D = cfg.d_model
    R = cfg.lru_width or D
    conv = torch.randn((cfg.conv_width, R), generator=gen,
                       dtype=torch.float32, device=dev) * 0.1
    return {
        "ln": torch.zeros((D,), dtype=dt, device=dev),
        "w_x": dense_init(gen, (D, R), D, dt),
        "w_gate": dense_init(gen, (D, R), D, dt),
        "conv": conv.to(dt),
        "w_rg": dense_init(gen, (R, R), R, dt),     # recurrence gate
        "w_ig": dense_init(gen, (R, R), R, dt),     # input gate
        "lam": torch.linspace(0.9, 5.0, R, dtype=torch.float32,
                              device=dev),         # softplus param
        "w_out": dense_init(gen, (R, D), R, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time.  x: (B, S, R), w: (cw, R); state:
    (B, cw-1, R), the previous inputs of a decode step.  The output sums
    the ``cw`` products left to right in ``x``'s dtype, as the reference
    does.

    ``lengths``: optional (B,) true lengths of a right-padded batch
    (bucketed prefill).  Real outputs never see the pads, but the carried
    state must be the last ``cw-1`` *real* inputs, at positions
    ``length-cw+1..length-1``: they are gathered per row."""
    cw = w.shape[0]
    B, S, _ = x.shape
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, :S] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i]
    if lengths is None:
        new_state = xp[:, xp.shape[1] - (cw - 1):]
    else:
        # xp index of input position p is p + cw - 1 (left pad): positions
        # length-cw+1..length-1 are xp indices length..length+cw-2
        idx = lengths.long()[:, None] + torch.arange(cw - 1,
                                                     device=x.device)
        new_state = xp[torch.arange(B, device=x.device)[:, None], idx]
    return out.to(x.dtype), new_state


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1 of (B, S, R).

    Chunks of ``SCAN_CHUNK`` steps aligned at position 0 (the last one
    padded with the identity (1, 0)) are scanned at once by doubling: at
    step d, t >= d takes (a_t a_{t-d}, a_t b_{t-d} + b_t).  Each position
    reads only positions at or before it, in an order fixed by its offset
    in its chunk; then each chunk's prefix pairs (A_t, B_t) meet the state
    carried out of the chunk before: h_t = A_t h_in + B_t."""
    B, S, R = a.shape
    C = min(SCAN_CHUNK, S)
    n = -(-S // C)
    pad = n * C - S
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    a = a.reshape(B, n, C, R)
    b = b.reshape(B, n, C, R)
    d = 1
    while d < C:
        a_hi, b_hi = a[:, :, d:], b[:, :, d:]
        b = torch.cat([b[:, :, :d], a_hi * b[:, :, :-d] + b_hi], dim=2)
        a = torch.cat([a[:, :, :d], a_hi * a[:, :, :-d]], dim=2)
        d *= 2
    if n > 1:
        chunks = [b[:, 0]]
        for c in range(1, n):
            chunks.append(a[:, c] * chunks[-1][:, -1:] + b[:, c])
        b = torch.stack(chunks, dim=1)
    return b.reshape(B, n * C, R)[:, :S]


def _rg_lru(x: torch.Tensor, p: Params, h0: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None):
    """x: (B, S, R) -> (B, S, R) in x's dtype, and the fp32 state after
    the last real step.  Diagonal gated linear recurrence:
      log a_t = -c * softplus(lam) * sigmoid(x W_rg)
      h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(x W_ig) * x_t)
    The gate GEMMs take fp32 A against the fp32 weights, as in the
    reference.  ``h0`` is folded into step 0.

    ``mask``: optional (B, S) validity mask of a right-padded batch
    (bucketed prefill): pad steps run with (a, b) = (1, 0), and the state
    returned is each row's at its last real step."""
    xf = x.float()
    w_rg, w_ig = p["w_rg"].float(), p["w_ig"].float()
    meta = shared_activation_meta(xf, w_rg, w_ig)
    r = torch.sigmoid(griffin_linear(xf, w_rg, meta=meta))
    i = torch.sigmoid(griffin_linear(xf, w_ig, meta=meta))
    log_a = -LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xf)
    if mask is not None:
        m3 = mask[:, :, None]
        a = torch.where(m3, a, 1.0)
        b = torch.where(m3, b, 0.0)
    if h0 is not None:
        # fold the carried state into the first step
        b[:, 0] += a[:, 0] * h0
    h = _linear_scan(a, b)
    h_last = h[:, -1] if mask is None else take_last(h, mask.sum(dim=1))
    return h.to(x.dtype), h_last


def rec_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, state=None,
            mask: Optional[torch.Tensor] = None,
            lengths: Optional[torch.Tensor] = None):
    """Recurrent mixing block.  state: (h0 (B, R) fp32, conv (B, cw-1,
    R)).  ``mask``/``lengths`` describe right padding (bucketed
    prefill).  Returns (out, (h_last, conv state))."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    meta = shared_activation_meta(h, p["w_x"], p["w_gate"])
    xr = griffin_linear(h, p["w_x"], meta=meta)
    gate = F.gelu(griffin_linear(h, p["w_gate"], meta=meta).float(),
                  approximate="tanh").to(x.dtype)
    h0, conv_state = (None, None) if state is None else state
    xr, new_conv = _causal_conv(xr, p["conv"], conv_state, lengths=lengths)
    hr, h_last = _rg_lru(xr, p, h0, mask=mask)
    out = griffin_linear(hr * gate, p["w_out"])
    return (x + out).to(x.dtype), (h_last, new_conv)


# ---------------------------------------------------------------------------
# attention + MLP blocks
# ---------------------------------------------------------------------------

def init_attn_block(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = _dtype(cfg)
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    return {
        "ln": torch.zeros((D,), dtype=dt, device=gen.device),
        "wq": dense_init(gen, (D, H * hd), D, dt),
        "wk": dense_init(gen, (D, KVH * hd), D, dt),
        "wv": dense_init(gen, (D, KVH * hd), D, dt),
        "wo": dense_init(gen, (H * hd, D), H * hd, dt),
    }


def init_mlp(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = _dtype(cfg)
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "ln": torch.zeros((D,), dtype=dt, device=gen.device),
        "w_gate": dense_init(gen, (D, F_), D, dt),
        "w_up": dense_init(gen, (D, F_), D, dt),
        "w_down": dense_init(gen, (F_, D), F_, dt),
    }


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    meta = shared_activation_meta(h, p["w_gate"], p["w_up"])
    f = act_fn(cfg.act)(griffin_linear(h, p["w_gate"], meta=meta)) * \
        griffin_linear(h, p["w_up"], meta=meta)
    return (x + griffin_linear(f, p["w_down"])).to(x.dtype)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
         positions: torch.Tensor):
    """(normed x, q, k, v) of an attention block, q and k rotated."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    meta = shared_activation_meta(h, p["wq"], p["wk"], p["wv"])
    q = rope(griffin_linear(h, p["wq"], meta=meta).reshape(B, S, H, hd),
             positions, cfg.rope_theta)
    k = rope(griffin_linear(h, p["wk"], meta=meta).reshape(B, S, KVH, hd),
             positions, cfg.rope_theta)
    v = griffin_linear(h, p["wv"], meta=meta).reshape(B, S, KVH, hd)
    return q, k, v


def _attn_out(p: Params, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return (x + griffin_linear(o.reshape(B, S, -1), p["wo"])).to(x.dtype)


def attn_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor):
    """Local-attention block over a sequence; returns (out, (k, v))."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = local_attention(q, k, v, window=cfg.window,
                        kv_chunk=min(cfg.kv_chunk, cfg.window))
    return _attn_out(p, x, o), (k, v)


def _decode_positions(pos: torch.Tensor) -> torch.Tensor:
    return pos[:, None] if pos.dim() else pos[None]


def attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor):
    """One-token local attention against a rolling window cache (B, clen,
    KVH, hd), written in place at slot ``pos % clen`` and attended up to
    ``min(pos, clen - 1)``.  ``pos`` is a scalar or a (B,) vector of
    per-row positions (the engine's slot pools)."""
    q, k, v = _qkv(cfg, p, x, _decode_positions(pos))
    clen = kc.shape[1]
    slot = pos % clen
    write_kv_slot(kc, k, slot)
    write_kv_slot(vc, v, slot)
    o = decode_attention(q, kc, vc, pos.clamp(max=clen - 1), window=None)
    return _attn_out(p, x, o), kc, vc


def attn_decode_paged(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      kc: torch.Tensor, vc: torch.Tensor,
                      kscale: Optional[torch.Tensor],
                      vscale: Optional[torch.Tensor], pages: torch.Tensor,
                      pos: torch.Tensor, slot=None):
    """Paged twin of :func:`attn_decode` (runtime/paging.py).  Paging is
    on only while ``window >= cache_len`` (the discovery rule), where the
    rolling slot and eff-pos algebra of the fixed cache reduces for live
    rows to write-at-``pos`` / attend-to-``pos``: bit-identical on the
    gathered view.  ``kscale``/``vscale`` are None for same-dtype pools;
    ``slot`` is ``common.paged_slot``'s pair, computed here if not
    given."""
    q, k, v = _qkv(cfg, p, x, _decode_positions(pos))
    if slot is None:
        slot = paged_slot(pages, pos, kc.shape[1])
    paged_write(kc, kscale, slot, k)
    paged_write(vc, vscale, slot, v)
    o = decode_attention(q, paged_view(kc, kscale, pages, x.dtype),
                         paged_view(vc, vscale, pages, x.dtype), pos,
                         window=None)
    return _attn_out(p, x, o), kc, vc, kscale, vscale


# ---------------------------------------------------------------------------
# model assembly: (rec, rec, attn) groups + a rec tail
# ---------------------------------------------------------------------------

def _group_counts(cfg: ModelConfig) -> Tuple[int, int]:
    plen = len(cfg.block_pattern)          # 3
    groups = cfg.num_layers // plen        # 12
    tail = cfg.num_layers - groups * plen  # 2 (rec, rec)
    return groups, tail


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``: normal / sqrt(fan_in)
    GEMMs, unit-normal embeddings, zero norm scales, 0.1-normal conv taps,
    the reference's ``lam`` ramp and an untied head (the reference's
    scheme; the draws themselves differ from ``jax.random``'s)."""
    if cfg.family != "hybrid":
        raise ValueError(f"rglru builds the hybrid family, not "
                         f"{cfg.family!r}")
    dt = _dtype(cfg)
    groups, tail = _group_counts(cfg)
    D, V = cfg.d_model, cfg.vocab_size

    def init_group(g):
        return {"rec1": init_rec_block(cfg, g), "mlp1": init_mlp(cfg, g),
                "rec2": init_rec_block(cfg, g), "mlp2": init_mlp(cfg, g),
                "attn": init_attn_block(cfg, g), "mlp3": init_mlp(cfg, g)}

    def init_tail(g):
        return {"rec": init_rec_block(cfg, g), "mlp": init_mlp(cfg, g)}

    return {
        "embed": dense_init(gen, (V, D), V, dt, scale=1.0),
        "final_norm": torch.zeros((D,), dtype=dt, device=gen.device),
        "groups": stack_layers(init_group, gen, groups),
        "tail": stack_layers(init_tail, gen, tail),
        "head": dense_init(gen, (D, V), D, dt),
    }


def _block(stack: Params, i: int) -> Params:
    """Layer ``i`` of a stack of block dicts (a group or a tail layer)."""
    return {name: stack_slice(sub, i) for name, sub in stack.items()}


def init_cache(cfg: ModelConfig, batch: int, length: int,
               device: torch.device) -> Params:
    """Zeroed cache: O(1) recurrent and conv state per rec block and a
    rolling K/V window of ``min(length, window)`` per attention block."""
    groups, tail = _group_counts(cfg)
    R = cfg.lru_width or cfg.d_model
    cw = cfg.conv_width
    clen = min(length, cfg.window)
    dt = _dtype(cfg)
    kv = (groups, batch, clen, cfg.num_kv_heads, cfg.hd)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "rec_h": zeros((groups, 2, batch, R), torch.float32),
        "rec_conv": zeros((groups, 2, batch, cw - 1, R), dt),
        "tail_h": zeros((tail, batch, R), torch.float32),
        "tail_conv": zeros((tail, batch, cw - 1, R), dt),
        "k": zeros(kv, dt), "v": zeros(kv, dt),
        "pos": zeros((), torch.int32),
    }


def _store(cache: Params, h_key: str, conv_key: str, idx: tuple,
           state) -> None:
    """Write a rec block's (h, conv) state into the cache in place."""
    cache[h_key][idx].copy_(state[0])
    cache[conv_key][idx].copy_(state[1])


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    """Every block over ``tokens`` from the zero state, the states and K/V
    thrown away: (final-normed hidden, aux 0), the loss side of the
    reference's ``forward_hidden``.  Each (rec, rec, attn) group runs
    under ``common.remat_fn``, as the reference checkpoints each group;
    the tail does not."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def group(gp, x):
        x, _ = rec_mix(cfg, gp["rec1"], x)
        x = mlp(cfg, gp["mlp1"], x)
        x, _ = rec_mix(cfg, gp["rec2"], x)
        x = mlp(cfg, gp["mlp2"], x)
        x, _ = attn_mix(cfg, gp["attn"], x, positions)
        return mlp(cfg, gp["mlp3"], x)

    group = remat_fn(cfg, group)
    for gp in unstack(params["groups"]):
        x = group(gp, x)
    for tp in unstack(params["tail"]):
        x, _ = rec_mix(cfg, tp["rec"], x)
        x = mlp(cfg, tp["mlp"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[Params, torch.Tensor]:
    """Process a prompt; returns (cache, last-token logits).

    ``lengths``: optional (B,) true prompt lengths of a right-padded batch
    (bucketed prefill).  Local attention is causal (real positions never
    see pads); the recurrent and conv states are each row's at its last
    real token; pad K/V rows sit in slots ``length..S-1``, which the decode
    loop overwrites at slot ``pos % clen`` before its position mask admits
    them (so a bucket must fit the window cache).  The last ``clen`` K/V
    rows are kept and, when the prompt fills the window, rolled by ``S %
    clen`` so position p sits at slot ``p % clen``."""
    B, S = tokens.shape
    clen = min(cache_len or S, cfg.window)
    if lengths is not None and S > clen:
        raise ValueError("bucketed prefill must fit the window cache")
    groups, tail = _group_counts(cfg)
    positions = torch.arange(S, device=tokens.device)
    mask = None if lengths is None else length_mask(lengths, S)
    cache = init_cache(cfg, B, clen, device=tokens.device)
    keep = min(S, clen)
    x = params["embed"][tokens]
    for g in range(groups):
        gp = _block(params["groups"], g)
        for j, name in enumerate(("rec1", "rec2")):
            x, st = rec_mix(cfg, gp[name], x, mask=mask, lengths=lengths)
            _store(cache, "rec_h", "rec_conv", (g, j), st)
            x = mlp(cfg, gp[f"mlp{j + 1}"], x)
        x, (k, v) = attn_mix(cfg, gp["attn"], x, positions)
        x = mlp(cfg, gp["mlp3"], x)
        cache["k"][g, :, :keep] = k[:, S - keep:]
        cache["v"][g, :, :keep] = v[:, S - keep:]
    for t in range(tail):
        tp = _block(params["tail"], t)
        x, st = rec_mix(cfg, tp["rec"], x, mask=mask, lengths=lengths)
        _store(cache, "tail_h", "tail_conv", (t,), st)
        x = mlp(cfg, tp["mlp"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is None:
        last = x[:, -1]
        pos = torch.full((), S - 1, dtype=torch.int32, device=tokens.device)
    else:
        last = take_last(x, lengths)
        pos = (lengths - 1).to(torch.int32)          # per-row (B,) vector
    logits = griffin_linear(last, params["head"])
    if S >= clen and S % clen:
        cache["k"] = torch.roll(cache["k"], S % clen, dims=2)
        cache["v"] = torch.roll(cache["v"], S % clen, dims=2)
    cache["pos"] = pos
    return cache, logits


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One decode step for the whole batch.  token: (B, 1).  The state and
    K/V tensors are updated in place; the returned cache shares them.  A
    ``"pages"`` key marks a paged K/V cache (the recurrent leaves are
    untouched by paging)."""
    x = params["embed"][token]
    pos = cache["pos"] + 1
    groups, tail = _group_counts(cfg)
    paged = "pages" in cache
    if paged:
        pages = cache["pages"].long()
        slot = paged_slot(pages, pos, cache["k"].shape[2])
        ks, vs = cache.get("k_scale"), cache.get("v_scale")
    for g in range(groups):
        gp = _block(params["groups"], g)
        for j, name in enumerate(("rec1", "rec2")):
            x, st = rec_mix(cfg, gp[name], x, state=(
                cache["rec_h"][g, j], cache["rec_conv"][g, j]))
            _store(cache, "rec_h", "rec_conv", (g, j), st)
            x = mlp(cfg, gp[f"mlp{j + 1}"], x)
        if paged:
            x = attn_decode_paged(
                cfg, gp["attn"], x, cache["k"][g], cache["v"][g],
                None if ks is None else ks[g], None if vs is None else vs[g],
                pages, pos, slot)[0]
        else:
            x = attn_decode(cfg, gp["attn"], x, cache["k"][g],
                            cache["v"][g], pos)[0]
        x = mlp(cfg, gp["mlp3"], x)
    for t in range(tail):
        tp = _block(params["tail"], t)
        x, st = rec_mix(cfg, tp["rec"], x, state=(cache["tail_h"][t],
                                                   cache["tail_conv"][t]))
        _store(cache, "tail_h", "tail_conv", (t,), st)
        x = mlp(cfg, tp["mlp"], x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = griffin_linear(x[:, 0], params["head"])
    return logits, dict(cache, pos=pos)
