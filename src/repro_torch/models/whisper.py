"""Whisper-large-v3 backbone (the audio family) — the counterpart of
``repro/models/whisper.py``: a 32-layer encoder over precomputed frame
embeddings and a 32-layer causal decoder with cross-attention, d=1280, 20
heads, GeLU (tanh) MLPs, an untied head.

The conv audio frontend is a stub, as in the reference: a request carries
its (F, d) post-conv frame embeddings under ``extras["frames"]``.  The
encoder adds fixed sinusoids and runs bidirectional attention; the
decoder's self-attention uses rope, as the reference does.  Every weight
GEMM goes through ``common.griffin_linear``; the attention products do
not (they are not weight GEMMs).

Dtypes follow the reference exactly.  Frames come in fp32 and the residual
keeps x's dtype, so at bf16 weights the whole encoder, and the
cross-attention's ``wk``/``wv`` on its output, multiply fp32 A against the
bf16 weights, and ``prefill`` returns the cross K/V (``xk``/``xv``) in
fp32.  ``init_cache`` declares them in the model dtype: the engine's
admission casts them into its arena, while ``greedy_generate`` decodes
from the prefill's own fp32 cache.

Parameters: ``embed`` (V, D), ``enc_layers`` and ``dec_layers`` holding
every per-layer leaf stacked along a leading layer axis (``attn``,
``self``, ``cross`` subtrees of wq/wk/wv/wo and an ``mlp`` subtree of
w_up/w_down beside the norm scales), ``enc_norm``, ``final_norm`` and
``head`` (D, V).  The layer stacks are Python loops.

Caches: ``{"k", "v": (L, B, S, H, hd), "xk", "xv": (L, B, F, H, hd),
"pos"}``; on a paged arena (``runtime/paging.py``) k/v become pools read
through ``"pages"`` (int8 beside ``"k_scale"``/``"v_scale"``) and the
cross K/V stay fixed, written once at admission.  ``decode_step`` writes
the new self-attention K/V rows in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import attention, decode_attention
from .common import (Draw, act_fn, gather_heads, griffin_linear,
                     head_share, init_from_draws, paged_slot, paged_view,
                     paged_write, remat_fn, rms_norm, rope,
                     shared_activation_meta, take_heads, take_last, unstack,
                     write_kv_slot)

Params = Dict[str, Any]

_ATTN = ("wq", "wk", "wv", "wo")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@functools.lru_cache(maxsize=8)
def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) fixed positions, sines then cosines, computed in numpy
    in float64 and rounded to fp32, as the reference does.  Kept per
    device, so only the first encode copies it from the host."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def param_draws(cfg: ModelConfig):
    """The audio family's draw order (``common.Draw``): the embedding,
    the encoder's leaves (ln1, attn wq/wk/wv/wo, ln2, mlp w_up/w_down),
    the decoder's (ln1, self, ln_x, cross, ln2, mlp), the two final norm
    scales, then the head; each stacked leaf drawn one layer at a time."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    HD = cfg.num_heads * cfg.hd

    def attn(path, lead):
        return [Draw(path + (w,), lead, (HD, D) if w == "wo" else (D, HD))
                for w in _ATTN]

    def norm(path, lead):
        return Draw(path, lead, (D,), zeros=True)

    def mlp(path, lead):
        return [Draw(path + ("w_up",), lead, (D, F)),
                Draw(path + ("w_down",), lead, (F, D))]

    enc, dec = ("enc_layers",), ("dec_layers",)
    le, ld = (cfg.encoder_layers,), (cfg.num_layers,)
    return ([Draw(("embed",), (), (V, D), scale=1.0),
             norm(enc + ("ln1",), le)] + attn(enc + ("attn",), le)
            + [norm(enc + ("ln2",), le)] + mlp(enc + ("mlp",), le)
            + [norm(dec + ("ln1",), ld)] + attn(dec + ("self",), ld)
            + [norm(dec + ("ln_x",), ld)] + attn(dec + ("cross",), ld)
            + [norm(dec + ("ln2",), ld)] + mlp(dec + ("mlp",), ld)
            + [norm(("enc_norm",), ()), norm(("final_norm",), ()),
               Draw(("head",), (), (D, V))])


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device`` in
    :func:`param_draws`' order: normal / sqrt(fan_in) GEMMs, unit-normal
    embeddings, zero norm scales (the reference's scheme; the draws
    themselves differ from ``jax.random``'s)."""
    return init_from_draws(param_draws(cfg), gen, _dtype(cfg))


def _layer(stack: Params, i: int) -> Params:
    """Layer ``i``'s leaves of a stacked (nested) parameter dict."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return griffin_linear(act_fn(cfg.act)(griffin_linear(x, p["w_up"])),
                          p["w_down"])


def _mha(cfg: ModelConfig, p: Params, xq: torch.Tensor, xkv: torch.Tensor,
         *, causal: bool, positions: Optional[torch.Tensor] = None):
    """Attention of ``xq`` over ``xkv`` (the same tensor for
    self-attention).  Returns (output in xq's dtype, (k, v))."""
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    H, hd = cfg.num_heads, cfg.hd
    if xq is xkv:
        mq = mkv = shared_activation_meta(xq, p["wq"], p["wk"], p["wv"])
    else:
        mq, mkv = None, shared_activation_meta(xkv, p["wk"], p["wv"])
    q = griffin_linear(xq, p["wq"], meta=mq).reshape(B, Sq, H, hd)
    k = griffin_linear(xkv, p["wk"], meta=mkv).reshape(B, Sk, H, hd)
    v = griffin_linear(xkv, p["wv"], meta=mkv).reshape(B, Sk, H, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, kv_chunk=cfg.kv_chunk)
    return griffin_linear(o.reshape(B, Sq, -1), p["wo"]).to(xq.dtype), \
        (k, v)


def encode(cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) precomputed post-conv embeddings (the frontend
    stub), in their own dtype, which the whole encoder keeps.  Each layer
    runs under ``common.remat_fn`` (where a gradient is wanted)."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)

    def layer(lp, x):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = _mha(cfg, lp["attn"], h, h, causal=False)
        x = (x + a).to(x.dtype)
        f = _mlp(cfg, lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        return (x + f).to(x.dtype)

    layer = remat_fn(cfg, layer)
    for lp in unstack(params["enc_layers"]):
        x = layer(lp, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
               enc: torch.Tensor, positions: torch.Tensor):
    """One decoder layer: (x, self K/V, cross K/V)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, kv = _mha(cfg, lp["self"], h, h, causal=True, positions=positions)
    x = (x + a).to(x.dtype)
    ax, xkv = _mha(cfg, lp["cross"], rms_norm(x, lp["ln_x"], cfg.norm_eps),
                   enc, causal=False)
    x = (x + ax).to(x.dtype)
    f = _mlp(cfg, lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return (x + f).to(x.dtype), kv, xkv


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   frames: torch.Tensor, return_kv: bool = False):
    """The decoder over ``tokens`` with cross-attention to the encoded
    ``frames``.  Returns (final-normed hidden (B, S, D), aux 0), each
    decoder layer under ``common.remat_fn`` (the loss); with
    ``return_kv`` (prefill, no remat) (hidden, the stacked self-attention
    K and V (L, B, S, H, hd) and the cross K and V (L, B, F, H, hd), the
    latter in the encoder's dtype)."""
    enc = encode(cfg, params, frames)
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    layers = unstack(params["dec_layers"])
    if not return_kv:
        def layer(lp, x):
            return _dec_layer(cfg, lp, x, enc, positions)[0]

        layer = remat_fn(cfg, layer)
        for lp in layers:
            x = layer(lp, x)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, torch.zeros((), device=x.device)
    ks, vs, xks, xvs = [], [], [], []
    for lp in layers:
        x, (k, v), (xk, xv) = _dec_layer(cfg, lp, x, enc, positions)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    del enc
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(ks), torch.stack(vs), torch.stack(xks), \
        torch.stack(xvs)


def init_cache(cfg: ModelConfig, batch: int, length: int,
               device: torch.device) -> Params:
    """Zeroed caches in the model dtype: the decoder's self-attention K/V
    over ``length`` positions and the cross K/V over ``enc_frames``."""
    dt = _dtype(cfg)
    L, H, hd, F = cfg.num_layers, cfg.num_heads, cfg.hd, cfg.enc_frames
    return {"k": torch.zeros((L, batch, length, H, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((L, batch, length, H, hd), dtype=dt,
                             device=device),
            "xk": torch.zeros((L, batch, F, H, hd), dtype=dt, device=device),
            "xv": torch.zeros((L, batch, F, H, hd), dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frames: torch.Tensor, cache_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[Params, torch.Tensor]:
    """Encode ``frames``, run the decoder over the prompt, return (cache,
    last-token logits).  ``lengths``: optional (B,) true lengths of a
    right-padded batch (bucketed prefill); the decoder is causal, so real
    positions never see the pads, whose K/V rows sit in slots the decode
    loop overwrites before its position mask admits them.  The cross K/V
    come back in the encoder's dtype (fp32 for fp32 frames)."""
    B, S = tokens.shape
    x, ks, vs, xks, xvs = forward_hidden(cfg, params, tokens, frames,
                                         return_kv=True)
    clen = cache_len or S
    if clen > S:
        pad = (0, 0, 0, 0, 0, clen - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    if lengths is None:
        last = x[:, -1]
        pos = torch.full((), S - 1, dtype=torch.int32, device=tokens.device)
    else:
        last = take_last(x, lengths)
        pos = (lengths - 1).to(torch.int32)
    logits = griffin_linear(last, params["head"])
    return {"k": ks, "v": vs, "xk": xks, "xv": xvs, "pos": pos}, logits


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One decode step for the whole batch.  token: (B, 1).
    ``cache["pos"]`` is a scalar (lockstep batch) or a (B,) vector of
    per-row positions (slot pools).  The self-attention K/V are written in
    place (fixed arena, or pools through the ``"pages"`` table, int8 with
    their scales); cross-attention attends every one of the F encoder
    frames of the fixed ``xk``/``xv``.  A cache of fewer heads than the
    model's is a rank's share on a serving mesh (``common.head_share``):
    both attentions run on its heads, and every model rank's heads are
    gathered before each ``wo`` (two more gathers a layer)."""
    x = params["embed"][token]
    pos = cache["pos"] + 1
    out = dict(cache, pos=pos)
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.hd
    heads = head_share(cache["k"].shape[3], H)
    xheads = head_share(cache["xk"].shape[3], H)
    posv = pos[:, None] if pos.dim() else pos[None]
    paged = "pages" in cache
    if paged:
        pages = cache["pages"].long()
        slot = paged_slot(pages, pos, cache["k"].shape[2])
        kscale, vscale = cache.get("k_scale"), cache.get("v_scale")
    else:
        slot = pos.clamp(max=cache["k"].shape[2] - 1)
    every = torch.full((), cache["xk"].shape[2] - 1, dtype=torch.int32,
                       device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_layers"], i)
        p = lp["self"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        meta = shared_activation_meta(h, p["wq"], p["wk"], p["wv"])
        q = rope(griffin_linear(h, p["wq"], meta=meta).reshape(B, 1, H, hd),
                 posv, cfg.rope_theta)
        k = rope(griffin_linear(h, p["wk"], meta=meta).reshape(B, 1, H, hd),
                 posv, cfg.rope_theta)
        v = griffin_linear(h, p["wv"], meta=meta).reshape(B, 1, H, hd)
        q = take_heads(q, heads, 2)
        if paged:
            ks = None if kscale is None else kscale[i]
            vs = None if vscale is None else vscale[i]
            paged_write(cache["k"][i], ks, slot, k, heads)
            paged_write(cache["v"][i], vs, slot, v, heads)
            o = decode_attention(q, paged_view(cache["k"][i], ks, pages,
                                               x.dtype),
                                 paged_view(cache["v"][i], vs, pages,
                                            x.dtype), pos)
        else:
            write_kv_slot(cache["k"][i], take_heads(k, heads, 2), slot)
            write_kv_slot(cache["v"][i], take_heads(v, heads, 2), slot)
            o = decode_attention(q, cache["k"][i], cache["v"][i], pos)
        if heads is not None:
            o = gather_heads(o, 2)
        x = (x + griffin_linear(o.reshape(B, 1, -1), p["wo"])).to(x.dtype)
        # cross-attention against the fixed encoder K/V
        p = lp["cross"]
        qx = griffin_linear(rms_norm(x, lp["ln_x"], cfg.norm_eps),
                            p["wq"]).reshape(B, 1, H, hd)
        ox = decode_attention(take_heads(qx, xheads, 2), cache["xk"][i],
                              cache["xv"][i], every)
        if xheads is not None:
            ox = gather_heads(ox, 2)
        x = (x + griffin_linear(ox.reshape(B, 1, -1), p["wo"])).to(x.dtype)
        f = _mlp(cfg, lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = (x + f).to(x.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = griffin_linear(x[:, 0], params["head"])
    return logits, out
