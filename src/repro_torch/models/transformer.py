"""Decoder-only transformer (llama-style) — the counterpart of
``repro/models/transformer.py`` for the dense family, the vlm backbone
(chameleon: early-fusion token ids, QK-norm) and the mixture-of-experts
family (mixtral with its sliding window, llama4-scout top-1).

Parameters are a plain dict of tensors with the reference's layout:
``embed`` (V, D), ``final_norm`` (D,), ``layers`` holding every per-layer
leaf stacked along a leading layer axis, and ``head`` (D, V) unless the
embeddings are tied; the moe family's layers hold a ``moe`` subtree of
``router`` (L, D, E), ``w_gate``/``w_up`` (L, E, D, F) and ``w_down`` (L,
E, F, D) in place of the dense FFN.  Every weight GEMM goes through
``common.griffin_linear``, so compacted ``GriffinWeights`` leaves (stacked,
sliced per layer) run the Sparse.B kernel.  The layer stack is a Python loop.

KV caches: ``{"k", "v": (L, B, S, KVH, hd), "pos": scalar or (B,)}``, or
a paged arena (``runtime/paging.py``): ``"k"``/``"v"`` pools (L,
num_pages, page_size, KVH, hd) read through the ``"pages"`` table, int8
beside ``"k_scale"``/``"v_scale"`` (L, num_pages, page_size) scales.
``decode_step`` writes the new K/V rows into the cache tensors in place
(the reference's donated update) and returns the cache with the advanced
position.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import attention, decode_attention
from .common import (Draw, act_fn, dense_init, gather_heads,
                     griffin_linear, head_share, init_from_draws,
                     length_mask, paged_slot, paged_view, paged_write,
                     remat_fn, rms_norm, rope, shared_activation_meta,
                     take_heads, take_last, unstack, write_kv_slot)
from .moe import moe_ffn

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_draws(cfg: ModelConfig):
    """The vlm and moe families' draw order (``common.Draw``): the
    embedding, the norm scales (``qn``/``kn`` with QK-norm), then leaf by
    leaf each weight matrix one (layer) or (layer, expert) slice at a time
    (wq, wk, wv, wo, then the dense FFN's w_gate, w_up, w_down, or the
    router and the experts' w_gate, w_up, w_down), then the head.
    ``init_params`` and ``sparsity.init_sparse_params`` both follow it, so
    the second can compact each slice before it draws the next."""
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    lay = ("layers",)
    draws = [Draw(("embed",), (), (cfg.vocab_size, D), scale=1.0),
             Draw(("final_norm",), (), (D,), zeros=True),
             Draw(lay + ("ln1",), (L,), (D,), zeros=True),
             Draw(lay + ("ln2",), (L,), (D,), zeros=True)]
    if cfg.qk_norm:
        draws += [Draw(lay + ("qn",), (L,), (hd,), zeros=True),
                  Draw(lay + ("kn",), (L,), (hd,), zeros=True)]
    draws += [Draw(lay + ("wq",), (L,), (D, H * hd)),
              Draw(lay + ("wk",), (L,), (D, KVH * hd)),
              Draw(lay + ("wv",), (L,), (D, KVH * hd)),
              Draw(lay + ("wo",), (L,), (H * hd, D))]
    if cfg.moe:
        E = cfg.moe.num_experts
        draws += [Draw(lay + ("moe", "router"), (L,), (D, E)),
                  Draw(lay + ("moe", "w_gate"), (L, E), (D, F)),
                  Draw(lay + ("moe", "w_up"), (L, E), (D, F)),
                  Draw(lay + ("moe", "w_down"), (L, E), (F, D))]
    else:
        draws += [Draw(lay + ("w_gate",), (L,), (D, F)),
                  Draw(lay + ("w_up",), (L,), (D, F)),
                  Draw(lay + ("w_down",), (L,), (F, D))]
    if not cfg.tie_embeddings:
        draws.append(Draw(("head",), (), (D, cfg.vocab_size)))
    return draws


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``: normal / sqrt(fan_in)
    GEMMs, unit-normal embeddings, zero norm scales (the reference's
    scheme; the draws themselves differ from ``jax.random``'s).  The vlm
    and moe families draw in :func:`param_draws`' order, one matrix at a
    time; the dense family draws each stacked leaf whole."""
    if cfg.family in ("vlm", "moe"):
        return init_from_draws(param_draws(cfg), gen, _dtype(cfg))
    if cfg.family == "audio":
        raise ValueError("the audio family is an encoder-decoder: "
                         "models.whisper.init_params draws it")
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not a decoder-only "
                         "transformer")
    dt = _dtype(cfg)
    dev = gen.device
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    layers: Params = {
        "ln1": torch.zeros((L, D), dtype=dt, device=dev),
        "ln2": torch.zeros((L, D), dtype=dt, device=dev),
        "wq": dense_init(gen, (L, D, H * hd), D, dt),
        "wk": dense_init(gen, (L, D, KVH * hd), D, dt),
        "wv": dense_init(gen, (L, D, KVH * hd), D, dt),
        "wo": dense_init(gen, (L, H * hd, D), H * hd, dt),
        "w_gate": dense_init(gen, (L, D, F), D, dt),
        "w_up": dense_init(gen, (L, D, F), D, dt),
        "w_down": dense_init(gen, (L, F, D), F, dt),
    }
    if cfg.qk_norm:
        layers["qn"] = torch.zeros((L, hd), dtype=dt, device=dev)
        layers["kn"] = torch.zeros((L, hd), dtype=dt, device=dev)
    params: Params = {
        "embed": dense_init(gen, (cfg.vocab_size, D), cfg.vocab_size, dt,
                            scale=1.0),
        "final_norm": torch.zeros((D,), dtype=dt, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (D, cfg.vocab_size), D, dt)
    return params


def unembed(cfg: ModelConfig, params: Params):
    """The unembedding weight; tied embeddings give the strided view
    ``embed.T``, which the dense kernel reads in place."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves (the moe subtree sliced the same way)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {name: pick(leaf) for name, leaf in tree.items()}
        return tree[i]
    return pick(params["layers"])


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, decode: bool = False,
         valid: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN and its aux loss: the dense SwiGLU (aux None), or the moe
    family's experts (drop-free on decode; ``valid``, the (B, S) right-pad
    mask of a bucketed prefill, keeps pads out of the experts) and their
    load-balance term.  The aux loss is a training term: serving drops
    it."""
    if cfg.moe:
        B, S, D = x.shape
        out, aux = moe_ffn(p["moe"], x.reshape(B * S, D), cfg.moe, cfg.act,
                           drop_free=decode,
                           valid=None if valid is None
                           else valid.reshape(B * S))
        return out.reshape(B, S, D), aux
    meta = shared_activation_meta(x, p["w_gate"], p["w_up"])
    h = act_fn(cfg.act)(griffin_linear(x, p["w_gate"], meta=meta)) * \
        griffin_linear(x, p["w_up"], meta=meta)
    return griffin_linear(h, p["w_down"]).to(x.dtype), None


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
         positions: torch.Tensor):
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    meta = shared_activation_meta(x, p["wq"], p["wk"], p["wv"])
    q = griffin_linear(x, p["wq"], meta=meta).reshape(B, S, H, hd)
    k = griffin_linear(x, p["wk"], meta=meta).reshape(B, S, KVH, hd)
    v = griffin_linear(x, p["wv"], meta=meta).reshape(B, S, KVH, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def block_train(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor,
                valid: Optional[torch.Tensor] = None):
    """Full-sequence block (train / prefill): returns (x, aux, k, v), aux
    the moe load-balance term (None for the dense FFN; the serve paths
    ignore it).  ``valid``: the optional (B, S) right-pad mask of a
    bucketed prefill.  Causal attention keeps pads out on its own (they
    sit after every real token); only the moe dispatch needs it, so pads
    take no expert capacity."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    o = attention(q, k, v, causal=True, window=cfg.window,
                  kv_chunk=cfg.kv_chunk)
    B, S = q.shape[:2]
    x = x + griffin_linear(o.reshape(B, S, -1), p["wo"]).to(x.dtype)
    f, aux = _ffn(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps), valid=valid)
    return (x + f).to(x.dtype), aux, k, v


def block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 pos: torch.Tensor, kv, attend_pos: torch.Tensor,
                 window: Optional[int], heads: Optional[slice] = None
                 ) -> torch.Tensor:
    """One-token block.  ``pos``: scalar, or (B,) per-row positions (slot
    pools).  ``kv(k, v)`` writes the token's K and V into this layer's
    cache in place and returns the (B, S_cache, KVH, hd) K and V to attend
    at ``attend_pos`` under ``window`` (:func:`decode_step` builds it for
    the fixed or the paged arena).  ``heads``: the KV heads the arena
    holds (``common.head_share``; None: all): the block attends with
    their query heads alone (contiguous under GQA) and gathers every
    model rank's heads before ``wo``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h,
                   positions=pos[:, None] if pos.dim() else pos[None])
    if heads is not None:
        g = cfg.num_heads // cfg.num_kv_heads
        q = take_heads(q, slice(heads.start * g, heads.stop * g), 2)
    o = decode_attention(q, *kv(k, v), attend_pos, window=window)
    if heads is not None:
        o = gather_heads(o, 2)
    B = x.shape[0]
    x = x + griffin_linear(o.reshape(B, 1, -1), p["wo"]).to(x.dtype)
    f, _ = _ffn(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps), decode=True)
    return (x + f).to(x.dtype)


def _fixed_kv(slot: torch.Tensor, heads: Optional[slice],
              k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor):
    write_kv_slot(k_cache, take_heads(k, heads, 2), slot)
    write_kv_slot(v_cache, take_heads(v, heads, 2), slot)
    return k_cache, v_cache


def _paged_kv(pages: torch.Tensor, slot, dtype: torch.dtype,
              heads: Optional[slice], k_pool: torch.Tensor,
              v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
              v_scale: Optional[torch.Tensor], k: torch.Tensor,
              v: torch.Tensor):
    paged_write(k_pool, k_scale, slot, k, heads)
    paged_write(v_pool, v_scale, slot, v, heads)
    return (paged_view(k_pool, k_scale, pages, dtype),
            paged_view(v_pool, v_scale, pages, dtype))


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   return_kv: bool = False,
                   lengths: Optional[torch.Tensor] = None):
    """Embed and run every layer.  Returns (final-normed hidden, aux
    summed over the layers) and, with ``return_kv``, the per-layer K and
    V stacked over the layers (L, B, S, KVH, hd).  ``lengths``: optional
    (B,) true prompt lengths of a right-padded batch (bucketed prefill).
    Without ``return_kv`` (the loss) each layer runs under
    ``common.remat_fn``; the serve paths never remat."""
    S = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device)
    valid = None if lengths is None else length_mask(lengths, S)
    aux = torch.zeros((), device=x.device)
    ks, vs = [], []

    def body(lp, x):
        x, a, _, _ = block_train(cfg, lp, x, positions, valid)
        return x, a

    layer = remat_fn(cfg, body)
    for lp in unstack(params["layers"]):
        if return_kv:
            x, a, k, v = block_train(cfg, lp, x, positions, valid)
            ks.append(k)
            vs.append(v)
        else:
            x, a = layer(lp, x)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_kv:
        return x, aux, (torch.stack(ks), torch.stack(vs))
    return x, aux


def init_cache(cfg: ModelConfig, batch: int, length: int,
               device: torch.device) -> Params:
    """Zeroed KV cache; sliding-window archs cap it at the window."""
    clen = min(length, cfg.window) if cfg.window else length
    shape = (cfg.num_layers, batch, clen, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[Params, torch.Tensor]:
    """Process a prompt, build the cache, return (cache, last-token logits).
    ``lengths``: optional (B,) true lengths of a right-padded batch
    (bucketed prefill); pad K/V rows land in slots the decode loop
    overwrites before its position mask admits them."""
    B, S = tokens.shape
    x, _, kv = forward_hidden(cfg, params, tokens, return_kv=True,
                              lengths=lengths)
    clen = cache_len or S
    clen = min(clen, cfg.window) if cfg.window else clen
    if clen >= S:
        cache_k, cache_v = (t.new_zeros(t.shape[:2] + (clen,) + t.shape[3:])
                            for t in kv)
        cache_k[:, :, :S] = kv[0]
        cache_v[:, :, :S] = kv[1]
    else:  # keep the last window
        if lengths is not None:
            raise ValueError("bucketed prefill must fit the cache window")
        cache_k, cache_v = (t[:, :, S - clen:].contiguous() for t in kv)
    if lengths is None:
        last = x[:, -1]
        pos = torch.full((), S - 1, dtype=torch.int32, device=tokens.device)
    else:
        last = take_last(x, lengths)
        pos = (lengths - 1).to(torch.int32)
    logits = griffin_linear(last, unembed(cfg, params))
    return {"k": cache_k, "v": cache_v, "pos": pos}, logits


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One decode step for the whole batch.  token: (B, 1).  The cache's
    K/V tensors are updated in place; the returned cache shares them.  A
    ``"pages"`` key marks a paged cache.  A cache of fewer KV heads than
    the model's is a rank's share on a serving mesh (``common.head_share``,
    one more gather a layer)."""
    x = params["embed"][token]
    pos = cache["pos"] + 1
    out = dict(cache, pos=pos)
    heads = head_share(cache["k"].shape[3], cfg.num_kv_heads)
    if "pages" in cache:
        # paging is on only where the arch has no rolling window at this
        # cache length, so for every live row the fixed arena's window
        # algebra reduces to: write at pos, attend the gathered view with
        # no window -- bit-identical to the fixed arena.  int8 pools carry
        # their per-token scales under "<key>_scale".
        pages = cache["pages"].long()
        slot = paged_slot(pages, pos, cache["k"].shape[2])
        ks, vs = cache.get("k_scale"), cache.get("v_scale")

        def kv(i):
            return partial(_paged_kv, pages, slot, x.dtype, heads,
                           cache["k"][i], cache["v"][i],
                           None if ks is None else ks[i],
                           None if vs is None else vs[i])
        attend_pos, window = pos, None
    else:
        cache_len = cache["k"].shape[2]
        if cfg.window is not None and cache_len <= cfg.window:  # rolling
            slot = pos % cache_len
            attend_pos, window = pos.clamp(max=cache_len - 1), None
        else:
            slot = pos.clamp(max=cache_len - 1)
            attend_pos, window = pos, cfg.window

        def kv(i):
            return partial(_fixed_kv, slot, heads, cache["k"][i],
                           cache["v"][i])
    for i in range(cfg.num_layers):
        x = block_decode(cfg, _layer(params, i), x, pos, kv(i), attend_pos,
                         window, heads)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = griffin_linear(x[:, 0], unembed(cfg, params))
    return logits, out
