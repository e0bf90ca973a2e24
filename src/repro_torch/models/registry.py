"""Model registry: one uniform API per architecture family — the
counterpart of ``repro/models/registry.py`` (the dense family with all
four of its configs, llama3.2-1b, stablelm-1.6b, minitron-8b and
command-r-plus-104b; the vlm backbone, chameleon-34b, through the same
transformer API; the moe, ssm, hybrid and audio families).

``build_model(cfg, device)`` binds the family's functions to ``cfg`` and to
the device the model runs on; the default is the CUDA card.  Analytic
parameter counts and ``input_specs`` (shape-and-dtype stand-ins on the
``meta`` device) are the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import rglru, transformer, whisper, xlstm
from .losses import chunked_cross_entropy

Params = Dict[str, Any]


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    loss: Callable[..., torch.Tensor]         # (params, batch) -> scalar
    prefill: Callable[..., Any]               # (params, batch) -> (cache, logits)
    decode_step: Callable[..., Any]           # (params, cache, token) -> (logits, cache)
    init_cache: Callable[..., Params]         # (batch, length, device=) -> cache
    param_count: Callable[[], int]            # analytic, excludes embeddings
    param_count_total: Callable[[], int]
    # the family's draw order (``common.Draw``), where ``init`` follows one
    # (the vlm and moe families): ``sparsity.init_sparse_params`` streams it
    draws: Optional[Callable[[], list]] = None

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)


def _transformer_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def loss(params, batch):
        hidden, aux = transformer.forward_hidden(cfg, params, batch["tokens"])
        ce = chunked_cross_entropy(hidden, transformer.unembed(cfg, params),
                                   batch["labels"], cfg.loss_chunk)
        return ce + 0.01 * aux

    def prefill_fn(params, batch, cache_len=None):
        return transformer.prefill(cfg, params, batch["tokens"], cache_len,
                                   lengths=batch.get("lengths"))

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(transformer.init_params, cfg),
        loss=loss,
        prefill=prefill_fn,
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg,
                                     device=device),
        param_count=lambda: _tf_param_count(cfg, active=True),
        param_count_total=lambda: _tf_param_count(cfg, active=False),
        draws=(functools.partial(transformer.param_draws, cfg)
               if cfg.family in ("vlm", "moe") else None),
    )


def _tf_param_count(cfg: ModelConfig, active: bool) -> int:
    D, H, KVH, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                        cfg.d_ff)
    attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
    if cfg.moe:
        E = cfg.moe.num_experts
        eff = cfg.moe.top_k if active else E
        ffn = D * E + eff * 3 * D * F
    else:
        ffn = 3 * D * F
    return cfg.num_layers * (attn + ffn)


def _head_loss(cfg: ModelConfig, hidden_fn):
    """The loss of a family with an untied ``head`` and no aux term."""
    def loss(params, batch):
        hidden, _ = hidden_fn(params, batch)
        return chunked_cross_entropy(hidden, params["head"], batch["labels"],
                                     cfg.loss_chunk)
    return loss


def _xlstm_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return xlstm.prefill(cfg, params, batch["tokens"], cache_len,
                             lengths=batch.get("lengths"))

    def count():
        D, H = cfg.d_model, cfg.num_heads
        din = int(cfg.proj_factor * D)
        hd_s = D // H
        groups, n_m, n_s = xlstm.group_counts(cfg)
        m_p = D * 2 * din + 3 * H * (din // H) ** 2 + 2 * din * H + din * D
        s_p = 4 * (D * D + H * hd_s * hd_s) + D * int(4 * D / 3) * 2
        return groups * (n_m * m_p + n_s * s_p)

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(xlstm.init_params, cfg),
        loss=_head_loss(cfg, lambda p, b: xlstm.forward_hidden(
            cfg, p, b["tokens"])),
        prefill=prefill_fn,
        decode_step=functools.partial(xlstm.decode_step, cfg),
        init_cache=functools.partial(xlstm.init_cache, cfg, device=device),
        param_count=count,
        param_count_total=count,
    )


def _rglru_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return rglru.prefill(cfg, params, batch["tokens"], cache_len,
                             lengths=batch.get("lengths"))

    def count():
        D, F = cfg.d_model, cfg.d_ff
        R = cfg.lru_width or D
        H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        groups, tail = rglru._group_counts(cfg)
        rec = 2 * D * R + 2 * R * R + R * D
        attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
        mlp = 3 * D * F
        return groups * (2 * rec + attn + 3 * mlp) + tail * (rec + mlp)

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(rglru.init_params, cfg),
        loss=_head_loss(cfg, lambda p, b: rglru.forward_hidden(
            cfg, p, b["tokens"])),
        prefill=prefill_fn,
        decode_step=functools.partial(rglru.decode_step, cfg),
        init_cache=functools.partial(rglru.init_cache, cfg, device=device),
        param_count=count,
        param_count_total=count,
    )


def _whisper_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return whisper.prefill(cfg, params, batch["tokens"], batch["frames"],
                               cache_len, lengths=batch.get("lengths"))

    def count():
        D, H, hd, F = cfg.d_model, cfg.num_heads, cfg.hd, cfg.d_ff
        attn = 4 * D * H * hd
        mlp = 2 * D * F
        return cfg.encoder_layers * (attn + mlp) + \
            cfg.num_layers * (2 * attn + mlp)

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(whisper.init_params, cfg),
        loss=_head_loss(cfg, lambda p, b: whisper.forward_hidden(
            cfg, p, b["tokens"], b["frames"])),
        prefill=prefill_fn,
        decode_step=functools.partial(whisper.decode_step, cfg),
        init_cache=functools.partial(whisper.init_cache, cfg, device=device),
        param_count=count,
        param_count_total=count,
    )


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = "cuda"
                ) -> ModelApi:
    device = resolve_device(device)
    if cfg.family in ("dense", "vlm", "moe"):
        return _transformer_api(cfg, device)
    if cfg.family == "ssm":
        return _xlstm_api(cfg, device)
    if cfg.family == "hybrid":
        return _rglru_api(cfg, device)
    if cfg.family == "audio":
        return _whisper_api(cfg, device)
    raise ValueError(f"unknown family {cfg.family}")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Shape-and-dtype stand-ins (``meta`` tensors: no allocation) for
    every model input of a shape cell, as the reference's."""
    B, S = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": spec((B, S)), "labels": spec((B, S))}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, S))}
    else:                                    # decode: one new token
        specs = {"token": spec((B, 1))}
    if cfg.is_encdec and shape.kind != "decode":
        specs["frames"] = spec((B, cfg.enc_frames, cfg.d_model),
                               getattr(torch, cfg.dtype))
    return specs
