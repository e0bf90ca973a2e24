"""Model registry: one uniform API per architecture family — the
counterpart of ``repro/models/registry.py`` (the dense, moe, ssm, hybrid
and audio families; vlm is not ported yet).

``build_model(cfg, device)`` binds the family's functions to ``cfg`` and to
the device the model runs on; the default is the CUDA card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import rglru, transformer, whisper, xlstm

Params = Dict[str, Any]


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    prefill: Callable[..., Any]               # (params, batch) -> (cache, logits)
    decode_step: Callable[..., Any]           # (params, cache, token) -> (logits, cache)
    init_cache: Callable[..., Params]         # (batch, length, device=) -> cache
    # the family's draw order (``common.Draw``), where ``init`` follows one
    # (the moe family): ``sparsity.init_sparse_params`` streams it
    draws: Optional[Callable[[], list]] = None

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)


def _transformer_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return transformer.prefill(cfg, params, batch["tokens"], cache_len,
                                   lengths=batch.get("lengths"))

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(transformer.init_params, cfg),
        prefill=prefill_fn,
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg,
                                     device=device),
        draws=(functools.partial(transformer.param_draws, cfg)
               if cfg.family == "moe" else None),
    )


def _xlstm_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return xlstm.prefill(cfg, params, batch["tokens"], cache_len,
                             lengths=batch.get("lengths"))

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(xlstm.init_params, cfg),
        prefill=prefill_fn,
        decode_step=functools.partial(xlstm.decode_step, cfg),
        init_cache=functools.partial(xlstm.init_cache, cfg, device=device),
    )


def _rglru_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return rglru.prefill(cfg, params, batch["tokens"], cache_len,
                             lengths=batch.get("lengths"))

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(rglru.init_params, cfg),
        prefill=prefill_fn,
        decode_step=functools.partial(rglru.decode_step, cfg),
        init_cache=functools.partial(rglru.init_cache, cfg, device=device),
    )


def _whisper_api(cfg: ModelConfig, device: torch.device) -> ModelApi:
    def prefill_fn(params, batch, cache_len=None):
        return whisper.prefill(cfg, params, batch["tokens"], batch["frames"],
                               cache_len, lengths=batch.get("lengths"))

    return ModelApi(
        cfg=cfg, device=device,
        init=functools.partial(whisper.init_params, cfg),
        prefill=prefill_fn,
        decode_step=functools.partial(whisper.decode_step, cfg),
        init_cache=functools.partial(whisper.init_cache, cfg, device=device),
    )


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = "cuda"
                ) -> ModelApi:
    device = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return _transformer_api(cfg, device)
    if cfg.family == "ssm":
        return _xlstm_api(cfg, device)
    if cfg.family == "hybrid":
        return _rglru_api(cfg, device)
    if cfg.family == "audio":
        return _whisper_api(cfg, device)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                              "(ROADMAP 1.12)")
