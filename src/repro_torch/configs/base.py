"""Model configuration: the dense decoder's, the mixture-of-experts
family's, the ssm (xlstm) family's, the hybrid (recurrentgemma) family's
and the audio (whisper) family's fields of
``repro.configs.base.ModelConfig`` and the same ``reduced()`` rule, so a
reduced config here has exactly the reference's dims."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    window: Optional[int] = None        # sliding-window attention
    qk_norm: bool = False
    tie_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # hybrid (recurrentgemma): pattern of block kinds, tiled over depth
    block_pattern: Tuple[str, ...] = ()          # e.g. ("rec","rec","attn")
    lru_width: int = 0                           # 0 -> d_model
    conv_width: int = 4
    # ssm (xlstm): blocks per group, e.g. 7 mLSTM + 1 sLSTM
    xlstm_pattern: Tuple[str, ...] = ()
    proj_factor: float = 2.0                     # mLSTM up-projection
    # enc-dec (whisper)
    encoder_layers: int = 0
    enc_frames: int = 1500
    dtype: str = "bfloat16"
    kv_chunk: int = 512         # prefill attention's KV chunk (online softmax)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's dims)."""
        r = dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=min(4, max(1, self.num_kv_heads)),
            head_dim=16, d_ff=128 if self.d_ff else 0, vocab_size=128,
            window=min(self.window, 32) if self.window else None,
            moe=MoEConfig(4, self.moe.top_k) if self.moe else None,
            encoder_layers=2 if self.encoder_layers else 0,
            enc_frames=8 if self.is_encdec else self.enc_frames,
            lru_width=64 if self.family == "hybrid" else 0,
            dtype="float32", kv_chunk=16)
        if self.xlstm_pattern:
            r = dataclasses.replace(r, xlstm_pattern=("m", "s"))
        if self.block_pattern:
            # one (rec, rec, attn) group and an empty tail
            r = dataclasses.replace(r, num_layers=3)
        return r


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def _load_all() -> None:
    from . import (llama3_2_1b, llama4_scout_17b_a16e,  # noqa: F401
                   mixtral_8x7b, recurrentgemma_9b, whisper_large_v3,
                   xlstm_1_3b)
