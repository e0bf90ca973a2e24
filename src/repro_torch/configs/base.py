"""Model / shape configuration: the dense decoder's, the vlm backbone's, the
mixture-of-experts family's, the ssm (xlstm) family's, the hybrid
(recurrentgemma) family's and the audio (whisper) family's fields of
``repro.configs.base.ModelConfig`` and the same ``reduced()`` rule, so a
reduced config here has exactly the reference's dims; ``SHAPES`` is the
reference's input-shape set and ``applicable_shapes(cfg)`` its assignment
rules.

The reference's ``scan_layers`` knob (``lax.scan`` over the layer stack,
or unrolled for its roofline cost pass) has no counterpart: the port's
layer stacks are always Python loops."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | vlm | moe | ssm | hybrid | audio
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
    # training knobs: rematerialise each layer (group) in the backward pass
    # (policy "none" saves nothing, "dots" saves the weight GEMMs' outputs)
    # and the sequence chunk of the cross entropy
    remat: bool = True
    remat_policy: str = "none"
    loss_chunk: int = 512
    kv_chunk: int = 512         # attention's KV chunk (online softmax)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can decode at 500k context: recurrent state and/or
        bounded-window attention only."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None

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
            dtype="float32", remat=False, loss_chunk=32, kv_chunk=16)
        if self.xlstm_pattern:
            r = dataclasses.replace(r, xlstm_pattern=("m", "s"))
        if self.block_pattern:
            # one (rec, rec, attn) group and an empty tail
            r = dataclasses.replace(r, num_layers=3)
        return r


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """The reference's assignment rules: long_500k needs sub-quadratic
    attention; every ported arch has a decoder, so the decode shapes
    apply."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def _load_all() -> None:
    from . import (chameleon_34b, command_r_plus_104b,  # noqa: F401
                   llama3_2_1b, llama4_scout_17b_a16e, minitron_8b,
                   mixtral_8x7b, recurrentgemma_9b, stablelm_1_6b,
                   whisper_large_v3, xlstm_1_3b)
