"""chameleon-34b [arXiv:2405.09818]: 48L d=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (early fusion: VQ image tokens share the vocab; the VQ
tokenizer frontend is a stub, as in the reference: inputs are token ids).
QK-norm."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, qk_norm=True,
))
