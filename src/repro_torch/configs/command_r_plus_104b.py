"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus]: 64L d=12288
96H (GQA kv=8) d_ff=33792 vocab=256000, no biases."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000, rope_theta=75000.0,
))
