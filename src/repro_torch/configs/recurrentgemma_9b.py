"""recurrentgemma-9b [arXiv:2402.19427]: 38 blocks d=4096, pattern
(rec, rec, attn) — RG-LRU recurrent blocks + local attention (window 2048,
MQA kv=1), d_ff=12288 (GeGLU), lru_width=4096."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256, act="gelu",
    window=2048, block_pattern=("rec", "rec", "attn"), lru_width=4096,
))
