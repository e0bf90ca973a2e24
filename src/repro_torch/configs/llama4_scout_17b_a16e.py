"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: 48L d=5120
40H (GQA kv=8) d_ff=8192 (per expert), MoE 16 experts top-1, early fusion
(modality frontend stubbed: text/VQ tokens).  Served reduced only: its
96.6 B expert parameters do not fit one card, compacted or not."""
from .base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=1), rope_theta=500000.0,
))
