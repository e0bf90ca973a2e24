"""xlstm-1.3b [arXiv:2405.04517]: 48 blocks d=2048, 4 heads, sLSTM+mLSTM
(7:1 mLSTM:sLSTM), no separate FFN (d_ff=0; blocks carry their own
up/down projections, proj_factor=2)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    proj_factor=2.0,
))
