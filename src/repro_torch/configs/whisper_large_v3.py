"""whisper-large-v3 [arXiv:2212.04356]: enc-dec, 32+32L d=1280 20H
d_ff=5120 vocab=51866.  The conv audio frontend is a stub: requests carry
precomputed frame embeddings (1500 frames post-conv)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, act="gelu",
    encoder_layers=32, enc_frames=1500,
))
