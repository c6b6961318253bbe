"""phi4-mini-3.8b [dense, RoPE SwiGLU GQA, G = 3] at its published widths."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    rope_fraction=0.75,
    rope_theta=10000.0,
    tie_embeddings=True,
    block_pattern=("dense",),
)
