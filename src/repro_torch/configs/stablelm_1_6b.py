"""stablelm-1.6b [dense MHA kv=32, partial RoPE] at its published widths."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    rope_fraction=0.25,
    rope_theta=10000.0,
    block_pattern=("dense",),
)
