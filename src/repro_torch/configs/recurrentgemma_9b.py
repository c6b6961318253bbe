"""recurrentgemma-9b [hybrid RG-LRU + local attention, 1:2] at its
published widths.

38 layers in the Griffin pattern (rec, rec, lattn): 12 full groups plus a
(rec, rec) tail. MQA (one kv head, G = 16, D = 256) local attention over a
2048-slot ring.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "lattn"),
    window=2048,
    long_context_window=2048,
    rope_theta=10000.0,
)
