"""kimi-k2-1t-a32b [trillion-parameter MoE] at its published widths: 61
layers, d_model 7168, 64 query on 8 KV heads, 384 experts top-8 with
d_expert 2048 plus one shared expert, vocab 163840. The reference's XL
settings (FSDP, Adafactor) are kept field for field; the port trains it
with Adafactor (one card holds one of its layers)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=2048,
    vocab_size=163840,
    rope_theta=50000.0,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared_experts=1),
    fsdp=True,
    optimizer="adafactor",
)
