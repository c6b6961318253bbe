"""qwen3-moe-30b-a3b [MoE 128 experts top-8; hf:Qwen/Qwen3-30B-A3B] at its
published widths."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    fsdp=True,
)
