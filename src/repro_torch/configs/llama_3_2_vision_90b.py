"""llama-3.2-vision-90b [VLM, gated cross-attention image layers] at its
published widths: 100 layers of d_model 8192, 64 query on 8 KV heads of
128, d_ff 28672, vocab 128256, every 5th layer (``"xattn"``) a tanh-gated
cross-attention over the image-patch embeddings. The vision encoder is
stubbed: the cross-attention reads precomputed patch embeddings
(``aux_embeds``, (B, 1600, d_model)). FSDP and Adafactor, as the
reference's XL settings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    block_pattern=("dense", "dense", "dense", "dense", "xattn"),
    n_aux_tokens=1600,
    fsdp=True,
    optimizer="adafactor",
)
