"""mamba2-1.3b [SSM, SSD state-space duality; arXiv:2405.21060] at its
published widths: 48 SSD mixer layers, d_model 2048, d_state 128."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=16,          # unused (attention-free); kept for config uniformity
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("mamba2",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    seq_parallel_residual=True,
)
