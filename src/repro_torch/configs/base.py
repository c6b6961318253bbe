"""Model configuration of the port: its own copy of the reference's
``ModelConfig``, ``EncoderConfig``, ``InputShape`` / ``INPUT_SHAPES`` and
``reduced`` (``src/repro/configs/base.py``).

The fields are the reference's, one for one, so a configuration can be
compared field by field with its JAX twin. The port runs dense, MoE,
hybrid, Mamba-2, encoder-decoder and cross-attention (VLM) stacks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int            # per-expert FFN hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128       # N
    d_conv: int = 4
    expand: int = 2          # d_inner = expand * d_model
    head_dim: int = 64       # P;  n_heads = d_inner // head_dim
    chunk: int = 256         # SSD chunk length
    n_groups: int = 1        # B/C groups


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of an encoder-decoder (audio) arch. Its frontend is
    stubbed: the encoder reads precomputed frame embeddings
    (``aux_embeds``, (B, n_frames, d_model))."""
    n_layers: int = 24
    n_frames: int = 1024     # stub frontend output length
    d_frontend: int = 0      # 0 => frames already at d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0          # 0 => d_model // n_heads
    norm: str = "rmsnorm"    # rmsnorm | layernorm
    act: str = "swiglu"      # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    tie_embeddings: bool = False
    block_pattern: Tuple[str, ...] = ("dense",)
    window: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_aux_tokens: int = 0
    long_context_window: int = 8192
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    fsdp: bool = False
    seq_parallel_residual: bool = False
    remat: bool = True
    optimizer: str = "adamw"
    attn_chunk: int = 1024
    bottleneck_ratio: int = 4
    quant_bits: int = 8
    kv_quant_bits: int = 0
    # Kept so that configs compare field for field with the reference; in
    # the port the tensor's device picks the ssd_intra kernel or its twin.
    use_pallas_ssd: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    def block_types(self) -> Tuple[str, ...]:
        """Block type of each of the n_layers layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Reduced variant of the same family for CPU tests, as the reference's
    ``reduced``: at most 4 heads (so qwen3-1.7b loses its GQA), f32, an
    SSM of d_state 16, head_dim 32, chunk 16, and an MoE of 4 experts,
    top-2, ``d_expert = d_model // 2``, at most one shared expert and a
    capacity factor of 4.0 (capacity T k: no assignment is ever dropped),
    an encoder of 2 layers over 16 frames and 16 aux tokens."""
    d_model = min(d_model, 512)
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    ssm = (None if cfg.ssm is None else
           dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16))
    moe = (None if cfg.moe is None else dataclasses.replace(
        cfg.moe, n_experts=4, top_k=2, d_expert=d_model // 2,
        n_shared_experts=min(cfg.moe.n_shared_experts, 1), capacity_factor=4.0))
    encoder = (None if cfg.encoder is None else
               dataclasses.replace(cfg.encoder, n_layers=2, n_frames=16))
    return cfg.replace(
        n_layers=max(n_layers, len(cfg.block_pattern)), d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, d_head=d_model // n_heads,
        d_ff=2 * d_model, vocab_size=vocab, param_dtype="float32",
        compute_dtype="float32", fsdp=False, attn_chunk=64,
        window=min(cfg.window, 64) if cfg.window else 0,
        long_context_window=128,
        n_aux_tokens=16 if cfg.n_aux_tokens else 0, ssm=ssm, moe=moe, encoder=encoder)
