"""seamless-m4t-large-v2 [audio encoder-decoder] at its published widths:
the transformer backbone only, 24 encoder and 24 decoder layers, d_model
1024, 16 heads (MHA, D 64), d_ff 8192, vocab 256 206, LayerNorm and GELU.
The speech frontend (mel spectrogram and conv feature extractor) is
stubbed: the encoder reads precomputed frame embeddings (``aux_embeds``,
(B, 1024, d_model)); every decoder layer (``"decx"``) attends to itself,
then, ungated, to the encoder's output."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm="layernorm",
    act="gelu",
    block_pattern=("decx",),
    encoder=EncoderConfig(n_layers=24, n_frames=1024),
    n_aux_tokens=1024,
    rope_theta=10000.0,
)
