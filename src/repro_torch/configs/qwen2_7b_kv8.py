"""qwen2-7b with an int8 KV cache: the paper's Eq. 1 quantizer applied to
the serving cache (symmetric, per-(slot, kv head) scales), which halves the
decode's cache bytes. An extra variant, outside ``ARCH_IDS``."""
from repro_torch.configs.qwen2_7b import CONFIG as _BASE

CONFIG = _BASE.replace(name="qwen2-7b-kv8", kv_quant_bits=8)
