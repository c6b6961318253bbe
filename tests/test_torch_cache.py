"""Parity of the port's serving cache (``repro_torch.models.cache``) with
the JAX reference's ``models/cache.py``, on the CPU. Inputs are made with
numpy from a seed and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import cache as jcache
from repro_torch.configs import get_config, reduced
from repro_torch.models import cache

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

GQA = dict(n_heads=4, n_kv_heads=2, d_head=64)


def _kv(b=2, s=24, hkv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, hkv, dh)) * 2).astype(np.float32) for _ in range(2)]


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s)).copy()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_and_dequantize_kv_are_bit_equal(bits):
    k, _ = _kv()
    k[0, 3] = 0.0                                      # an all-zero row takes the 1e-8 floor
    want_codes, want_scale = jcache.quantize_kv(jnp.asarray(k), bits)
    codes, scale = cache.quantize_kv(torch.from_numpy(k), bits)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jcache.dequantize_kv(want_codes, want_scale, jdt)
        got = cache.dequantize_kv(codes, scale, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("s,cache_len", [(24, 40), (24, 24), (40, 24), (37, 16)])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_pack_full_kv_both_branches(s, cache_len, kv_bits):
    """s < cache_len fills the front; s >= cache_len keeps the last
    cache_len positions, each at its ring slot p % cache_len."""
    k, v = _kv(s=s, seed=s)
    pos = _positions(2, s, start=3)
    want = jcache.pack_full_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), cache_len,
                               kv_bits=kv_bits)
    got = cache.pack_full_kv(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
                             cache_len, kv_bits=kv_bits)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == {"float32": torch.float32, "int32": torch.int32,
                                   "int8": torch.int8}[str(np.asarray(want[name]).dtype)]
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    if s >= cache_len:
        assert int(got["pos"].min()) == 3 + s - cache_len


def _cfg_pair(arch, **kw):
    j = jreduced(jget_config(arch), n_layers=4)
    t = reduced(get_config(arch), n_layers=4)
    return j.replace(**kw), t.replace(**kw)


@pytest.mark.parametrize("arch,btype,kw", [
    ("qwen3-1.7b", "dense", GQA),
    ("qwen3-1.7b", "dense", dict(GQA, kv_quant_bits=8)),
    ("qwen3-1.7b", "dense", dict(compute_dtype="bfloat16")),
    ("mamba2-1.3b", "mamba2", {}),
    ("recurrentgemma-9b", "rec", {}),
    ("recurrentgemma-9b", "lattn", {}),
    ("recurrentgemma-9b", "lattn", dict(compute_dtype="bfloat16", kv_quant_bits=8)),
    ("qwen2-7b-kv8", "dense", {}),
])
def test_entry_shape_and_payload_bits_match(arch, btype, kw):
    jcfg, cfg = _cfg_pair(arch, **kw)
    for batch, ctx in [(1, 1), (2, 17), (4, 2080), (3, 32768)]:
        want = jcache.entry_shape(jcfg, btype, batch, ctx)
        got = cache.entry_shape(cfg, btype, batch, ctx)
        assert list(got) == list(want)
        for name in want:
            assert tuple(got[name][0]) == tuple(want[name][0])
            assert got[name][1].itemsize == np.dtype(want[name][1]).itemsize
        assert cache.entry_payload_bits(cfg, btype, batch, ctx) == \
            jcache.entry_payload_bits(jcfg, btype, batch, ctx)
    with pytest.raises(ValueError):
        cache.entry_payload_bits(cfg, btype, 1, 0)


def test_full_width_qwen_cache_size():
    """qwen3-1.7b at (4, 2080): 954.2 MB of bf16 k/v and 0.93 MB of pos."""
    cfg = get_config("qwen3-1.7b")
    bits = cache.entry_payload_bits(cfg, "dense", 4, 2080)
    assert bits == 8 * (2 * 4 * 2080 * 8 * 128 * 2 + 4 * 2080 * 4)
    assert 28 * bits // 8 == 954_204_160 + 931_840


def test_other_block_types_name_their_slice():
    _, cfg = _cfg_pair("qwen3-1.7b")
    # the MoE block is ported: its cache is a dense layer's KV entry
    assert cache.entry_shape(cfg, "moe", 1, 8) == cache.entry_shape(cfg, "dense", 1, 8)
    moe_cache = cache.make_cache(cfg.replace(block_pattern=("moe",)), 1, 8)
    assert len(moe_cache) == cfg.n_layers and int(moe_cache[0]["pos"].max()) == -1
    # the encoder-decoder and VLM blocks are ported: an enc layer's shape is
    # a dense layer's (it keeps no cache), a decx layer's adds the encoder
    # output's ck / cv over n_frames, an xattn layer's is ck / cv over the
    # image tokens, each the reference's
    for arch, btype in (("seamless-m4t-large-v2", "enc"), ("seamless-m4t-large-v2", "decx"),
                        ("llama-3.2-vision-90b", "xattn")):
        jc, tc = _cfg_pair(arch)
        want = {k: (sh, getattr(torch, str(np.dtype(dt))))
                for k, (sh, dt) in jcache.entry_shape(jc, btype, 1, 8).items()}
        assert cache.entry_shape(tc, btype, 1, 8) == want
    jc, tc = _cfg_pair("seamless-m4t-large-v2")
    assert cache.entry_shape(tc, "decx", 1, 8)["ck"][0] == (1, tc.encoder.n_frames, 4, 64)
    with pytest.raises(ValueError, match="unknown block type"):
        cache.entry_shape(cfg, "conv", 1, 8)


@pytest.mark.parametrize("arch,kw", [("qwen3-1.7b", GQA), ("mamba2-1.3b", {})])
def test_make_cache_shapes_and_empty_positions(arch, kw):
    jcfg, cfg = _cfg_pair(arch, **kw)
    want = jcache.make_cache(jcfg, 2, 48)
    got = cache.make_cache(cfg, 2, 48)
    assert len(got) == cfg.n_layers
    stacked = want["blocks"][0]
    for layer in got:
        assert sorted(layer) == sorted(stacked)
        for name, t in layer.items():
            ref = np.asarray(stacked[name])
            assert tuple(t.shape) == ref.shape[1:], name
            np.testing.assert_array_equal(t.float().numpy(), ref[0].astype(np.float32))
    if "pos" in got[0]:
        assert torch.all(got[0]["pos"] == -1) and got[0]["pos"].dtype == torch.int32
