"""Parity of the port's transformer (configs, layers, attention, dense
block, model, weight carrying) with the JAX reference, in float32 on the
CPU. Weights come from the reference's ``init_params`` and are carried
across by ``repro_torch.weights``; activations are made with numpy.

Two configs: ``reduced(qwen3-1.7b)`` (which caps the heads at 4, so
n_kv_heads == n_heads) and a GQA variant (4 query heads on 2 KV heads) run
at a sequence longer than ``attn_chunk``, so both chunked online softmaxes
take several chunks, the last one ragged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import apply_model as japply_model
from repro.models import attention as jattn
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.blocks import apply_block as japply_block
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.models import apply_model, init_params, layer_plan
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.blocks import make_block
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

GQA = dict(n_heads=4, n_kv_heads=2, d_head=64)


def _cfgs(kind, n_layers=2):
    j = jreduced(jget_config("qwen3-1.7b"), n_layers=n_layers)
    t = reduced(get_config("qwen3-1.7b"), n_layers=n_layers)
    if kind == "gqa":
        j, t = j.replace(**GQA), t.replace(**GQA)
    return j, t


_CACHE = {}


def _setup(kind, n_layers=2):
    """(jax cfg, port cfg, jax params, port model), built once per kind."""
    key = (kind, n_layers)
    if key not in _CACHE:
        jcfg, cfg = _cfgs(kind, n_layers)
        params = jinit_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _CACHE[key] = (jcfg, cfg, params, from_jax_params(tree, cfg, "cpu"))
    return _CACHE[key]


def _layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["decoder"]["blocks"][0])


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().numpy()


def _positions(b, s):
    p = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return jnp.asarray(p), torch.from_numpy(p.copy())


def test_configs_match_the_reference_field_for_field():
    for jc, tc in [(jget_config("qwen3-1.7b"), get_config("qwen3-1.7b")),
                   _cfgs("reduced"), _cfgs("reduced", 4)]:
        j, t = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert j == t
        assert jc.head_dim == tc.head_dim and jc.block_types() == tc.block_types()
    full = get_config("qwen3-1.7b")
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.n_layers) == (2048, 16, 8, 128, 6144, 151936, 28)
    assert layer_plan(full) == (("dense",), 28, ())


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    x = _x((2, 5, 64), 1, 3.0)
    scale, bias = _x((64,), 2), _x((64,), 3)
    jcfg = jreduced(jget_config("qwen3-1.7b")).replace(norm=norm)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = np.asarray(jlayers.apply_norm(p, jnp.asarray(x), jcfg))
    got = layers.apply_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), norm=norm)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_rms_head_norm():
    x, scale = _x((2, 7, 4, 32), 4, 2.0), _x((32,), 5)
    want = np.asarray(jlayers.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)))
    got = layers.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_rotates_interleaved_pairs(fraction):
    x = _x((2, 40, 3, 64), 6)
    pj, pt = _positions(2, 40)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), pj, 1e6, fraction))
    got = layers.apply_rope(torch.from_numpy(x), pt, 1e6, fraction)
    # cos/sin of the same f32 angles from two libms
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=2e-5)


def test_rope_frequencies_are_built_once_per_device(monkeypatch):
    """rope_freqs gives the same bits on every call, and after the first
    call per (d_rot, theta, device) its inverse frequencies are the cached
    tensor: nothing is built in numpy or copied from the host again."""
    _, pt = _positions(2, 40)
    first = layers.rope_freqs(pt, 64, 1e6, 0.5)
    inv = layers.rope_inv_freqs(32, 1e6, pt.device)
    misses = layers.rope_inv_freqs.cache_info().misses

    def no_host_copy(*args):
        raise AssertionError("rope_freqs built its frequencies again")
    monkeypatch.setattr(torch, "from_numpy", no_host_copy)
    again = layers.rope_freqs(pt, 64, 1e6, 0.5)
    for a, b in zip(first[:2], again[:2]):
        assert torch.equal(a, b)
    assert first[2] == again[2] == 32
    assert layers.rope_inv_freqs(32, 1e6, pt.device) is inv
    assert layers.rope_inv_freqs.cache_info().misses == misses
    # the cached bits are the reference's numpy bits
    np.testing.assert_array_equal(
        _np(inv), 1.0 / (1e6 ** (np.arange(0, 32, 2, dtype=np.float32) / 32)))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    _, cfg = _cfgs("reduced")
    cfg = cfg.replace(act=act)
    jcfg = _cfgs("reduced")[0].replace(act=act)
    d, f = cfg.d_model, cfg.d_ff
    w = {k: _x(s, i + 10, 0.05) for i, (k, s) in
         enumerate([("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))])}
    x = _x((2, 6, d), 7)
    want = np.asarray(jlayers.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                                        jnp.asarray(x), jcfg))
    mlp = layers.MLP(cfg)
    with torch.no_grad():
        for k, v in w.items():
            if getattr(mlp, k) is not None:
                getattr(mlp, k).copy_(torch.from_numpy(v))
    np.testing.assert_allclose(_np(mlp(torch.from_numpy(x))), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["reduced", "gqa"])
def test_qkv_and_self_attention(kind):
    jcfg, cfg, params, model = _setup(kind)
    p0, a0 = _layer0(params)["attn"], model.blocks[0].attn
    b, s = 2, 80                                  # s > attn_chunk (64)
    x = _x((b, s, cfg.d_model), 8)
    pj, pt = _positions(b, s)
    for want, got in zip(jattn._qkv(p0, jnp.asarray(x), jnp.asarray(x), jcfg),
                         attn.qkv(a0, torch.from_numpy(x), torch.from_numpy(x), cfg)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    want, _ = jattn.self_attention(p0, jnp.asarray(x), jcfg, pj)
    got = a0(torch.from_numpy(x), pt)
    # two f32 chunks (64 + a ragged 16) on both sides, summed in other orders
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24)])
def test_attention_matches_flash_attention(causal, window):
    b, s, hq, hkv, dh = 2, 96, 4, 2, 32
    q, k, v = (_x((b, s, h, dh), 20 + i) for i, h in enumerate((hq, hkv, hkv)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[1, -5:] = -1                             # invalid slots in one row
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_positions=jnp.asarray(pos),
                                 k_positions=jnp.asarray(pos), causal=causal,
                                 window=window, chunk=32)
    tp = torch.from_numpy(pos)
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         q_positions=tp, k_positions=tp, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=2e-5)


def _attention_inputs(b, sq, sk, hq, hkv, dh, seed):
    q = _x((b, sq, hq, dh), seed)
    k, v = _x((b, sk, hkv, dh), seed + 1), _x((b, sk, hkv, dh), seed + 2)
    qpos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq)).copy()
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    kpos[1, 7:11] = -1                           # invalid slots in one row
    return q, k, v, qpos, kpos


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40)])
def test_chunked_attention_matches_jax_flash_inner(causal, window):
    """Sq and Sk above the chunk (32), with a ragged last chunk (150 = 4 x 32
    + 22), and query rows whose every key is invalid (q position -1): the
    reference pads the last chunk with slots at position -1, which such a
    row counts, and the port pads it the same way."""
    b, sq, sk, hq, hkv, dh = 2, 130, 150, 4, 2, 32
    q, k, v, qpos, kpos = _attention_inputs(b, sq, sk, hq, hkv, dh, 30)
    qpos[0, :3] = -1                             # rows with no valid key when causal
    want = jattn._flash_inner(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                              causal=causal, window=window, chunk=32)
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos),
                         causal=causal, window=window, chunk=32)
    # the same chunks and running max in f32; only the sums' order differs
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40)])
def test_query_blocks_match_jax_flash_attention(causal, window):
    """Sq above q_block (48) with a ragged last block (130 = 2 x 48 + 34):
    the reference pads the queries and maps over blocks; the port takes
    the blocks one after another."""
    b, sq, sk, hq, hkv, dh = 2, 130, 150, 4, 2, 32
    q, k, v, qpos, kpos = _attention_inputs(b, sq, sk, hq, hkv, dh, 40)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                                 causal=causal, window=window, chunk=32, q_block=48)
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos),
                         causal=causal, window=window, chunk=32, q_block=48)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=2e-6)


def _one_piece_attention(q, k, v, qpos, kpos, causal, window):
    """The whole (B, Hkv, G, Sq, Sk) score matrix in one softmax: the form
    the port used before it chunked, kept here as an oracle."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qf = q.reshape(b, sq, hkv, hq // hkv, dh) * float(torch.tensor(dh ** -0.5))
    s = torch.einsum("bqhgd,bchd->bhgqc", qf, k)
    kp, qp = kpos[:, None, None, None, :], qpos[:, None, None, :, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    s = s.masked_fill(~valid, attn.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhgqc,bchd->bhgqd", p, v) / p.sum(-1)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40)])
def test_chunked_attention_matches_the_one_piece_form(causal, window):
    """Every query row here has a valid key, so padding the last chunk
    changes nothing and the chunked softmax equals the one-piece one up to
    f32 rounding."""
    b, sq, sk, hq, hkv, dh = 2, 130, 150, 4, 2, 32
    q, k, v, qpos, kpos = (torch.from_numpy(a) for a in
                           _attention_inputs(b, sq, sk, hq, hkv, dh, 50))
    want = _one_piece_attention(q, k, v, qpos, kpos, causal, window)
    for chunk, q_block in [(32, 2048), (32, 48), (1024, 2048)]:
        got = attn.attention(q, k, v, q_positions=qpos, k_positions=kpos, causal=causal,
                             window=window, chunk=chunk, q_block=q_block)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("kind", ["reduced", "gqa"])
def test_dense_block(kind):
    jcfg, cfg, params, model = _setup(kind)
    b, s = 2, 80
    x = _x((b, s, cfg.d_model), 9)
    pj, pt = _positions(b, s)
    want, _, _ = japply_block(_layer0(params), jnp.asarray(x), jcfg, "dense",
                              positions=pj, mode="train")
    got = model.blocks[0](torch.from_numpy(x), pt)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("kind,s", [("reduced", 24), ("gqa", 80)])
def test_apply_model(kind, s):
    jcfg, cfg, params, model = _setup(kind)
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    want, _, _ = japply_model(params, jcfg, jnp.asarray(tokens), mode="train")
    got = apply_model(model, torch.from_numpy(tokens).long())
    assert got.shape == (2, s, cfg.vocab_size)
    # f32 through two blocks, the final norm and the tied head
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert (_np(got).argmax(-1) == np.asarray(want).argmax(-1)).mean() > 0.99


def test_from_jax_params_carries_every_parameter():
    jcfg, cfg, params, model = _setup("gqa")
    stacked = params["decoder"]["blocks"][0]
    blk = model.blocks[1]
    np.testing.assert_array_equal(_np(blk.attn.wk), np.asarray(stacked["attn"]["wk"][1]))
    np.testing.assert_array_equal(_np(blk.mlp.wg), np.asarray(stacked["mlp"]["wg"][1]))
    np.testing.assert_array_equal(_np(model.embed), np.asarray(params["embed"]))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())
    # bf16 parameters carry across exactly
    bcfg = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    bparams = jinit_params(_cfgs("gqa")[0].replace(param_dtype="bfloat16"),
                           jax.random.PRNGKey(1))
    bmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, bparams), bcfg, "cpu")
    assert bmodel.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(bmodel.embed.float()),
                                  np.asarray(bparams["embed"]).astype(np.float32))


def test_init_params_shapes_and_scales_match_the_reference():
    jcfg, cfg, params, model = _setup("gqa")
    ours = init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    assert [p.shape for p in ours.parameters()] == [p.shape for p in model.parameters()]
    blk = ours.blocks[0]
    d = cfg.d_model
    assert abs(float(blk.attn.wq.std()) - d ** -0.5) < 0.05 * d ** -0.5
    assert abs(float(blk.mlp.wo.std()) - cfg.d_ff ** -0.5) < 0.05 * cfg.d_ff ** -0.5
    assert abs(float(ours.embed.std()) - 0.02) < 0.002
    assert torch.all(blk.attn.q_scale == 1) and torch.all(blk.ln1.scale == 1)
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.blocks[1].mlp.wi, ours.blocks[1].mlp.wi)


def test_other_block_types_and_modes_name_their_slice():
    _, cfg = _cfgs("reduced")
    # the encoder-decoder and VLM blocks are ported: an enc block is a
    # bidirectional dense block, decx adds lnx and an ungated xattn, xattn
    # a gated cross-attention in place of the self-attention
    enc, decx, xattn = (make_block(cfg, bt) for bt in ("enc", "decx", "xattn"))
    assert not enc.causal and decx.causal and decx.xattn.gate is None
    assert xattn.xattn.gate is not None and xattn.xattn.gate.dim() == 0
    assert {n.split(".")[0] for n, _ in decx.named_parameters()} == {
        "ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    assert {n.split(".")[0] for n, _ in xattn.named_parameters()} == {"ln1", "xattn", "ln2",
                                                                       "mlp"}
    with pytest.raises(ValueError, match="unknown block type"):
        make_block(cfg, "conv")
    # the moe block is ported: it builds, and its train mode runs and
    # appends its load-balance loss
    moe_cfg = cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, d_expert=32))
    blk = make_block(moe_cfg, "moe")
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.05)
    aux = []
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    out = blk(x, torch.arange(5).expand(2, 5), aux=aux)
    assert out.shape == x.shape and bool(torch.isfinite(out).all()) and len(aux) == 1
    # decode over an int8 KV cache is ported: prefill packs codes and
    # scales, decode writes the token's and reads them back
    model = init_params(cfg.replace(kv_quant_bits=8), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with torch.inference_mode():
        _, cache = apply_model(model, tokens, mode="prefill", attn_len=6)
        assert cache[0]["k"].dtype == torch.int8
        logits, cache = apply_model(model, tokens[:, :1], mode="decode", cache=cache, idx=4)
        assert bool(torch.isfinite(logits).all()) and int(cache[0]["pos"][0, 4]) == 4
        assert float(cache[0]["k_scale"][0, 4].min()) > 0
