"""Parity of the port's encoder-decoder and VLM stacks with the JAX
reference on the CPU: seamless-m4t-large-v2 (an encoder of ``"enc"``
layers over the stubbed frontend's frames, ``"decx"`` decoder layers:
self-attention, then ungated cross-attention over the encoder's output)
and llama-3.2-vision-90b (every 5th layer an ``"xattn"`` layer: tanh-gated
cross-attention over the stubbed image patches). Configs field for field
and the registry; ``cross_attention`` gated and ungated; each new block in
train, prefill and decode; ``apply_model``, prefill and 3 decode steps of
each reduced arch; ``loss_fn`` and its gradients; weights and caches both
ways; the cost and split tables; the serving entry.

The gate starts at zero, so at init an ``"xattn"`` layer adds nothing, and
zero ``aux_embeds`` give seamless a zero context (the LayerNorm of zeros
is its bias, 0): every case here sets each gate from N(0, 1) in the shared
numpy parameters and draws ``aux_embeds`` from the seed. Weights come from
the reference's initializers through ``repro_torch.weights``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro.models.blocks import apply_block as japply_block
from repro_torch.configs import (ALL_ARCHS, ARCH_IDS, INPUT_SHAPES, all_configs, get_config,
                                 reduced)
from repro_torch.core import overhead as oh
from repro_torch.core import split
from repro_torch.launch import collab_serve
from repro_torch.launch.serve import cache_bytes, serve
from repro_torch.models import (apply_model, cache, decode_step, init_params, layer_plan,
                                loss_fn, prefill)
from repro_torch.models import attention as attn
from repro_torch.weights import (cache_from_jax, from_jax_params, reference_leaves,
                                 to_reference_tree)

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ARCHS = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
# reduced seamless: 2 decoder and 2 encoder layers over 16 frames; reduced
# llama keeps its 5-layer pattern: 4 dense layers and one xattn
N_LAYERS = {"seamless-m4t-large-v2": 2, "llama-3.2-vision-90b": 5}

_jprefill = jax.jit(jmodel.prefill, static_argnums=1, static_argnames="attn_len")
_jdecode = jax.jit(jmodel.decode_step, static_argnums=1)
_japply = jax.jit(jmodel.apply_model, static_argnums=1)
_jvalue_and_grad = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True), static_argnums=1)


def _f(t):
    return t.detach().float().numpy()


def with_gates(tree, seed=5):
    """``tree`` (numpy leaves) with every ``gate`` leaf drawn from N(0, 1)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (rng.standard_normal(np.shape(v)).astype(np.asarray(v).dtype)
                        if k == "gate" else walk(v)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return np.asarray(t)
    return walk(tree)


_SETUPS = {}


def _setup(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params with drawn gates, port model)."""
    key = (arch, dtype)
    if key not in _SETUPS:
        kw = dict(param_dtype=dtype, compute_dtype=dtype)
        jcfg = jreduced(jget_config(arch), n_layers=N_LAYERS[arch]).replace(**kw)
        cfg = reduced(get_config(arch), n_layers=N_LAYERS[arch]).replace(**kw)
        tree = with_gates(jax.tree_util.tree_map(np.asarray,
                                                 jmodel.init_params(jcfg, jax.random.PRNGKey(0))))
        model = from_jax_params(tree, cfg, "cpu").requires_grad_(False)
        _SETUPS[key] = (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree), model)
    return _SETUPS[key]


def _aux(cfg, b, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


# ------------------------------------------------------------------ configs
def test_the_registry_holds_every_arch_of_the_reference():
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    assert "qwen2-7b-kv8" in ALL_ARCHS and "qwen2-7b-kv8" not in ARCH_IDS
    assert tuple(all_configs()) == ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JINPUT_SHAPES.items()}
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_layers", [None, 2, 7])
def test_configs_match_the_reference_field_for_field(arch, n_layers):
    jc, tc = jget_config(arch), get_config(arch)
    if n_layers:
        jc, tc = jreduced(jc, n_layers=n_layers), reduced(tc, n_layers=n_layers)
        assert tc.n_aux_tokens == 16 and tc.n_layers == max(n_layers, len(tc.block_pattern))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.block_types() == tc.block_types() and jc.head_dim == tc.head_dim
    assert jmodel.layer_plan(jc) == layer_plan(tc)


def test_the_reduced_configs_keep_their_families():
    sm = reduced(get_config("seamless-m4t-large-v2"))
    assert (sm.encoder.n_layers, sm.encoder.n_frames, sm.n_aux_tokens) == (2, 16, 16)
    assert sm.block_types() == ("decx", "decx") and sm.family == "encdec"
    lv = reduced(get_config("llama-3.2-vision-90b"))
    assert lv.block_types() == ("dense",) * 4 + ("xattn",) and lv.optimizer == "adafactor"


# ------------------------------------------------------------------ cross-attention
def _cross_pair(gated, seed):
    cfg = reduced(get_config("llama-3.2-vision-90b"))
    jcfg = jreduced(jget_config("llama-3.2-vision-90b"))
    p = jattn.init_attn(jax.random.PRNGKey(seed), jcfg, cross=gated)
    p = with_gates(jax.tree_util.tree_map(np.asarray, p), seed)
    layer = attn.Attention(cfg, cross=gated).requires_grad_(False)
    with torch.no_grad():
        for name, t in layer.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name])))
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, p), layer


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("s", [9, 1])
def test_cross_attention_matches_the_reference(gated, s):
    """From the context and from its precomputed k / v, at 9 queries and at
    one (the reference's decode form): within 1e-5; the gate, where there
    is one, scales the output by tanh(gate)."""
    jcfg, cfg, p, layer = _cross_pair(gated, seed=int(gated) + s)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, (jk, jv) = jattn.cross_attention(p, jnp.asarray(x), jcfg, context=jnp.asarray(ctx))
    got, (k, v) = attn.cross_attention(layer, torch.from_numpy(x), cfg,
                                       context=torch.from_numpy(ctx))
    np.testing.assert_allclose(_f(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f(k), np.asarray(jk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_f(v), np.asarray(jv), rtol=1e-6, atol=1e-6)
    again, _ = attn.cross_attention(layer, torch.from_numpy(x), cfg, kv=(k, v))
    assert torch.equal(again, got)
    pk, pv = attn.project_cross_kv(layer, torch.from_numpy(ctx), cfg)
    assert torch.equal(pk, k) and torch.equal(pv, v)
    assert (layer.gate is not None) == gated
    if gated:
        gate = float(layer.gate)
        assert gate != 0.0
        with torch.no_grad():
            layer.gate.zero_()
            zero, _ = attn.cross_attention(layer, torch.from_numpy(x), cfg, kv=(k, v))
            layer.gate.fill_(gate)
        assert float(zero.abs().max()) == 0.0
    with pytest.raises(ValueError, match="aux_embeds"):
        attn.cross_attention(layer, torch.from_numpy(x), cfg)


# ------------------------------------------------------------------ blocks
def _block_case(btype):
    """(jax cfg, port cfg, reference layer params, port block, context):
    the encoder's first layer over drawn frames, seamless's first decoder
    layer and llama's image layer over drawn contexts."""
    arch = "llama-3.2-vision-90b" if btype == "xattn" else "seamless-m4t-large-v2"
    jcfg, cfg, params, model = _setup(arch)
    first = lambda stack, j: jax.tree_util.tree_map(lambda a: a[0], stack["blocks"][j])
    if btype == "enc":
        return jcfg, cfg, first(params["encoder"], 0), model.encoder.blocks[0]
    j = 4 if btype == "xattn" else 0
    return jcfg, cfg, first(params["decoder"], j), model.blocks[j]


@pytest.mark.parametrize("btype", ["enc", "decx", "xattn"])
def test_blocks_match_the_reference_in_every_mode(btype):
    """Train and prefill over 12 tokens, then one decode step from the
    prefill's entry: outputs within 1e-5 and every cache leaf within 1e-5
    (the encoder layer runs in train mode only and keeps no entry)."""
    jcfg, cfg, p, blk = _block_case(btype)
    rng = np.random.default_rng(11)
    b, s = 2, 12
    x = rng.standard_normal((b, s + 1, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((b, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(positions=jnp.asarray(pos), context=jnp.asarray(ctx))
    tpos, tctx = torch.from_numpy(pos.copy()), torch.from_numpy(ctx)
    want, _, _ = japply_block(p, jnp.asarray(x[:, :s]), jcfg, btype, mode="train", **kw)
    with torch.inference_mode():
        got = blk(torch.from_numpy(x[:, :s]), tpos, context=tctx)
    np.testing.assert_allclose(_f(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    if btype == "enc":
        return
    want, jentry, _ = japply_block(p, jnp.asarray(x[:, :s]), jcfg, btype, mode="prefill",
                                   attn_len=s + 1, **kw)
    with torch.inference_mode():
        got, entry = blk(torch.from_numpy(x[:, :s]), tpos, mode="prefill", attn_len=s + 1,
                         context=tctx)
    np.testing.assert_allclose(_f(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert sorted(entry) == sorted(jentry)
    assert sorted(entry) == (["ck", "cv"] if btype == "xattn" else ["ck", "cv", "k", "pos", "v"])
    dpos = np.full((b, 1), s, np.int32)
    want, jentry, _ = japply_block(p, jnp.asarray(x[:, s:]), jcfg, btype, mode="decode",
                                   positions=jnp.asarray(dpos), cache=jentry, idx=jnp.int32(s))
    with torch.inference_mode():
        got, entry = blk(torch.from_numpy(x[:, s:]), torch.from_numpy(dpos), mode="decode",
                         cache=entry, idx=s)
    np.testing.assert_allclose(_f(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert sorted(entry) == sorted(jentry)
    for name, t in entry.items():
        np.testing.assert_allclose(_f(t), np.asarray(jentry[name]).astype(np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------------------------------ the slice
def _ref_layers(tree, cfg):
    pattern, n_groups, _ = layer_plan(cfg)
    n = len(pattern)
    return [{k: np.asarray(a)[i // n] for k, a in tree["blocks"][i % n].items()}
            if i < n_groups * n else
            {k: np.asarray(a) for k, a in tree["tail"][i - n_groups * n].items()}
            for i in range(cfg.n_layers)]


def _assert_cache_close(got, want, cfg, tol):
    ref = _ref_layers(want, cfg)
    assert len(got) == len(ref) == cfg.n_layers
    for i, (entry, w) in enumerate(zip(got, ref)):
        assert sorted(entry) == sorted(w), i
        for name, t in entry.items():
            np.testing.assert_allclose(_f(t), w[name].astype(np.float32), rtol=tol, atol=tol,
                                       err_msg=f"{i} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_model_prefill_and_decode_match_the_reference(arch):
    """Train-mode logits, then prefill + 3 decode steps against the
    reference's on the same params, tokens and drawn aux_embeds, in f32:
    logits and every cache leaf within 1e-4 (the zoo's bound). The decode
    reads the context's K/V from the cache: no aux_embeds."""
    jcfg, cfg, params, model = _setup(arch)
    p_len, n = 24, 3
    toks = _tokens(cfg, (2, p_len + n), seed=1)
    aux = _aux(cfg, 2)
    jl, _, _ = _japply(params, jcfg, jnp.asarray(toks[:, :p_len]), aux_embeds=jnp.asarray(aux))
    with torch.inference_mode():
        tl = apply_model(model, torch.from_numpy(toks[:, :p_len]).long(),
                         aux_embeds=torch.from_numpy(aux))
    np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jl, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + n + 1,
                       aux_embeds=jnp.asarray(aux))
    with torch.inference_mode():
        tl, tc = prefill(model, torch.from_numpy(toks[:, :p_len]).long(),
                         attn_len=p_len + n + 1, aux_embeds=torch.from_numpy(aux))
        np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
        _assert_cache_close(tc, jc, cfg, 1e-4)
        for i in range(n):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            assert tl.shape == (2, cfg.vocab_size)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
            _assert_cache_close(tc, jc, cfg, 1e-4)
    xattn = [i for i, bt in enumerate(cfg.block_types()) if bt in ("xattn", "decx")]
    assert xattn and all(tuple(tc[i]["ck"].shape[1:3]) == (16, cfg.n_kv_heads) for i in xattn)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_from_a_cache_the_reference_prefilled(arch):
    jcfg, cfg, params, model = _setup(arch)
    p_len = 20
    toks = _tokens(cfg, (2, p_len + 2), seed=2)
    _, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + 2,
                      aux_embeds=jnp.asarray(_aux(cfg, 2, seed=4)))
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), cfg, "cpu")
    _assert_cache_close(tc, jc, cfg, 0.0)
    with torch.inference_mode():
        for i in range(2):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _assert_cache_close(tc, jc, cfg, 1e-4)


def test_a_missing_context_is_named():
    """A VLM or encoder-decoder prefill, forward or loss without aux_embeds
    raises a ValueError naming it; the split forward refuses both."""
    for arch in ARCHS:
        _, cfg, _, model = _setup(arch)
        toks = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(ValueError, match="aux_embeds"):
            prefill(model, toks, attn_len=6)
        with pytest.raises(ValueError, match="aux_embeds"):
            loss_fn(model, {"tokens": toks, "labels": toks})
        with pytest.raises(ValueError, match="aux_embeds"):
            collab_serve.serve(cfg, device="cpu", requests=1, batch=1, seq=8, log=lambda _: None)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    """``loss_fn`` with drawn aux_embeds and nonzero gates: the loss and its
    metrics within 1e-5 relative, and every parameter's gradient (the
    encoder's, the gates' and the lnx norms' among them) within 1e-4 of
    its leaf's largest, the bound of tests/test_torch_loss.py (f32 through
    the same products summed in other orders)."""
    jcfg, cfg, params, _ = _setup(arch)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[rng.random((2, 16)) < 0.25] = -100
    aux = _aux(cfg, 2, seed=8)
    (want, wm), wgrads = _jvalue_and_grad(params, jcfg, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "aux_embeds": jnp.asarray(aux)})
    loss, metrics = loss_fn(model, {"tokens": torch.from_numpy(tokens).long(),
                                    "labels": torch.from_numpy(labels),
                                    "aux_embeds": torch.from_numpy(aux)})
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(wm[k]), rtol=1e-5, atol=1e-7)
    params_ = list(model.parameters())
    grads = torch.autograd.grad(loss, params_)
    leaves = reference_leaves(model)
    assert sum(len(leaf.index) for leaf in leaves) == len(params_)
    names = set()      # every key on the leaves' paths
    for leaf in leaves:
        w = np.asarray(_at(wgrads, leaf.path), np.float64)
        g = np.stack([grads[i].double().numpy() for i in leaf.index]) if leaf.stacked \
            else grads[leaf.index[0]].double().numpy()
        assert g.shape == w.shape, leaf.path
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (leaf.path, err, np.abs(w).max())
        names.update(leaf.path)
        if leaf.path[-1] == "gate":
            assert np.abs(w).min() > 0
    assert {"gate"} <= names if arch == "llama-3.2-vision-90b" else {"lnx", "encoder"} <= names


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_over_both_ways(arch):
    """The reference's params into the port and back, leaf for leaf and bit
    for bit, in f32 and bf16: the encoder stack with its own ln_f, the
    gates and the lnx norms."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg, params, model = _setup(arch, dtype)
        back = jax.tree_util.tree_leaves_with_path(to_reference_tree(model))
        want = dict(jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, params)))
        assert len(back) == len(want)
        for path, t in back:
            w = want[path]
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype), path
            np.testing.assert_array_equal(_f(t), w.astype(np.float32), err_msg=str(path))
        again = from_jax_params(dict(to_reference_tree(model)), cfg, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))
    if arch == "seamless-m4t-large-v2":
        assert params["encoder"]["blocks"][0]["attn"]["wq"].shape[0] == cfg.encoder.n_layers
        assert "gate" not in params["decoder"]["blocks"][0]["xattn"]
        assert model.blocks[0].xattn.gate is None and model.encoder.ln_f.bias is not None
    else:
        assert params["decoder"]["blocks"][4]["xattn"]["gate"].shape == (1,)


def test_init_params_draws_zero_gates_and_the_reference_shapes():
    for arch in ARCHS:
        cfg = reduced(get_config(arch), n_layers=N_LAYERS[arch])
        jcfg = jreduced(jget_config(arch), n_layers=N_LAYERS[arch])
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        shapes = {p: tuple(t.shape) for p, t in
                  jax.tree_util.tree_leaves_with_path(to_reference_tree(model))}
        want = {p: a.shape for p, a in jax.tree_util.tree_leaves_with_path(
            jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0)))}
        assert shapes == want
        for name, p in model.named_parameters():
            if name.endswith(".gate"):
                assert p.dim() == 0 and float(p.detach()) == 0.0


# ------------------------------------------------------------------ entry
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_end_to_end_on_the_cpu(arch):
    """The reference's zero aux_embeds by default; drawn ones move the
    generated logits (a nonzero context)."""
    cfg = reduced(get_config(arch), n_layers=N_LAYERS[arch])
    res = serve(cfg, device="cpu", batch=2, prompt_len=20, gen=4, requests=1, seed=1,
                log=lambda _: None)
    st = res.stats[0]
    assert st["tokens"].shape == (2, 4) and st["logits_finite"]
    want = sum(cache.entry_payload_bits(cfg, bt, 2, 24) for bt in cfg.block_types()) // 8
    assert st["cache_bytes"] == cache_bytes(res.cache) == want
    xcache = [e for e, bt in zip(res.cache, cfg.block_types()) if bt in ("xattn", "decx")]
    assert xcache and all(e["ck"].shape[:2] == (2, 16) for e in xcache)


# ------------------------------------------------------------------ tables
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_costs_and_payload_bits_match_the_reference(arch):
    for n_layers in (None, 7):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if n_layers:
            cfg, jcfg = reduced(cfg, n_layers=n_layers), jreduced(jcfg, n_layers=n_layers)
        for s in (1, 64, 2048):
            for got, want in ((oh.layer_costs(cfg, s), joh.layer_costs(jcfg, s)),
                              (oh.decode_layer_costs(cfg, s), joh.decode_layer_costs(jcfg, s))):
                assert len(got) == len(want) == cfg.n_layers
                assert got == want
            for bt in set(cfg.block_types()) | {"dense", "enc", "xattn"}:
                for batch in (1, 4):
                    assert (cache.entry_payload_bits(cfg, bt, batch, s)
                            == jcache.entry_payload_bits(jcfg, bt, batch, s)), (bt, s)
                    assert (cache.entry_shape(cfg, bt, batch, s)
                            == {k: (sh, getattr(torch, str(np.dtype(dt))))
                                for k, (sh, dt) in jcache.entry_shape(jcfg, bt, batch, s).items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_split_tables_match_the_reference(arch):
    """The family extras: raw input bits, the encoder's FLOPs on the UE, the
    AE'd image embeddings while an image layer lies at or past the split,
    the encoder output at every split."""
    for batch in (1, 2):
        cfg, jcfg = get_config(arch), jget_config(arch)
        tables = [(split.transformer_split_table(cfg, batch=batch),
                   jsplit.transformer_split_table(jcfg, batch=batch))]
        tables += [(split.llm_decode_split_table(cfg, ctx, batch=batch),
                    jsplit.llm_decode_split_table(jcfg, ctx, batch=batch)) for ctx in (256, 4096)]
        for got, want in tables:
            assert (got.name, got.points, got.device) == (want.name, want.points, want.device)
            for field in ("t_local", "e_local", "t_comp", "e_comp", "f_bits"):
                _close(getattr(got, field), getattr(want, field))
            np.testing.assert_array_equal(np.asarray(got.feasible), np.asarray(want.feasible))
