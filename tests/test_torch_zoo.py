"""Parity of the port's model zoo with the JAX reference on the CPU: the
dense archs stablelm-1.6b (LayerNorm, a quarter of each head roped, MHA),
phi4-mini-3.8b (G = 3, three quarters roped), qwen2-7b (G = 7, QKV bias),
qwen2-7b-kv8 (the int8 KV cache) and the hybrid recurrentgemma-9b (RG-LRU
and local attention over a window ring, a tail of two ``"rec"`` layers
past the last whole group). Configs field for field; the RG-LRU mixer;
prefill and decode steps of each reduced arch (the reduced configs keep at
most 4 heads, so G = 3 and 7 come from a head override); the weight and
cache carry-over both ways; the cost tables. Inputs are made with numpy
from a seed; weights come from the reference's ``init_params`` through
``repro_torch.weights``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro_torch.configs import ALL_ARCHS, ARCH_IDS, get_config, reduced
from repro_torch.core import overhead as oh
from repro_torch.core import split
from repro_torch.launch.serve import cache_bytes, serve
from repro_torch.models import cache, decode_step, init_params, layer_plan, prefill, rglru
from repro_torch.weights import (cache_from_jax, from_jax_params, reference_decay_mask,
                                 to_reference_tree)

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ZOO = ("stablelm-1.6b", "phi4-mini-3.8b", "qwen2-7b", "qwen2-7b-kv8", "recurrentgemma-9b")
# the reduced configs keep at most 4 heads; these keep each arch's G
HEADS = {"phi4-mini-3.8b": dict(n_heads=6, n_kv_heads=2, d_head=32),
         "qwen2-7b": dict(n_heads=7, n_kv_heads=1, d_head=32),
         "qwen2-7b-kv8": dict(n_heads=7, n_kv_heads=1, d_head=32)}
N_LAYERS = {"recurrentgemma-9b": 5}   # one (rec, rec, lattn) group and a (rec, rec) tail


def test_the_registry_holds_the_zoo():
    assert set(ZOO) <= set(ALL_ARCHS) and "qwen2-7b-kv8" not in ARCH_IDS
    assert set(ARCH_IDS) == ({"qwen3-1.7b", "mamba2-1.3b", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
                              "seamless-m4t-large-v2", "llama-3.2-vision-90b"}
                             | set(ZOO) - {"qwen2-7b-kv8"})


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("n_layers", [None, 2, 5])
def test_configs_match_the_reference_field_for_field(arch, n_layers):
    jc, tc = jget_config(arch), get_config(arch)
    if n_layers:
        jc, tc = jreduced(jc, n_layers=n_layers), reduced(tc, n_layers=n_layers)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.block_types() == tc.block_types() and jc.head_dim == tc.head_dim
    assert jmodel.layer_plan(jc) == layer_plan(tc)


def test_recurrentgemma_has_twelve_groups_and_a_tail():
    cfg = get_config("recurrentgemma-9b")
    assert layer_plan(cfg) == (("rec", "rec", "lattn"), 12, ("rec", "rec"))
    assert cfg.n_heads // cfg.n_kv_heads == 16 and cfg.head_dim == 256 and cfg.window == 2048


# ------------------------------------------------------------------ RG-LRU
_SETUPS = {}


def _setup(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params, port model) at a reduced size."""
    key = (arch, dtype)
    if key not in _SETUPS:
        kw = dict(HEADS.get(arch, {}), param_dtype=dtype, compute_dtype=dtype)
        n = N_LAYERS.get(arch, 2)
        jcfg = jreduced(jget_config(arch), n_layers=n).replace(**kw)
        cfg = reduced(get_config(arch), n_layers=n).replace(**kw)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
        _SETUPS[key] = (jcfg, cfg, params, model.requires_grad_(False))
    return _SETUPS[key]


def _f(t):
    return t.detach().float().numpy()


def _mixer(seed=0):
    """The first rec layer's mixer of reduced recurrentgemma, on both sides,
    with ``lam`` and the biases drawn (the reference's init sets them
    constant), so the gates differ along the width."""
    jcfg, cfg, params, model = _setup("recurrentgemma-9b")
    jp = jax.tree_util.tree_map(lambda a: a[0], params["decoder"]["blocks"][0]["mixer"])
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    extra = {"lam": rng.uniform(-1.0, 2.0, d), "ba": rng.normal(0, 0.5, d),
             "bi": rng.normal(0, 0.5, d)}
    jp = dict(jp, **{k: jnp.asarray(v, jnp.float32) for k, v in extra.items()})
    mixer = rglru.RGLRU(cfg)
    with torch.no_grad():
        for name, p in mixer.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(jp[name]).astype(np.float32)))
    return jcfg, cfg, jp, mixer.requires_grad_(False)


@pytest.mark.parametrize("seq", [1, 2, 5, 37, 130])
def test_apply_rglru_matches_the_reference(seq):
    """The log-step scan against ``jax.lax.associative_scan`` (f32, other
    summation trees: 1e-5), with no state (the conv state zero-padded where
    L < 3) and from a state."""
    jcfg, cfg, jp, mixer = _mixer(seq)
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32),
          "h": rng.standard_normal((2, cfg.d_model)).astype(np.float32)}
    for state in (None, st):
        jout, jst = jrglru.apply_rglru(jp, jnp.asarray(x), jcfg, state=None if state is None
                                       else {k: jnp.asarray(v) for k, v in state.items()})
        out, tst = rglru.apply_rglru(mixer, torch.from_numpy(x), cfg, state=None if state is None
                                     else {k: torch.from_numpy(v) for k, v in state.items()})
        np.testing.assert_allclose(_f(out), np.asarray(jout), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f(tst["conv"]), np.asarray(jst["conv"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_f(tst["h"]), np.asarray(jst["h"]), rtol=1e-5, atol=1e-5)
        assert tst["h"].dtype == torch.float32 and tst["conv"].shape == (2, 3, cfg.d_model)


def test_decode_rglru_matches_the_reference_and_the_sequence_form():
    jcfg, cfg, jp, mixer = _mixer(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    full, _ = rglru.apply_rglru(mixer, torch.from_numpy(x), cfg)
    _, tst = rglru.apply_rglru(mixer, torch.from_numpy(x[:, :6]), cfg)
    _, jst = jrglru.apply_rglru(jp, jnp.asarray(x[:, :6]), jcfg)
    for i in range(6, 9):
        jout, jst = jrglru.decode_rglru(jp, jnp.asarray(x[:, i:i + 1]), jcfg, jst)
        out, tst = rglru.decode_rglru(mixer, torch.from_numpy(x[:, i:i + 1]), cfg, tst)
        np.testing.assert_allclose(_f(out), np.asarray(jout), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f(tst["h"]), np.asarray(jst["h"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f(tst["conv"]), np.asarray(jst["conv"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_f(out[:, 0]), _f(full[:, i]), rtol=1e-5, atol=1e-5)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 77, 4)))
    b = torch.from_numpy(rng.standard_normal((3, 77, 4)))
    h, want = torch.zeros(3, 4, dtype=torch.float64), []
    for t in range(77):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------------------ the slice
_jprefill = jax.jit(jmodel.prefill, static_argnums=1, static_argnames="attn_len")
_jdecode = jax.jit(jmodel.decode_step, static_argnums=1)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _ref_layers(tree, cfg):
    """The reference cache tree as one dict of numpy leaves a layer."""
    pattern, n_groups, _ = layer_plan(cfg)
    n = len(pattern)
    out = []
    for i in range(cfg.n_layers):
        if i < n_groups * n:
            out.append({k: np.asarray(a)[i // n] for k, a in tree["blocks"][i % n].items()})
        else:
            out.append({k: np.asarray(a) for k, a in tree["tail"][i - n_groups * n].items()})
    return out


def _assert_cache_close(got, want, cfg, tol):
    """Every leaf within ``tol``; int8 codes within one code, where a value
    that lands half a code from a level may round either way, and equal
    almost everywhere."""
    ref = _ref_layers(want, cfg)
    assert len(got) == len(ref) == cfg.n_layers
    for i, (entry, want_entry) in enumerate(zip(got, ref)):
        assert sorted(entry) == sorted(want_entry), i
        for name, t in entry.items():
            w = want_entry[name]
            if t.dtype == torch.int8:
                diff = np.abs(t.numpy().astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (i, name)
            else:
                np.testing.assert_allclose(_f(t), w.astype(np.float32), rtol=tol, atol=tol,
                                           err_msg=f"{i} {name}")


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_steps_match_the_reference(arch):
    """Port prefill + 3 decode steps against JAX prefill + decode_step on
    the same params and tokens, in f32: logits and every cache leaf within
    1e-4 (the bound of the qwen3 and mamba2 cases). recurrentgemma's prompt
    (80) is longer than its 64-slot window, so prefill wraps the ring and
    decode reads a wrapped ring; qwen2-7b-kv8's cache holds int8 codes and
    their scales."""
    jcfg, cfg, params, model = _setup(arch)
    p_len, n = (80, 3) if cfg.window else (40, 3)
    toks = _tokens(cfg, (2, p_len + n), seed=1)
    with torch.inference_mode():
        jl, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + n + 1)
        tl, tc = prefill(model, torch.from_numpy(toks[:, :p_len]).long(), attn_len=p_len + n + 1)
        np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
        _assert_cache_close(tc, jc, cfg, 1e-4)
        for i in range(n):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            assert tl.shape == (2, cfg.vocab_size)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
            _assert_cache_close(tc, jc, cfg, 1e-4)
    if arch == "qwen2-7b-kv8":
        assert tc[0]["k"].dtype == torch.int8 and tc[0]["k_scale"].dtype == torch.float32
    if arch == "recurrentgemma-9b":
        ring = tc[2]["pos"]
        assert ring.shape == (2, cfg.window) and int(ring.min()) == p_len + n - cfg.window


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen2-7b-kv8"])
def test_decode_continues_from_a_cache_the_reference_prefilled(arch):
    jcfg, cfg, params, model = _setup(arch)
    p_len = 70
    toks = _tokens(cfg, (2, p_len + 2), seed=2)
    _, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + 2)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), cfg, "cpu")
    _assert_cache_close(tc, jc, cfg, 0.0)
    with torch.inference_mode():
        for i in range(2):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _assert_cache_close(tc, jc, cfg, 1e-4)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "phi4-mini-3.8b"])
def test_weights_carry_over_both_ways(arch):
    """The reference's params into the port and back, leaf for leaf and bit
    for bit, also in bf16 (the RG-LRU's ba, bi and lam stay float32)."""
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
    _, cfg, _, model = _setup(arch, "bfloat16")
    if cfg.window:
        mixer = model.blocks[0].mixer
        assert {mixer.ba.dtype, mixer.bi.dtype, mixer.lam.dtype} == {torch.float32}
        assert mixer.wx.dtype == torch.bfloat16


def test_the_decay_mask_names_the_slice_for_a_tail():
    _, cfg, params, model = _setup("recurrentgemma-9b")
    # the tail's layers are unstacked in the reference: their 1-D leaves
    # (norm scales, biases, lam) are not decayed, their matrices are
    names = [n for n, _ in model.named_parameters()]
    mask = dict(zip(names, reference_decay_mask(model)))
    tail = params["decoder"]["tail"]
    assert len(tail) == 2 and cfg.n_layers == 5
    for t, layer in enumerate(tail):
        for sub, leaves in layer.items():
            for leaf, a in leaves.items():
                assert mask[f"blocks.{3 + t}.{sub}.{leaf}"] == (np.ndim(a) >= 2), (t, sub, leaf)
    assert mask["blocks.0.ln1.scale"] and not mask["blocks.3.ln1.scale"]
    # whole groups only: every block parameter is stacked, so decayed
    whole = init_params(cfg.replace(n_layers=6), torch.Generator().manual_seed(0), "cpu")
    mask = reference_decay_mask(whole)
    names = [n for n, _ in whole.named_parameters()]
    assert [n for n, d in zip(names, mask) if not d] == [n for n in names
                                                         if n.startswith("ln_f.")]


def test_init_params_draws_the_rglru_as_the_reference():
    cfg = get_config("recurrentgemma-9b").replace(n_layers=3, d_model=512, n_heads=2,
                                                  d_ff=64, vocab_size=64)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    mixer = model.blocks[0].mixer
    assert torch.all(mixer.lam == 0.3) and torch.all(mixer.ba == 0) and torch.all(mixer.bi == 0)
    assert {mixer.ba.dtype, mixer.bi.dtype, mixer.lam.dtype} == {torch.float32}
    assert mixer.wa.dtype == torch.bfloat16 and torch.all(mixer.conv_b == 0)
    assert abs(float(mixer.conv_w.float().std()) - 0.5) < 0.02         # fan-in 4
    assert abs(float(mixer.wa.float().std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert model.blocks[2].window == cfg.window and model.blocks[0].__class__.__name__ == "RecBlock"


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen2-7b-kv8"])
def test_serve_runs_end_to_end_on_the_cpu(arch):
    cfg = reduced(get_config(arch), n_layers=N_LAYERS.get(arch, 2))
    res = serve(cfg, device="cpu", batch=2, prompt_len=70, gen=4, requests=1, seed=1,
                log=lambda _: None)
    st = res.stats[0]
    assert st["tokens"].shape == (2, 4) and st["logits_finite"]
    want = sum(cache.entry_payload_bits(cfg, bt, 2, 74) for bt in cfg.block_types()) // 8
    assert st["cache_bytes"] == cache_bytes(res.cache) == want


# ------------------------------------------------------------------ tables
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("arch", ZOO)
def test_layer_costs_and_payload_bits_match_the_reference(arch):
    for n_layers in (None, 5):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if n_layers:
            cfg, jcfg = reduced(cfg, n_layers=n_layers), jreduced(jcfg, n_layers=n_layers)
        for s in (1, 64, 2048, 4096):
            for got, want in ((oh.layer_costs(cfg, s), joh.layer_costs(jcfg, s)),
                              (oh.decode_layer_costs(cfg, s), joh.decode_layer_costs(jcfg, s))):
                assert len(got) == len(want) == cfg.n_layers
                for g, w in zip(got, want):
                    assert g == w
            for bt in set(cfg.block_types()):
                for batch in (1, 4):
                    assert (cache.entry_payload_bits(cfg, bt, batch, s)
                            == jcache.entry_payload_bits(jcfg, bt, batch, s)), (bt, s)


@pytest.mark.parametrize("arch", ZOO)
def test_split_tables_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tables = [(split.transformer_split_table(cfg), jsplit.transformer_split_table(jcfg))]
    tables += [(split.llm_decode_split_table(cfg, ctx), jsplit.llm_decode_split_table(jcfg, ctx))
               for ctx in (256, 4096)]
    for got, want in tables:
        assert (got.name, got.points, got.device) == (want.name, want.points, want.device)
        for field in ("t_local", "e_local", "t_comp", "e_comp", "f_bits"):
            _close(getattr(got, field), getattr(want, field))
        np.testing.assert_array_equal(np.asarray(got.feasible), np.asarray(want.feasible))
