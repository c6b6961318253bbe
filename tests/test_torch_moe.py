"""Parity of the port's mixture-of-experts stack with the JAX reference on
the CPU: qwen3-moe-30b-a3b (128 experts, top-8) and kimi-k2-1t-a32b (384
experts, top-8, one shared expert). Configs field for field; ``apply_moe``
against the reference's single-device ``_apply_moe_global`` with and
without dropped assignments; the routing integers (top-e ids, counts,
ranks, the kept mask) held exactly against the same steps in ``jnp``;
prefill and decode of each reduced arch (G 8 kept by a head override for
qwen3-moe, whose reduced config would have 4 query on 4 KV heads), also
with decode drops; ``loss_fn`` with the aux term and its gradients; the
weight and cache carry-over; the cost and split tables; both serving
entry points. Inputs are made with numpy from a seed; weights come from
the reference's initializers through ``repro_torch.weights``.

Near-ties in top-k: where a token's k-th and (k+1)-th router
probabilities lie closer than the two packages' rounding, an expert could
flip and move a whole expert's contribution. Every case asserts that the
least such gap in its inputs is at least ``MIN_GAP``, some hundred times
the f32 differences of the two routers, so no flip can occur and no
tolerance has to absorb one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import reduced as jreduced
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import ARCH_IDS, ModelConfig, MoEConfig, get_config, reduced
from repro_torch.core import overhead as oh
from repro_torch.core import split
from repro_torch.launch import collab_serve
from repro_torch.launch.serve import cache_bytes, serve
from repro_torch.models import cache, decode_step, init_params, layer_plan, loss_fn, prefill
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.weights import (cache_from_jax, from_jax_params, reference_decay_mask,
                                 to_reference_tree)

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

MOE = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
# reduced qwen3-moe keeps 4 query on 4 KV heads; this keeps its G = 8
HEADS = {"qwen3-moe-30b-a3b": dict(n_heads=8, n_kv_heads=1, d_head=32)}
MIN_GAP = 1e-5

_japply_moe = jax.jit(jmoe._apply_moe_global, static_argnums=2)
_jprefill = jax.jit(jmodel.prefill, static_argnums=1, static_argnames="attn_len")
_jdecode = jax.jit(jmodel.decode_step, static_argnums=1)
_jvalue_and_grad = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True), static_argnums=1)


def _f(t):
    return t.detach().float().numpy()


def _with_cf(cfg, cf):
    return cfg if cf is None else cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _least_gap(probs, k):
    """The least gap between a token's k-th and (k+1)-th probability."""
    top = torch.topk(probs.detach(), k + 1, dim=-1).values
    return float((top[:, k - 1] - top[:, k]).min())


# ------------------------------------------------------------------ configs
def test_the_registry_holds_the_moe_archs():
    assert set(MOE) <= set(ARCH_IDS)
    for arch in MOE:
        cfg = get_config(arch)
        assert cfg.family == "moe" and cfg.block_types() == ("moe",) * cfg.n_layers
        assert isinstance(cfg.moe, MoEConfig)
    qwen = get_config("qwen3-moe-30b-a3b")
    assert qwen.n_heads // qwen.n_kv_heads == 8 and qwen.n_layers == 48
    assert get_config("kimi-k2-1t-a32b").moe.n_shared_experts == 1


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("n_layers", [None, 2, 5])
def test_configs_match_the_reference_field_for_field(arch, n_layers):
    jc, tc = jget_config(arch), get_config(arch)
    if n_layers:
        jc, tc = jreduced(jc, n_layers=n_layers), reduced(tc, n_layers=n_layers)
        assert tc.moe.n_experts == 4 and tc.moe.capacity_factor == 4.0
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.block_types() == tc.block_types() and jc.head_dim == tc.head_dim
    assert jmodel.layer_plan(jc) == layer_plan(tc)


# ------------------------------------------------------------------ apply_moe
def _small(config_cls, moe_cls):
    """The reference test's own MoE (tests/test_mixers.py:101-108)."""
    return config_cls(name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                      d_ff=64, vocab_size=32, block_pattern=("moe",),
                      moe=moe_cls(n_experts=4, top_k=2, d_expert=16, capacity_factor=4.0),
                      param_dtype="float32", compute_dtype="float32")


def _moe_pair(arch, cf):
    """(jax cfg, port cfg, jax params, port MoE) of one reduced MoE layer."""
    if arch == "small":
        jc, tc = _small(JModelConfig, JMoEConfig), _small(ModelConfig, MoEConfig)
    else:
        jc, tc = jreduced(jget_config(arch), n_layers=2), reduced(get_config(arch), n_layers=2)
    jc, tc = _with_cf(jc, cf), _with_cf(tc, cf)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jc)
    layer = moe.MoE(tc).requires_grad_(False)
    with torch.no_grad():
        for name, t in layer.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name])))
    return jc, tc, p, layer


# (arch, capacity factor, (B, S), dropped assignments expected). x is
# 0.25 N(0, 1): the reference-init experts (fan-in E) give outputs of tens,
# where f32 rounding stays inside the absolute bounds below
MOE_CASES = [("small", None, (2, 5), False), ("small", 1.0, (2, 24), True),
             ("qwen3-moe-30b-a3b", None, (2, 24), False),
             ("qwen3-moe-30b-a3b", 1.25, (2, 24), True),
             ("qwen3-moe-30b-a3b", 1.0, (4, 40), True),
             ("qwen3-moe-30b-a3b", 1.0, (4, 1), True),
             ("kimi-k2-1t-a32b", None, (2, 24), False),
             ("kimi-k2-1t-a32b", 1.25, (2, 24), True),
             ("kimi-k2-1t-a32b", 1.0, (4, 1), True)]


@pytest.mark.parametrize("arch,cf,shape,drops", MOE_CASES)
def test_apply_moe_matches_the_reference(arch, cf, shape, drops):
    """Within 2e-4 with no drop (tests/test_mixers.py:124) and 2e-5 with
    drops; the aux loss within 1e-6. kimi's cases run its shared expert."""
    jc, tc, p, layer = _moe_pair(arch, cf)
    scale = 0.5 if arch == "small" else 0.25
    x = (scale * np.random.default_rng(1).standard_normal(
        shape + (tc.d_model,))).astype(np.float32)
    jout, jaux = _japply_moe(p, jnp.asarray(x), jc)
    with moe.routing_log() as log:
        out, aux = moe.apply_moe(layer, torch.from_numpy(x), tc)
    (r,) = log.calls
    assert _least_gap(r.probs, tc.moe.top_k) >= MIN_GAP
    assert (log.dropped_share() > 0) == drops
    assert out.shape == shape + (tc.d_model,) and out.dtype == torch.float32
    tol = 2e-5 if drops else 2e-4
    np.testing.assert_allclose(_f(out), np.asarray(jout), rtol=tol, atol=tol)
    assert abs(float(aux) - float(jaux)) <= 1e-6 and float(aux) > 0


def _jnp_routing(probs, k, cap):
    """The reference's routing steps (src/repro/models/moe.py:72-84) on the
    given f32 probabilities."""
    t = probs.shape[0]
    e = probs.shape[1]
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    e_flat = top_e.reshape(t * k)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    counts = jnp.zeros((e,), jnp.int32).at[e_flat].add(1)
    offsets = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k, dtype=jnp.int32) - offsets[e_sorted]
    return dict(top_p=top_p, top_e=top_e, order=order, expert=e_sorted, counts=counts,
                rank=rank, token=order // k, kept=rank < cap)


@pytest.mark.parametrize("t,e,k,cap", [(48, 4, 2, 24), (48, 4, 2, 7), (4, 4, 2, 1),
                                       (64, 128, 8, 5), (16, 384, 8, 1), (200, 16, 4, 30)])
def test_routing_integers_match_the_reference_exactly(t, e, k, cap):
    rng = np.random.default_rng(t + e + k + cap)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = _jnp_routing(jnp.asarray(probs), k, cap)
    got = moe.route(torch.from_numpy(probs), k, cap)
    assert _least_gap(got.probs, k) >= MIN_GAP
    for name in ("top_e", "order", "expert", "counts", "rank", "token", "kept"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(_f(got.top_p), np.asarray(want["top_p"]))
    assert int(got.counts.sum()) == t * k and got.cap == cap
    assert bool((~got.kept).any()) == bool((got.counts > cap).any())


def test_capacity_is_the_reference_formula():
    m = get_config("qwen3-moe-30b-a3b").moe
    assert moe.capacity(4, m) == 1               # decode at B = 4: ceil(0.3125)
    assert moe.capacity(8192, m) == 640          # prefill at (4, 2048)
    assert moe.capacity(1024, m) == 80           # split serving at (4, 256)
    assert moe.capacity(4, get_config("kimi-k2-1t-a32b").moe) == 1


# ------------------------------------------------------------------ the slice
_SETUPS = {}


def _setup(arch, dtype="float32", cf=None):
    """(jax cfg, port cfg, jax params, port model), 2 reduced layers."""
    key = (arch, dtype, cf)
    if key not in _SETUPS:
        kw = dict(HEADS.get(arch, {}), param_dtype=dtype, compute_dtype=dtype)
        jcfg = _with_cf(jreduced(jget_config(arch), n_layers=2).replace(**kw), cf)
        cfg = _with_cf(reduced(get_config(arch), n_layers=2).replace(**kw), cf)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
        _SETUPS[key] = (jcfg, cfg, params, model.requires_grad_(False))
    return _SETUPS[key]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _assert_cache_close(got, want, cfg, tol):
    assert len(got) == cfg.n_layers
    for i, entry in enumerate(got):
        ref = {k: np.asarray(a)[i] for k, a in want["blocks"][0].items()}
        assert sorted(entry) == sorted(ref) == ["k", "pos", "v"], i
        for name, t in entry.items():
            np.testing.assert_allclose(_f(t), ref[name].astype(np.float32), rtol=tol, atol=tol,
                                       err_msg=f"{i} {name}")


def _assert_no_near_tie(log, cfg):
    for r in log.calls:
        assert _least_gap(r.probs, cfg.moe.top_k) >= MIN_GAP


# (arch, capacity factor, batch, prompt, decode steps): the reduced
# configs' factor of 4.0 drops nothing; at 1.25 a batch of 4 has a decode
# capacity of 3 and the prompt's capacity drops too
SLICE_CASES = [("qwen3-moe-30b-a3b", None, 2, 40, 3), ("kimi-k2-1t-a32b", None, 2, 40, 3),
               ("qwen3-moe-30b-a3b", 1.25, 4, 24, 3)]


@pytest.mark.parametrize("arch,cf,batch,p_len,n", SLICE_CASES)
def test_prefill_and_decode_steps_match_the_reference(arch, cf, batch, p_len, n):
    """Port prefill + decode steps against JAX prefill + decode_step on the
    same params and tokens, in f32: logits and every cache leaf within 1e-4
    (the zoo's bound); in the capacity-1.25 case assignments are dropped at
    prefill and at decode, where the decode MoE routes the B tokens of the
    step."""
    jcfg, cfg, params, model = _setup(arch, cf=cf)
    toks = _tokens(cfg, (batch, p_len + n), seed=1)
    dropped = []
    with torch.inference_mode():
        jl, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + n + 1)
        with moe.routing_log() as log:
            tl, tc = prefill(model, torch.from_numpy(toks[:, :p_len]).long(),
                             attn_len=p_len + n + 1)
        _assert_no_near_tie(log, cfg)
        dropped.append(log.dropped_share())
        np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
        _assert_cache_close(tc, jc, cfg, 1e-4)
        for i in range(n):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            with moe.routing_log() as log:
                tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            _assert_no_near_tie(log, cfg)
            assert [r.cap for r in log.calls] == [moe.capacity(batch, cfg.moe)] * cfg.n_layers
            dropped.append(log.dropped_share())
            assert tl.shape == (batch, cfg.vocab_size)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
            _assert_cache_close(tc, jc, cfg, 1e-4)
    if cf is None:
        assert dropped == [0.0] * (n + 1)
    else:
        assert dropped[0] > 0 and max(dropped[1:]) > 0


@pytest.mark.parametrize("arch", MOE)
def test_decode_continues_from_a_cache_the_reference_prefilled(arch):
    jcfg, cfg, params, model = _setup(arch)
    p_len = 30
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


def _grad_pairs(model, grads):
    """(port parameter, reference gradient) for every parameter."""
    out = [(model.embed, grads["embed"])]
    if model.lm_head is not None:
        out.append((model.lm_head, grads["lm_head"]))
    stacked = grads["decoder"]["blocks"][0]
    for i, blk in enumerate(model.blocks):
        for sub, leaves in stacked.items():
            out += [(getattr(getattr(blk, sub), k), a[i]) for k, a in leaves.items()]
    out += [(getattr(model.ln_f, k), a) for k, a in grads["decoder"]["ln_f"].items()]
    return out


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_match_the_reference(arch):
    """``loss_fn`` with the MoE layers' aux term, its metrics within 1e-5
    relative and every parameter's gradient within 1e-4 of its leaf's
    largest, the bound of tests/test_torch_loss.py; the router's gradient
    comes through the combine weights and the aux term."""
    jcfg, cfg, params, _ = _setup(arch)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels[rng.random((2, 16)) < 0.25] = -100
    (want, wm), wgrads = _jvalue_and_grad(params, jcfg, {"tokens": jnp.asarray(tokens),
                                                         "labels": jnp.asarray(labels)})
    with moe.routing_log() as log:
        loss, metrics = loss_fn(model, {"tokens": torch.from_numpy(tokens).long(),
                                        "labels": torch.from_numpy(labels)})
    assert len(log.calls) == cfg.n_layers
    _assert_no_near_tie(log, cfg)
    assert float(metrics["aux"].detach()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(wm[k]), rtol=1e-5, atol=1e-7)
    pairs = _grad_pairs(model, jax.tree_util.tree_map(np.asarray, wgrads))
    assert len(pairs) == len(list(model.parameters()))
    got = torch.autograd.grad(loss, [p for p, _ in pairs])
    for (p, w), g in zip(pairs, got):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        err = np.abs(g.double().numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (tuple(p.shape), err, np.abs(w).max())


@pytest.mark.parametrize("arch", MOE)
def test_weights_carry_over_both_ways(arch):
    """The reference's params into the port and back, leaf for leaf and bit
    for bit, in f32 and bf16: stacked (G, E, d, f) expert leaves and the
    (G, d, E) router, which stays float32 in a bf16 model."""
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
    moe_tree = params["decoder"]["blocks"][0]["moe"]
    m = cfg.moe
    assert moe_tree["wi"].shape == (2, m.n_experts, cfg.d_model, m.d_expert)
    assert moe_tree["router"].shape == (2, cfg.d_model, m.n_experts)
    assert model.blocks[0].moe.router.dtype == torch.float32
    assert model.blocks[0].moe.wi.dtype == torch.bfloat16
    assert ("shared_wi" in moe_tree) == bool(m.n_shared_experts)
    assert all(reference_decay_mask(model)[:-1]) and not reference_decay_mask(model)[-1]


def test_init_params_draws_the_experts_as_the_reference():
    """Expert leaves take the reference's fan-in, their first axis E (a
    quirk of ``dense_init``, kept), drawn in slabs of experts; the router is
    drawn in f32."""
    cfg = get_config("qwen3-moe-30b-a3b").replace(n_layers=1, d_model=256, n_heads=2,
                                                   n_kv_heads=1, vocab_size=64,
                                                   moe=MoEConfig(n_experts=64, top_k=8,
                                                                 d_expert=96))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    layer = model.blocks[0].moe
    assert layer.router.dtype == torch.float32 and layer.wi.dtype == torch.bfloat16
    for w in (layer.wi, layer.wg, layer.wo):
        assert abs(float(w.float().std()) - 64 ** -0.5) < 0.01 * 64 ** -0.5
        assert float(w.float().abs().min(dim=-1).values.max()) > 0   # no slab left undrawn
    assert abs(float(layer.router.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    slab, model_lib.SLAB_ELEMENTS = model_lib.SLAB_ELEMENTS, 3 * 256 * 96
    try:
        sliced = init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    finally:
        model_lib.SLAB_ELEMENTS = slab
    assert torch.equal(sliced.blocks[0].moe.router, layer.router)
    assert abs(float(sliced.blocks[0].moe.wo.float().std()) - 64 ** -0.5) < 0.01 * 64 ** -0.5
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.blocks[0].moe.wg, layer.wg)


# ------------------------------------------------------------------ entries
@pytest.mark.parametrize("arch", MOE)
def test_serve_and_collab_serve_run_end_to_end_on_the_cpu(arch):
    cfg = reduced(get_config(arch), n_layers=2)
    cfg = _with_cf(cfg, 1.0)
    res = serve(cfg, device="cpu", batch=4, prompt_len=20, gen=4, requests=1, seed=1,
                log=lambda _: None)
    st = res.stats[0]
    assert st["tokens"].shape == (4, 4) and st["logits_finite"]
    want = sum(cache.entry_payload_bits(cfg, bt, 4, 24) for bt in cfg.block_types()) // 8
    assert st["cache_bytes"] == cache_bytes(res.cache) == want
    assert 0 < st["moe_dropped_prefill"] < 1 and 0 < st["moe_dropped_decode"] < 1
    split = collab_serve.serve(reduced(get_config(arch), n_layers=4), device="cpu", requests=1,
                               batch=2, seq=16, log=lambda _: None)
    sst = split.stats[0]
    assert sst["logits_finite"] and sst["logits_shape"] == (2, 16, cfg.vocab_size)
    assert sst["moe_dropped"] == 0.0 and split.split == 2


def test_a_stack_without_moe_reports_no_drop_share():
    res = serve(reduced(get_config("qwen3-1.7b"), n_layers=2), device="cpu", batch=2,
                prompt_len=8, gen=2, requests=1, log=lambda _: None)
    assert res.stats[0]["moe_dropped_prefill"] is None
    assert res.stats[0]["moe_dropped_decode"] is None


# ------------------------------------------------------------------ tables
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("arch", MOE)
def test_layer_costs_and_payload_bits_match_the_reference(arch):
    """Only the activated experts' bytes count, as the reference counts
    them (qwen3-moe: 8 of 128 experts, 75.5 MB a layer)."""
    for n_layers in (None, 3):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if n_layers:
            cfg, jcfg = reduced(cfg, n_layers=n_layers), jreduced(jcfg, n_layers=n_layers)
        for kv in (0, 8):
            c, jc = cfg.replace(kv_quant_bits=kv), jcfg.replace(kv_quant_bits=kv)
            for s in (1, 64, 2048, 4096):
                for got, want in ((oh.layer_costs(c, s), joh.layer_costs(jc, s)),
                                  (oh.decode_layer_costs(c, s), joh.decode_layer_costs(jc, s))):
                    assert len(got) == len(want) == c.n_layers
                    assert got == want
                for batch in (1, 4):
                    assert (cache.entry_payload_bits(c, "moe", batch, s)
                            == jcache.entry_payload_bits(jc, "moe", batch, s)), s
    q = get_config("qwen3-moe-30b-a3b")
    assert 3 * q.d_model * q.moe.d_expert * q.moe.top_k * 2 == 75_497_472


@pytest.mark.parametrize("arch", MOE)
def test_split_tables_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tables = [(split.transformer_split_table(cfg), jsplit.transformer_split_table(jcfg))]
    tables += [(split.llm_decode_split_table(cfg, ctx, **kw),
                jsplit.llm_decode_split_table(jcfg, ctx, **kw))
               for ctx in (256, 4096) for kw in ({}, {"kv_bits": 8})]
    for got, want in tables:
        assert (got.name, got.points, got.device) == (want.name, want.points, want.device)
        for field in ("t_local", "e_local", "t_comp", "e_comp", "f_bits"):
            _close(getattr(got, field), getattr(want, field))
        np.testing.assert_array_equal(np.asarray(got.feasible), np.asarray(want.feasible))
