"""The port's training step (``launch/steps.py::make_train_step``: the loss,
its gradient, global-norm clipping, the cosine schedule and AdamW with the
reference's decay mask) against the reference's ``make_train_step`` under
``jax.jit``, on the CPU, for 2-layer ``reduced`` qwen3 and mamba2 stacks in
float32, from the reference's weights (``weights.from_jax_params``) and
numpy batches; and its parts: ``cosine_schedule`` bit for bit, the decay
mask against the reference's leaves, and AdamW over bf16 leaves against a
float64 evaluation of the reference's formula.

Tolerances: loss, ``grad_norm`` and ``lr`` within 1e-5 relative (the
gradients' own parity, ``test_torch_loss.py``, is 1e-4 of a leaf's
largest); every parameter, after three steps, within 1e-3 of its leaf's
largest change, the bound ``test_torch_train.py`` holds MAHPPO's update to
(AdamW divides by the root of the second moment, so entries whose
gradients are small carry the gradients' relative error into the update
undamped). The first step runs at rate 0 and moves nothing, in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import init_params as jinit_params
from repro.optim import schedule as jschedule
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init, adamw_update,
                               cosine_schedule, make_optimizer)
from repro_torch.weights import from_jax_params, reference_decay_mask

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

STEPS = 3
_JSTEP = {}


def _jstep(jcfg, **kw):
    key = (jcfg.name, tuple(sorted(kw.items())))
    if key not in _JSTEP:
        step, init = jsteps.make_train_step(jcfg, **kw)
        _JSTEP[key] = (jax.jit(step), init)
    return _JSTEP[key]


def _configs(arch):
    return jreduced(jget_config(arch), n_layers=2), reduced(get_config(arch), n_layers=2)


def _pairs(model, tree, whole=False):
    """(port parameter, reference leaf) for every parameter, walking the
    reference's tree as ``weights.from_jax_params`` does: a block's layer of
    its leaf, or with ``whole`` the leaf itself (stacked over the layers)."""
    out = [(model.embed, tree["embed"])]
    if model.lm_head is not None:
        out.append((model.lm_head, tree["lm_head"]))
    stacked = tree["decoder"]["blocks"][0]
    for i, blk in enumerate(model.blocks):
        for sub, leaves in stacked.items():
            out += [(getattr(getattr(blk, sub), k), a if whole else a[i])
                    for k, a in leaves.items()]
    out += [(getattr(model.ln_f, k), a) for k, a in tree["decoder"]["ln_f"].items()]
    return out


def _batches(vocab, b, s, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -100
        out.append((tokens, labels))
    return out


@pytest.mark.parametrize("step", [0, 1, 19, 20, 21, 75, 149, 150, 400])
@pytest.mark.parametrize("args", [(3e-3, 20, 150), (1e-3, 20, 300), (3e-4, 200, 10000)])
def test_cosine_schedule_is_the_reference_bit_for_bit(args, step):
    want = np.asarray(jschedule.cosine_schedule(*args)(jnp.int32(step)))
    got = cosine_schedule(*args)(torch.tensor(step, dtype=torch.int32)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_decay_mask_is_the_references_rank_rule_on_its_leaves(arch):
    jcfg, cfg = _configs(arch)
    tree = jax.tree_util.tree_map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    model = from_jax_params(tree, cfg, "cpu")
    leaf = {id(p): w for p, w in _pairs(model, tree, whole=True)}
    want = [np.ndim(leaf[id(p)]) >= 2 for p in model.parameters()]
    assert reference_decay_mask(model) == want
    names = [n for n, _ in model.named_parameters()]
    assert [n for n, d in zip(names, want) if not d] == [n for n in names if n.startswith("ln_f.")]
    if arch == "mamba2-1.3b":   # 1-D in the port, stacked (rank 2) and decayed in the reference
        ones = [n for n in names if n.startswith("blocks.")
                and n.rsplit(".", 1)[-1] in ("A_log", "D", "dt_bias", "conv_x_b", "scale")]
        assert len(ones) == 2 * 5 and all(want[names.index(n)] for n in ones)


def _run_both(arch, seq, n_steps=STEPS, **kw):
    jcfg, cfg = _configs(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(1))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    start = jax.tree_util.tree_map(np.asarray, params)
    jstep, jinit = _jstep(jcfg, **kw)
    train_step, opt_init = make_train_step(cfg, **kw)
    jopt, opt = jinit(params), opt_init(model)
    for tokens, labels in _batches(cfg.vocab_size, 2, seq, n_steps, seed=seq):
        params, jopt, wm = jstep(params, jopt, {"tokens": jnp.asarray(tokens),
                                                "labels": jnp.asarray(labels)})
        model, opt, m = train_step(model, opt, {"tokens": torch.from_numpy(tokens).long(),
                                                "labels": torch.from_numpy(labels)})
        assert set(m) == set(wm) == {"loss", "ce", "aux", "ppl_proxy", "grad_norm", "lr"}
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5, err_msg=k)
    assert int(opt["step"]) == int(jopt["step"]) == n_steps
    return model, start, jax.tree_util.tree_map(np.asarray, params)


def _hold_params(model, start, end):
    for (p, w0), (_, w1) in zip(_pairs(model, start), _pairs(model, end)):
        change = np.abs(np.asarray(w1, np.float64) - np.asarray(w0, np.float64)).max()
        err = np.abs(p.detach().double().numpy() - np.asarray(w1, np.float64)).max()
        assert err <= 1e-3 * change, (tuple(p.shape), err, change)


@pytest.mark.parametrize("arch,seq", [("qwen3-1.7b", 24), ("mamba2-1.3b", 40)])
def test_train_steps_match_the_reference(arch, seq):
    """Three steps at base rate 1e-2 with 2 steps of warmup: rate 0, then
    5e-3, then 1e-2. mamba2 at seq 40 with chunk 16 ends on a ragged chunk.
    Every leaf the reference decays (its per-layer norm scales, A_log, D,
    dt_bias) moves in both."""
    model, start, end = _run_both(arch, seq, base_lr=1e-2, warmup=2, total=10)
    _hold_params(model, start, end)


def test_clipping_that_bites_matches_the_reference():
    """clip 1e-3, far under the gradients' global norm: every gradient is
    scaled down before AdamW (which is nearly scale-free, so the step's
    size changes little but its direction follows the clipped moments)."""
    model, start, end = _run_both("qwen3-1.7b", 16, n_steps=2, base_lr=1e-2, warmup=1,
                                  total=10, clip=1e-3)
    _hold_params(model, start, end)


def test_first_step_moves_nothing():
    _, cfg = _configs("qwen3-1.7b")
    jcfg, _ = _configs("qwen3-1.7b")
    model = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jinit_params(jcfg, jax.random.PRNGKey(2))), cfg, "cpu")
    before = [p.detach().clone() for p in model.parameters()]
    train_step, opt_init = make_train_step(cfg, base_lr=1.0, warmup=5, total=10)
    (tokens, labels), = _batches(cfg.vocab_size, 1, 8, 1, seed=3)
    _, opt, m = train_step(model, opt_init(model), {"tokens": torch.from_numpy(tokens).long(),
                                                    "labels": torch.from_numpy(labels)})
    assert float(m["lr"]) == 0.0 and int(opt["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def _ref_adamw_f64(p, g, m, v, lr, step, wd, b1=0.9, b2=0.95, eps=1e-8):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    upd = (m / (1 - b1 ** step)) / (np.sqrt(v / (1 - b2 ** step)) + eps)
    return p - lr * (upd + wd * p), m, v


def test_adamw_over_bf16_leaves_is_the_reference_formula():
    """Two steps over bf16 parameters and gradients, some decayed and some
    not: each new parameter within one bf16 step (2^-8 of its magnitude) of
    the reference's formula evaluated in float64 and rounded to bf16 (the
    port evaluates it in float32 and rounds once; a float32 rounding can
    land on the other side of a bf16 rounding boundary), and the float32
    moments within 1e-6 relative of the float64 ones. wd * p is formed in
    float32: forming it in bf16 misses by more than a bf16 step here."""
    rng = np.random.default_rng(5)
    shapes, decay = [(6, 5), (7,), (3, 4)], [True, False, True]
    p64 = [rng.normal(size=s) * 3.0 for s in shapes]
    params = [torch.from_numpy(a).to(torch.bfloat16) for a in p64]
    p64 = [p.double().numpy() for p in params]           # the bf16 values, exactly
    m64 = [np.zeros(s) for s in shapes]
    v64 = [np.zeros(s) for s in shapes]
    state = adamw_init(params)
    for step, lr in ((1, 0.3), (2, 0.2)):
        grads = [torch.from_numpy(rng.normal(size=s)).to(torch.bfloat16) for s in shapes]
        params, state = adamw_update(grads, state, params, torch.tensor(lr, dtype=torch.float32),
                                     weight_decay=0.4, decay=decay)
        for i, d in enumerate(decay):
            new, m64[i], v64[i] = _ref_adamw_f64(p64[i], grads[i].double().numpy(), m64[i],
                                                 v64[i], np.float64(np.float32(lr)), step,
                                                 0.4 if d else 0.0)
            want = torch.from_numpy(new).to(torch.bfloat16).double().numpy()
            got = params[i].double().numpy()
            assert params[i].dtype == torch.bfloat16
            assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want)), (i, step)
            np.testing.assert_allclose(state["m"][i].double().numpy(), m64[i], rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(state["v"][i].double().numpy(), v64[i], rtol=1e-6,
                                       atol=1e-7)
            p64[i] = got


def test_make_optimizer_names_what_it_lacks():
    assert make_optimizer("adamw") == (adamw_init, adamw_update)
    # Adafactor is ported (tests/test_torch_adafactor.py holds it to the
    # reference); an unknown name is refused
    assert make_optimizer("adafactor") == (adafactor_init, adafactor_update)
    with pytest.raises(ValueError):
        make_optimizer("sgd")
