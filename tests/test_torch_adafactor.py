"""Adafactor, the reference's leaf layout and the ``--arch`` training
launcher of the port, against the JAX reference on the CPU.

The reference runs its optimizers on stacked leaves: each block parameter
of a whole pattern group carries a leading group axis, the layers past the
last whole group (the tail) and the final norms do not. The port holds one
parameter a layer, so ``weights.reference_leaves`` describes the
reference's leaves in the port's terms, and Adafactor factors by the
reference's ranks: a per-layer 1-D leaf (a norm scale) is a (G, d) leaf
there and is factored, its ``vc`` spanning the layers; the per-layer gate
is a (G,) leaf and is not; a stacked leaf of matrices keeps its moments
one a layer and clips its update's RMS over all its layers together.

Tolerances, which the reference states none of for an optimizer: the
slots within 1e-5 relative, and each parameter after an Adafactor step
within 1e-5 of its leaf's largest change (f32 on both sides; the step
divides by square roots of moments of the same gradients, which the two
packages sum in other orders); after three ``make_train_step`` steps
through the loss and its gradient, 1e-3 of the leaf's largest change, the
bound ``tests/test_torch_train_step.py`` holds AdamW's steps to.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch.ckpt import load_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch import train as train_lib
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import (Leaf, adafactor_init, adafactor_update, adamw_init,
                               adamw_update, make_optimizer)
from repro_torch.weights import (from_jax_params, reference_decay_mask, reference_leaves,
                                 to_reference_tree)

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

# (arch, n_layers): llama's 5-layer pattern, one group and a one-layer tail
# at 6; kimi's MoE experts; recurrentgemma's (rec, rec, lattn) group and a
# (rec, rec) tail at 5; seamless's encoder stack; mamba2's 1-D mixer leaves
CASES = [("llama-3.2-vision-90b", 6), ("kimi-k2-1t-a32b", 2), ("recurrentgemma-9b", 5),
         ("seamless-m4t-large-v2", 2), ("mamba2-1.3b", 2)]
_jupdate = jax.jit(jopt.adafactor_update, static_argnames=("weight_decay",))


def _gates(tree, seed=5):
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


def _setup(arch, n_layers):
    """(jax cfg, port cfg, reference params (numpy, drawn gates), port model)."""
    key = (arch, n_layers)
    if key not in _SETUPS:
        jcfg = jreduced(jget_config(arch), n_layers=n_layers)
        cfg = reduced(get_config(arch), n_layers=n_layers)
        tree = _gates(jax.tree_util.tree_map(np.asarray,
                                             jmodel.init_params(jcfg, jax.random.PRNGKey(0))))
        _SETUPS[key] = (jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu"))
    return _SETUPS[key]


def _paths(tree):
    """The reference tree's leaves in its flattening order, by path."""
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _port_value(leaf, tensors):
    """A reference leaf's value from the port's tensors (one a parameter)."""
    ts = [tensors[i].detach().double().numpy() for i in leaf.index]
    return np.stack(ts) if leaf.stacked else ts[0]


def _slot_value(slot):
    return {k: (np.stack([t.double().numpy() for t in v]) if isinstance(v, list)
                else v.double().numpy()) for k, v in slot.items()}


# ------------------------------------------------------------------ the layout
@pytest.mark.parametrize("arch,n_layers", CASES)
def test_reference_leaves_describe_the_reference_tree(arch, n_layers):
    """One leaf a reference leaf, in the reference's set of paths, with its
    shape and rank; every port parameter in exactly one leaf."""
    _, cfg, tree, model = _setup(arch, n_layers)
    leaves = reference_leaves(model)
    assert sorted(leaf.path for leaf in leaves) == sorted(_paths(tree))
    params = list(model.parameters())
    assert sorted(i for leaf in leaves for i in leaf.index) == list(range(len(params)))
    for leaf in leaves:
        want = _at(tree, leaf.path)
        assert _port_value(leaf, params).shape == want.shape and leaf.rank == want.ndim, leaf.path
    tail = [leaf for leaf in leaves if "tail" in leaf.path]
    assert bool(tail) == (cfg.n_layers % len(cfg.block_pattern) > 0)
    assert all(not leaf.stacked for leaf in tail)


@pytest.mark.parametrize("arch,n_layers", CASES)
def test_the_decay_mask_is_the_rank_rule_on_the_reference_leaves(arch, n_layers):
    """Rank >= 2 of each parameter's reference leaf; a tail layer's norm
    scales (1-D, unstacked) are not decayed, the same scales in a whole
    group are."""
    _, cfg, tree, model = _setup(arch, n_layers)
    by_index = {i: _at(tree, leaf.path).ndim >= 2
                for leaf in reference_leaves(model) for i in leaf.index}
    mask = reference_decay_mask(model)
    assert mask == [by_index[i] for i in range(len(mask))]
    names = [n for n, _ in model.named_parameters()]
    if arch == "recurrentgemma-9b":
        decayed = dict(zip(names, mask))
        assert decayed["blocks.0.ln1.scale"] and not decayed["blocks.3.ln1.scale"]
        assert decayed["blocks.0.mixer.lam"] and not decayed["blocks.4.mixer.lam"]
        assert decayed["blocks.3.mixer.wx"]


# ------------------------------------------------------------------ Adafactor
def _slots_by_path(state, tree):
    return dict(zip(_paths(tree), state["slots"]))


@pytest.mark.parametrize("arch,n_layers", CASES[:3])
def test_adafactor_init_matches_the_reference(arch, n_layers):
    _, _, tree, model = _setup(arch, n_layers)
    want = _slots_by_path(jopt.adafactor_init(tree), tree)
    got = adafactor_init(list(model.parameters()), reference_leaves(model))
    assert int(got["step"]) == 0 and len(got["slots"]) == len(want)
    for leaf, slot in zip(reference_leaves(model), got["slots"]):
        w = want[leaf.path]
        g = _slot_value(slot)
        assert sorted(g) == sorted(w), leaf.path
        for k in w:
            assert g[k].shape == np.shape(w[k]) and not g[k].any(), (leaf.path, k)


def _grads(tree, seed, scale):
    """Random gradients of the tree's shapes, each leaf's entries of one
    random magnitude a row, so the factored moments are not flat."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)
                   * np.exp(rng.standard_normal(a.shape[:-1] + (1,)) if a.ndim else 1.0)
                   ).astype(np.float32), tree)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("arch,n_layers", CASES[:4])
def test_adafactor_steps_match_the_reference(arch, n_layers, weight_decay):
    """Two Adafactor steps from the same f32 parameters and gradients: every
    slot and parameter. The second step's update is clipped (its RMS is
    above 1 for some leaves); stacked 1-D leaves are factored with a ``vc``
    over the layers, the gate's slot is a ``v`` of one entry a layer, and a
    tail leaf's moments are its own."""
    _, cfg, tree, model = _setup(arch, n_layers)
    model = from_jax_params(tree, cfg, "cpu").requires_grad_(False)
    params = list(model.parameters())
    leaves = reference_leaves(model)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.adafactor_init(jparams)
    state = adafactor_init(params, leaves)
    before = jax.tree_util.tree_map(np.asarray, jparams)
    for step, scale in enumerate((1.0, 30.0)):
        gtree = _grads(tree, seed=step, scale=scale)
        grads = [None] * len(params)
        for leaf in leaves:
            a = _at(gtree, leaf.path)
            for g, i in enumerate(leaf.index):
                grads[i] = torch.from_numpy(np.array(a[g] if leaf.stacked else a))
        lr = 1e-2
        jparams, jstate = _jupdate(jax.tree_util.tree_map(jnp.asarray, gtree), jstate, jparams,
                                   jnp.float32(lr), weight_decay=weight_decay)
        _, state = adafactor_update(grads, state, params, torch.tensor(lr), leaves=leaves,
                                    weight_decay=weight_decay)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        want_slots = _slots_by_path(jstate, tree)
        for leaf, slot in zip(leaves, state["slots"]):
            w = {k: np.asarray(v, np.float64) for k, v in want_slots[leaf.path].items()}
            g = _slot_value(slot)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=0, err_msg=str(leaf.path))
            want = np.asarray(_at(jparams, leaf.path), np.float64)
            change = np.abs(want - _at(before, leaf.path)).max()
            err = np.abs(_port_value(leaf, params) - want).max()
            assert err <= 1e-5 * change, (leaf.path, err, change)
    kinds = {(leaf.stacked, leaf.rank, tuple(sorted(slot))) for leaf, slot in
             zip(leaves, state["slots"])}
    assert (True, 2, ("vc", "vr")) in kinds                 # stacked norm scales, factored
    if arch == "llama-3.2-vision-90b":
        gate = next(s for leaf, s in zip(leaves, state["slots"]) if leaf.path[-1] == "gate")
        assert sorted(gate) == ["v"] and tuple(gate["v"].shape) == (1,)
    if arch == "recurrentgemma-9b":
        assert (False, 1, ("v",)) in kinds                  # the tail's norm scales
    # the clip acted: the second step's gradients are 30 x the first's, so
    # the moments lag and the final norm's unclipped update has an RMS above 1
    ln_f = next(i for i, leaf in enumerate(leaves) if leaf.path == ("decoder", "ln_f", "scale"))
    g = grads[leaves[ln_f].index[0]].double()
    assert float(torch.sqrt(torch.mean(g * g / state["slots"][ln_f]["v"].double()))) > 1.0


def test_the_layerwise_rms_spans_the_layers():
    """A stacked leaf of matrices is clipped by the RMS of its whole update:
    two layers whose gradients differ 100-fold in scale move by updates of
    the same clip, as the reference's one (2, a, b) leaf does."""
    w = [torch.zeros(4, 6), torch.zeros(4, 6)]
    grads = [torch.randn(4, 6, generator=torch.Generator().manual_seed(1)),
             100 * torch.randn(4, 6, generator=torch.Generator().manual_seed(2))]
    leaves = [Leaf((0, 1), True, 3)]
    state = adafactor_init(w, leaves)
    _, state = adafactor_update(grads, state, w, 1.0, leaves=leaves)
    jw, _ = jopt.adafactor_update(jnp.stack([jnp.asarray(g.numpy()) for g in grads]),
                                  jopt.adafactor_init(jnp.zeros((2, 4, 6))), jnp.zeros((2, 4, 6)),
                                  1.0)
    np.testing.assert_allclose(torch.stack(w).numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    assert isinstance(state["slots"][0]["vr"], list) and len(state["slots"][0]["vr"]) == 2


def test_make_optimizer_names_both():
    assert make_optimizer("adamw") == (adamw_init, adamw_update)
    assert make_optimizer("adafactor") == (adafactor_init, adafactor_update)
    with pytest.raises(ValueError):
        make_optimizer("sgd")


# ------------------------------------------------------------------ the train step
def _jstep(jcfg, **kw):
    step, init = jsteps.make_train_step(jcfg, **kw)
    return jax.jit(step), init


@pytest.mark.parametrize("arch,n_layers", [("llama-3.2-vision-90b", 6),
                                           ("kimi-k2-1t-a32b", 2)])
def test_three_train_steps_match_the_reference(arch, n_layers):
    """``make_train_step`` runs the config's Adafactor over the reference's
    leaves: three steps (the first at rate 0) on drawn tokens and
    aux_embeds; loss and grad_norm within 1e-5 relative, each parameter
    within 1e-3 of its leaf's largest change, the step count and every
    slot within 1e-3 relative."""
    jcfg, cfg, tree, _ = _setup(arch, n_layers)
    model = from_jax_params(tree, cfg, "cpu")
    kw = dict(base_lr=1e-2, warmup=1, total=10)
    jstep, jinit = _jstep(jcfg, **kw)
    step, init = make_train_step(cfg, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate, state = jinit(jparams), init(model)
    assert cfg.optimizer == "adafactor" and "slots" in state
    rng = np.random.default_rng(0)
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
        if cfg.n_aux_tokens:
            batch["aux_embeds"] = rng.standard_normal(
                (2, cfg.n_aux_tokens, cfg.d_model)).astype(np.float32)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tb["tokens"] = tb["tokens"].long()
        model, state, m = step(model, state, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert int(state["step"]) == int(jstate["step"]) == 3
    params = list(model.parameters())
    want_slots = _slots_by_path(jstate, tree)
    for leaf, slot in zip(reference_leaves(model), state["slots"]):
        want = np.asarray(_at(jparams, leaf.path), np.float64)
        change = np.abs(want - _at(tree, leaf.path)).max()
        err = np.abs(_port_value(leaf, params) - want).max()
        assert err <= 1e-3 * change, (leaf.path, err, change)
        for k, v in _slot_value(slot).items():
            np.testing.assert_allclose(v, np.asarray(want_slots[leaf.path][k]), rtol=1e-3,
                                       err_msg=str(leaf.path))


# ------------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_the_launcher_trains_every_arch_on_the_cpu(arch, tmp_path):
    """``python -m repro_torch.launch.train --reduce`` on the CPU, 2 steps:
    the reference's JSONL record of step 1 with a finite loss, and a final
    checkpoint in the reference's tree that loads back into the model's."""
    model, records, losses = train_lib.main(["--arch", arch, "--reduce", "--steps", "2", "--batch",
                                             "2", "--seq", "16", "--device", "cpu", "--out",
                                             str(tmp_path)])
    assert len(losses) == 2 and float(losses[0]) == records[0]["loss"]
    lines = [json.loads(line) for line in (tmp_path / f"{arch}.jsonl").read_text().splitlines()]
    assert lines == records and [r["step"] for r in lines] == [1]
    assert sorted(lines[0]) == ["elapsed_s", "grad_norm", "loss", "step"]
    assert np.isfinite(lines[0]["loss"]) and np.isfinite(lines[0]["grad_norm"])
    assert model.cfg == reduced(get_config(arch), n_layers=4, d_model=256)
    tree, meta = load_checkpoint(str(tmp_path / f"{arch}_final"), to_reference_tree(model))
    assert meta["step"] == 2
    back = from_jax_params(tree, model.cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), model.parameters()))
