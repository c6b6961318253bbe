"""Activation recomputation in the train step (``cfg.remat``) against the
JAX reference, which wraps each layer group's body in ``jax.checkpoint``
(``src/repro/models/model.py``).

The port runs each group of ``layer_plan`` under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` and its tail
outside it. Held here:

* **FLOPs.** The product FLOPs of the port's ``make_train_step`` counted
  on ``meta`` (``opcount``) equal the reference's trip-count-weighted
  ``weighted_dot_flops`` of its compiled train step, with remat on and
  off, at 1e-9 relative (float rounding of the sums only): reduced
  qwen3-1.7b at 2 and 4 layers, and with remat reduced recurrentgemma-9b
  at 5 layers (one (rec, rec, lattn) group under the checkpoint and a
  tail of 2 outside it). The checkpoint stops its recompute at the last tensor the backward
  needs, so the group's last product (the MLP's down-projection) is not
  rerun; XLA drops the same product, and the counts agree to the unit.
* **Memory.** The port's remat ``temp_size_in_bytes`` (``count_memory``,
  as the dry-run counts it) is within ``MEMORY_FACTOR`` of the reference's
  ``memory_analysis`` at reduced qwen3 at (2, 1024), where activations
  dominate, at 2 and 4 layers; going from 2 to 4 layers adds under a
  tenth of what it adds without remat.
* **Gradients.** With remat on, the loss and every gradient are the same
  bits as with remat off, at f32 on the CPU (the recompute runs the same
  ops on the same inputs): dense, MoE (the aux loss counted once, each
  routing recorded once), mamba2 (through the ``ssd_intra`` twin, called
  twice a layer forward and its backward once), recurrentgemma's group
  and tail, seamless's encoder and decoder layers, and llama-vision's
  pattern cut to (dense, xattn) with a dense tail. The group's layers run
  twice, the tail's once; without grad every layer runs once.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.launch.hloanalysis import weighted_dot_flops
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.kernels import ssd_intra as ssd_lib
from repro_torch.launch import opcount, steps
from repro_torch.models import init_params, loss_fn, layer_plan
from repro_torch.models import moe as moe_lib

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

MEMORY_FACTOR = 1.25
# the reference's weighted_dot_flops of reduced qwen3-1.7b's train step at
# (2, 128), read from its compiled step: (layers, remat) -> FLOPs
QWEN3_DOT_FLOPS = {(2, True): 3_019_898_880, (4, True): 5_838_471_168,
                   (2, False): 2_415_919_104, (4, False): 4_630_511_616}


@functools.lru_cache(maxsize=None)
def _reference(arch, layers, remat, b, s):
    """(weighted_dot_flops, temp_size_in_bytes) of the reference's jitted,
    compiled ``make_train_step`` for a reduced config."""
    cfg = jreduced(jget_config(arch), n_layers=layers).replace(remat=remat)
    step, opt_init = jsteps.make_train_step(cfg)
    params = jsteps.params_spec(cfg)
    batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32) for k in ("tokens", "labels")}
    compiled = jax.jit(step).lower(params, jax.eval_shape(opt_init, params), batch).compile()
    return weighted_dot_flops(compiled.as_text()), compiled.memory_analysis().temp_size_in_bytes


@functools.lru_cache(maxsize=None)
def _port(arch, layers, remat, b, s):
    """(dot_flops, temp_size_in_bytes) of the port's train step counted on
    ``meta``."""
    cfg = reduced(get_config(arch), n_layers=layers).replace(remat=remat)
    train_step, opt_init = steps.make_train_step(cfg)
    model = steps.params_spec(cfg)
    batch = steps.input_specs(cfg, InputShape("train", s, b, "train"))["batch"]
    costs, memory, _ = opcount.count_memory(train_step, model, opt_init(model), batch)
    return costs["dot_flops"], memory["temp_size_in_bytes"]


@pytest.mark.parametrize("arch,layers,remat", [
    ("qwen3-1.7b", 2, True), ("qwen3-1.7b", 4, True), ("qwen3-1.7b", 2, False),
    ("qwen3-1.7b", 4, False), ("recurrentgemma-9b", 5, True)])
def test_train_step_dot_flops_equal_the_references(arch, layers, remat):
    got = _port(arch, layers, remat, 2, 128)[0]
    want = _reference(arch, layers, remat, 2, 128)[0]
    assert got == pytest.approx(want, rel=1e-9)
    if arch == "qwen3-1.7b":
        assert got == QWEN3_DOT_FLOPS[(layers, remat)]


@pytest.mark.parametrize("layers", [2, 4])
def test_remat_temporaries_within_a_factor_of_the_references(layers):
    got = _port("qwen3-1.7b", layers, True, 2, 1024)[1]
    want = _reference("qwen3-1.7b", layers, True, 2, 1024)[1]
    assert 1 / MEMORY_FACTOR <= got / want <= MEMORY_FACTOR


def test_remat_temporaries_grow_by_the_group_inputs_only():
    """Two more layers keep two more group inputs with remat, and every
    activation of two layers without it."""
    remat = _port("qwen3-1.7b", 4, True, 2, 1024)[1] - _port("qwen3-1.7b", 2, True, 2, 1024)[1]
    plain = (_port("qwen3-1.7b", 4, False, 2, 1024)[1]
             - _port("qwen3-1.7b", 2, False, 2, 1024)[1])
    assert 0 < remat < plain / 10


# name: (arch, layers, overrides)
CASES = {"dense": ("qwen3-1.7b", 2, {}),
         "moe": ("qwen3-moe-30b-a3b", 2, {}),
         "mamba2": ("mamba2-1.3b", 2, {}),
         "recurrentgemma": ("recurrentgemma-9b", 5, {}),
         "seamless": ("seamless-m4t-large-v2", 2, {}),
         "llama-vision": ("llama-3.2-vision-90b", 3,
                          dict(n_layers=3, block_pattern=("dense", "xattn")))}


def _batch(cfg, gen, b=2, s=40):
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    labels = tokens.roll(-1, 1)
    labels[:, -1] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.n_aux_tokens:
        batch["aux_embeds"] = torch.randn((b, cfg.n_aux_tokens, cfg.d_model), generator=gen)
    return batch


def _set_remat(model, remat):
    model.cfg = model.cfg.replace(remat=remat)
    if model.encoder is not None:
        model.encoder.remat = remat


def _runs(model):
    """Counts of each layer's forward calls (decoder and encoder), filled
    as the model runs."""
    calls = {}
    layers = list(model.blocks) + (list(model.encoder.blocks) if model.encoder else [])
    for i, blk in enumerate(layers):
        calls[i] = 0
        blk.register_forward_pre_hook(lambda *_, i=i: calls.__setitem__(i, calls[i] + 1))
    return calls


@pytest.fixture(scope="module")
def grads():
    """Each case's (cfg, per remat setting: loss, metrics, gradients, the
    routing log's calls, each layer's forward calls, the ssd_intra twin's
    forward and backward calls)."""
    out = {}
    fwd, bwd = ssd_lib.ssd_intra, ssd_lib.ssd_intra_backward
    for name, (arch, layers, kw) in CASES.items():
        cfg = reduced(get_config(arch), n_layers=layers).replace(**kw)
        gen = torch.Generator().manual_seed(0)
        model = init_params(cfg, gen, "cpu")
        batch = _batch(cfg, gen)
        calls = _runs(model)
        out[name] = {"cfg": cfg}
        for remat in (True, False):
            _set_remat(model, remat)
            kernels = {"ssd_intra": 0, "ssd_intra_backward": 0}

            def spy(fn, key):
                def run(*a):
                    kernels[key] += 1
                    return fn(*a)
                return run

            ssd_lib.ssd_intra = spy(fwd, "ssd_intra")
            ssd_lib.ssd_intra_backward = spy(bwd, "ssd_intra_backward")
            try:
                for k in calls:
                    calls[k] = 0
                with moe_lib.routing_log() as log:
                    loss, metrics = loss_fn(model, batch)
                    g = torch.autograd.grad(loss, list(model.parameters()))
            finally:
                ssd_lib.ssd_intra, ssd_lib.ssd_intra_backward = fwd, bwd
            out[name][remat] = (loss.detach(), {k: v.detach() for k, v in metrics.items()}, g,
                                len(log.calls), dict(calls), kernels)
    return out


@pytest.mark.parametrize("name", CASES)
def test_remat_gradients_are_the_same_bits(grads, name):
    on, off = grads[name][True], grads[name][False]
    assert torch.equal(on[0], off[0])
    for k in off[1]:
        assert torch.equal(on[1][k], off[1][k]), k
    assert len(on[2]) == len(off[2])
    for i, (a, b) in enumerate(zip(on[2], off[2])):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("name", CASES)
def test_the_groups_run_twice_and_the_tail_once(grads, name):
    cfg = grads[name]["cfg"]
    pattern, n_groups, tail = layer_plan(cfg)
    grouped = n_groups * len(pattern)
    n_enc = cfg.encoder.n_layers if cfg.encoder else 0
    want = {i: 2 if i < grouped else 1 for i in range(cfg.n_layers)}
    want.update({cfg.n_layers + i: 2 for i in range(n_enc)})    # an encoder layer is a group
    assert grads[name][True][4] == want
    assert set(grads[name][False][4].values()) == {1}
    if name == "recurrentgemma":
        assert (n_groups, tail) == (1, ("rec", "rec"))
    if name == "llama-vision":
        assert (n_groups, tail) == (1, ("dense",))


def test_the_moe_aux_loss_and_routing_are_counted_once(grads):
    on, off = grads["moe"][True], grads["moe"][False]
    assert float(on[1]["aux"]) > 0
    assert torch.equal(on[1]["aux"], off[1]["aux"])
    assert on[3] == off[3] == grads["moe"]["cfg"].n_layers


def test_mamba2_recomputes_ssd_intra_and_differentiates_it_once(grads):
    layers = grads["mamba2"]["cfg"].n_layers
    assert grads["mamba2"][True][5] == {"ssd_intra": 2 * layers, "ssd_intra_backward": layers}
    assert grads["mamba2"][False][5] == {"ssd_intra": layers, "ssd_intra_backward": layers}


def test_without_grad_every_layer_runs_once():
    cfg = reduced(get_config("seamless-m4t-large-v2"), n_layers=2)
    gen = torch.Generator().manual_seed(3)
    model = init_params(cfg, gen, "cpu")
    batch = _batch(cfg, gen)
    calls = _runs(model)
    with torch.no_grad():
        loss_fn(model, batch)
    assert set(calls.values()) == {1}
