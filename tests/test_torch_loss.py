"""The port's training loss (``models/model.py::loss_fn``) and its
gradients against ``jax.value_and_grad`` of the reference's ``loss_fn``,
in float32 on the CPU, for a 2-layer narrow dense stack and a 2-layer
narrow mamba2 stack (``reduced`` configs). Weights come from the
reference's ``init_params`` through ``weights.from_jax_params``; tokens and
labels (with ``-100`` entries) are made with numpy.

Tolerance: the loss and its metrics within 1e-5 relative; every parameter's
gradient within 1e-4 of that parameter's largest magnitude. The forward
parity tests hold the logits to 1e-4 (XLA's CPU and torch sum their
products in other orders); the gradient runs the same products again,
transposed, so it is held to the same 1e-4, taken against each leaf's
largest gradient because most entries of a leaf are near zero. Measured
at these inputs: at most 3.2e-6 for either stack.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import init_params as jinit_params
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.models import loss_fn, model as model_lib
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

_jvalue_and_grad = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True), static_argnums=1)
_CACHE = {}


def _setup(arch):
    if arch not in _CACHE:
        jcfg = jreduced(jget_config(arch), n_layers=2)
        cfg = reduced(get_config(arch), n_layers=2)
        params = jinit_params(jcfg, jax.random.PRNGKey(0))
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
        _CACHE[arch] = (jcfg, cfg, params, model)
    return _CACHE[arch]


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.25] = -100
    labels[0, :3] = -100
    return tokens, labels


def _pairs(model, grads):
    """(port parameter, reference gradient) for every parameter, walking the
    reference's tree as ``weights.from_jax_params`` does."""
    out = [(model.embed, grads["embed"])]
    if model.lm_head is not None:
        out.append((model.lm_head, grads["lm_head"]))
    stacked = grads["decoder"]["blocks"][0]
    for i, blk in enumerate(model.blocks):
        for sub, leaves in stacked.items():
            out += [(getattr(getattr(blk, sub), k), a[i]) for k, a in leaves.items()]
    out += [(getattr(model.ln_f, k), a) for k, a in grads["decoder"]["ln_f"].items()]
    return out


@pytest.mark.parametrize("arch,seq", [("qwen3-1.7b", 24), ("mamba2-1.3b", 40)])
def test_loss_and_gradients_match_the_reference(arch, seq):
    """mamba2 at seq 40 with chunk 16 ends on a ragged chunk, and its
    gradient runs through ``SsdIntra``'s backward."""
    jcfg, cfg, params, model = _setup(arch)
    tokens, labels = _batch(cfg.vocab_size, 2, seq, seed=len(arch) + seq)
    (want, wm), wgrads = _jvalue_and_grad(params, jcfg, {"tokens": jnp.asarray(tokens),
                                                         "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels)}
    loss, metrics = loss_fn(model, batch)
    assert set(metrics) == set(wm) == {"ce", "aux", "ppl_proxy"}
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(wm[k]), rtol=1e-5, atol=1e-7)
    pairs = _pairs(model, jax.tree_util.tree_map(np.asarray, wgrads))
    assert len(pairs) == len(list(model.parameters()))
    got = torch.autograd.grad(loss, [p for p, _ in pairs])
    for (p, w), g in zip(pairs, got):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        err = np.abs(g.double().numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (tuple(p.shape), err, np.abs(w).max())


def test_labels_all_ignored_give_zero_loss_and_zero_gradient():
    _, cfg, _, model = _setup("qwen3-1.7b")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    loss, metrics = loss_fn(model, {"tokens": tokens, "labels": torch.full((1, 8), -100)})
    assert float(loss.detach()) == 0.0 and float(metrics["ppl_proxy"].detach()) == 1.0
    assert all(float(g.abs().max()) == 0.0 for g in
               torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
               if g is not None)
    # a decoder-only arch ignores aux_embeds, as the reference's loss does
    # (only the encoder-decoder and VLM stacks read them)
    plain, _ = model_lib.loss_fn(model, {"tokens": tokens, "labels": tokens})
    with_aux, _ = model_lib.loss_fn(model, {"tokens": tokens, "labels": tokens,
                                            "aux_embeds": torch.zeros(1)})
    assert float(with_aux.detach()) == float(plain.detach())
