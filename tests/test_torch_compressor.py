"""Parity of the port's trained compressor (``core/compressor.py``: Eq. 4,
the two-stage AE training, the Fig. 4 rate-distortion sweep) with the JAX
reference.

ResNet18 at width 0.25, 7 classes, batches of 4 made with numpy at 32 px.
The parameters are the port's init, carried to the reference as numpy
(ResNet18's tree is the reference's, tensors in place of arrays; the
reference's own init compiles for seconds).
Both packages run in float64: the last stage is 1 x 1 at 32 px, where
BatchNorm over a small batch divides by the spread of nearly equal values
and float32 sides drift apart by ~5e-4 (``tests/test_torch_cnn.py``).

``pca_init_autoencoder``'s component signs are whatever each SVD returns,
and the 8-bit codes (Eq. 1 takes min and max over the whole bottleneck)
see the sign, so the training tests inject the reference's PCA AE into the
port. The rate-distortion sweep's parity is in
``tests/test_torch_rate_distortion.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import compressor as jcomp
from repro_torch.core import cnn, compressor

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

NCLS, B, IMG, WIDTH = 7, 4, 32, 0.25
SPLIT = 1          # ResNet18's first split point: (16, 8, 8) boundary features


@functools.lru_cache(maxsize=None)
def _models():
    """The reference's model and float64 numpy parameters, the port's."""
    m = cnn.make_resnet18(NCLS, WIDTH)
    p = m.init(torch.Generator().manual_seed(0))
    return (jcnn.make_resnet18(NCLS, width=WIDTH),
            jax.tree_util.tree_map(lambda t: t.numpy().astype(np.float64), p), m)


def _port_params(jp):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), jp)


def _batches(seed, n, batch=B):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 3, IMG, IMG)), rng.integers(0, NCLS, batch))
            for _ in range(n)]


def _jit(batches):
    return iter([(jnp.asarray(x), jnp.asarray(y, jnp.int32)) for x, y in batches])


def _tit(batches):
    return iter([(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches])


def _ae64(ae):
    """A numpy AE as float64 port tensors."""
    return {k: torch.from_numpy(np.array(ae[k], np.float64)) for k in ("enc", "dec")}


def _ref_pca(feats, ch_prime):
    """The reference's PCA of the port's features, as port tensors."""
    with jax.enable_x64(True):
        return _ae64(jcomp.pca_init_autoencoder(jnp.asarray(feats.detach().numpy()), ch_prime))


def test_ae_loss_and_gradients_match_the_reference():
    """Eq. 4's value, its parts and the gradient of every AE and backbone
    leaf: 1e-8 of each leaf's largest (float64 on both sides)."""
    jm, jp, m = _models()
    (x, y), = _batches(1, 1)
    rng = np.random.default_rng(2)
    ch = jm.feature_shapes(IMG)[SPLIT][0]
    ae = {"enc": rng.standard_normal((ch, 8)) / np.sqrt(ch),
          "dec": rng.standard_normal((8, ch)) / np.sqrt(8)}
    with jax.enable_x64(True):
        fn = jax.jit(jax.value_and_grad(
            lambda a, p: jcomp.ae_loss(a, p, jm, SPLIT, jnp.asarray(x), jnp.asarray(y), 0.1),
            argnums=(0, 1), has_aux=True))
        (jloss, (jl2, jce)), (jg_ae, jg_bb) = fn(ae, jp)
    tae = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ae.items()}
    tbb = cnn.trainable_copy(_port_params(jp))
    loss, (l2, ce) = compressor.ae_loss(tae, tbb, m, SPLIT, torch.from_numpy(x),
                                        torch.from_numpy(y), 0.1)
    for got, want in ((loss, jloss), (l2, jl2), (ce, jce)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    leaves = cnn.param_leaves(tae) + cnn.param_leaves(tbb)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jg_ae) + jax.tree_util.tree_leaves(jg_bb)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-8 * max(np.abs(w).max(), 1e-30)


def test_pca_init_matches_the_reference_up_to_sign():
    """Both layouts, float64 on both sides (in float32 the two libraries'
    SVDs of these small, nearly degenerate sample sets differ by ~1e-6)."""
    rng = np.random.default_rng(3)
    for feats in (rng.standard_normal((3, 8, 4, 4)), rng.standard_normal((2, 5, 8))):
        with jax.enable_x64(True):
            want = jcomp.pca_init_autoencoder(jnp.asarray(feats), 3)
        got = compressor.pca_init_autoencoder(torch.from_numpy(feats), 3)
        enc, wenc = got["enc"].numpy(), np.asarray(want["enc"])
        sign = np.sign(np.sum(enc * wenc, axis=0))
        assert np.all(sign != 0)
        np.testing.assert_allclose(enc * sign, wenc, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dec"].numpy() * sign[:, None], np.asarray(want["dec"]),
                                   rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference_training(finetune_steps):
    jm, jp, _ = _models()
    batches = _batches(4, 8)
    with jax.enable_x64(True):
        ae, bb, logs = jcomp.train_autoencoder(
            jax.random.PRNGKey(0), jm, jp, SPLIT, _jit(batches), ch=16, ch_prime=8, steps=5,
            lr=3e-3, finetune_steps=finetune_steps, ft_lr=1e-3)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return batches, tree(ae), tree(bb), logs


@pytest.mark.parametrize("finetune_steps", [0, 2])
def test_training_matches_the_reference(monkeypatch, finetune_steps):
    """5 stage-1 steps, then none or 2 stage-2 steps, on the same batches
    from the reference's PCA AE. The logged losses agree to rtol 1e-6.
    After stage 1 alone every AE leaf lands within 1e-4 of its leaf's
    largest change, and the backbone is the caller's.

    After stage 2 the parameters are held by what they compute: Eq. 4 on a
    held-out batch at the port's and at the reference's trained parameters
    agrees to rtol 1e-6 (measured 2.7e-8; stage 2 moves it by 2.7 %), and
    each leaf's change agrees in L2 to 2e-2 of its norm (measured at most
    5.2e-3). Element by element the leaves do not agree to 1e-4: both
    packages round the parameters through float32 at every AdamW step, one
    ULP apart now and then (XLA fuses p - lr * u into one FMA); at 32 px
    ResNet18's last BatchNorm normalizes 4 values a channel, which turns
    that ULP into ~1e-4 of a gradient, and AdamW's second step, m / sqrt(v)
    with m a near-cancelling sum of two gradients, turns that into up to
    70 % of a step on elements where the two gradients cancel."""
    jm, jp, m = _models()
    batches, jae, jbb, jlogs = _reference_training(finetune_steps)
    monkeypatch.setattr(compressor, "pca_init_autoencoder", _ref_pca)
    bb0 = _port_params(jp)
    ae, bb, logs = compressor.train_autoencoder(
        torch.Generator().manual_seed(0), m, bb0, SPLIT, _tit(batches), ch=16, ch_prime=8,
        steps=5, lr=3e-3, finetune_steps=finetune_steps, ft_lr=1e-3)
    assert [set(r) for r in logs] == [set(r) for r in jlogs]
    assert [r["stage"] for r in logs] == [1] * 5 + [2] * finetune_steps
    for got, want in zip(logs, jlogs):
        for k in ("loss", "l2", "ce"):
            if k in want:
                np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, err_msg=k)
    init = _ref_pca(cnn.forward(m, bb0, _tit(batches[:1]).__next__()[0], upto=SPLIT + 1), 8)
    pairs = [(cnn.param_leaves(ae), jax.tree_util.tree_leaves(jae),
              cnn.param_leaves(init))]
    if finetune_steps:
        pairs.append((cnn.param_leaves(bb), jax.tree_util.tree_leaves(jbb),
                      cnn.param_leaves(bb0)))
        (x, y), = _tit(_batches(99, 1))
        with torch.no_grad():
            loss = [float(compressor.ae_loss(a, p, m, SPLIT, x, y)[0])
                    for a, p in ((ae, bb), (_ae64(jae), _port_params(jbb)), (init, bb0))]
        np.testing.assert_allclose(loss[0], loss[1], rtol=1e-6)
        assert abs(loss[1] - loss[2]) > 1e-3 * loss[2]
    else:
        assert bb is bb0
    for got, want, start in pairs:
        assert len(got) == len(want)
        for g, w, s in zip(got, want, start):
            change = w - s.numpy()
            assert np.abs(change).max() > 0
            diff = g.numpy() - w
            if finetune_steps:
                assert np.linalg.norm(diff) <= 2e-2 * np.linalg.norm(change)
            else:
                assert np.abs(diff).max() <= 1e-4 * np.abs(change).max()
    # the caller's backbone is left as it was
    assert all(bool((a == b).all()) for a, b in
               zip(cnn.param_leaves(bb0), cnn.param_leaves(_port_params(jp))))


def test_accuracy_with_ae_matches_the_reference():
    """At 8 and 4 bits on 12 images, and on one image, whose last stage
    BatchNorm sees one value a channel (the sweep's channel probe runs it):
    the logits there are the biases, as in the reference. The reference runs
    op by op at the sweep's evaluation shapes (``test_torch_rate_distortion``
    then finds its ops compiled)."""
    jm, jp, m = _models()
    (x, y), = _batches(5, 1, batch=12)
    _, jae, _, _ = _reference_training(0)
    for bits, n in ((8, 12), (4, 12), (8, 1)):
        with jax.enable_x64(True):
            want = jcomp.accuracy_with_ae(jm, jp, jae, SPLIT, jnp.asarray(x[:n]),
                                          jnp.asarray(y[:n]), bits=bits)
        got = compressor.accuracy_with_ae(m, _port_params(jp), _ae64(jae), SPLIT,
                                          torch.from_numpy(x[:n]), torch.from_numpy(y[:n]),
                                          bits=bits)
        assert got.dtype == torch.float32 and float(got) == float(want)
