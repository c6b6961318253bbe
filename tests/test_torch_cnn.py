"""Parity of the port's CNN backbones, their split tables and the mixed
fleet with the JAX reference.

The backbones run at width 0.25 with 7 classes on (2, 3, 32, 32) inputs
made with numpy, from the port's init given to the reference as numpy and
to the port through ``weights.cnn_from_jax`` (the reference's own init
compiles op by op for ~15 s a model; its tree is held to the port's by
shape and structure); forward and the split forward at every split
point are held to the reference's own tolerance, rtol = atol = 1e-4
(``tests/test_cnn_compressor.py``). ResNet18's last stage is 1 x 1 at 32
px, where BatchNorm over a batch of 2 divides by the spread of two
nearly equal values: each float32 side is then ~5e-4 from the exact
function (the reference's own float32 too), so the 1e-4 comparison is made
with both packages in float64, where they agree to ~1e-12, and float32 is
held to the reference's own float32 error against float64 (twice it, plus
1e-4). The tables and fleets are numpy on both sides and must be equal.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import cnn as jcnn
from repro.core import fleets as jfleets
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro_torch import weights
from repro_torch.core import cnn, fleets, split
from repro_torch.core import overhead as oh
from repro_torch.configs import get_config

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

NAMES = ["resnet18", "vgg11", "mobilenetv2"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _wide(tree):
    """A tree's float arrays as float64 (the structural entries kept)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f" else a, tree)


def _reference_init_shapes(jm):
    """The reference's ``jm.init`` tree with every array as its shape,
    from one trace (``jax.eval_shape``, nothing compiled: run eagerly the
    init compiles op by op, ~15 s a model); the structural entries (layer
    kinds, block descriptors), which the trace keeps as Python values, in
    their places."""
    box = {}

    def arrays(k):
        leaves, box["treedef"] = jax.tree_util.tree_flatten(jm.init(k))
        box["static"] = [None if isinstance(a, jax.core.Tracer) else a for a in leaves]
        return [a for a in leaves if isinstance(a, jax.core.Tracer)]

    shapes = iter(jax.eval_shape(arrays, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_unflatten(box["treedef"], [
        tuple(next(shapes).shape) if a is None else a for a in box["static"]])


@functools.lru_cache(maxsize=None)
def _models(name):
    """The reference's model, the parameters both packages run (the port's
    init as numpy: the same distribution as the reference's, whose
    structure ``test_walkers_and_init_match_the_reference`` holds to the
    reference's), the port's model, and the input."""
    jm, m = jcnn.CNN_FACTORY[name](7, width=0.25), cnn.CNN_FACTORY[name](7, width=0.25)
    jp = jax.tree_util.tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
                                m.init(torch.Generator().manual_seed(0)))
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32)
    return jm, jp, m, x


def _port_params(jp, dtype):
    p = weights.cnn_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jax.tree_util.tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor) else t,
                                  p)


@functools.lru_cache(maxsize=None)
def _reference_outputs(name, wide):
    """The reference's forward and, at each split point k, its boundary
    feature and split forward, in float64 (``wide``) or float32 (the
    forward only)."""
    jm, jp, _, x = _models(name)

    points = jm.split_after if wide else ()

    def outputs(a, p):
        feats = {k: jcnn.forward(jm, p, a, upto=k + 1) for k in points}
        return jcnn.forward(jm, p, a), {k: (f, jcnn.forward_from(jm, p, f, k + 1))
                                        for k, f in feats.items()}

    def run():
        p, xx = (_wide(jp), x.astype(np.float64)) if wide else (jp, x)
        full, splits = jax.jit(lambda a: outputs(a, p))(xx)   # one compile a model
        return np.asarray(full), jax.tree_util.tree_map(np.asarray, splits)

    if wide:
        with jax.enable_x64(True):
            return run()
    return run()


def _port_outputs(name, dtype):
    jm, jp, m, x = _models(name)
    p = _port_params(jp, dtype)
    xx = torch.from_numpy(x).to(dtype)
    full = cnn.forward(m, p, xx).numpy()
    splits = {}
    for k in m.split_after:
        feat = cnn.forward(m, p, xx, upto=k + 1)
        splits[k] = (feat.numpy(), cnn.forward_from(m, p, feat, k + 1).numpy())
    return full, splits


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_split_forward_match_the_reference_in_float64(name):
    want_full, want = _reference_outputs(name, True)
    got_full, got = _port_outputs(name, torch.float64)
    assert got_full.shape == (2, 7)
    np.testing.assert_allclose(got_full, want_full, **TOL)
    for k, (feat, rest) in got.items():
        np.testing.assert_allclose(feat, want[k][0], err_msg=f"boundary {k}", **TOL)
        np.testing.assert_allclose(rest, want[k][1], err_msg=f"split {k}", **TOL)
        np.testing.assert_allclose(rest, got_full, err_msg=f"split {k} vs full", **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_float32_forward_is_as_close_to_float64_as_the_reference(name):
    exact, exact_splits = _reference_outputs(name, True)
    ref32, _ = _reference_outputs(name, False)
    got, got_splits = _port_outputs(name, torch.float32)
    bound = 1e-4 + 2 * np.abs(ref32 - exact).max()
    for g, e in [(got, exact)] + [(got_splits[k][1], exact_splits[k][1]) for k in got_splits]:
        assert g.dtype == np.float32
        assert np.abs(g - e).max() <= bound
    if name != "resnet18":
        np.testing.assert_allclose(got, ref32, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_walkers_and_init_match_the_reference(name):
    jm, jp, m, _ = _models(name)
    for size in (32, 224):
        assert m.feature_shapes(size) == jm.feature_shapes(size)
        assert m.module_flops(size) == jm.module_flops(size)
    assert (m.n_modules, m.split_after, m.name) == (jm.n_modules, jm.split_after, jm.name)
    # the port's own init: the reference's shapes and structure
    mine = m.init(torch.Generator().manual_seed(0))
    shape = lambda t: tuple(t.shape) if hasattr(t, "shape") else t
    assert _reference_init_shapes(jm) == jax.tree_util.tree_map(shape, mine)


def _tables_equal(got, want):
    for f in ("t_local", "e_local", "t_comp", "e_comp", "f_bits", "feasible"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("dev", ["JETSON_NANO", "IOT_SOC"])
def test_cnn_split_table_equals_reference(dev):
    want = jsplit.cnn_split_table(jcnn.make_resnet18(101), 224, dev=getattr(joh, dev))
    got = split.cnn_split_table(cnn.make_resnet18(101), 224, dev=getattr(oh, dev))
    assert (got.name, got.points, got.device) == (want.name, want.points, want.device)
    _tables_equal(got, want)
    _tables_equal(split.split_table(cnn.make_vgg11(101), dev=getattr(oh, dev)),
                  jsplit.split_table(jcnn.make_vgg11(101), dev=getattr(joh, dev)))
    _tables_equal(split.split_table(get_config("qwen3-1.7b")),
                  jsplit.split_table(jget_config("qwen3-1.7b")))


@pytest.mark.parametrize("n", [4, 6])
def test_mixed_fleet_equals_reference(n):
    want, got = jfleets.make_mixed_fleet("qwen3-1.7b", n), fleets.make_mixed_fleet("qwen3-1.7b", n)
    assert got.names == want.names and got.n_ue == n
    assert [p.device.name for p in got.profiles] == [p.device.name for p in want.profiles]
    _tables_equal(got, want)
    np.testing.assert_array_equal(got.p_compute, want.p_compute)
