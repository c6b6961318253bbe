"""Parity of the scheduling path's kernel wrappers, ``pair_scorer`` and
``flat_trunk``, with the JAX reference kernels.

On the CPU the wrappers run their plain PyTorch twins; the JAX side runs
the Pallas kernels in interpret mode and the reference oracles. Inputs are
made with numpy at the magnitudes of tests/test_kernels.py, whose shapes
and tolerances these are: 1e-5 in float32, 5e-2 with bfloat16 inputs
(both sides see the same rounded values). The kernels themselves are held
to the twins on the card by tests/test_torch_kernels_card.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flat_trunk as jft
from repro.kernels import pair_scorer as jps
from repro.kernels import ref as jref
from repro_torch.kernels import flat_trunk, ops, pair_scorer, ref
from repro_torch.kernels.ref import code_dtype

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scorer_inputs(seed, n, e):
    """(ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    as float32 numpy, at live-env magnitudes."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return [f(np.tanh(rng.standard_normal((n, 128)))),
            f(rng.uniform(1.0, 100.0, n)), f(rng.uniform(5e7, 5e8, n)),
            f(rng.random(n) < 0.7), f(rng.uniform(0.5, 2.0, (e, 3))),
            f([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e-12]),
            f(rng.standard_normal((4, 32)) * 0.5), f(np.zeros(32)),
            f(rng.standard_normal((163, 48)) * 0.1), f(np.zeros(48)),
            f(rng.standard_normal((48, 1)) * 0.01), f(np.zeros(1))]


def _both(arrs, dtype="float32", n_obs=6):
    """The JAX and torch forms; the first ``n_obs`` (the observation block)
    in ``dtype``, the weights in float32 as the reference's tests keep them."""
    j = [jnp.asarray(a).astype(dtype) if i < n_obs else jnp.asarray(a)
         for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(TORCH[dtype]) if i < n_obs else torch.from_numpy(a)
         for i, a in enumerate(arrs)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,e", [(1, 1), (7, 2), (64, 3), (300, 5)])
def test_pair_scorer_matches_jax(n, e):
    j, t = _both(_scorer_inputs(n * 7 + e, n, e))
    logits, srv = pair_scorer.pair_scorer(*t)
    assert logits.shape == (n, e) and srv.shape == (e, 32) and logits.dtype == torch.float32
    oracle = jref.pair_scorer_ref(*j)
    # the port's oracle is the reference's
    for got, want in zip(ref.pair_scorer_ref(*t), oracle):
        _close(got, want, 1e-5)
    for want_l, want_s in (jps.pair_scorer_pallas(*j, interpret=True), oracle):
        _close(logits, want_l, 1e-5)
        _close(srv, want_s, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_scorer_dtypes_match_jax(dtype):
    j, t = _both(_scorer_inputs(11, 33, 3), dtype)
    logits, _ = pair_scorer.pair_scorer(*t)
    assert logits.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 5e-2
    _close(logits, jref.pair_scorer_ref(*j)[0], tol)
    _close(logits, jps.pair_scorer_pallas(*j, interpret=True)[0], tol)


def test_pair_scorer_churn_mask_matches_jax():
    """``active`` enters only through the occupancy scalar: masks of equal
    occupancy give bitwise-equal logits."""
    n, e = 24, 3
    arrs = _scorer_inputs(3, n, e)
    for frac in (0.0, 0.5, 1.0):
        arrs[3] = (np.arange(n) < frac * n).astype(np.float32)
        j, t = _both(arrs)
        logits, srv = pair_scorer.pair_scorer(*t)
        want_l, want_s = jref.pair_scorer_ref(*j)
        _close(logits, want_l, 1e-5)
        _close(srv, want_s, 1e-5)
    a1, a2 = np.zeros(n, np.float32), np.zeros(n, np.float32)
    a1[0], a2[n - 1] = 1.0, 1.0
    arrs[3] = a1
    l1, _ = pair_scorer.pair_scorer(*_both(arrs)[1])
    arrs[3] = a2
    l2, _ = pair_scorer.pair_scorer(*_both(arrs)[1])
    assert torch.equal(l1, l2)


def test_ops_pair_scorer_unpacks_the_reference_dicts():
    arrs = _scorer_inputs(5, 9, 2)
    t = [torch.from_numpy(a) for a in arrs]
    raw = dict(zip(("d", "work", "active", "geom", "consts"), t[1:6]))
    got = ops.pair_scorer(t[0], raw, {"w": t[6], "b": t[7]},
                          [{"w": t[8], "b": t[9]}, {"w": t[10], "b": t[11]}])
    want = pair_scorer.pair_scorer_plain(*t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="shapes"):
        pair_scorer.pair_scorer(t[0][:, :100], *t[1:])


def _trunk(seed, dims=(19, 64, 64, 13), bits=8):
    """Per-layer codes (the reference's quantize_ref of a random weight),
    float32 range and biases, as numpy."""
    rng = np.random.default_rng(seed)
    layers = []
    for d_in, d_out in zip(dims, dims[1:]):
        w = (rng.standard_normal((d_in, d_out)) * 0.4).astype(np.float32)
        mn, mx = np.float32(w.min()), np.float32(w.max())
        codes = np.asarray(jref.quantize_ref(jnp.asarray(w), mn, mx, bits=bits))
        layers.append((codes, mn, mx, (rng.standard_normal(d_out) * 0.1).astype(np.float32)))
    return layers


def _trunk_args(layers, bits):
    jargs = ([jnp.asarray(c) for c, *_ in layers], [jnp.float32(m) for _, m, _, _ in layers],
             [jnp.float32(m) for _, _, m, _ in layers], [jnp.asarray(b) for *_, b in layers])
    targs = ([torch.from_numpy(c.astype(np.int32)).to(code_dtype(bits)) for c, *_ in layers],
             [m for _, m, _, _ in layers], [m for _, _, m, _ in layers],
             [torch.from_numpy(b) for *_, b in layers])
    return jargs, targs


@pytest.mark.parametrize("shape", [(1, 19), (7, 19), (4, 8, 19), (600, 19)])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_flat_trunk_matches_jax(shape, bits):
    layers = _trunk(sum(shape) + bits, bits=bits)
    jargs, targs = _trunk_args(layers, bits)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    qlayers = [dict(zip(("codes", "mn", "mx", "b"), layer)) for layer in zip(*targs)]
    out = ops.flat_trunk(torch.from_numpy(x), qlayers, bits=bits)
    assert out.shape == shape[:-1] + (13,) and out.dtype == torch.float32
    x2 = jnp.asarray(x.reshape(-1, 19))
    for want in (jft.flat_trunk_pallas(x2, *jargs, bits=bits, interpret=True),
                 jref.flat_trunk_ref(x2, *jargs, bits=bits),
                 ref.flat_trunk_ref(torch.from_numpy(x.reshape(-1, 19)), *targs, bits=bits)):
        _close(out.reshape(-1, 13), want, 1e-5)


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_flat_trunk_dequantized_weights_bit_equal(bits):
    """The twin's (and the kernel's) dequantized weights are bit-equal to
    flat_trunk_xla's association, codes * ((mx - mn) / levels) + mn, each
    step rounded to float32 (here in numpy)."""
    for codes, mn, mx, _ in _trunk(bits, bits=bits):
        step = (mx - mn) / np.float32((1 << bits) - 1)
        want = codes.astype(np.float32) * step + mn
        got = flat_trunk.dequantized_weights(
            torch.from_numpy(codes.astype(np.int32)).to(code_dtype(bits)), mn, mx, bits=bits)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_trunk_dtypes_match_jax(dtype):
    layers = _trunk(2)
    jargs, targs = _trunk_args(layers, 8)
    x = (np.random.default_rng(3).standard_normal((33, 19)) * 2).astype(np.float32)
    out = flat_trunk.flat_trunk(torch.from_numpy(x).to(TORCH[dtype]), *targs, bits=8)
    assert out.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 5e-2
    xj = jnp.asarray(x).astype(dtype)
    _close(out, jref.flat_trunk_ref(xj, *jargs, bits=8), tol)
    _close(out, jft.flat_trunk_pallas(xj, *jargs, bits=8, interpret=True), tol)


def test_flat_trunk_other_widths_and_depth():
    """No width or depth is built in: a 2-layer 10 -> 30 -> 5 trunk."""
    layers = _trunk(9, dims=(10, 30, 5), bits=6)
    jargs, targs = _trunk_args(layers, 6)
    x = np.random.default_rng(4).standard_normal((70, 10)).astype(np.float32)
    out = flat_trunk.flat_trunk(torch.from_numpy(x), *targs, bits=6)
    _close(out, jft.flat_trunk_xla(jnp.asarray(x), *jargs, bits=6), 1e-5)
    with pytest.raises(ValueError, match="chain"):
        flat_trunk.flat_trunk(torch.from_numpy(x[:, :9]), *targs, bits=6)
