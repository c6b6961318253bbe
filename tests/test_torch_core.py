"""Parity of the port's compressor (Eq. 1-3, AE inits, encode/decode) and
uplink channel model with the JAX reference, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jcomp
from repro.env import channel as jchan
from repro_torch.core import compressor as comp
from repro_torch.env import channel as chan

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 8, 5, 5)])
@pytest.mark.parametrize("bits", [4, 8, 12])
@pytest.mark.parametrize("given_range", [False, True])
def test_quantize_dequantize(shape, bits, given_range):
    x = _x(shape, 0, 2.0)
    rng = (-3.0, 3.0) if given_range else (None, None)
    jq, jmn, jmx = jcomp.quantize(jnp.asarray(x), bits, *rng)
    q, mn, mx = comp.quantize(torch.from_numpy(x), bits, *rng)
    assert q.dtype == (torch.uint8 if bits <= 8 else torch.uint16)
    np.testing.assert_allclose(float(mn), float(jmn))
    np.testing.assert_allclose(float(mx), float(jmx))
    # the same float32 steps and round-half-even on both sides
    np.testing.assert_array_equal(q.numpy().astype(np.int64),
                                  np.asarray(jq).astype(np.int64))
    want = np.asarray(jcomp.dequantize(jq, bits, jmn, jmx))
    got = comp.dequantize(q, bits, mn, mx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_compression_rate():
    for ch, chp, bits in [(2048, 512, 8), (64, 16, 4), (256, 3, 12)]:
        assert comp.compression_rate(ch, chp, bits) == jcomp.compression_rate(ch, chp, bits)


@pytest.mark.parametrize("shape", [(2, 12, 32), (2, 32, 4, 4)])
def test_encode_decode_roundtrip(shape):
    ch = shape[1] if len(shape) == 4 else shape[-1]
    ae_np = {"enc": _x((ch, 8), 1, 0.2), "dec": _x((8, ch), 2, 0.2)}
    jae = {k: jnp.asarray(v) for k, v in ae_np.items()}
    ae = {k: torch.from_numpy(v) for k, v in ae_np.items()}
    x = _x(shape, 3)
    np.testing.assert_allclose(comp.encode(ae, torch.from_numpy(x)).numpy(),
                               np.asarray(jcomp.encode(jae, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    z = _x(shape[:1] + ((8,) + shape[2:] if len(shape) == 4 else shape[1:-1] + (8,)), 4)
    np.testing.assert_allclose(comp.decode(ae, torch.from_numpy(z)).numpy(),
                               np.asarray(jcomp.decode(jae, jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)
    for bits in (None, 8):
        np.testing.assert_allclose(
            comp.roundtrip(ae, torch.from_numpy(x), bits).numpy(),
            np.asarray(jcomp.roundtrip(jae, jnp.asarray(x), bits)),
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(400, 32), (8, 32, 5, 5)])
def test_pca_init_autoencoder_up_to_component_signs(shape):
    # a spectrum with well-separated variances, so the components are unique
    # up to sign; the SVDs of the two libraries may flip any of them
    ch = shape[1] if len(shape) == 4 else shape[-1]
    mix = np.diag(np.linspace(4.0, 0.5, ch)).astype(np.float32)
    x = _x(shape, 5)
    x = np.moveaxis(np.moveaxis(x, 1, -1) @ mix, -1, 1) if len(shape) == 4 else x @ mix
    jae = jcomp.pca_init_autoencoder(jnp.asarray(x), 6)
    ae = comp.pca_init_autoencoder(torch.from_numpy(np.ascontiguousarray(x)), 6)
    je, e = np.asarray(jae["enc"]), ae["enc"].numpy()
    assert e.shape == je.shape == (ch, 6)
    signs = np.sign((e * je).sum(0))
    np.testing.assert_allclose(e * signs, je, atol=1e-4)
    np.testing.assert_allclose(ae["dec"].numpy(), e.T)


def test_init_autoencoder_scales():
    ae = comp.init_autoencoder(torch.Generator().manual_seed(0), 256, 64)
    assert ae["enc"].shape == (256, 64) and ae["dec"].shape == (64, 256)
    assert abs(float(ae["enc"].std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(ae["dec"].std()) - 64 ** -0.5) < 0.05 * 64 ** -0.5


def test_channel_gain_and_uplink_rates():
    rng = np.random.default_rng(6)
    n, e, c = 9, 3, 2
    d = rng.uniform(0.5, 300.0, n).astype(np.float32)
    np.testing.assert_allclose(chan.channel_gain(torch.from_numpy(d)).numpy(),
                               np.asarray(jchan.channel_gain(jnp.asarray(d))), rtol=1e-6)
    p = rng.uniform(0.05, 1.0, n).astype(np.float32)
    g = np.array(jchan.channel_gain(jnp.asarray(d)))
    ch = rng.integers(0, c, n).astype(np.int32)
    route = rng.integers(0, e, n).astype(np.int32)
    tx = rng.random(n) < 0.7
    omega = rng.uniform(0.5e6, 2e6, (e, c)).astype(np.float32)
    sigma = rng.uniform(1e-10, 1e-9, (e, c)).astype(np.float32)
    t = torch.from_numpy
    # one server: (C,) channels
    want = jchan.uplink_rates(jnp.asarray(p), jnp.asarray(ch), jnp.asarray(g),
                              jnp.asarray(tx), omega=jnp.asarray(omega[0]),
                              sigma=jnp.asarray(sigma[0]))
    got = chan.uplink_rates(t(p), t(ch), t(g), t(tx), omega=t(omega[0]),
                            sigma=t(sigma[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # an edge pool: (E, C) slots chosen by route
    want = jchan.uplink_rates(jnp.asarray(p), jnp.asarray(ch), jnp.asarray(g),
                              jnp.asarray(tx), omega=jnp.asarray(omega),
                              sigma=jnp.asarray(sigma), route=jnp.asarray(route))
    got = chan.uplink_rates(t(p), t(ch), t(g), t(tx), omega=t(omega),
                            sigma=t(sigma), route=t(route))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
