"""Parity of the port's JALAD baseline (``core/jalad.py``), its Huffman codec
(``core/huffman.py``) and the JALAD split tables with the JAX reference.

The codec is numpy and Python on both sides and must be bit for bit the
reference's: the code table (heap tie-breaks included), the stream's bytes,
the decode and the coded size, on seeded peaky and flat symbol arrays and
on an empty one. The entropy estimate and the coded-size estimate are
float32 sums over a histogram on both sides (rtol 1e-6); the JALAD round
trip is Eq. 1-2 in float32 on both sides and must be equal. The tables are
numpy on both sides and must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import huffman as jhuffman
from repro.core import jalad as jjalad
from repro.core import split as jsplit
from repro.core.compressor import quantize as jquantize
from repro_torch.core import cnn, huffman, jalad, split

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def _features(kind, seed=0):
    """float32 feature maps: a cubed Gaussian (peaky codes), a uniform one
    (flat codes) and a post-ReLU one (a code of zeros taking half)."""
    rng = np.random.default_rng(seed)
    if kind == "peaky":
        return (rng.standard_normal((4, 16, 16, 16)) ** 3).astype(np.float32)
    if kind == "flat":
        return rng.uniform(-1, 1, (4, 16, 16, 16)).astype(np.float32)
    return np.maximum(rng.standard_normal((2, 32, 14, 14)), 0).astype(np.float32)


def _symbols(kind):
    if kind == "empty":
        return np.empty(0, np.int64)
    codes, _, _ = jquantize(jnp.asarray(_features(kind)), 8)
    return np.asarray(codes).reshape(-1).astype(np.int64)


@pytest.mark.parametrize("kind", ["peaky", "flat", "relu", "empty"])
def test_huffman_codec_is_the_reference_bit_for_bit(kind):
    sym = _symbols(kind)
    assert huffman.build_code(sym) == jhuffman.build_code(sym)
    stream, table, n = huffman.encode(sym)
    assert (stream, table, n) == jhuffman.encode(sym)
    back = huffman.decode(stream, table, n)
    np.testing.assert_array_equal(back, jhuffman.decode(stream, table, n))
    np.testing.assert_array_equal(back, sym)
    assert back.dtype == np.int64
    assert huffman.coded_size_bits(sym) == jhuffman.coded_size_bits(sym)
    if kind == "empty":
        with pytest.raises(ValueError):
            huffman.decode(b"", {}, 3)
    else:
        assert huffman.coded_size_bits(sym) == 8 * len(stream) - (-huffman.coded_size_bits(sym)
                                                                  % 8)


@pytest.mark.parametrize("kind", ["peaky", "flat", "relu"])
def test_jalad_sizes_and_roundtrip_match_the_reference(kind):
    feat = _features(kind)
    for bits in (8, 4):
        jcodes, _, _ = jquantize(jnp.asarray(feat), bits)
        want = float(jjalad.byte_entropy_bits(jcodes, bits))
        got = jalad.byte_entropy_bits(torch.from_numpy(np.array(jcodes)), bits)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        (size, rate), (jsize, jrate) = (jalad.jalad_compress_size_bits(torch.from_numpy(feat),
                                                                       bits),
                                        jjalad.jalad_compress_size_bits(jnp.asarray(feat), bits))
        np.testing.assert_allclose(float(size), float(jsize), rtol=1e-6)
        np.testing.assert_allclose(float(rate), float(jrate), rtol=1e-6)
        got = jalad.jalad_roundtrip(torch.from_numpy(feat), bits)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jjalad.jalad_roundtrip(
            jnp.asarray(feat), bits)))
    assert jalad.ENTROPY_CODER_SYMBOLS_PER_S == jjalad.ENTROPY_CODER_SYMBOLS_PER_S


def test_entropy_estimate_tracks_the_real_coded_size():
    """The estimate JALAD's sizes rest on is within 2 % of the real Huffman
    size on a cubed Gaussian, the reference's own check."""
    sym = _symbols("peaky")
    est = float(jalad.byte_entropy_bits(torch.from_numpy(sym), 8)) * sym.size
    assert abs(huffman.coded_size_bits(sym) - est) / est < 0.02


@pytest.mark.parametrize("name", ["resnet18", "vgg11", "mobilenetv2"])
def test_cnn_jalad_table_equals_the_reference(name):
    want = jsplit.cnn_jalad_table(jcnn.CNN_FACTORY[name](101), 224)
    got = split.cnn_jalad_table(cnn.CNN_FACTORY[name](101), 224)
    assert (got.name, got.points, got.device) == (want.name, want.points, want.device)
    for f in ("t_local", "e_local", "t_comp", "e_comp", "f_bits", "feasible"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.name.endswith("-jalad") and (got.t_comp[1:-1] > 0).all()
