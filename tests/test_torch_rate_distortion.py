"""Parity of the port's rate-distortion sweep (``core.compressor.
measure_rate_distortion``, the paper's Fig. 4 selection rule) with the JAX
reference.

The model, its float64 parameters, the batches and the injected PCA are
``tests/test_torch_compressor.py``'s. The reference's ``train_autoencoder``
compiles its step at every call and runs its accuracy checks op by op, so
the sweep is the smallest that makes a choice at two points: 2 points x 2
ratios x 3 steps. This file stands alone so that each parity file stays
well inside a worker's share of the test run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import compressor as jcomp
from repro_torch.core import compressor

from test_torch_compressor import _batches, _jit, _models, _port_params, _ref_pca, _tit

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def test_rate_distortion_rows_match_the_reference(monkeypatch):
    """2 points x 2 ratios x 3 steps from the reference's PCA AEs on the
    same batches: the rows' keys, ch', rate and bits equal, and each
    accuracy within one sample of its evaluation batch."""
    jm, jp, m = _models()
    # (32, 4, 4) and (64, 2, 2) features: 64 and 16 samples in a batch, so
    # ch' of 4 and 8 at most keeps each PCA's components well defined
    points, n_eval = (2, 3), 12
    data = {pi: _batches(10 + pi, 4) for pi in range(2)}
    evals = {pi: _batches(20 + pi, 1, batch=n_eval)[0] for pi in range(2)}
    kw = dict(points=points, ratios=(8, 16), steps=3, lr=3e-3, acc_drop=0.1)
    with jax.enable_x64(True):
        want = jcomp.measure_rate_distortion(
            jm, jp, lambda pi: _jit(data[pi]),
            lambda pi: (jnp.asarray(evals[pi][0]), jnp.asarray(evals[pi][1], jnp.int32)), **kw)
    monkeypatch.setattr(compressor, "pca_init_autoencoder", _ref_pca)
    got = compressor.measure_rate_distortion(
        m, _port_params(jp), lambda pi: _tit(data[pi]),
        lambda pi: tuple(map(torch.from_numpy, evals[pi])), **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("point", "module", "channels", "ch_prime", "bits"):
            assert g[k] == int(w[k]), k
        assert g["rate"] == float(w["rate"])
        assert g["rate"] == compressor.compression_rate(g["channels"], g["ch_prime"], 8)
        assert g["base_acc"] == float(w["base_acc"])
        assert abs(g["acc"] - float(w["acc"])) <= 1.0 / n_eval + 1e-6
