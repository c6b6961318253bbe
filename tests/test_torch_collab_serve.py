"""Parity of the port's split-serving path with the reference example.

``examples/collaborative_serve.py`` is loaded as it is (not edited) and its
``run_split_forward`` runs on the same params, tokens and autoencoder as
the port's, in float32 on the CPU: the JAX side through the Pallas kernels
in interpret mode, the port through the plain twins of its kernels.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.models import init_params as jinit_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.compressor import compression_rate
from repro_torch.launch import collab_serve
from repro_torch.weights import ae_from_numpy, from_jax_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "collaborative_serve_example", ROOT / "examples" / "collaborative_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(kind):
    arch = "mamba2-1.3b" if kind.startswith("mamba") else "qwen3-1.7b"
    j = jreduced(jget_config(arch), n_layers=4)
    t = reduced(get_config(arch), n_layers=4)
    if kind == "mamba-pallas":     # the reference through its Pallas ssd_intra
        j, t = j.replace(use_pallas_ssd=True), t.replace(use_pallas_ssd=True)
    if kind == "gqa":
        gqa = dict(n_heads=4, n_kv_heads=2, d_head=64)
        j, t = j.replace(**gqa), t.replace(**gqa)
    return j, t


# mamba at seq 40: chunk 16 leaves a ragged last chunk
@pytest.mark.parametrize("kind,seq", [("reduced", 16), ("gqa", 80), ("mamba", 40),
                                      ("mamba-pallas", 40)])
def test_split_forward_matches_the_reference_example(kind, seq, monkeypatch):
    ex = _example()
    jcfg, cfg = _cfgs(kind)
    split, bits = 2, 8
    # one compiled init (eagerly every op compiles alone)
    params = jax.jit(lambda k: jinit_params(jcfg, k))(jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)

    # the reference's PCA autoencoder, computed once in JAX and carried
    # across (torch's SVD may flip the sign of a component)
    calib = np.random.default_rng(12).integers(0, cfg.vocab_size, (4, seq)).astype(np.int32)
    xc = model.run_layers(model.embed_tokens(torch.from_numpy(calib).long()), 0, split,
                          collab_serve.default_positions(4, seq, "cpu"))
    feats = jnp.asarray(xc.detach().reshape(-1, cfg.d_model).numpy())
    _, _, vt = jnp.linalg.svd(feats - feats.mean(0), full_matrices=False)
    pcs = np.asarray(vt[: cfg.d_model // 4].T)
    ae_np = {"enc": pcs, "dec": pcs.T}

    captured = {}

    def capture(x, w, mn, mx, *, bits):
        captured["codes"] = jops.bottleneck_encode(x, w, mn, mx, bits=bits)
        captured["range"] = (mn, mx)
        return captured["codes"]

    monkeypatch.setattr(ex, "kops", SimpleNamespace(bottleneck_encode=capture,
                                                    dequantize=jops.dequantize))
    want, want_bits = ex.run_split_forward(
        params, jcfg, jnp.asarray(tokens), split,
        {k: jnp.asarray(v) for k, v in ae_np.items()}, bits=bits)

    ae = ae_from_numpy(ae_np, "cpu")
    tt = torch.from_numpy(tokens).long()
    got, got_bits = collab_serve.run_split_forward(model, cfg, tt, split, ae, bits=bits)
    with torch.no_grad():
        boundary = collab_serve.ue_side(model, tt, split, ae, bits)

    assert got_bits == want_bits == tokens.size * (cfg.d_model // 4) * bits
    # the range comes from the UE-side hidden state x, not from z = x W_enc
    np.testing.assert_allclose((boundary.mn, boundary.mx), captured["range"], rtol=1e-5)
    codes = np.asarray(captured["codes"]).astype(np.int64)
    assert np.abs(boundary.codes.numpy().astype(np.int64) - codes).max() <= 1
    # f32 through four blocks on both sides, plus at most one code of
    # difference at the boundary where a value sits on a .5 edge
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-3)
    assert (got.numpy().argmax(-1) == np.asarray(want).argmax(-1)).mean() > 0.95


@pytest.mark.parametrize("kind", ["gqa", "mamba"])
def test_serve_answers_requests_on_the_cpu_when_asked(kind):
    _, cfg = _cfgs(kind)
    lines = []
    res = collab_serve.serve(cfg, device="cpu", requests=2, batch=2, seq=16,
                             log=lines.append)
    assert len(res.stats) == 2 and len(lines) == 3
    d_prime = cfg.d_model // cfg.bottleneck_ratio
    for st in res.stats:
        assert st["payload_kbit"] == 2 * 16 * d_prime * 8 / 1e3
        assert st["rate_R"] == pytest.approx(compression_rate(cfg.d_model, d_prime, 8))
        assert st["logits_finite"] and st["logits_shape"] == (2, 16, cfg.vocab_size)
        assert 0.0 <= st["top1_agree"] <= 1.0 and st["tx_ms"] > 0
    assert res.ae["enc"].shape == (cfg.d_model, d_prime)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("reduced")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collab_serve.serve(cfg, requests=1, batch=1, seq=4)
    for argv in (["--requests", "1"], ["--arch", "mamba2-1.3b", "--requests", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            collab_serve.main(argv)


def test_split_forward_is_near_lossless_with_an_identity_autoencoder():
    """With W_enc = W_dec = I and 16-bit codes the only loss is the
    quantization step (range / 65535), so the split forward agrees with the
    uncompressed forward: the split itself drops and reorders nothing."""
    _, cfg = _cfgs("gqa")
    model = collab_serve.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                           generator=torch.Generator().manual_seed(1))
    eye = torch.eye(cfg.d_model)
    got, payload = collab_serve.run_split_forward(model, cfg, tokens, 2,
                                                  {"enc": eye, "dec": eye}, bits=16)
    with torch.no_grad():
        want = model(tokens)
    assert payload == tokens.numel() * cfg.d_model * 16
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() > 0.99
