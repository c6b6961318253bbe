"""Parity of the port's Mamba-2 path (the ssd_intra kernel's plain twin,
``ssd_chunked``, ``apply_mamba``, the mamba2 block, the model, configs,
weight carrying and init) with the JAX reference, in float32 on the CPU.
Inputs are made with numpy; the JAX side runs live, with its Pallas
``ssd_intra`` in interpret mode as ``tests/test_ssd_kernel.py`` runs it.
Sizes are the reference's reduced ones (d_state 16, head_dim 32, chunk 16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import apply_model as japply_model
from repro.models import init_params as jinit_params
from repro.models import ssm as jssm
from repro.models.blocks import apply_block as japply_block
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref, ssd_intra
from repro_torch.models import apply_model, init_params, ssm
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# jitted, since the eager reference compiles every op anew for each shape
_japply_mamba = jax.jit(jssm.apply_mamba, static_argnums=2)
_jssd_chunked = jax.jit(jssm.ssd_chunked, static_argnums=5, static_argnames="use_pallas")
_japply_block = jax.jit(japply_block, static_argnums=(2, 3), static_argnames="mode")
_CACHE = {}


def _setup(n_layers=2):
    """(jax cfg, port cfg, jax params, port model) of reduced(mamba2-1.3b)."""
    if n_layers not in _CACHE:
        jcfg = jreduced(jget_config("mamba2-1.3b"), n_layers=n_layers)
        cfg = reduced(get_config("mamba2-1.3b"), n_layers=n_layers)
        params = jinit_params(jcfg, jax.random.PRNGKey(0))
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
        _CACHE[n_layers] = (jcfg, cfg, params, model.requires_grad_(False))
    return _CACHE[n_layers]


def _layer(params, i):
    return jax.tree_util.tree_map(lambda a: a[i], params["decoder"]["blocks"][0])


def _ssd_inputs(b, l, h, p, n, seed):
    """xh, dt (post-softplus), a_log, B, C as numpy f32."""
    xh = _x((b, l, h, p), seed)
    dt = np.logaddexp(_x((b, l, h), seed + 1), 0).astype(np.float32)
    a_log = (-np.exp(_x((h,), seed + 2)) * dt * 0.5).astype(np.float32)
    return xh, dt, a_log, _x((b, l, n), seed + 3), _x((b, l, n), seed + 4)


@pytest.mark.parametrize("q,h,p,n", [(16, 2, 8, 8), (32, 4, 16, 8), (64, 2, 32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_plain_matches_the_reference(q, h, p, n, dtype):
    b, nc = 2, 2
    xh, bm, cm = _x((b, nc, q, h, p), 0), _x((b, nc, q, n), 2), _x((b, nc, q, n), 3)
    dt = np.logaddexp(_x((b, nc, q, h), 1), 0).astype(np.float32)
    la = -np.cumsum(dt * 0.3, axis=2).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jb, jc = (jnp.asarray(a).astype(jd) for a in (xh, bm, cm))
    tx, tb, tc = (_t(a).to(td) for a in (xh, bm, cm))
    want_kernel = np.asarray(jops.ssd_intra(jx, jnp.asarray(dt), jnp.asarray(la), jb, jc))
    f32 = lambda a: a.astype(jnp.float32)
    want_ref = np.asarray(jref.ssd_intra_ref(f32(jx), jnp.asarray(dt), jnp.asarray(la),
                                             f32(jb), f32(jc)))
    got = ssd_intra.ssd_intra(tx, _t(dt), _t(la), tb, tc)      # CPU: the plain twin
    assert got.dtype == torch.float32 and got.shape == (b, nc, q, h, p)
    # the reference's own tolerance (tests/test_ssd_kernel.py)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), want_ref, rtol=tol, atol=tol)
    f = lambda t: t.float()
    np.testing.assert_allclose(_np(ref.ssd_intra_ref(f(tx), _t(dt), _t(la), f(tb), f(tc))),
                               want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_the_reference(use_pallas, with_h0):
    b, l, h, p, n, chunk = 2, 40, 4, 8, 16, 16               # ragged last chunk
    xh, dt, a_log, bm, cm = _ssd_inputs(b, l, h, p, n, 10)
    h0 = _x((b, h, p, n), 15, 0.5) if with_h0 else None
    want_y, want_h = _jssd_chunked(
        *(jnp.asarray(a) for a in (xh, dt, a_log, bm, cm)), chunk,
        None if h0 is None else jnp.asarray(h0), use_pallas=use_pallas)
    got_y, got_h = ssm.ssd_chunked(*(_t(a) for a in (xh, dt, a_log, bm, cm)), chunk,
                                   None if h0 is None else _t(h0))
    assert got_y.shape == (b, l, h, p) and got_h.shape == (b, h, p, n)
    # the reference's consistency bound (tests/test_ssd_kernel.py)
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), rtol=1e-4, atol=1e-4)


def test_ssd_chunked_equals_naive_recurrence():
    b, l, h, p, n = 2, 37, 4, 8, 16
    xh, dt, a_log, bm, cm = (_t(a) for a in _ssd_inputs(b, l, h, p, n, 20))
    y, hlast = ssm.ssd_chunked(xh, dt, a_log, bm, cm, chunk=8)
    hs = torch.zeros(b, h, p, n)
    ys = []
    for t in range(l):
        a = torch.exp(a_log[:, t])
        hs = hs * a[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bm[:, t],
                                                     xh[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t], hs))
    # as tests/test_mixers.py
    np.testing.assert_allclose(_np(y), _np(torch.stack(ys, 1)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(hlast), _np(hs), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_chunk_size_invariance(chunk):
    b, l, h, p, n = 1, 33, 2, 4, 8
    xh, _, _, bm, cm = (_t(a) for a in _ssd_inputs(b, l, h, p, n, 30))
    dt = torch.full((b, l, h), 0.5)
    a_log = -0.3 * dt
    y_ref, h_ref = ssm.ssd_chunked(xh, dt, a_log, bm, cm, chunk=l)
    y, hl = ssm.ssd_chunked(xh, dt, a_log, bm, cm, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(hl), _np(h_ref), rtol=1e-4, atol=1e-4)


def test_apply_mamba_full_pass_and_resume_match_the_reference():
    jcfg, cfg, params, model = _setup()
    p, mixer = _layer(params, 0)["mixer"], model.blocks[0].mixer
    x = _x((2, 20, cfg.d_model), 40, 0.3)
    want, wst = _japply_mamba(p, jnp.asarray(x), jcfg)
    got, st = ssm.apply_mamba(mixer, _t(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    for k in ("conv_x", "conv_bc", "h"):
        np.testing.assert_allclose(_np(st[k]), np.asarray(wst[k]), rtol=1e-4, atol=1e-4)
    # resume at step 11 from the state of the first part (tests/test_mixers.py)
    _, st1 = ssm.apply_mamba(mixer, _t(x[:, :11]), cfg)
    got2, _ = ssm.apply_mamba(mixer, _t(x[:, 11:]), cfg, state=st1)
    _, jst1 = _japply_mamba(p, jnp.asarray(x[:, :11]), jcfg)
    want2, _ = _japply_mamba(p, jnp.asarray(x[:, 11:]), jcfg, state=jst1)
    np.testing.assert_allclose(_np(got2), np.asarray(want2), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(got2), _np(got[:, 11:]), rtol=2e-4, atol=2e-4)


def test_mamba2_block_matches_the_reference():
    jcfg, cfg, params, model = _setup()
    x = _x((2, 40, cfg.d_model), 50)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    want, _, _ = _japply_block(_layer(params, 1), jnp.asarray(x), jcfg, "mamba2",
                              positions=jnp.asarray(pos), mode="train")
    got = model.blocks[1](_t(x), _t(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_apply_model_matches_the_reference():
    jcfg, cfg, params, model = _setup()
    tokens = np.random.default_rng(60).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _, _ = japply_model(params, jcfg, jnp.asarray(tokens), mode="train")
    got = apply_model(model, _t(tokens).long())
    assert got.shape == (2, 40, cfg.vocab_size)
    # f32 through two mamba2 blocks, the final norm and the tied head
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_configs_match_the_reference_field_for_field():
    for n_layers in (None, 2, 4):
        jc, tc = jget_config("mamba2-1.3b"), get_config("mamba2-1.3b")
        if n_layers:
            jc, tc = jreduced(jc, n_layers=n_layers), reduced(tc, n_layers=n_layers)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jssm.dims(jc) == ssm.dims(tc) and jc.block_types() == tc.block_types()
    assert ssm.dims(get_config("mamba2-1.3b")) == (4096, 64, 64, 128, 4)
    # reduced takes an encoder config too: 2 layers over 16 frames, as the
    # reference's
    enc = get_config("seamless-m4t-large-v2").encoder
    jenc = jget_config("seamless-m4t-large-v2").encoder
    tc = reduced(get_config("mamba2-1.3b").replace(encoder=enc), n_layers=2)
    jc = jreduced(jget_config("mamba2-1.3b").replace(encoder=jenc), n_layers=2)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (tc.encoder.n_layers, tc.encoder.n_frames) == (2, 16)


def test_from_jax_params_carries_every_mamba_parameter():
    jcfg, cfg, params, model = _setup()
    stacked = params["decoder"]["blocks"][0]
    for i, blk in enumerate(model.blocks):
        names = [k for k, _ in blk.mixer.named_parameters()]
        assert sorted(names) == sorted(stacked["mixer"])    # the reference's names
        for k, a in stacked["mixer"].items():
            np.testing.assert_array_equal(_np(getattr(blk.mixer, k)), np.asarray(a[i]))
        np.testing.assert_array_equal(_np(blk.ln1.scale), np.asarray(stacked["ln1"]["scale"][i]))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())
    # a bf16 model keeps A_log, D and dt_bias in f32
    bparams = jinit_params(jcfg.replace(param_dtype="bfloat16"), jax.random.PRNGKey(1))
    bmodel = from_jax_params(jax.tree_util.tree_map(np.asarray, bparams),
                             cfg.replace(param_dtype="bfloat16"), "cpu")
    mixer = bmodel.blocks[0].mixer
    assert mixer.wx.dtype == torch.bfloat16 and mixer.A_log.dtype == torch.float32
    np.testing.assert_array_equal(_np(mixer.wx),
                                  np.asarray(bparams["decoder"]["blocks"][0]["mixer"]["wx"][0])
                                  .astype(np.float32))


def test_init_params_gives_the_reference_mamba_scales():
    _, cfg, _, model = _setup()
    ours = init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)
    assert [p.shape for p in ours.parameters()] == [p.shape for p in model.parameters()]
    m = ours.blocks[0].mixer
    assert torch.all(m.D == 1) and torch.all(m.norm_scale == 1)
    for z in (m.A_log, m.dt_bias, m.conv_x_b, m.conv_bc_b):
        assert torch.all(z == 0)
    assert m.A_log.dtype == m.D.dtype == m.dt_bias.dtype == torch.float32
    # dense_init(scale=1) with fan-in d_conv = 4
    assert abs(float(m.conv_x.std()) - 0.5) < 0.05 * 0.5
    assert abs(float(m.wx.std()) - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5
