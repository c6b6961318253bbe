"""Parity of the port's decode slice with the JAX reference on the CPU: the
``decode_attention`` kernel's plain twin, the model's prefill and
``decode_step`` (dense GQA and Mamba-2 stacks), decoding from a cache the
reference prefilled, and the serving launcher. Inputs are made with numpy
from a seed; weights come from the reference's ``init_params`` through
``repro_torch.weights``. The JAX side runs live, with Pallas in interpret
mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.kernels import _build, decode_attn, ops
from repro_torch.launch.serve import cache_bytes, serve
from repro_torch.models import apply_model, cache, decode_step, init_params, prefill
from repro_torch.weights import cache_from_jax, from_jax_params

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

GQA = dict(n_heads=4, n_kv_heads=2, d_head=64)
HKV_G = [(2, 4), (1, 8), (4, 1)]           # tests/test_kernels.py:59


def _decode_inputs(b, s, hkv, g, d, seed=0, empty_row=False):
    """The reference's decode inputs: slots with pos % 5 == 2 empty, and
    optionally every slot of batch row 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    pos[pos % 5 == 2] = -1
    if empty_row:
        pos[0] = -1
    return q, k, v, pos


def _both(args):
    return [jnp.asarray(a) for a in args], [torch.from_numpy(a) for a in args]


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("s", [64, 257, 1024, 600, 1088])
@pytest.mark.parametrize("hkv,g", HKV_G)
def test_decode_attention_twin_matches_the_reference_oracle(s, hkv, g):
    """The twin against ``ref.decode_attention_ref`` at the reference's
    2e-5 (tests/test_kernels.py:72), on its grid and at the ragged S = 600
    and 1088 (not multiples of the TPU kernel's 512-slot block)."""
    j, t = _both(_decode_inputs(2, s, hkv, g, 64, seed=s + hkv))
    want = jref.decode_attention_ref(*j, s - 10)
    got = ops.decode_attention(*t, s - 10)
    assert got.dtype == torch.float32 and got.shape == (2, hkv * g, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_decode_attention_row_with_no_valid_slot_gives_the_mean_of_v():
    args = _decode_inputs(2, 600, 2, 4, 32, seed=3, empty_row=True)
    j, t = _both(args)
    got = ops.decode_attention(*t, 590).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.decode_attention_ref(*j, 590)),
                               rtol=2e-5, atol=2e-5)
    mean_v = np.repeat(args[2][0].mean(0), 4, axis=0)       # (Hq, D)
    np.testing.assert_allclose(got[0], mean_v, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,hkv,g", [(64, 2, 4), (257, 1, 8), (512, 4, 1), (1024, 2, 4)])
def test_decode_attention_twin_matches_the_pallas_kernel(s, hkv, g):
    """Against ``ops.decode_attention`` (Pallas, interpret mode) where S is at
    most its 512-slot block or a multiple of it."""
    j, t = _both(_decode_inputs(2, s, hkv, g, 64, seed=s))
    want = jops.decode_attention(*j, s - 10, interpret=True)
    np.testing.assert_allclose(ops.decode_attention(*t, s - 10).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_the_pallas_kernel_returns_nan_at_a_ragged_s():
    """Records a fault of the reference kernel, which the port does not
    copy: at S = 1088 (> 512, not a multiple of 512) the last S block of
    ``src/repro/kernels/decode_attn.py`` reads past the cache end; the
    probability of such a slot is 0, but 0 times the NaN it reads is NaN.
    This test fails, and should be removed, once the reference is fixed."""
    j, t = _both(_decode_inputs(2, 1088, 2, 2, 32, seed=4))
    pallas = np.asarray(jops.decode_attention(*j, 1078, interpret=True))
    assert np.isnan(pallas).any()
    got = ops.decode_attention(*t, 1078).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jref.decode_attention_ref(*j, 1078)),
                               rtol=2e-5, atol=2e-5)


def test_decode_attention_matches_the_models_flash_decode():
    """As tests/test_kernels.py:75: the model's flash attention at one query
    token (``_flash_decode``, two 64-slot chunks) against the twin."""
    b, s, hkv, g, d = 2, 128, 2, 2, 32
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_positions=jnp.full((b, 1), s - 1),
                                 k_positions=jnp.asarray(pos), causal=True, chunk=64)
    got = decode_attn.decode_attention_plain(*(torch.from_numpy(a) for a in (q[:, 0], k, v, pos)),
                                             s - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], rtol=2e-5, atol=2e-5)


def test_decode_attention_on_the_cpu_counts_no_launch():
    _build.reset_launches()
    ops.decode_attention(*_both(_decode_inputs(1, 8, 1, 2, 32))[1], 7)
    assert _build.LAUNCHES["decode_attention"] == 0


def _resident(gpcs, per_sm, cluster_cap=None):
    """A card's resident blocks in clusters of 1..8, as the occupancy query
    gives them: the SMs of a GPC hold ``per_sm`` blocks each, and a cluster
    lies within one GPC; ``cluster_cap`` caps the clusters of 8."""
    counts = [sum(k * per_sm // c * c for k in gpcs) for c in range(1, 9)]
    if cluster_cap is not None:
        counts[7] = min(counts[7], 8 * cluster_cap)
    return tuple(counts)


_TABLES = {"132x3": _resident([132], 3), "gpc-132x3": _resident([18] * 4 + [16] * 2 + [14] * 2, 3),
           "132x3-cap45": _resident([132], 3, cluster_cap=45), "132x1": _resident([132], 1),
           "gpc-114x2": _resident([16] * 6 + [18], 2)}


@pytest.mark.parametrize("table", list(_TABLES))
@pytest.mark.parametrize("s", [1, 31, 32, 33, 257, 520, 2080, 40_000])
@pytest.mark.parametrize("pairs", [1, 7, 32, 100, 300])
def test_split_planner_covers_each_slot_once_in_one_wave(pairs, s, table):
    """The kernel's split planner: every slot in exactly one non-empty
    split, each a run of whole tiles but the last, at most a cluster's worth
    of splits, the grid within one wave of the card's resident blocks unless
    the (b, kv head) pairs alone exceed it, and no plan that fits one wave
    with fewer tiles a block."""
    resident = _TABLES[table]
    n, per = decode_attn.plan_splits(pairs, s, resident)
    tile = decode_attn.TILE
    assert 1 <= n <= decode_attn.MAX_SPLIT and per % tile == 0
    seen = np.zeros(s, dtype=int)
    for c in range(n):
        lo, hi = c * per, min(s, (c + 1) * per)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert pairs * n <= resident[n - 1] or n == 1
    for c in range(1, min(decode_attn.MAX_SPLIT, -(-s // tile)) + 1):
        if pairs * c <= resident[c - 1]:
            assert per // tile <= -(-s // (c * tile)), c


def test_split_planner_refuses_what_it_cannot_plan():
    with pytest.raises(ValueError):
        decode_attn.plan_splits(0, 10, _TABLES["132x3"])
    with pytest.raises(ValueError):
        decode_attn.plan_splits(4, 0, _TABLES["132x3"])
    with pytest.raises(ValueError):
        decode_attn.plan_splits(4, 10, (396,) * 4)


def _merge(parts):
    """Merge online-softmax partials (m, l, acc) by their maxima."""
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mm) for m, _, _ in parts]
    return (mm, sum(wc * l for wc, (_, l, _) in zip(w, parts)),
            sum(wc[..., None] * a for wc, (_, _, a) in zip(w, parts)))


def _kernel_schedule(q, k, v, pos, idx, resident, warps=2, k_scale=None, v_scale=None,
                     window=0):
    """The CUDA kernel's order of work, in float64: a kv head's G query rows
    in ``block_rows`` row groups, each padded with zero rows to the block's
    rows; the planner's splits over the pairs times the groups; in each,
    32-slot tiles dealt to ``warps`` consumer warps, one max and one
    rescale a tile (invalid slots -1e30, nothing past the split; an int8
    cache's scores times k_scale, its probabilities added into l, then
    times v_scale); the warps merged, then the splits; the padding rows
    dropped."""
    b, hq, d = q.shape
    s, hkv = k.shape[1:3]
    g = hq // hkv
    rows, groups = decode_attn.block_rows(g, d)
    n, per = decode_attn.plan_splits(b * hkv * groups, s, resident)
    qg = torch.zeros((b, hkv, groups * rows, d), dtype=torch.float64)
    qg[:, :, :g] = q.double().reshape(b, hkv, g, d) * d ** -0.5
    kk, vv = (t.double().permute(0, 2, 1, 3) for t in (k, v))       # (B, Hkv, S, D)
    ones = torch.ones((b, s, hkv), dtype=torch.float64)
    ksc, vsc = ((ones if t is None else t.double()).permute(0, 2, 1)[:, :, None, :]
                for t in (k_scale, v_scale))                           # (B, Hkv, 1, S)
    valid = (pos >= 0) & (pos <= idx)
    if window:
        valid = valid & (pos > idx - window)
    valid = valid[:, None, None, :]
    outs = []
    for r0 in range(0, groups * rows, rows):
        qr = qg[:, :, r0:r0 + rows]
        splits = []
        for c in range(n):
            lo, hi = c * per, min(s, (c + 1) * per)
            states = [(torch.full((b, hkv, rows), -1e30, dtype=torch.float64),
                       torch.zeros((b, hkv, rows), dtype=torch.float64),
                       torch.zeros((b, hkv, rows, d), dtype=torch.float64))
                      for _ in range(warps)]
            for t, t0 in enumerate(range(lo, hi, decode_attn.TILE)):
                t1 = min(t0 + decode_attn.TILE, hi)
                m, l, acc = states[t % warps]
                sc = torch.einsum("bhgd,bhsd->bhgs", qr, kk[:, :, t0:t1]) * ksc[..., t0:t1]
                sc = torch.where(valid[..., t0:t1], sc, torch.tensor(-1e30, dtype=torch.float64))
                m_new = torch.maximum(m, sc.amax(-1))
                alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new[..., None])
                states[t % warps] = (m_new, l * alpha + p.sum(-1), acc * alpha[..., None]
                                     + torch.einsum("bhgs,bhsd->bhgd", p * vsc[..., t0:t1],
                                                    vv[:, :, t0:t1]))
            splits.append(_merge(states))
        _, l, acc = _merge(splits)
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    return torch.cat(outs, dim=2)[:, :, :g].reshape(b, hq, d)


@pytest.mark.parametrize("b,s,hkv,g,d", [(2, 1, 2, 4, 32), (2, 31, 1, 8, 32), (2, 32, 2, 2, 64),
                                         (2, 33, 4, 1, 64), (1, 257, 2, 4, 32),
                                         (3, 600, 5, 2, 32), (4, 2080, 8, 2, 32)])
def test_the_kernels_schedule_matches_the_reference_oracle(b, s, hkv, g, d):
    """The kernel's tiles, splits and merges give the reference's function
    at the planner's edges (S = 1, a tile less one, a tile, a tile and one,
    eight splits' worth and one), with B Hkv not dividing 132, a row with no
    valid slot and a split whose slots are all empty."""
    q, k, v, pos = _decode_inputs(b, s, hkv, g, d, seed=s, empty_row=True)
    resident = _TABLES["gpc-132x3"]
    n, per = decode_attn.plan_splits(b * hkv, s, resident)
    pos[-1, (n - 1) * per:] = -1                        # the last split of the last row
    j, t = _both((q, k, v, pos))
    want = np.asarray(jref.decode_attention_ref(*j, s - 1))
    got = _kernel_schedule(*t, s - 1, resident)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[0].numpy(), np.repeat(v[0].mean(0), g, 0),
                               rtol=2e-5, atol=2e-5)


def _scaled_inputs(b, s, hkv, g, d, seed, codes):
    """Decode inputs over a ring that has wrapped (idx = 3 S + 5: slot j
    holds the last position = j mod S), pos % 5 == 2 empty; with ``codes``
    the cache is int8 codes with per-(slot, kv head) scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    idx = 3 * s + 5
    p = np.arange(idx - s + 1, idx + 1)
    pos = np.empty((b, s), dtype=np.int32)
    pos[:, p % s] = p
    pos[pos % 5 == 2] = -1
    if not codes:
        k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32) for _ in range(2))
        return (q, k, v, pos), idx, {}
    k, v = (rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.05, (b, s, hkv)).astype(np.float32) for _ in range(2))
    return (q, k, v, pos), idx, {"k_scale": ks, "v_scale": vs}


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("g", [3, 7, 16])
def test_the_twin_matches_the_models_flash_decode_with_scales_and_window(g, d, codes, window):
    """The twin against the reference model's ``_flash_decode`` (two 64-slot
    chunks, the last padded) over an f32 or an int8 cache with its scales,
    with and without a window, on a wrapped ring, at the zoo's G and D
    (phi4-mini's 3, qwen2's 7, recurrentgemma's 16 at D 256), within the
    reference's 2e-5; and the kernel's schedule against the twin."""
    b, s, hkv = 2, 100, 2
    args, idx, scales = _scaled_inputs(b, s, hkv, g, d, seed=g * d + window, codes=codes)
    q, k, v, pos = args
    jsc = {n: jnp.asarray(a) for n, a in scales.items()}
    want = jattn._flash_decode(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
                               q_positions=jnp.full((b, 1), idx), k_positions=jnp.asarray(pos),
                               causal=True, window=window, chunk=64, **jsc)
    tsc = {n: torch.from_numpy(a) for n, a in scales.items()}
    t = [torch.from_numpy(a) for a in args]
    got = ops.decode_attention(*t, idx, window=window, **tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], rtol=2e-5, atol=2e-5)
    sched = _kernel_schedule(*t, idx, _TABLES["gpc-132x3"], window=window, **tsc)
    np.testing.assert_allclose(sched.numpy(), got.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,s,hkv,g,d,codes,window", [
    (2, 33, 2, 3, 64, False, 0), (1, 257, 1, 7, 128, True, 0), (2, 300, 1, 16, 256, False, 64),
    (2, 70, 2, 24, 32, True, 40), (3, 65, 1, 17, 256, True, 0), (2, 2080, 4, 7, 128, True, 0)])
def test_the_kernels_schedule_covers_rows_scales_and_windows(b, s, hkv, g, d, codes, window):
    """The schedule with padded row groups (G 3 and 7 in blocks of 4 and
    8, 16 at D 256 in two blocks of 8, 17 in three, 24 in two of 16), an
    int8 cache's scales and a window, against the reference's oracle in
    float64 (``repro.kernels.ref`` has no scales or window: the twin is
    compared with ``_flash_decode`` above)."""
    args, idx, scales = _scaled_inputs(b, s, hkv, g, d, seed=s + g, codes=codes)
    t = [torch.from_numpy(a) for a in args]
    tsc = {n: torch.from_numpy(a) for n, a in scales.items()}
    resident = _TABLES["132x1"]
    want = decode_attn.decode_attention_plain(
        *(x.double() if i < 3 else x for i, x in enumerate(t)), idx, window=window,
        **{n: x.double() for n, x in tsc.items()})
    got = _kernel_schedule(*t, idx, resident, window=window, **tsc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    rows, groups = decode_attn.block_rows(g, d)
    assert rows * groups >= g > rows * (groups - 1) and rows <= (8 if d > 128 else 16)


def test_block_rows_pads_each_g_to_a_template():
    assert [decode_attn.block_rows(g, 128) for g in (1, 2, 3, 5, 7, 8, 9, 16, 17, 28)] == [
        (1, 1), (2, 1), (4, 1), (8, 1), (8, 1), (8, 1), (16, 1), (16, 1), (16, 2), (16, 2)]
    assert [decode_attn.block_rows(g, 256) for g in (1, 3, 8, 16)] == [
        (1, 1), (4, 1), (8, 1), (8, 2)]
    with pytest.raises(ValueError):
        decode_attn.block_rows(0, 64)


# ------------------------------------------------------------------ the slice
_jprefill = jax.jit(jmodel.prefill, static_argnums=1, static_argnames="attn_len")
_jdecode = jax.jit(jmodel.decode_step, static_argnums=1)
_SETUPS = {}


def _setup(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params, port model) at a reduced size; qwen3
    keeps GQA (4 query heads on 2 KV heads)."""
    key = (arch, dtype)
    if key not in _SETUPS:
        kw = dict(GQA) if arch == "qwen3-1.7b" else {}
        kw.update(param_dtype=dtype, compute_dtype=dtype)
        jcfg = jreduced(jget_config(arch), n_layers=3).replace(**kw)
        cfg = reduced(get_config(arch), n_layers=3).replace(**kw)
        params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
        _SETUPS[key] = (jcfg, cfg, params, model.requires_grad_(False))
    return _SETUPS[key]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _f(t):
    return t.detach().float().numpy()


def _assert_cache_close(got, want, tol):
    """The port's per-layer list against the reference's stacked tree."""
    stacked = want["blocks"][0]
    assert len(got) == next(iter(stacked.values())).shape[0]
    for i, entry in enumerate(got):
        assert sorted(entry) == sorted(stacked)
        for name, t in entry.items():
            ref = np.asarray(stacked[name][i]).astype(np.float32)
            np.testing.assert_allclose(_f(t), ref, rtol=tol, atol=tol, err_msg=f"{i} {name}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_prefill_and_decode_steps_match_the_reference(arch):
    """Port prefill + 3 decode steps against JAX prefill + decode_step on
    the same params and tokens, in f32: logits and every cache leaf within
    1e-4 (f32 through 3 blocks, one softmax against the reference's chunked
    online softmax). The prompt (40) is ragged against the SSM chunk (16)."""
    jcfg, cfg, params, model = _setup(arch)
    p_len, n = 40, 3
    toks = _tokens(cfg, (2, p_len + n), seed=1)
    with torch.inference_mode():
        jl, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + n + 1)
        tl, tc = prefill(model, torch.from_numpy(toks[:, :p_len]).long(), attn_len=p_len + n + 1)
        np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
        _assert_cache_close(tc, jc, 1e-4)
        for i in range(n):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            assert tl.shape == (2, cfg.vocab_size)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
            _assert_cache_close(tc, jc, 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_decode_continues_from_a_cache_the_reference_prefilled(arch):
    jcfg, cfg, params, model = _setup(arch)
    p_len = 24
    toks = _tokens(cfg, (2, p_len + 2), seed=2)
    _, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + 2)
    tc = cache_from_jax(jax.tree_util.tree_map(np.asarray, jc), cfg, "cpu")
    _assert_cache_close(tc, jc, 0.0)
    with torch.inference_mode():
        for i in range(2):
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)
            np.testing.assert_allclose(_f(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _assert_cache_close(tc, jc, 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_decode_logits_match_the_train_forward(arch):
    """Decoding token s from the cache gives position s of a full train-mode
    forward (rel < 2e-3, tests/test_smoke_archs.py:81)."""
    _, cfg, _, model = _setup(arch)
    s = 17
    toks = torch.from_numpy(_tokens(cfg, (2, s + 3), seed=3)).long()
    with torch.inference_mode():
        full = apply_model(model, toks)
        _, tc = prefill(model, toks[:, :s], attn_len=s + 3)
        for i in range(3):
            dec, tc = decode_step(model, tc, toks[:, s + i:s + i + 1], s + i)
            ref = full[:, s + i]
            rel = float((ref - dec).abs().max()) / (float(ref.abs().max()) + 1e-9)
            assert rel < 2e-3, f"{arch} step {i} rel={rel}"


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_bf16_decode_stays_near_the_reference(arch):
    """In bf16 the two differ by more than rounding order: the reference's
    ``_flash_decode`` rounds q * scale and the probabilities to bf16
    (``attention.py:112, 150``) where the port's decode attention keeps them
    f32, and each bf16 op rounds at other places in the two frameworks. So
    the bound is 5e-2 x max|logit| over the prefill and 2 decode steps."""
    jcfg, cfg, params, model = _setup(arch, "bfloat16")
    p_len = 20
    toks = _tokens(cfg, (2, p_len + 2), seed=4)
    with torch.inference_mode():
        jl, jc = _jprefill(params, jcfg, jnp.asarray(toks[:, :p_len]), attn_len=p_len + 2)
        tl, tc = prefill(model, torch.from_numpy(toks[:, :p_len]).long(), attn_len=p_len + 2)
        assert tc[0][next(iter(tc[0]))].dtype == torch.bfloat16
        for i in range(3):
            want = np.asarray(jl).astype(np.float32)
            assert float(np.abs(_f(tl) - want).max()) <= 5e-2 * float(np.abs(want).max())
            if i == 2:
                break
            tok = toks[:, p_len + i:p_len + i + 1]
            jl, jc = _jdecode(params, jcfg, jc, jnp.asarray(tok), jnp.int32(p_len + i))
            tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(), p_len + i)


def test_decode_names_what_is_not_ported():
    """Decode needs its cache and position, takes the three modes, runs
    the ported moe block, and runs the enc, decx and xattn blocks of the
    encoder-decoder and VLM stacks: their caches are the reference's and a
    decode step reads the context's K/V from them."""
    _, cfg, _, model = _setup("qwen3-1.7b")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with torch.inference_mode():
        _, tc = prefill(model, toks, attn_len=6)
        with pytest.raises(ValueError, match="idx"):
            apply_model(model, toks[:, :1], mode="decode", cache=tc)
        with pytest.raises(ValueError, match="mode"):
            apply_model(model, toks, mode="serve")
    moe_cfg = cfg.replace(block_pattern=("moe",), moe=MoEConfig(n_experts=4, top_k=2,
                                                                d_expert=32))
    moe_model = init_params(moe_cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.inference_mode():
        _, mc = prefill(moe_model, toks, attn_len=6)
        logits, mc = decode_step(moe_model, mc, toks[:, :1], 4)
    assert logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert int(mc[0]["pos"][0, 4]) == 4 and sorted(mc[0]) == ["k", "pos", "v"]
    for arch, btype in (("seamless-m4t-large-v2", "decx"), ("llama-3.2-vision-90b", "xattn")):
        xcfg = reduced(get_config(arch), n_layers=2)
        jcfg = jreduced(jget_config(arch), n_layers=2)
        want = {k: (sh, getattr(torch, str(np.dtype(dt))))
                for k, (sh, dt) in jcache.entry_shape(jcfg, btype, 1, 6).items()}
        assert cache.entry_shape(xcfg, btype, 1, 6) == want
        xmodel = init_params(xcfg, torch.Generator().manual_seed(0), "cpu")
        aux = torch.randn((1, xcfg.n_aux_tokens, xcfg.d_model),
                          generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            _, xc = prefill(xmodel, toks, attn_len=6, aux_embeds=aux)
            logits, xc = decode_step(xmodel, xc, toks[:, :1], 4)
        assert bool(torch.isfinite(logits).all())
        layer = xcfg.block_types().index(btype)
        assert sorted(xc[layer]) == sorted(want)
        assert tuple(xc[layer]["ck"].shape) == want["ck"][0]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_serve_runs_end_to_end_on_the_cpu(arch):
    cfg = reduced(get_config(arch), n_layers=2)
    lines = []
    res = serve(cfg, device="cpu", batch=2, prompt_len=20, gen=4, requests=2, seed=1,
                log=lines.append)
    assert len(res.stats) == 2 and len(lines) == 2
    btype = cfg.block_types()[0]
    want_bytes = cfg.n_layers * cache.entry_payload_bits(cfg, btype, 2, 24) // 8
    for st in res.stats:
        assert st["tokens"].shape == (2, 4) and st["logits_finite"]
        assert st["cache_bytes"] == want_bytes
        assert st["prefill_ms"] > 0 and st["decode_ms_per_token"] > 0
    assert cache_bytes(res.cache) == want_bytes
    if btype == "dense":                       # every slot filled but the last
        assert int((res.cache[0]["pos"] >= 0).sum()) == 2 * 23
    # the same seed serves the same tokens
    again = serve(cfg, device="cpu", batch=2, prompt_len=20, gen=4, requests=1, seed=1,
                  log=lambda _: None)
    assert torch.equal(again.stats[0]["tokens"], res.stats[0]["tokens"])
