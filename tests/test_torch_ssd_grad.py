"""The gradient of the port's SSD intra-chunk term against the JAX
reference, in float32 on the CPU.

The reference has no backward kernel: its train-mode forward runs the
einsum form of ``ssd_chunked`` (``use_pallas_ssd`` is off by default) and
``jax.grad`` differentiates it. The port's ``ops.ssd_intra`` is an autograd
``Function`` (``kernels/ssd_intra.SsdIntra``) whose CPU backward is the
explicit formula ``ssd_intra_backward_plain``; on the card it is the
backward kernel (``csrc/ssd_intra_bwd.cu``, held to the same formula in
``tests/test_torch_grad_card.py`` and ``chip_smoke.py``). Inputs are made
with numpy; the JAX side is jitted, as ``tests/test_torch_ssm.py`` jits it.
Each gradient is held within 1e-5 of its largest magnitude, the
reference's own f32 bound for this term (``tests/test_ssd_kernel.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels import ssd_intra
from repro_torch.models import ssm

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

_jssd_chunked = jax.jit(jssm.ssd_chunked, static_argnums=5, static_argnames="use_pallas")
BF16_STEP = 2.0 ** -7     # one bf16 step of an element, relative


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@jax.jit
def _jvjp_intra(xh, dt, la, bm, cm, dy):
    return jax.vjp(jref.ssd_intra_ref, xh, dt, la, bm, cm)[1](dy)


def _intra_inputs(b, nc, q, h, p, n, seed):
    """xh, dt (post-softplus), la (each chunk's cumulative log decay), B, C
    and an incoming dy, as numpy f32."""
    dt = np.logaddexp(_x((b, nc, q, h), seed + 1), 0).astype(np.float32)
    la = -np.cumsum(dt * 0.3, axis=2).astype(np.float32)
    return (_x((b, nc, q, h, p), seed), dt, la, _x((b, nc, q, n), seed + 2),
            _x((b, nc, q, n), seed + 3), _x((b, nc, q, h, p), seed + 4))


def _hold(got, want, bf16_first=False):
    """Each gradient within 1e-5 of its largest magnitude (the first, dx in
    bf16, also within one bf16 step of each element)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().double().numpy(), np.asarray(b, np.float64)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        tol = 1e-5 * np.abs(b).max() + (BF16_STEP * np.abs(b) if bf16_first and i == 0 else 0)
        assert np.all(np.abs(a - b) <= tol), (i, float(np.abs(a - b).max()), float(np.abs(b).max()))


# (B, NC, Q, H, P, N): the reference's shapes, a ragged Q (not a multiple
# of the kernel's 64-row tiles) over two tiles, a single chunk
INTRA_SHAPES = [(2, 2, 16, 2, 8, 8), (2, 2, 64, 2, 32, 16), (1, 2, 72, 3, 16, 8),
                (2, 1, 40, 4, 8, 16)]


@pytest.mark.parametrize("shape", INTRA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_formula_matches_the_reference_vjp(shape, dtype):
    xh, dt, la, bm, cm, dy = _intra_inputs(*shape, seed=sum(shape))
    td = getattr(torch, dtype)
    tx = _t(xh).to(td)
    # the JAX side differentiates the f32 function at the same (bf16-exact)
    # values of x
    want = _jvjp_intra(jnp.asarray(tx.float().numpy()), *(jnp.asarray(a) for a in
                                                          (dt, la, bm, cm, dy)))
    got = ssd_intra.ssd_intra_backward_plain(_t(dy), tx, _t(dt), _t(la), _t(bm), _t(cm))
    assert [g.dtype for g in got] == [td] + [torch.float32] * 4
    _hold(got, want, bf16_first=dtype == "bfloat16")


def test_the_function_s_cpu_backward_is_the_formula():
    xh, dt, la, bm, cm, dy = (_t(a) for a in _intra_inputs(2, 2, 24, 3, 8, 8, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (xh, dt, la, bm, cm)]
    y = ssd_intra.SsdIntra.apply(*leaves)
    torch.testing.assert_close(y, ssd_intra.ssd_intra_plain(xh, dt, la, bm, cm), rtol=0, atol=0)
    got = torch.autograd.grad(y, leaves, dy)
    want = ssd_intra.ssd_intra_backward_plain(dy, xh, dt, la, bm, cm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in
               zip(ssd_intra.ssd_intra_backward(dy, xh, dt, la, bm, cm), want))


def _chunked_inputs(b, l, h, p, n, seed):
    dt = np.logaddexp(_x((b, l, h), seed + 1), 0).astype(np.float32)
    a_log = (-np.exp(_x((h,), seed + 2)) * dt * 0.5).astype(np.float32)
    return _x((b, l, h, p), seed), dt, a_log, _x((b, l, n), seed + 3), _x((b, l, n), seed + 4)


# (B, L, H, P, N, chunk): a ragged last chunk, a single chunk shorter than
# the chunk size, Q = 64 over several chunks
@pytest.mark.parametrize("b,l,h,p,n,chunk", [(2, 40, 4, 8, 16, 16), (2, 12, 2, 8, 8, 16),
                                             (1, 136, 2, 16, 8, 64)])
def test_ssd_chunked_gradients_match_the_reference(b, l, h, p, n, chunk):
    """The whole chunked SSD (the intra term through ``SsdIntra``, the
    chunk states and the inter-chunk scan through autograd) against
    ``jax.vjp`` of the reference's einsum form, for a cotangent of both y
    and the final state."""
    ins = _chunked_inputs(b, l, h, p, n, seed=b + l + chunk)
    gy, gh = _x((b, l, h, p), 90), _x((b, h, p, n), 91)
    f = lambda *a: _jssd_chunked(*a, chunk, use_pallas=False)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    leaves = [_t(a).requires_grad_(True) for a in ins]
    y, hl = ssm.ssd_chunked(*leaves, chunk)
    got = torch.autograd.grad((y, hl), leaves, (_t(gy), _t(gh)))
    _hold(got, want)


def test_backward_plan_fills_the_card_and_divides_the_heads():
    # serving: 8 chunks of 256 rows (10 tile pairs), 64 heads, 132 SMs
    assert ssd_intra.backward_plan(8, 256, 64, 132) == ssd_intra.BwdPlan(32, 2, 10, 160)
    # the calibration batch: one group of every head
    assert ssd_intra.backward_plan(32, 256, 64, 132) == ssd_intra.BwdPlan(64, 1, 10, 320)
    # a ragged Q of 200 rows still takes 4 tiles; one chunk of one tile
    assert ssd_intra.backward_plan(4, 200, 3, 132).n_pairs == 10
    assert ssd_intra.backward_plan(1, 16, 4, 132) == ssd_intra.BwdPlan(1, 4, 1, 4)
    # a wide batch of short chunks: every head in one block
    assert ssd_intra.backward_plan(512, 64, 8, 132) == ssd_intra.BwdPlan(8, 1, 1, 512)


def test_mma_backward_plan_balances_the_card_and_divides_the_heads():
    # serving: 8 chunks x 4 column tiles x 8 groups of 8 heads; the busiest
    # SM takes a column-tile-0 block (9 x 2 units) and a later one (9 x 1)
    assert ssd_intra.mma_backward_plan(8, 256, 64, 132) == ssd_intra.MmaBwdPlan(8, 8, 4, 256, 27)
    # the calibration batch: fewer, larger groups (each group copies dG once)
    pl = ssd_intra.mma_backward_plan(32, 256, 64, 132)
    assert 64 % pl.heads_per_block == 0 and pl.blocks == 32 * 4 * pl.n_groups
    total = 32 * pl.n_groups * sum((pl.heads_per_block + 1) * -(-(4 - jt) // 2) for jt in range(4))
    assert pl.span < total / 132 + 2 * (pl.heads_per_block + 1)
    # a ragged Q of 200 rows still takes 4 column tiles
    assert ssd_intra.mma_backward_plan(4, 200, 3, 132).n_col_tiles == 4


def test_backward_route_takes_the_tensor_cores_only_where_the_kernel_can():
    def args(q=256, p=64, n=128, off=0):
        x = torch.zeros(2 * 1 * q * 2 * p + off)[off:].view(2, 1, q, 2, p)
        bm = torch.zeros(2, 1, q, n)
        return x, bm, bm
    assert ssd_intra.backward_route(*args()) == "mma"
    assert ssd_intra.backward_route(*args(q=200, n=32)) == "mma"
    assert ssd_intra.backward_route(*args(q=300)) == "simt"     # more than 4 row tiles
    assert ssd_intra.backward_route(*args(p=32)) == "simt"      # the reduced configs' P
    assert ssd_intra.backward_route(*args(n=16)) == "simt"      # N not whole stretches of 32
    assert ssd_intra.backward_route(*args(off=1)) == "simt"     # x off a 16-byte boundary
