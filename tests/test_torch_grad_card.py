"""The port's backward kernels and the forward-only guard, on the card.

These tests need an NVIDIA card and import no JAX, so they run on the
card's machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_grad_card.py

Without a card they skip (the kernels have no CPU mode). The scorer's
backward is held to its formula and float64 at the training path's shapes
in ``tests/test_torch_kernels_card.py``; here it is held to one launch a
call with nothing else on the card.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build, decode_attn, flat_trunk, pair_scorer, quant, ssd_intra
from repro_torch.models import init_params, loss_fn

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

BF16_STEP = 2.0 ** -7     # one bf16 step of an element, relative


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ssd_inputs(card, g, b, nc, q, h, p, n, dtype):
    """ssd_intra's inputs as the SSD mixer gives them, and an incoming dy."""
    xh = torch.randn(b, nc, q, h, p, generator=g, device=card).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, nc, q, h, generator=g, device=card))
    la = -torch.cumsum(dt * 0.3, dim=2)
    bm, cm = (torch.randn(b, nc, q, n, generator=g, device=card).to(dtype) for _ in range(2))
    dy = torch.randn(b, nc, q, h, p, generator=g, device=card)
    return dy, xh, dt, la, bm, cm


def _hold(got, want, what, bf16=()):
    """Each gradient within 1e-5 of its largest magnitude (the reference's
    f32 bound for this term); a gradient returned in bf16 also within one
    bf16 step of each element."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.double(), b.double()
        tol = 1e-5 * float(b.abs().max()) + (BF16_STEP * b.abs() if i in bf16 else 0.0)
        assert bool(((a - b).abs() <= tol).all()), (what, i, float((a - b).abs().max()),
                                                    float(b.abs().max()))


# (B, NC, Q, H, P, N): the serving shape and a ragged Q (the forward's
# tensor-core route), a ragged P and N (its SIMT route), the reference's
@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [((2, 4, 256, 64, 64, 128), "mma"),
                                         ((2, 2, 200, 3, 64, 128), "mma"),
                                         ((1, 2, 100, 2, 130, 24), "simt"),
                                         ((2, 2, 64, 2, 32, 16), "mma")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_backward_matches_its_formula_and_float64_on_card(card, shape, route, dtype):
    g = torch.Generator(device=card).manual_seed(60 + sum(shape))
    dy, *args = _ssd_inputs(card, g, *shape, dtype)
    assert ssd_intra.route(args[0], args[3], args[4]) == route
    _build.reset_launches()
    got = ssd_intra.ssd_intra_backward(dy, *args)
    again = ssd_intra.ssd_intra_backward(dy, *args)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"ssd_intra_backward": 2}
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32, dtype, dtype]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bf16 = (0, 3, 4) if dtype == torch.bfloat16 else ()
    _hold(got, ssd_intra.ssd_intra_backward_plain(dy, *args), "plain", bf16)
    _hold(got, ssd_intra.ssd_intra_backward_plain(*(t.double() for t in (dy, *args))),
          "float64", bf16)


@pytest.mark.cuda
def test_ops_ssd_intra_differentiates_through_both_kernels_on_card(card):
    """A train-mode call keeps the intra-chunk gradient: one forward and one
    backward launch, the gradients those of the CPU's twin and formula."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=card).manual_seed(61)
    dy, *args = _ssd_inputs(card, g, 2, 2, 128, 4, 64, 32, torch.float32)

    def grads(dev):
        leaves = [a.to(dev).requires_grad_(True) for a in args]
        y = ops.ssd_intra(*leaves)
        return [t.cpu() for t in torch.autograd.grad(y, leaves, dy.to(dev))]

    _build.reset_launches()
    got = grads(card)
    assert dict(_build.LAUNCHES) == {"ssd_intra": 1, "ssd_intra_backward": 1}
    _hold(got, grads(torch.device("cpu")), "cpu")


@pytest.mark.cuda
def test_mamba2_loss_gradient_runs_the_backward_kernel_on_card(card):
    """A reduced mamba2 stack's loss gradient on the card against the CPU's:
    two ssd_intra launches a layer (the forward and, under the config's
    remat, its recompute in the backward) and one ssd_intra backward
    launch a layer, every parameter's gradient within
    1e-4 of its largest (f32 on both sides, products summed in other
    orders, as tests/test_torch_loss.py holds the port to the reference)."""
    cfg = reduced(get_config("mamba2-1.3b"), n_layers=2)
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, d_state=32, chunk=64))
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=torch.Generator().manual_seed(0))
    labels = tokens.roll(-1, dims=1)
    labels[:, -1] = -100

    def grads(dev):
        model = init_params(cfg, torch.Generator().manual_seed(1), "cpu").to(dev)
        loss, _ = loss_fn(model, {"tokens": tokens.to(dev), "labels": labels.to(dev)})
        return [t.cpu() for t in torch.autograd.grad(loss, list(model.parameters()))]

    _build.reset_launches()
    got = grads(card)
    assert dict(_build.LAUNCHES) == {"ssd_intra": 4, "ssd_intra_backward": 2}
    for a, b in zip(got, grads(torch.device("cpu"))):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _scorer_inputs(card, g, b, n, e, d_ue=128, hid=48):
    """Batched scorer inputs at the training path's magnitudes (as
    ``tests/test_torch_kernels_card.py`` draws them), at any UE width
    ``d_ue`` and hidden width ``hid``."""
    u = lambda *s: torch.rand(s, generator=g, device=card)
    r = lambda *s: torch.randn(s, generator=g, device=card)
    geom = torch.stack([0.9 + 1.1 * u(b, e), 0.5 + 0.75 * u(b, e), 4.2e-12 * u(b, e)], -1)
    return [torch.tanh(r(b, n, d_ue)), 1 + 99 * u(b, n), 1e8 + 4.9e9 * u(b, n),
            (u(b, n) < 0.7).float(), geom,
            torch.tensor([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e12], device=card),
            r(4, 32) * 0.5, r(32) * 0.1, r(d_ue + 35, hid) * 0.1, r(hid) * 0.1,
            r(hid, 1) * 0.3, r(1)]


def _off_boundary(t):
    """A copy of ``t`` that starts one element (4 bytes) past a 16-byte
    boundary."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


@pytest.mark.cuda
def test_pair_scorer_backward_is_one_launch_with_nothing_else_on_card(card):
    """At the fleet demo's minibatch shape a call after the first launches
    the backward kernel and nothing else (no GEMM, no memset), reuses its
    workspace, and allocates only the gradients it returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=card).manual_seed(62)
    b, n, e = 256, 4, 2
    args = _scorer_inputs(card, g, b, n, e)
    g_l, g_s = (torch.randn(s, generator=g, device=card) for s in ((b, n, e), (b, e, 32)))
    srv = pair_scorer.pair_scorer(*args)[1]
    first = pair_scorer.pair_scorer_backward(g_l, g_s, *args, srv=srv)
    torch.cuda.synchronize()
    workspace = {k: (v[0].data_ptr(), v[1].data_ptr()) for k, v in pair_scorer._WORKSPACE.items()}
    before = torch.cuda.memory_allocated(card)
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = pair_scorer.pair_scorer_backward(g_l, g_s, *args, srv=srv)
        torch.cuda.synchronize()
    kernels = [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    assert dict(_build.LAUNCHES) == {"pair_scorer_backward": 1}
    assert kernels and all("pair_scorer_backward_kernel" in k for k in kernels), kernels
    assert {k: (v[0].data_ptr(), v[1].data_ptr())
            for k, v in pair_scorer._WORKSPACE.items()} == workspace
    returned = sum(t.numel() * t.element_size() for t in got)
    assert torch.cuda.memory_allocated(card) - before <= returned + 512 * len(got)
    assert all(torch.equal(a, c) for a, c in zip(first, got))


# the minibatch's whole-env units and a fleet's chunks of one env; a UE
# block or W1 off a 16-byte boundary, or widths that are not multiples of 4
@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e", [(256, 4, 2), (1, 300, 3)])
@pytest.mark.parametrize("case", ["ue_off_boundary", "w1_off_boundary", "d_ue126_h50"])
def test_pair_scorer_backward_on_the_loads_route_on_card(card, b, n, e, case):
    """Where the bulk copy cannot take W1 or the UE rows, the backward loads
    them into the same padded layout: its gradients are held to the formula
    and to float64 within 1e-5 of each one's largest, as on the bulk route,
    in one launch, with the same bits twice."""
    g = torch.Generator(device=card).manual_seed(64 + n)
    widths = dict(d_ue=126, hid=50) if case == "d_ue126_h50" else {}
    args = _scorer_inputs(card, g, b, n, e, **widths)
    moved = {"ue_off_boundary": 0, "w1_off_boundary": 8}.get(case)
    if moved is not None:
        args[moved] = _off_boundary(args[moved])
    assert pair_scorer.route(args[0], args[8]) == "loads"
    g_l, g_s = (torch.randn(s, generator=g, device=card) for s in ((b, n, e), (b, e, 32)))
    srv = pair_scorer.pair_scorer(*args)[1]
    _build.reset_launches()
    got = pair_scorer.pair_scorer_backward(g_l, g_s, *args, srv=srv)
    again = pair_scorer.pair_scorer_backward(g_l, g_s, *args, srv=srv)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"pair_scorer_backward": 2}
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    _hold(got, pair_scorer.pair_scorer_backward_plain(g_l, g_s, *args), "plain")
    grads = (0, 6, 7, 8, 9, 10, 11)     # ue_emb and the weights
    wide = [a.double().requires_grad_(i in grads) for i, a in enumerate(args)]
    logits, srv64 = pair_scorer.pair_scorer_plain(*wide)
    loss = (logits * g_l.double()).sum() + (srv64 * g_s.double()).sum()
    _hold(got, torch.autograd.grad(loss, [wide[i] for i in grads]), "float64")


@pytest.mark.parametrize("shape,units", [
    ((256, 4, 2), (2, 0, 128)),     # the fleet demo's minibatch: 2 envs a unit
    ((4, 4, 2), (1, 0, 4)),         # its rollout: one env a unit
    ((3, 13, 2), (1, 0, 3)),        # a ragged N
    ((64, 1, 20), (1, 0, 64)),      # more servers than a unit's 16 pairs: one env
    ((1, 1024, 3), (0, 8, 128)),    # the dispatch fleet: 8-row chunks of one env
    ((2, 1025, 5), (0, 16, 130)),   # a ragged fleet: 16-row chunks
    ((1, 40, 3), (0, 8, 5)),        # a fleet just past one unit's 32 rows
])
def test_pair_scorer_backward_units(shape, units):
    """The backward's unit layout on 132 SMs (on the CPU: no card needed):
    whole envs where N <= 32, as many as keep the grid within one wave,
    else chunks of one env."""
    b, n, e = shape
    assert pair_scorer.backward_units(b, n, e, 132) == units
    envs, rows, count = units
    assert (envs * n if envs else rows) <= pair_scorer.BWD_MAX_ROWS


def test_guard_names_the_forward_only_kernels():
    """On the CPU the guard itself: it raises only in grad mode with an
    input that requires grad (the wrappers call it on CUDA tensors only)."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="flat_trunk: the kernel has no backward"):
        _build.refuse_grad("flat_trunk", x, torch.zeros(2))
    with torch.no_grad():
        _build.refuse_grad("flat_trunk", x)
    with torch.inference_mode():
        _build.refuse_grad("flat_trunk", x)
    _build.refuse_grad("flat_trunk", x.detach(), 1.5)


@pytest.mark.cuda
def test_forward_only_kernels_refuse_inputs_that_require_grad_on_card(card):
    """dequantize, decode_attention and flat_trunk have no backward: on the
    card, in grad mode, an input their twins would differentiate must not
    require grad (the gradient would be dropped); detached or under
    no_grad / inference_mode they run."""
    g = torch.Generator(device=card).manual_seed(63)
    codes = quant.quantize_2d(torch.randn(8, 16, generator=g, device=card), -2.0, 2.0)
    mn = torch.tensor(-2.0, device=card, requires_grad=True)
    q = torch.randn(2, 8, 64, generator=g, device=card)
    k, v = (torch.randn(2, 16, 2, 64, generator=g, device=card) for _ in range(2))
    pos = torch.arange(16, dtype=torch.int32, device=card).expand(2, 16).contiguous()
    w = torch.randn(19, 13, generator=g, device=card) * 0.4
    tcodes = [quant.quantize_2d(w, float(w.min()), float(w.max()))]
    rows = torch.randn(5, 19, generator=g, device=card)
    bias = torch.zeros(13, device=card)
    qg, rows_g = q.clone().requires_grad_(True), rows.clone().requires_grad_(True)
    calls = {   # name: the call on inputs that require grad, or on detached ones
        "dequantize": lambda grad: quant.dequantize_2d(codes, mn if grad else mn.detach(), 2.0),
        "decode_attention": lambda grad: decode_attn.decode_attention(
            qg if grad else q, k, v, pos, 15),
        "flat_trunk": lambda grad: flat_trunk.flat_trunk(
            rows_g if grad else rows, tcodes, [float(w.min())], [float(w.max())], [bias]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
            call(True)
        out = call(False)
        with torch.no_grad():
            assert torch.equal(call(True), out)
        with torch.inference_mode():
            assert torch.equal(call(True), out)
    torch.cuda.synchronize()
