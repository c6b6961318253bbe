"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA card and import no JAX, so they run on the
card's machine:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_card.py

Without a card they skip (the kernels have no CPU mode).
"""
import pytest
import torch

from repro_torch.kernels import (_build, bottleneck, decode_attn, flat_trunk, ops,
                                 pair_scorer, quant, ssd_intra)
from repro_torch.kernels.ref import code_dtype, decode_attention_ref

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8])
def test_kernels_match_plain_twins_on_card(card, dtype, bits):
    g = torch.Generator(device=card).manual_seed(7)
    for t, d, dp in [(1024, 2048, 512), (513, 384, 96), (100, 260, 64), (100, 257, 63)]:
        x = torch.randn(t, d, generator=g, device=card).to(dtype)
        w = (torch.randn(d, dp, generator=g, device=card) * 0.05).to(dtype)
        q = quant.quantize_2d(x, -3.0, 3.0, bits=bits)
        q_plain = quant.quantize_plain(x, -3.0, 3.0, bits=bits)
        assert torch.equal(q, q_plain)
        assert torch.equal(quant.dequantize_2d(q, -3.0, 3.0, bits=bits),
                           quant.dequantize_plain(q, -3.0, 3.0, bits=bits))
        b = bottleneck.bottleneck_encode(x, w, -4.0, 4.0, bits=bits)
        b_plain = bottleneck.bottleneck_encode_plain(x, w, -4.0, 4.0, bits=bits)
        assert (b.int() - b_plain.int()).abs().max().item() <= 1
    # an x that starts 4 bytes into its buffer takes the element-wise loads
    buf = torch.randn(96 * 256 + 1, generator=g, device=card).to(dtype)
    x, w = buf[1:].view(96, 256), torch.randn(256, 64, generator=g, device=card).to(dtype)
    b = bottleneck.bottleneck_encode(x, w, -4.0, 4.0, bits=bits)
    b_plain = bottleneck.bottleneck_encode_plain(x, w, -4.0, 4.0, bits=bits)
    assert (b.int() - b_plain.int()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 12, 16])
def test_bottleneck_encode_on_the_tensor_cores_at_the_serving_shapes_on_card(card, bits):
    """Both serving shapes take the 3xTF32 kernel and stay within one code
    of the f32 twin at up to 16 bits, where a single TF32 product would
    miss by many codes (its 10-bit mantissa, summed over d = 2048)."""
    g = torch.Generator(device=card).manual_seed(16)
    for t in (1024, 2048):
        x = torch.randn(t, 2048, generator=g, device=card)
        w = torch.randn(2048, 512, generator=g, device=card) * 0.05
        assert bottleneck.route(x, w) == "mma"
        _build.reset_launches()
        b = bottleneck.bottleneck_encode(x, w, -4.0, 4.0, bits=bits)
        assert _build.LAUNCHES["bottleneck_encode"] == 1 and b.dtype == code_dtype(bits)
        b_plain = bottleneck.bottleneck_encode_plain(x, w, -4.0, 4.0, bits=bits)
        assert (b.int() - b_plain.int()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bottleneck_encode_takes_the_simt_kernel_where_the_shape_asks_on_card(card, dtype):
    """d' not a multiple of 4, d not a multiple of 4, and an x four bytes
    into its buffer take the SIMT kernel, chosen before the launch; 16-bit
    codes within one of the twin's, one launch a call."""
    g = torch.Generator(device=card).manual_seed(17)
    buf = torch.randn(300 * 256 + 1, generator=g, device=card).to(dtype)
    cases = [(torch.randn(300, 256, generator=g, device=card).to(dtype),
              (torch.randn(256, 62, generator=g, device=card) * 0.05).to(dtype)),
             (torch.randn(300, 258, generator=g, device=card).to(dtype),
              (torch.randn(258, 64, generator=g, device=card) * 0.05).to(dtype)),
             (buf[1:].view(300, 256), (torch.randn(256, 64, generator=g, device=card)
                                       * 0.05).to(dtype))]
    for x, w in cases:
        assert bottleneck.route(x, w) == "simt"
        _build.reset_launches()
        b = bottleneck.bottleneck_encode(x, w, -4.0, 4.0, bits=16)
        assert _build.LAUNCHES["bottleneck_encode"] == 1
        b_plain = bottleneck.bottleneck_encode_plain(x, w, -4.0, 4.0, bits=16)
        assert (b.int() - b_plain.int()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_quantize_is_bit_equal_on_views_at_any_offset_on_card(card, bits, dtype):
    """The vectorised quantize against its twin, torch.equal: f32 and bf16
    input, uint8 and uint16 codes, n no multiple of 16, and 2-D views that
    start 0-15 bytes past a 16-byte boundary (the scalar head, the
    element-wise stores of an unaligned output chunk and the scalar tail)."""
    g = torch.Generator(device=card).manual_seed(18)
    step = dtype.itemsize
    _build.reset_launches()
    calls = 0
    for m, n in [(1024, 512), (64, 64), (1, 1), (3, 5), (7, 37), (33, 100), (129, 257)]:
        for offset in range(0, 16, step):
            buf = (torch.randn(m * n + offset // step, generator=g, device=card) * 3).to(dtype)
            x = buf[offset // step:].view(m, n)
            assert (x.data_ptr() - buf.data_ptr()) == offset and buf.data_ptr() % 16 == 0
            got = quant.quantize_2d(x, -2.5, 3.0, bits=bits)
            want = quant.quantize_plain(x, -2.5, 3.0, bits=bits)
            assert got.dtype == code_dtype(bits) and torch.equal(got, want), (m, n, offset)
            calls += 1
    assert _build.LAUNCHES["quantize"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_dequantize_is_bit_equal_on_views_at_any_offset_on_card(card, bits, out_dtype):
    """The vectorised dequantize against its twin, torch.equal: uint8 and
    uint16 codes, f32 and bf16 output, n no multiple of 16, and 2-D views
    that start 0-15 bytes past a 16-byte boundary (the scalar head, the
    element-wise stores of an unaligned output chunk and the scalar tail)."""
    g = torch.Generator(device=card).manual_seed(14)
    dtype, levels = code_dtype(bits), (1 << bits) - 1
    step = dtype.itemsize
    _build.reset_launches()
    calls = 0
    for m, n in [(1024, 512), (1, 1), (3, 5), (7, 37), (33, 100), (129, 257)]:
        for offset in range(0, 16, step):
            buf = torch.randint(0, levels + 1, (m * n + offset // step,), generator=g,
                                device=card).to(dtype)
            y = buf[offset // step:].view(m, n)
            assert (y.data_ptr() - buf.data_ptr()) == offset and buf.data_ptr() % 16 == 0
            got = quant.dequantize_2d(y, -2.5, 3.0, bits=bits, out_dtype=out_dtype)
            want = quant.dequantize_plain(y, -2.5, 3.0, bits=bits, out_dtype=out_dtype)
            assert got.dtype == out_dtype and torch.equal(got, want), (m, n, offset)
            calls += 1
    assert _build.LAUNCHES["dequantize"] == calls


def _ssd_inputs(card, g, b, nc, q, h, p, n, dtype):
    xh = torch.randn(b, nc, q, h, p, generator=g, device=card).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, nc, q, h, generator=g, device=card))
    la = -torch.cumsum(dt * 0.3, dim=2)
    bm, cm = (torch.randn(b, nc, q, n, generator=g, device=card).to(dtype) for _ in range(2))
    return xh, dt, la, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_matches_its_plain_twin_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(8)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    # the reference's shapes (tests/test_ssd_kernel.py): elementwise, at the
    # reference's tolerance
    for q, h, p, n in [(16, 2, 8, 8), (32, 4, 16, 8), (64, 2, 32, 16)]:
        args = _ssd_inputs(card, g, 2, 2, q, h, p, n, dtype)
        torch.testing.assert_close(ssd_intra.ssd_intra(*args), ssd_intra.ssd_intra_plain(*args),
                                   rtol=tol, atol=tol)
    # the reduced config's shape, a Q that is no multiple of the 64-row tile,
    # a ragged P of three tiles with ragged N, and the serving shape: with
    # N up to 128 f32 itself breaks an elementwise 1e-5 (max |y| in the
    # hundreds), so the bound is relative to max |plain|
    for b, nc, q, h, p, n in [(2, 3, 16, 16, 32, 16), (2, 2, 200, 3, 64, 128),
                              (1, 2, 100, 2, 130, 24), (2, 4, 256, 64, 64, 128)]:
        args = _ssd_inputs(card, g, b, nc, q, h, p, n, dtype)
        got, want = ssd_intra.ssd_intra(*args), ssd_intra.ssd_intra_plain(*args)
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 256, 64, 64, 128), (2, 2, 200, 3, 64, 128)])
def test_ssd_intra_on_the_tensor_cores_against_float64_on_card(card, shape):
    """The serving shape and a ragged Q take the 3xTF32 kernel, one launch a
    call, and stay within 1e-5 max|y| of the same function in float64 (the
    kernel and the f32 twin sum in different orders)."""
    g = torch.Generator(device=card).manual_seed(19)
    args = _ssd_inputs(card, g, *shape, torch.float32)
    assert ssd_intra.route(args[0], args[3], args[4]) == "mma"
    _build.reset_launches()
    got = ssd_intra.ssd_intra(*args)
    assert _build.LAUNCHES["ssd_intra"] == 1
    exact = ssd_intra.ssd_intra_ref(*(a.double() for a in args))
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_at_the_calibration_shape_on_card(card, dtype):
    """The calibration batch's shape (8 sequences of 4 chunks): the planner's
    other main-path grid (2 groups of 32 heads), against the twin."""
    g = torch.Generator(device=card).manual_seed(20)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    args = _ssd_inputs(card, g, 8, 4, 256, 64, 64, 128, dtype)
    assert ssd_intra.route(args[0], args[3], args[4]) == "mma"
    got, want = ssd_intra.ssd_intra(*args), ssd_intra.ssd_intra_plain(*args)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_takes_the_simt_pair_where_the_shape_asks_on_card(card, dtype):
    """A ragged P and N, a Q above 256 and an x four bytes into its buffer
    take the SIMT pair, chosen before the launch; one launch counted a call,
    within the tolerances of the twin check."""
    g = torch.Generator(device=card).manual_seed(21)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    cases = [_ssd_inputs(card, g, 1, 2, 100, 2, 130, 24, dtype),
             _ssd_inputs(card, g, 1, 1, 300, 2, 64, 32, dtype)]
    xh, dt, la, bm, cm = _ssd_inputs(card, g, 1, 2, 64, 2, 32, 16, dtype)
    buf = torch.empty(xh.numel() + 1, dtype=dtype, device=card)
    buf[1:].copy_(xh.reshape(-1))
    cases.append((buf[1:].view(xh.shape), dt, la, bm, cm))
    for args in cases:
        assert ssd_intra.route(args[0], args[3], args[4]) == "simt"
        _build.reset_launches()
        got, want = ssd_intra.ssd_intra(*args), ssd_intra.ssd_intra_plain(*args)
        assert _build.LAUNCHES["ssd_intra"] == 1
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _scorer_inputs(card, g, n, e, dtype=torch.float32, d_ue=128, hid=48):
    """The pair scorer's inputs at the magnitudes of tests/test_kernels.py;
    the observation block in ``dtype``, the weights in float32."""
    u = lambda *shape: torch.rand(shape, generator=g, device=card)
    r = lambda *shape: torch.randn(shape, generator=g, device=card)
    obs = [torch.tanh(r(n, d_ue)), 1 + 99 * u(n), 5e7 + 4.5e8 * u(n), (u(n) < 0.7).float(),
           0.5 + 1.5 * u(e, 3),
           torch.tensor([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e-12], device=card)]
    return [t.to(dtype) for t in obs] + [r(4, 32) * 0.5, torch.zeros(32, device=card),
                                         r(d_ue + 35, hid) * 0.1, torch.zeros(hid, device=card),
                                         r(hid, 1) * 0.01, torch.zeros(1, device=card)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scorer_matches_its_plain_twin_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(9)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for n, e in [(1, 1), (7, 2), (64, 3), (300, 5), (1024, 3)]:
        args = _scorer_inputs(card, g, n, e, dtype)
        for got, want in zip(pair_scorer.pair_scorer(*args), pair_scorer.pair_scorer_plain(*args)):
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # equal occupancy gives bitwise-equal logits
    args = _scorer_inputs(card, g, 1024, 3)
    a1, a2 = torch.zeros(1024, device=card), torch.zeros(1024, device=card)
    a1[:300], a2[-300:] = 1.0, 1.0
    l1, _ = pair_scorer.pair_scorer(*args[:3], a1, *args[4:])
    l2, _ = pair_scorer.pair_scorer(*args[:3], a2, *args[4:])
    assert torch.equal(l1, l2)


def _trunk(card, g, bits, dims=(19, 64, 64, 13)):
    """A quantized trunk (codes by the quantize kernel, range, biases)."""
    codes, mns, mxs, bs = [], [], [], []
    for d_in, d_out in zip(dims, dims[1:]):
        w = torch.randn(d_in, d_out, generator=g, device=card) * 0.4
        mn, mx = float(w.min()), float(w.max())
        codes.append(quant.quantize_2d(w, mn, mx, bits=bits))
        mns.append(mn)
        mxs.append(mx)
        bs.append(torch.randn(d_out, generator=g, device=card) * 0.1)
    return codes, mns, mxs, bs


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_flat_trunk_matches_its_plain_twin_on_card(card, bits):
    g = torch.Generator(device=card).manual_seed(10)
    codes, mns, mxs, bs = _trunk(card, g, bits)
    assert codes[0].dtype == code_dtype(bits)
    for rows in [(1,), (7,), (32,), (600,), (1024,), (10240,)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(*rows, 19, generator=g, device=card).to(dtype)
            tol = 1e-5 if dtype == torch.float32 else 5e-2
            torch.testing.assert_close(flat_trunk.flat_trunk(x, codes, mns, mxs, bs, bits=bits),
                                       flat_trunk.flat_trunk_plain(x, codes, mns, mxs, bs,
                                                                   bits=bits),
                                       rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", [(1023, 3), (1025, 3), (1024, 8), (300, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scorer_at_ragged_fleets_and_more_servers_on_card(card, n, e, dtype):
    """A last block of 7 or 1 UEs, and E = 8 (64 pairs a block, two passes
    of the pair stage)."""
    g = torch.Generator(device=card).manual_seed(20 + n + e)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    args = _scorer_inputs(card, g, n, e, dtype)
    assert pair_scorer.route(args[0].float(), args[8]) == "bulk"
    for got, want in zip(pair_scorer.pair_scorer(*args), pair_scorer.pair_scorer_plain(*args)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_flat_trunk_dequantized_weights_are_bit_equal_on_card(card, bits):
    """A one-layer trunk on the identity rows with a zero bias returns the
    kernel's dequantized weights exactly (x 1 and + 0 are exact, and the
    other lanes' K parts add zeros)."""
    g = torch.Generator(device=card).manual_seed(21)
    codes, mns, mxs, _ = _trunk(card, g, bits)
    for c, mn, mx in zip(codes, mns, mxs):
        eye = torch.eye(c.shape[0], device=card)
        got = flat_trunk.flat_trunk(eye, [c], [mn], [mx], [torch.zeros(c.shape[1], device=card)],
                                    bits=bits)
        assert torch.equal(got, flat_trunk.dequantized_weights(c, mn, mx, bits=bits))


@pytest.mark.cuda
def test_flat_trunk_other_widths_and_depth_on_card(card):
    """A 2-layer 10 -> 30 -> 5 trunk at 6 bits (its 300 code bytes take the
    loads route), from one row to a persistent grid of many tiles a block."""
    g = torch.Generator(device=card).manual_seed(22)
    codes, mns, mxs, bs = _trunk(card, g, 6, dims=(10, 30, 5))
    assert flat_trunk.route(codes) == "loads"
    for m in (1, 70, 10240, 40000):
        x = torch.randn(m, 10, generator=g, device=card)
        torch.testing.assert_close(flat_trunk.flat_trunk(x, codes, mns, mxs, bs, bits=6),
                                   flat_trunk.flat_trunk_plain(x, codes, mns, mxs, bs, bits=6),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(19, 128, 128, 13), (19, 64, 64, 64, 64, 13)])
@pytest.mark.parametrize("bits", [8, 12])
def test_flat_trunk_wide_and_deep_trunks_on_card(card, dims, bits):
    """Trunks whose padded biases number more than a block's 256 threads
    (128 + 128 + 16 and 4 x 64 + 16 = 272), so the bias load must take some
    threads more than once; the wide one takes one block an SM, and at 12
    bits loads its codes (staged, they would not fit)."""
    g = torch.Generator(device=card).manual_seed(25)
    codes, mns, mxs, bs = _trunk(card, g, bits, dims=dims)
    # the wide trunk's 16-bit codes leave no room to stage them: loads
    wide12 = dims[1] == 128 and bits == 12
    assert flat_trunk.launch_plan(torch.empty(8, dims[0], device=card), codes, bits).route == \
        ("loads" if wide12 else "bulk")
    for m in (1, 600, 10240):
        x = torch.randn(m, dims[0], generator=g, device=card)
        torch.testing.assert_close(flat_trunk.flat_trunk(x, codes, mns, mxs, bs, bits=bits),
                                   flat_trunk.flat_trunk_plain(x, codes, mns, mxs, bs, bits=bits),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flat_trunk_plan_query_gives_the_kernel_layout_on_card(card):
    """The shared memory the library reports is the kernel's layout: f64
    weight fragments (K padded to 4, N to 8), the K parts' sums (8 warps x
    32 lanes x 2 f64), two f64 activation tiles of the widest hidden layer
    (rows padded by 4), the layers' 64-byte table, the f32 biases (padded to
    8), two f32 row stages (padded to 4), the codes' staging area on the
    bulk route, the 8-byte mbarrier; widths that need more than a block has
    are refused before the launch."""
    g = torch.Generator(device=card).manual_seed(26)
    x = torch.randn(1024, 19, generator=g, device=card)
    n = (8 * (20 * 64 + 64 * 64 + 64 * 16) + 8 * 512 + 8 * 2 * 8 * 68 + 3 * 64 + 4 * 144
         + 4 * 2 * 8 * 20)
    codes8, codes12 = _trunk(card, g, 8)[0], _trunk(card, g, 12)[0]
    pl = flat_trunk.launch_plan(x, codes8, 8)
    assert (pl.route, pl.smem_bytes, pl.k_split, pl.tiles) == ("bulk", n + 6144 + 8, (1, 1, 4), 128)
    assert pl.grid == 128
    assert flat_trunk.launch_plan(x, codes12, 12).smem_bytes == n + 2 * 6144 + 8
    shifted = torch.empty(64 * 64 + 1, dtype=torch.uint8, device=card)[1:].view(64, 64)
    shifted.copy_(codes8[1])
    loads = flat_trunk.launch_plan(x, [codes8[0], shifted, codes8[2]], 8)
    assert (loads.route, loads.smem_bytes) == ("loads", n + 8)
    big = flat_trunk.launch_plan(torch.randn(10240, 19, device=card), codes8, 8)
    assert big.tiles == 1280 and big.grid < big.tiles      # one wave, several tiles a block
    odd = _trunk(card, g, 6, dims=(10, 30, 5))[0]
    n = 8 * (12 * 32 + 32 * 8) + 8 * 512 + 8 * 2 * 8 * 36 + 2 * 64 + 4 * (32 + 8) + 4 * 2 * 8 * 12
    assert flat_trunk.launch_plan(x[:70, :10], odd, 6).smem_bytes == n + 8
    with pytest.raises(ValueError, match="shared memory"):
        flat_trunk.launch_plan(x, _trunk(card, g, 8, dims=(19, 256, 256, 13))[0], 8)


@pytest.mark.cuda
def test_dispatch_kernels_are_deterministic_and_launch_once_a_call_on_card(card):
    """The same call twice gives the same bits (fixed-order sums, no
    atomics), and each call is one launch."""
    g = torch.Generator(device=card).manual_seed(23)
    args = _scorer_inputs(card, g, 1024, 3)
    codes, mns, mxs, bs = _trunk(card, g, 8)
    x = torch.randn(10240, 19, generator=g, device=card)
    _build.reset_launches()
    l1, s1 = pair_scorer.pair_scorer(*args)
    assert _build.LAUNCHES["pair_scorer"] == 1
    l2, s2 = pair_scorer.pair_scorer(*args)
    assert torch.equal(l1, l2) and torch.equal(s1, s2)
    _build.reset_launches()
    t1 = flat_trunk.flat_trunk(x, codes, mns, mxs, bs)
    assert _build.LAUNCHES["flat_trunk"] == 1
    assert torch.equal(t1, flat_trunk.flat_trunk(x, codes, mns, mxs, bs))
    assert sum(_build.LAUNCHES.values()) == 2


@pytest.mark.cuda
def test_dispatch_kernels_take_the_loads_route_where_planned_on_card(card):
    """Inputs off a 16-byte boundary, and widths that are not multiples of 4,
    take the loads route and still match the twins."""
    g = torch.Generator(device=card).manual_seed(24)
    args = _scorer_inputs(card, g, 300, 3)
    ue = torch.empty(300 * 128 + 1, device=card)[1:].view(300, 128)
    ue.copy_(args[0])
    moved = [ue] + args[1:]
    assert pair_scorer.route(ue, args[8]) == "loads"
    odd = _scorer_inputs(card, g, 300, 3, d_ue=126, hid=50)
    assert pair_scorer.route(odd[0], odd[8]) == "loads"
    for a in (moved, odd):
        _build.reset_launches()
        got = pair_scorer.pair_scorer(*a)
        assert _build.LAUNCHES["pair_scorer"] == 1
        for k, p in zip(got, pair_scorer.pair_scorer_plain(*a)):
            torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-5)
    codes, mns, mxs, bs = _trunk(card, g, 8)
    shifted = torch.empty(codes[1].numel() + 1, dtype=torch.uint8, device=card)[1:]
    shifted = shifted.view(codes[1].shape)
    shifted.copy_(codes[1])
    codes[1] = shifted
    assert flat_trunk.route(codes) == "loads"
    x = torch.randn(600, 19, generator=g, device=card)
    torch.testing.assert_close(flat_trunk.flat_trunk(x, codes, mns, mxs, bs),
                               flat_trunk.flat_trunk_plain(x, codes, mns, mxs, bs),
                               rtol=1e-5, atol=1e-5)


def _decode_inputs(card, g, b, s, hkv, grp, d, dtype=torch.float32, empty_row=False):
    """The reference's decode inputs (tests/test_kernels.py:58): slots with
    pos % 5 == 2 empty; optionally batch row 0 with every slot empty."""
    q = torch.randn(b, hkv * grp, d, generator=g, device=card)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=card).to(dtype) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device=card).expand(b, s).clone()
    pos[pos % 5 == 2] = -1
    if empty_row:
        pos[0] = -1
    return q, k, v, pos


def _assert_twin(got, want, tol):
    """Within the reference's tol (2e-5 in f32, 5e-2 with a bf16 cache), and
    within 2e-5 whatever the cache: kernel and twin read the same values and
    compute in f32, so only the order of the sums parts them."""
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_its_plain_twin_on_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(11)
    # 2e-5 is tests/test_kernels.py:72's bound in f32; 5e-2 with a bf16 cache
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    cases = [(2, s, hkv, grp, 64) for s in (64, 257, 1024) for hkv, grp in ((2, 4), (1, 8), (4, 1))]
    cases += [(2, 1088, 2, 2, 32), (2, 600, 2, 2, 128), (4, 2080, 8, 2, 128), (3, 5, 1, 1, 32)]
    for b, s, hkv, grp, d in cases:
        q, k, v, pos = _decode_inputs(card, g, b, s, hkv, grp, d, dtype)
        idx = s - 10
        _assert_twin(decode_attn.decode_attention(q, k, v, pos, idx),
                     decode_attn.decode_attention_plain(q, k, v, pos, idx), tol)
    # bf16 queries, as the bf16 model's decode gives them
    q, k, v, pos = _decode_inputs(card, g, 4, 2080, 8, 2, 128, dtype)
    _assert_twin(decode_attn.decode_attention(q.bfloat16(), k, v, pos, 2079),
                 decode_attn.decode_attention_plain(q.bfloat16(), k, v, pos, 2079), tol)


def _ring(card, b, s):
    """pos of a ring of S slots that has wrapped: idx = 3 S + 5 and slot j
    holds the last position = j mod S; slots with pos % 5 == 2 empty."""
    idx = 3 * s + 5
    p = torch.arange(idx - s + 1, idx + 1, device=card)
    pos = torch.empty((b, s), dtype=torch.int32, device=card)
    pos[:, p % s] = p.to(torch.int32)
    pos[pos % 5 == 2] = -1
    return pos, idx


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_decode_attention_takes_every_g_d_cache_and_window_on_card(card, kv, d):
    """Any G (padded to a block's rows, or in row groups past 16, 8 at D
    256), each D of the registry and the reference's kernel, f32, bf16 and
    int8 caches (the last with its scales), with and without a window on a
    wrapped ring: within 2e-5 + 2e-5 |plain| of the twin."""
    g = torch.Generator(device=card).manual_seed(d)
    for grp in (1, 3, 5, 7, 16, 17, 24):
        for s, window in ((33, 0), (300, 0), (300, 64)):
            b, hkv = 2, 2
            q = torch.randn(b, hkv * grp, d, generator=g, device=card)
            if kv == "int8":
                k, v = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=card)
                        .to(torch.int8) for _ in range(2))
                scales = {n: 0.01 + 0.04 * torch.rand(b, s, hkv, generator=g, device=card)
                          for n in ("k_scale", "v_scale")}
            else:
                k, v = (torch.randn(b, s, hkv, d, generator=g, device=card)
                        .to(getattr(torch, kv)) for _ in range(2))
                scales = {}
            pos, idx = _ring(card, b, s)
            _assert_twin(decode_attn.decode_attention(q, k, v, pos, idx, window=window, **scales),
                         decode_attn.decode_attention_plain(q, k, v, pos, idx, window=window,
                                                            **scales), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_the_planners_edges_on_card(card, dtype):
    """S = 1 and S at the tile and split edges the planner makes (a tile
    less one, a tile, a tile and one, eight splits' worth and one), B Hkv
    not dividing 132 and above a wave, G = 8 with D = 32, f32 and bf16 q,
    a row with no valid slot and a split whose slots are all empty."""
    g = torch.Generator(device=card).manual_seed(15)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    tile = decode_attn.TILE
    cases = [(2, 1, 2, 4, 64), (2, tile - 1, 2, 2, 128), (2, tile, 2, 2, 128),
             (2, tile + 1, 2, 2, 128), (2, 8 * tile + 1, 2, 2, 64), (1, 8 * 260 + 1, 2, 2, 128),
             (5, 700, 7, 1, 64), (2, 300, 2, 8, 32), (40, 100, 8, 2, 64), (4, 2080, 8, 2, 128)]
    for b, s, hkv, grp, d in cases:
        q, k, v, pos = _decode_inputs(card, g, b, s, hkv, grp, d, dtype, empty_row=b > 1)
        n, per = decode_attn.plan_splits(b * hkv, s,
                                         decode_attn.resident_blocks(card, dtype, grp, d))
        pos[-1, (n - 1) * per:] = -1                    # the last split of the last row
        for qq in (q, q.bfloat16()):
            _assert_twin(decode_attn.decode_attention(qq, k, v, pos, s - 1),
                         decode_attn.decode_attention_plain(qq, k, v, pos, s - 1), tol)


@pytest.mark.cuda
def test_decode_attention_row_with_no_valid_slot_gives_the_mean_of_v(card):
    g = torch.Generator(device=card).manual_seed(12)
    q, k, v, pos = _decode_inputs(card, g, 2, 300, 2, 4, 64, empty_row=True)
    got = decode_attn.decode_attention(q, k, v, pos, 290)
    mean = v[0].mean(0).repeat_interleave(4, dim=0)          # (Hq, D)
    torch.testing.assert_close(got[0], mean, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, decode_attn.decode_attention_plain(q, k, v, pos, 290),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_decode_attention_log_sum_exp_matches_its_twin_on_card(card, kv):
    """``return_lse``: the same launch also writes each row's log-sum-exp,
    within 2e-5 + 2e-5 |plain| of the twin's (an empty row's -1e30 equal),
    the output the same bits as without it, at one split and at many (a
    tensor-parallel rank's run of 1040 slots), G 7 and 8."""
    g = torch.Generator(device=card).manual_seed(17)
    for b, s, hkv, grp, d in ((2, 40, 2, 7, 64), (2, 1040, 4, 7, 128), (3, 700, 2, 8, 128)):
        q = torch.randn(b, hkv * grp, d, generator=g, device=card).bfloat16()
        if kv == "int8":
            k, v = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=card)
                    .to(torch.int8) for _ in range(2))
            scales = {n: 0.01 + 0.04 * torch.rand(b, s, hkv, generator=g, device=card)
                      for n in ("k_scale", "v_scale")}
        else:
            k, v = (torch.randn(b, s, hkv, d, generator=g, device=card).to(getattr(torch, kv))
                    for _ in range(2))
            scales = {}
        pos = torch.arange(s, dtype=torch.int32, device=card).repeat(b, 1)
        pos[0] = -1
        pos[1, s // 3:] = -1
        _build.reset_launches()
        out, lse = decode_attn.decode_attention(q, k, v, pos, s - 1, return_lse=True, **scales)
        assert _build.LAUNCHES["decode_attention"] == 1 and lse.shape == (b, hkv * grp)
        want, want_lse = decode_attn.decode_attention_plain(q, k, v, pos, s - 1, return_lse=True,
                                                            **scales)
        assert torch.equal(out, decode_attn.decode_attention(q, k, v, pos, s - 1, **scales))
        _assert_twin(out, want, 2e-5)
        torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
        assert torch.equal(lse[0], want_lse[0])


@pytest.mark.cuda
def test_decode_attention_counts_launches_and_refuses_what_it_does_not_take(card):
    g = torch.Generator(device=card).manual_seed(13)
    q, k, v, pos = _decode_inputs(card, g, 2, 64, 2, 2, 64)
    _build.reset_launches()
    out = ops.decode_attention(q, k, v, pos, 60)
    assert _build.LAUNCHES["decode_attention"] == 1 and out.dtype == torch.float32
    torch.testing.assert_close(out, decode_attention_ref(q.double(), k.double(), v.double(),
                                                         pos, 60).float(), rtol=2e-5, atol=2e-5)
    with pytest.raises(TypeError):                        # a float cache with scales
        decode_attn.decode_attention(q, k, v, pos, 60, k_scale=pos.float()[..., None],
                                     v_scale=pos.float()[..., None])
    with pytest.raises(TypeError):                        # int8 codes without scales
        decode_attn.decode_attention(q, k.to(torch.int8), v.to(torch.int8), pos, 60)
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                     v[..., :48].contiguous(), pos, 60)            # D 48
    with pytest.raises(TypeError):
        decode_attn.decode_attention(q, k, v, pos.long(), 60)
    with pytest.raises(ValueError):
        decode_attn.decode_attention(q, k, v, pos.cpu(), 60)


# ------------------------------------------------- pair_scorer: envs and backward
# The shapes the training path gives the kernels: the rollout (4 envs of 4
# UEs, 2 servers), the minibatch (256 samples), the zero-shot pool (E 3),
# the dispatch fleet (1024 UEs, E 3), a ragged N and E 1 and 5.
GRAD_SHAPES = [(4, 4, 2), (256, 4, 2), (4, 4, 3), (1, 1024, 3), (3, 13, 2), (2, 20, 1),
               (2, 20, 5)]


def _grad_inputs(card, g, b, n, e, dtype=torch.float32):
    """Batched scorer inputs at the training path's magnitudes (slowness in
    s/FLOP, edge work in FLOPs, so the edge features are O(1)); the
    observation block (ue, d, work, active, geom) in ``dtype``."""
    u = lambda *shape: torch.rand(shape, generator=g, device=card)
    r = lambda *shape: torch.randn(shape, generator=g, device=card)
    geom = torch.stack([0.9 + 1.1 * u(b, e), 0.5 + 0.75 * u(b, e), 4.2e-12 * u(b, e)], -1)
    obs = [torch.tanh(r(b, n, 128)), 1 + 99 * u(b, n), 1e8 + 4.9e9 * u(b, n),
           (u(b, n) < 0.7).float(), geom]
    consts = torch.tensor([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e12], device=card)
    return [t.to(dtype) for t in obs] + [consts, r(4, 32) * 0.5, r(32) * 0.1, r(163, 48) * 0.1,
                                         r(48) * 0.1, r(48, 1) * 0.3, r(1)]


_GRAD_ARGS = (0, 6, 7, 8, 9, 10, 11)       # ue_emb and the weights take gradients


def _float64_grads(args, g_logits, g_srv):
    """Autograd of the plain twin in float64 from the same inputs."""
    wide = [a.detach().double().requires_grad_(i in _GRAD_ARGS) for i, a in enumerate(args)]
    logits, srv = pair_scorer.pair_scorer_plain(*wide)
    loss = (logits * g_logits.double()).sum() + (srv * g_srv.double()).sum()
    return torch.autograd.grad(loss, [wide[i] for i in _GRAD_ARGS])


def _hold(got, want, what, bf16_ue=False):
    """Each gradient within 1e-5 of its largest magnitude; d ue in bf16 also
    one bf16 step of each element (2^-7 of it: two float32 values a
    rounding apart may round to neighbouring bf16 values)."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.double(), b.double()
        tol = 1e-5 * float(b.abs().max()) + (2.0 ** -7 * b.abs() if bf16_ue and i == 0 else 0)
        assert bool(((a - b).abs() <= tol).all()), (what, i, float((a - b).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_scorer_backward_matches_its_formula_and_float64_on_card(card, b, n, e, dtype):
    g = torch.Generator(device=card).manual_seed(30 + b + n + e)
    args = _grad_inputs(card, g, b, n, e, dtype)
    g_logits = torch.randn((b, n, e), generator=g, device=card)
    g_srv = torch.randn((b, e, 32), generator=g, device=card)
    _build.reset_launches()
    _, srv = pair_scorer.pair_scorer(*args)
    got = pair_scorer.pair_scorer_backward(g_logits, g_srv, *args, srv=srv)
    assert _build.LAUNCHES["pair_scorer_backward"] == 1 and _build.LAUNCHES["pair_scorer"] == 1
    assert got[0].dtype == dtype and got[0].shape == (b, n, 128)
    bf16 = dtype == torch.bfloat16
    _hold(got, pair_scorer.pair_scorer_backward_plain(g_logits, g_srv, *args), "plain", bf16)
    _hold(got, _float64_grads(args, g_logits, g_srv), "float64", bf16)
    again = pair_scorer.pair_scorer_backward(g_logits, g_srv, *args, srv=srv)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e", [(4, 4, 2), (256, 4, 2), (3, 37, 3), (2, 1025, 5)])
def test_pair_scorer_batched_forward_equals_single_env_launches_on_card(card, b, n, e):
    """One launch over B envs gives the bits of B launches of one env, and
    the twin's values within the reference's 1e-5."""
    g = torch.Generator(device=card).manual_seed(40 + b + n)
    args = _grad_inputs(card, g, b, n, e)
    _build.reset_launches()
    logits, srv = pair_scorer.pair_scorer(*args)
    assert _build.LAUNCHES["pair_scorer"] == 1
    assert logits.shape == (b, n, e) and srv.shape == (b, e, 32)
    for i in range(b):
        one = pair_scorer.pair_scorer(*(a[i] for a in args[:5]), *args[5:])
        assert torch.equal(logits[i], one[0]) and torch.equal(srv[i], one[1])
    for got, want in zip((logits, srv), pair_scorer.pair_scorer_plain(*args)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ops_pair_scorer_differentiates_through_the_kernels_on_card(card):
    """ops.pair_scorer on (T, B, ...) leaves: one forward and one backward
    launch, the card's gradients those of the CPU's plain twins."""
    g = torch.Generator(device=card).manual_seed(50)
    args = _grad_inputs(card, g, 8, 4, 2)
    params = [a.clone().requires_grad_(True) for a in args[6:]]
    mix = torch.randn((2, 4, 4, 2), generator=g, device=card)

    def run(dev):
        ue = args[0].reshape(2, 4, 4, 128).to(dev).requires_grad_(True)
        raw = {"d": args[1].reshape(2, 4, 4).to(dev), "work": args[2].reshape(2, 4, 4).to(dev),
               "active": args[3].reshape(2, 4, 4).to(dev),
               "geom": args[4].reshape(2, 4, 2, 3).to(dev),
               "consts": args[5].expand(2, 4, 8).to(dev)}
        w = [p.detach().to(dev).requires_grad_(True) for p in params]
        logits, srv = ops.pair_scorer(ue, raw, {"w": w[0], "b": w[1]},
                                      [{"w": w[2], "b": w[3]}, {"w": w[4], "b": w[5]}])
        assert logits.shape == (2, 4, 4, 2) and srv.shape == (2, 4, 2, 32)
        # a logit term too: a softmax alone leaves b2 a zero gradient
        loss = (torch.softmax(logits, -1) @ srv).square().sum() + srv.mean() \
            + (logits * mix.to(dev)).sum()
        return [t.cpu() for t in torch.autograd.grad(loss, [ue] + w)]

    _build.reset_launches()
    got = run(card)
    assert dict(_build.LAUNCHES) == {"pair_scorer": 1, "pair_scorer_backward": 1}
    _hold(got, run(torch.device("cpu")), "cpu")
