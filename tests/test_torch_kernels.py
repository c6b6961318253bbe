"""Parity of the port's kernel wrappers with the JAX reference kernels.

On the CPU the wrappers run their plain PyTorch twins; the JAX side runs
the Pallas kernels in interpret mode and the reference oracles. Shapes and
tolerances are those of tests/test_kernels.py. The kernels themselves are
held to the twins on the card by tests/test_torch_kernels_card.py and by
chip_smoke.py.
"""
import collections
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, bottleneck, ops, quant, ref, ssd_intra

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of ``dtype``
    (both frameworks round f32 -> bf16 to nearest even)."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH[dtype])


def _codes(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("shape", [(17, 130), (256, 512), (3, 5, 384)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(shape, bits, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    xj, xt = _both(x, dtype)
    ours = _codes(ops.quantize(xt, -9.0, 9.0, bits=bits))
    pallas = _codes(jops.quantize(xj, -9.0, 9.0, bits=bits, interpret=True))
    oracle = _codes(jref.quantize_ref(xj, -9.0, 9.0, bits=bits))
    assert ours.shape == pallas.shape == shape
    if dtype == "float32":
        # the same float32 steps and round-half-even on both sides
        np.testing.assert_array_equal(ours, pallas)
        np.testing.assert_array_equal(ours, oracle)
    else:
        # the reference's bf16 tolerance: values at .5 boundaries may round
        # one code apart
        assert np.abs(ours - pallas).max() <= 1
        assert np.abs(ours - oracle).max() <= 1


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_dequantize_matches_jax(bits):
    x = np.random.default_rng(1).standard_normal((64, 257)).astype(np.float32) * 2
    q = np.asarray(jref.quantize_ref(jnp.asarray(x), -7.0, 7.0, bits=bits))
    qt = torch.from_numpy(q.astype(np.int32)).to(ref.code_dtype(bits))
    ours = ops.dequantize(qt, -7.0, 7.0, bits=bits).numpy()
    pallas = np.asarray(jops.dequantize(jnp.asarray(q), -7.0, 7.0, bits=bits,
                                        interpret=True))
    oracle = np.asarray(jref.dequantize_ref(jnp.asarray(q), -7.0, 7.0, bits=bits))
    # the reference's tolerance: the kernel's association of Eq. 2 differs
    # from the oracle's by float32 rounding
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref.dequantize_ref(qt, -7.0, 7.0, bits=bits).numpy(),
                               oracle, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_quant_roundtrip_error_bound(out_dtype):
    """Round-off error is at most half a quantization step (Eq. 1-2), plus
    the bf16 rounding of the output where it is bf16."""
    x = np.random.default_rng(2).uniform(-5.0, 5.0, (128, 256)).astype(np.float32)
    xt = torch.from_numpy(x)
    for bits in (4, 8):
        q = ops.quantize(xt, -5.0, 5.0, bits=bits)
        d = ops.dequantize(q, -5.0, 5.0, bits=bits, out_dtype=out_dtype)
        assert d.dtype == out_dtype
        step = 10.0 / ((1 << bits) - 1)
        slack = 1e-5 if out_dtype == torch.float32 else 5.0 * 2.0 ** -8
        assert float((d.float() - xt).abs().max()) <= step / 2 + slack


@pytest.mark.parametrize("t,d,dp", [(64, 128, 32), (513, 384, 96), (100, 260, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottleneck_encode_matches_jax(t, d, dp, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, dp)) * 0.05).astype(np.float32)
    (xj, xt), (wj, wt) = _both(x, dtype), _both(w, dtype)
    ours = _codes(ops.bottleneck_encode(xt, wt, -4.0, 4.0))
    pallas = _codes(jops.bottleneck_encode(xj, wj, -4.0, 4.0, interpret=True))
    oracle = _codes(jref.bottleneck_encode_ref(xj, wj, -4.0, 4.0))
    assert ours.shape == (t, dp)
    # the reference's tolerance: f32 sums in another order can put a value
    # on the other side of a .5 boundary
    assert np.abs(ours - pallas).max() <= 1
    assert np.abs(ours - oracle).max() <= 1
    assert np.abs(_codes(ref.bottleneck_encode_ref(xt, wt, -4.0, 4.0)) - oracle).max() <= 1


def test_any_shape_bottleneck_and_uint16_codes():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 16)) * 0.1).astype(np.float32)
    codes = ops.bottleneck_encode(torch.from_numpy(x), torch.from_numpy(w),
                                  -2.0, 2.0, bits=12)
    assert codes.shape == (2, 3, 16) and codes.dtype == torch.uint16
    oracle = _codes(jref.bottleneck_encode_ref(jnp.asarray(x), jnp.asarray(w),
                                               -2.0, 2.0, bits=12))
    assert np.abs(_codes(codes) - oracle).max() <= 1
    np.testing.assert_array_equal(
        _codes(ops.quantize(torch.from_numpy(x), -2.0, 2.0, bits=12)),
        _codes(jref.quantize_ref(jnp.asarray(x), -2.0, 2.0, bits=12)))


def test_bottleneck_route_is_chosen_by_shape_and_address():
    """The tensor-core kernel takes d and d' multiples of 4 with x and w on
    a four-element boundary (both serving shapes); the SIMT kernel takes
    the rest. The choice is made before any launch, from shape and address."""
    for dtype in (torch.float32, torch.bfloat16):
        x, w = torch.zeros(1024, 2048, dtype=dtype), torch.zeros(2048, 512, dtype=dtype)
        assert bottleneck.route(x, w) == "mma"
        assert bottleneck.route(torch.zeros(5, 2048, dtype=dtype), w) == "mma"
        assert bottleneck.route(x[:, :2044], torch.zeros(2044, 12, dtype=dtype)) == "mma"
        assert bottleneck.route(torch.zeros(4, 258, dtype=dtype),
                                torch.zeros(258, 64, dtype=dtype)) == "simt"
        assert bottleneck.route(torch.zeros(4, 256, dtype=dtype),
                                torch.zeros(256, 63, dtype=dtype)) == "simt"
        buf = torch.zeros(96 * 256 + 4, dtype=dtype)
        for offset in range(4):
            got = bottleneck.route(buf[offset:offset + 96 * 256].view(96, 256),
                                   torch.zeros(256, 64, dtype=dtype))
            assert got == ("mma" if offset == 0 else "simt")


@pytest.mark.parametrize("n_sm", [132, 114, 78])
def test_bottleneck_split_planner_fills_one_wave(n_sm):
    """The serving shapes on an H100 (132 SMs): 64 tiles in clusters of 2
    at T = 1024 and 128 tiles unsplit at T = 2048, both 128 blocks. On any
    card and shape a split grid fits the SMs and every block keeps a ring's
    worth of K tiles."""
    if n_sm == 132:
        assert bottleneck.plan_split(1024, 2048, 512, n_sm) == 2
        assert bottleneck.plan_split(2048, 2048, 512, n_sm) == 1
    fits = lambda split, tiles, k_tiles: (split * tiles <= n_sm
                                          and k_tiles >= split * bottleneck.STAGES)
    for t in (1, 100, 513, 1024, 2048, 4096):
        for d in (4, 128, 384, 2048, 8192):
            for dp in (4, 96, 512):
                split = bottleneck.plan_split(t, d, dp, n_sm)
                tiles = -(-t // bottleneck.BM) * -(-dp // bottleneck.BN)
                k_tiles = -(-d // bottleneck.BK)
                assert split in (1, 2, 4)
                assert split == 1 or fits(split, tiles, k_tiles)
                # and the largest such split
                assert split == bottleneck.MAX_SPLIT or not fits(2 * split, tiles, k_tiles)


def _ssd_meta(b, nc, q, h, p, n, dtype=torch.float32, x_offset=0):
    """ssd_intra's inputs as meta tensors (shapes, dtypes and addresses, no
    data); xh starts ``x_offset`` elements into its buffer."""
    buf = torch.empty(b * nc * q * h * p + x_offset, dtype=dtype, device="meta")
    xh = buf[x_offset:].view(b, nc, q, h, p)
    dt, la = (torch.empty(b, nc, q, h, device="meta") for _ in range(2))
    bm, cm = (torch.empty(b, nc, q, n, dtype=dtype, device="meta") for _ in range(2))
    return xh, dt, la, bm, cm


def test_ssd_intra_route_is_chosen_by_shape_and_address():
    """Both main-path shapes take the tensor-core kernel; a row of P that is
    no whole number of 16-byte units, an N that is not a multiple of 4, a Q
    above 256 and an x off a 16-byte boundary take the SIMT pair. The choice
    is made before any launch."""
    xh, _, _, bm, cm = _ssd_meta(1, 1, 256, 1, 4, 4)
    assert ssd_intra.route(xh, bm, cm) == "mma"                      # P 4 in f32
    xh, _, _, bm, cm = _ssd_meta(1, 1, 256, 1, 4, 4, dtype=torch.bfloat16)
    assert ssd_intra.route(xh, bm, cm) == "simt"                     # 8 bytes in bf16
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(2, 4, 256, 64, 64, 128), (8, 4, 256, 64, 64, 128), (2, 2, 16, 2, 8, 8),
                      (2, 2, 200, 3, 64, 128), (2, 3, 16, 16, 32, 16), (1, 1, 256, 1, 8, 4)]:
            xh, _, _, bm, cm = _ssd_meta(*shape, dtype=dtype)
            assert ssd_intra.route(xh, bm, cm) == "mma", shape
        for shape in [(1, 2, 100, 2, 130, 24), (1, 2, 100, 2, 64, 18), (1, 1, 257, 2, 64, 16),
                      (1, 1, 512, 2, 64, 16)]:
            xh, _, _, bm, cm = _ssd_meta(*shape, dtype=dtype)
            assert ssd_intra.route(xh, bm, cm) == "simt", shape
        for offset in range(4):
            xh, _, _, bm, cm = _ssd_meta(1, 2, 64, 2, 32, 16, dtype=dtype, x_offset=offset)
            assert ssd_intra.route(xh, bm, cm) == ("mma" if offset == 0 else "simt")
        xh, _, _, bm, cm = _ssd_meta(1, 2, 64, 2, 32, 16, dtype=dtype)
        assert ssd_intra.route(xh, bm[..., 1:], cm[..., 1:]) == "simt"   # N 15, B at +1


@pytest.mark.parametrize("bc, q, h, p", [(8, 256, 64, 64), (32, 256, 64, 64), (4, 16, 2, 8),
                                         (4, 200, 3, 64), (2, 192, 6, 130), (1, 64, 5, 32),
                                         (300, 256, 4, 64)])
@pytest.mark.parametrize("n_sm", [132, 114, 16])
def test_ssd_intra_plan_covers_every_tile_once(bc, q, h, p, n_sm):
    """The blocks of a plan, decoded in the kernel's order, cover every
    (chunk, row tile, head, P tile) exactly once; where the row tiles pair
    up evenly, every block does the same number of tile products."""
    pl = ssd_intra.plan(bc, q, h, p, n_sm)
    nt, n_pt = -(-q // ssd_intra.TILE), -(-p // ssd_intra.TILE)
    assert h % pl.heads_per_block == 0
    assert pl.blocks == bc * pl.n_pairs * pl.n_groups * pl.n_ptiles
    seen, products = set(), set()
    for blk in range(pl.blocks):
        chunk, tiles, heads, pt = ssd_intra.block_work(pl, q, h, blk)
        assert 0 <= chunk < bc and 0 <= pt < n_pt and len(heads) == pl.heads_per_block
        assert sum(tiles) == nt - 1 or tiles == [(nt - 1) // 2]
        for it in tiles:
            for hh in heads:
                assert (chunk, it, hh, pt) not in seen
                seen.add((chunk, it, hh, pt))
        products.add(len(heads) * sum(it + 1 for it in tiles))
    assert len(seen) == bc * nt * h * n_pt
    if nt % 2 == 0:
        assert products == {pl.heads_per_block * (nt + 1)}


@pytest.mark.parametrize("n_sm", [132, 114, 78])
def test_ssd_intra_plan_fills_one_wave(n_sm):
    """The serving shape (8 chunks) on an H100's 132 SMs: 8 groups of 8
    heads, 128 blocks, one wave. The calibration batch (32 chunks) takes
    more heads a block (fewer copies of the Gram strip) and again one wave.
    On any card a plan fits one wave unless it already holds every head,
    and fewer heads a block would not fit."""
    if n_sm == 132:
        assert ssd_intra.plan(8, 256, 64, 64, n_sm) == (8, 2, 8, 1, 128)
        assert ssd_intra.plan(32, 256, 64, 64, n_sm) == (32, 2, 2, 1, 128)
    for bc in (1, 4, 8, 32, 128, 1024):
        for q, h, p in [(256, 64, 64), (200, 3, 64), (64, 24, 128)]:
            pl = ssd_intra.plan(bc, q, h, p, n_sm)
            assert pl.blocks <= n_sm or pl.heads_per_block == h
            smaller = [d for d in range(1, pl.heads_per_block) if h % d == 0]
            if smaller:
                assert pl.blocks * pl.heads_per_block // smaller[-1] > n_sm


def test_ssd_intra_wrapper_launches_the_route_it_chose_or_raises(monkeypatch):
    """Off the CPU the wrapper passes the route and plan it chose before the
    launch (the SIMT pair also gets its Gram scratch), counts one launch a
    call, and raises, counting nothing, when the launch reports an error;
    nothing falls back to the twin. The card is stood in for by meta
    tensors sent down the kernel branch (meta alone takes the twin's shapes)
    and a recording library."""
    calls, status = [], [0]

    class Lib:
        def repro_ssd_intra(self, *a):
            calls.append(a)
            return status[0]

    monkeypatch.setattr(_build, "takes_twin", lambda name, *ts: False)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *ts: None)
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    out = ssd_intra.ssd_intra(*_ssd_meta(2, 4, 256, 64, 64, 128))
    assert out.shape == (2, 4, 256, 64, 64) and out.dtype == torch.float32
    assert calls[-1][6 + 1:] == (8, 256, 64, 64, 128, 0, 0, 1, 8, None) and calls[-1][5] is None
    ssd_intra.ssd_intra(*_ssd_meta(8, 4, 256, 64, 64, 128, dtype=torch.bfloat16))
    assert calls[-1][7:16] == (32, 256, 64, 64, 128, 1, 1, 1, 32)
    ssd_intra.ssd_intra(*_ssd_meta(1, 2, 100, 2, 130, 24))
    assert calls[-1][14:16] == (0, 0) and calls[-1][5] is not None     # SIMT, Gram scratch
    assert _build.LAUNCHES["ssd_intra"] == 3
    status[0] = 1
    with pytest.raises(RuntimeError, match="ssd_intra kernel launch failed"):
        ssd_intra.ssd_intra(*_ssd_meta(2, 4, 256, 64, 64, 128))
    xh, dt, la, bm, cm = _ssd_meta(1, 2, 64, 2, 32, 16)
    with pytest.raises(TypeError, match="dt and la must be float32"):
        ssd_intra.ssd_intra(xh, dt.double(), la, bm, cm)
    with pytest.raises(TypeError, match="share"):
        ssd_intra.ssd_intra(xh, dt, la, bm, cm.bfloat16())
    assert _build.LAUNCHES["ssd_intra"] == 3 and len(calls) == 4


def test_plain_twins_are_the_cpu_path_and_count_nothing():
    _build.reset_launches()
    x = torch.randn(33, 70, generator=torch.Generator().manual_seed(5))
    w = torch.randn(70, 20, generator=torch.Generator().manual_seed(6)) * 0.1
    q = quant.quantize_2d(x, -3.0, 3.0)
    assert torch.equal(q, quant.quantize_plain(x, -3.0, 3.0))
    assert torch.equal(quant.dequantize_2d(q, -3.0, 3.0),
                       quant.dequantize_plain(q, -3.0, 3.0))
    assert torch.equal(bottleneck.bottleneck_encode(x, w, -1.0, 1.0),
                       bottleneck.bottleneck_encode_plain(x, w, -1.0, 1.0))
    ops.quantize(x[None], -3.0, 3.0)
    assert sum(_build.LAUNCHES.values()) == 0


def _card(*shape, dtype=torch.float32):
    """A tensor that reports the card as its device (a fake tensor: shape,
    dtype and device, no data), for the wrappers' choice of branch."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    return FakeTensor(FakeTensorMode(), torch.empty(shape, dtype=dtype, device="meta"),
                      torch.device("cuda"))


def test_wrappers_raise_rather_than_fall_back_off_the_cpu(monkeypatch):
    """A tensor the card could compute never reaches a twin: the wrapper
    takes the kernel branch, which raises here (no card, no CUDA build);
    CUDA mixed with CPU inputs raises for the device, and so does meta
    mixed with the CPU. Only all-CPU or all-meta inputs take the twin."""
    reached = []
    for mod, twin in ((quant, "quantize_plain"), (quant, "dequantize_plain"),
                      (bottleneck, "bottleneck_encode_plain"), (ssd_intra, "ssd_intra_plain")):
        monkeypatch.setattr(mod, twin, lambda *a, _t=twin, **k: reached.append(_t))
    with pytest.raises((AssertionError, RuntimeError)):
        quant.quantize_2d(_card(4, 8), -1.0, 1.0)
    with pytest.raises((AssertionError, RuntimeError)):
        quant.dequantize_2d(_card(4, 8, dtype=torch.uint8), -1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck.bottleneck_encode(_card(4, 8), torch.zeros(8, 2), -1.0, 1.0)
    with pytest.raises(ValueError, match="chain"):
        bottleneck.bottleneck_encode(torch.zeros(4, 8), torch.zeros(7, 2), -1.0, 1.0)
    xh, dt, bc = _card(1, 2, 16, 2, 8), _card(1, 2, 16, 2), torch.zeros(1, 2, 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_intra.ssd_intra(xh, dt, dt, bc, bc)
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="mix the meta device"):
        bottleneck.bottleneck_encode(meta, torch.zeros(8, 2), -1.0, 1.0)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_intra.ssd_intra(torch.zeros(1, 2, 16, 2, 8), torch.zeros(1, 2, 16, 3),
                            torch.zeros(1, 2, 16, 3), torch.zeros(1, 2, 16, 4),
                            torch.zeros(1, 2, 16, 4))
    assert reached == [] and sum(_build.LAUNCHES.values()) == 0


def test_build_finds_nvcc_or_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert _build.find_nvcc() == str(nvcc)


def test_build_commands_target_sm90a_without_fast_math(tmp_path):
    compiles, link = _build.compile_commands("nvcc", tmp_path, tmp_path / "lib.so")
    assert len(compiles) == len(_build.SOURCES) == 11
    assert [s.name for s in _build.SOURCES] == ["quant.cu", "bottleneck.cu", "ssd_intra.cu",
                                                 "ssd_intra_bwd.cu", "pair_scorer.cu",
                                                 "pair_scorer_bwd.cu", "flat_trunk.cu",
                                                 "decode_attn.cu", "decode_attn_f32.cu",
                                                 "decode_attn_bf16.cu", "decode_attn_i8.cu"]
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert "-shared" in link
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR and lib == _build.library_path()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


def test_library_name_follows_every_source_and_header(monkeypatch, tmp_path):
    """The library is named by a hash of the sources and the headers they
    include (tf32_mma.cuh, mbarrier.cuh, wgmma.cuh and decode_attn.cuh among
    them), so an edit to a header cannot leave a stale library under the
    same name."""
    assert {h.name for h in _build.HEADERS} == {"quant.cuh", "tf32_mma.cuh", "mbarrier.cuh",
                                                "wgmma.cuh", "decode_attn.cuh"}
    for f in _build.SOURCES + _build.HEADERS:
        for inc in re.findall(r'#include "([^"]+)"', f.read_text()):
            assert _build.CSRC / inc in _build.HEADERS, (f.name, inc)
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCES", (src,))
    monkeypatch.setattr(_build, "HEADERS", (hdr,))
    before = _build.library_path()
    hdr.write_text("// two\n")
    assert _build.library_path() != before
