"""Parity of the scheduling path's kernel wrappers, ``pair_scorer`` and
``flat_trunk``, with the JAX reference kernels.

On the CPU the wrappers run their plain PyTorch twins; the JAX side runs
the Pallas kernels in interpret mode and the reference oracles. Inputs are
made with numpy at the magnitudes of tests/test_kernels.py, whose shapes
and tolerances these are: 1e-5 in float32, 5e-2 with bfloat16 inputs
(both sides see the same rounded values). The kernels themselves are held
to the twins on the card by tests/test_torch_kernels_card.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flat_trunk as jft
from repro.kernels import pair_scorer as jps
from repro.kernels import ref as jref
from repro_torch.kernels import _build, flat_trunk, ops, pair_scorer, ref
from repro_torch.kernels.ref import code_dtype

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scorer_inputs(seed, n, e):
    """(ue_emb, d, work, active, geom, consts, w_srv, b_srv, w1, b1, w2, b2)
    as float32 numpy, at live-env magnitudes."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return [f(np.tanh(rng.standard_normal((n, 128)))),
            f(rng.uniform(1.0, 100.0, n)), f(rng.uniform(5e7, 5e8, n)),
            f(rng.random(n) < 0.7), f(rng.uniform(0.5, 2.0, (e, 3))),
            f([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e-12]),
            f(rng.standard_normal((4, 32)) * 0.5), f(np.zeros(32)),
            f(rng.standard_normal((163, 48)) * 0.1), f(np.zeros(48)),
            f(rng.standard_normal((48, 1)) * 0.01), f(np.zeros(1))]


def _both(arrs, dtype="float32", n_obs=6):
    """The JAX and torch forms; the first ``n_obs`` (the observation block)
    in ``dtype``, the weights in float32 as the reference's tests keep them."""
    j = [jnp.asarray(a).astype(dtype) if i < n_obs else jnp.asarray(a)
         for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(TORCH[dtype]) if i < n_obs else torch.from_numpy(a)
         for i, a in enumerate(arrs)]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,e", [(1, 1), (7, 2), (64, 3), (300, 5)])
def test_pair_scorer_matches_jax(n, e):
    j, t = _both(_scorer_inputs(n * 7 + e, n, e))
    logits, srv = pair_scorer.pair_scorer(*t)
    assert logits.shape == (n, e) and srv.shape == (e, 32) and logits.dtype == torch.float32
    oracle = jref.pair_scorer_ref(*j)
    # the port's oracle is the reference's
    for got, want in zip(ref.pair_scorer_ref(*t), oracle):
        _close(got, want, 1e-5)
    for want_l, want_s in (jps.pair_scorer_pallas(*j, interpret=True), oracle):
        _close(logits, want_l, 1e-5)
        _close(srv, want_s, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_scorer_dtypes_match_jax(dtype):
    j, t = _both(_scorer_inputs(11, 33, 3), dtype)
    logits, _ = pair_scorer.pair_scorer(*t)
    assert logits.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 5e-2
    _close(logits, jref.pair_scorer_ref(*j)[0], tol)
    _close(logits, jps.pair_scorer_pallas(*j, interpret=True)[0], tol)


def test_pair_scorer_churn_mask_matches_jax():
    """``active`` enters only through the occupancy scalar: masks of equal
    occupancy give bitwise-equal logits."""
    n, e = 24, 3
    arrs = _scorer_inputs(3, n, e)
    for frac in (0.0, 0.5, 1.0):
        arrs[3] = (np.arange(n) < frac * n).astype(np.float32)
        j, t = _both(arrs)
        logits, srv = pair_scorer.pair_scorer(*t)
        want_l, want_s = jref.pair_scorer_ref(*j)
        _close(logits, want_l, 1e-5)
        _close(srv, want_s, 1e-5)
    a1, a2 = np.zeros(n, np.float32), np.zeros(n, np.float32)
    a1[0], a2[n - 1] = 1.0, 1.0
    arrs[3] = a1
    l1, _ = pair_scorer.pair_scorer(*_both(arrs)[1])
    arrs[3] = a2
    l2, _ = pair_scorer.pair_scorer(*_both(arrs)[1])
    assert torch.equal(l1, l2)


def test_ops_pair_scorer_unpacks_the_reference_dicts():
    arrs = _scorer_inputs(5, 9, 2)
    t = [torch.from_numpy(a) for a in arrs]
    raw = dict(zip(("d", "work", "active", "geom", "consts"), t[1:6]))
    got = ops.pair_scorer(t[0], raw, {"w": t[6], "b": t[7]},
                          [{"w": t[8], "b": t[9]}, {"w": t[10], "b": t[11]}])
    want = pair_scorer.pair_scorer_plain(*t)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="shapes"):
        pair_scorer.pair_scorer(t[0][:, :100], *t[1:])


def _trunk(seed, dims=(19, 64, 64, 13), bits=8):
    """Per-layer codes (the reference's quantize_ref of a random weight),
    float32 range and biases, as numpy."""
    rng = np.random.default_rng(seed)
    layers = []
    for d_in, d_out in zip(dims, dims[1:]):
        w = (rng.standard_normal((d_in, d_out)) * 0.4).astype(np.float32)
        mn, mx = np.float32(w.min()), np.float32(w.max())
        codes = np.asarray(jref.quantize_ref(jnp.asarray(w), mn, mx, bits=bits))
        layers.append((codes, mn, mx, (rng.standard_normal(d_out) * 0.1).astype(np.float32)))
    return layers


def _trunk_args(layers, bits):
    jargs = ([jnp.asarray(c) for c, *_ in layers], [jnp.float32(m) for _, m, _, _ in layers],
             [jnp.float32(m) for _, _, m, _ in layers], [jnp.asarray(b) for *_, b in layers])
    targs = ([torch.from_numpy(c.astype(np.int32)).to(code_dtype(bits)) for c, *_ in layers],
             [m for _, m, _, _ in layers], [m for _, _, m, _ in layers],
             [torch.from_numpy(b) for *_, b in layers])
    return jargs, targs


@pytest.mark.parametrize("shape", [(1, 19), (7, 19), (4, 8, 19), (600, 19)])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_flat_trunk_matches_jax(shape, bits):
    layers = _trunk(sum(shape) + bits, bits=bits)
    jargs, targs = _trunk_args(layers, bits)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    qlayers = [dict(zip(("codes", "mn", "mx", "b"), layer)) for layer in zip(*targs)]
    out = ops.flat_trunk(torch.from_numpy(x), qlayers, bits=bits)
    assert out.shape == shape[:-1] + (13,) and out.dtype == torch.float32
    x2 = jnp.asarray(x.reshape(-1, 19))
    for want in (jft.flat_trunk_pallas(x2, *jargs, bits=bits, interpret=True),
                 jref.flat_trunk_ref(x2, *jargs, bits=bits),
                 ref.flat_trunk_ref(torch.from_numpy(x.reshape(-1, 19)), *targs, bits=bits)):
        _close(out.reshape(-1, 13), want, 1e-5)


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_flat_trunk_dequantized_weights_bit_equal(bits):
    """The twin's (and the kernel's) dequantized weights are bit-equal to
    flat_trunk_xla's association, codes * ((mx - mn) / levels) + mn, each
    step rounded to float32 (here in numpy)."""
    for codes, mn, mx, _ in _trunk(bits, bits=bits):
        step = (mx - mn) / np.float32((1 << bits) - 1)
        want = codes.astype(np.float32) * step + mn
        got = flat_trunk.dequantized_weights(
            torch.from_numpy(codes.astype(np.int32)).to(code_dtype(bits)), mn, mx, bits=bits)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_trunk_dtypes_match_jax(dtype):
    layers = _trunk(2)
    jargs, targs = _trunk_args(layers, 8)
    x = (np.random.default_rng(3).standard_normal((33, 19)) * 2).astype(np.float32)
    out = flat_trunk.flat_trunk(torch.from_numpy(x).to(TORCH[dtype]), *targs, bits=8)
    assert out.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 5e-2
    xj = jnp.asarray(x).astype(dtype)
    _close(out, jref.flat_trunk_ref(xj, *jargs, bits=8), tol)
    _close(out, jft.flat_trunk_pallas(xj, *jargs, bits=8, interpret=True), tol)


def test_flat_trunk_other_widths_and_depth():
    """No width or depth is built in: a 2-layer 10 -> 30 -> 5 trunk."""
    layers = _trunk(9, dims=(10, 30, 5), bits=6)
    jargs, targs = _trunk_args(layers, 6)
    x = np.random.default_rng(4).standard_normal((70, 10)).astype(np.float32)
    out = flat_trunk.flat_trunk(torch.from_numpy(x), *targs, bits=6)
    _close(out, jft.flat_trunk_xla(jnp.asarray(x), *jargs, bits=6), 1e-5)
    with pytest.raises(ValueError, match="chain"):
        flat_trunk.flat_trunk(torch.from_numpy(x[:, :9]), *targs, bits=6)


# ------------------------------------------------------------- the planners
# What the kernels are launched with is decided on the host, so it is
# tested here; the kernels themselves run on the card only.
@pytest.mark.parametrize("n,blocks", [(1024, 128), (1, 1), (7, 1), (300, 38), (1023, 128),
                                      (1025, 129)])
def test_pair_scorer_plan_at_the_serving_and_ragged_fleets(n, blocks):
    pl = pair_scorer.plan(n, 3, 128, 32, 48, "bulk")
    assert (pl.rows_per_block, pl.blocks, pl.route) == (8, blocks, "bulk")
    # 48 tiles of 2 x 4 outputs over the six ue warps' 192 lanes: K in 4
    # parts of 32
    assert pl.ue_split == 4
    # W1 163 x 48, UE rows 8 x 128, their term 8 x 48, the servers' 3 x 48,
    # b1 and w2 48 each, embeddings 3 x 32, w_srv's last row and b_srv 2 x
    # 32, edges 8 x 3 x 3, 4 partials; then the 8-byte mbarrier
    floats = 163 * 48 + 8 * 128 + 8 * 48 + 3 * 48 + 2 * 48 + 96 + 64 + 72 + 4
    assert pl.smem_bytes == 4 * floats + 8


def test_pair_scorer_plan_pads_odd_widths_and_refuses_what_does_not_fit():
    # d_ue 126 and H 50 are padded to 128 and 52 in shared memory
    pl = pair_scorer.plan(300, 8, 126, 32, 50, "loads")
    floats = ((128 + 32 + 3) * 52 + 8 * 128 + 8 * 52 + 8 * 52 + 2 * 52 + 8 * 32 + 64
              + 8 * 8 * 3 + 4)
    assert (pl.blocks, pl.smem_bytes, pl.route) == (38, 4 * floats + 8, "loads")
    # parts at least 4 deep
    assert [pair_scorer.plan(64, 3, d, 32, 48, "bulk").ue_split for d in (4, 8, 16)] == [1, 2, 4]
    with pytest.raises(ValueError, match="shared memory"):
        pair_scorer.plan(1024, 3, 1024, 32, 64, "bulk")


def test_pair_scorer_route_by_width_and_address():
    t = [torch.from_numpy(a) for a in _scorer_inputs(1, 16, 3)]
    assert pair_scorer.route(t[0], t[8]) == "bulk"
    base = torch.zeros(16 * 128 + 4)
    for offset, want in ((0, "bulk"), (1, "loads"), (2, "loads"), (4, "bulk")):
        view = base[offset:offset + 16 * 128].view(16, 128)
        assert pair_scorer.route(view, t[8]) == want, offset
    assert pair_scorer.route(t[0][:, :126].contiguous(), t[8]) == "loads"      # d_ue 126
    assert pair_scorer.route(t[0], t[8][:, :46].contiguous()) == "loads"       # H 46


@pytest.mark.parametrize("m,tiles,grid", [(1024, 128, 128), (1, 1, 1), (7, 1, 1),
                                          (600, 75, 75), (10240, 1280, 396)])
def test_flat_trunk_plan_at_the_serving_and_ragged_batches(m, tiles, grid):
    """At 132 SMs holding 3 blocks each: one block a tile up to one wave.
    The shared bytes are the kernel's own (the library's plan query, held to
    its layout by the card tests); the planner passes them on."""
    pl = flat_trunk.plan(m, (19, 64, 64, 13), "bulk", 61_000, 132, 3)
    assert (pl.rows_per_tile, pl.tiles, pl.grid, pl.route) == (8, tiles, grid, "bulk")
    # 19 -> 64 and 64 -> 64 have 8 column tiles, one a warp; 64 -> 13 has 2,
    # so its K is split over 4 warps (4 of its 16 steps each)
    assert pl.k_split == (1, 1, 4)
    assert pl.smem_bytes == 61_000


def test_flat_trunk_plan_by_code_width_route_and_depth():
    dims = (19, 64, 64, 13)
    assert flat_trunk.plan(1024, dims, "loads", 55_000, 132, 3).route == "loads"
    pl = flat_trunk.plan(70, (10, 30, 5), "loads", 9_000, 132, 3)
    # 10 -> 30: 4 column tiles of 3 steps (too few to split); 30 -> 5: one
    # tile of 8 steps, split over 4 warps
    assert (pl.tiles, pl.grid, pl.k_split) == (9, 9, (1, 4))
    assert flat_trunk.plan(5, (19, 13), "bulk", 6_000, 132, 3).k_split == (2,)   # no hidden layer
    # wide and deep trunks split K only where a layer has few column tiles
    assert flat_trunk.plan(1024, (19, 128, 128, 13), "bulk", 210_000, 132, 1).k_split == (1, 1, 4)
    assert flat_trunk.plan(1024, (19, 64, 64, 64, 64, 13), "bulk", 90_000, 132, 2).k_split == \
        (1, 1, 1, 1, 4)
    with pytest.raises(ValueError, match="shared memory"):
        flat_trunk.plan(1024, (19, 256, 256, 13), "bulk", flat_trunk.SMEM_MAX + 8, 132, 0)
    with pytest.raises(ValueError, match="blocks fit"):
        flat_trunk.plan(1024, dims, "bulk", 61_000, 132, 0)


@pytest.mark.parametrize("m,n_sm,resident", [(10240, 132, 5), (10240, 132, 1), (1024, 132, 4),
                                             (40000, 16, 3), (9, 132, 8), (8 * 661, 132, 5)])
def test_flat_trunk_persistent_grid_takes_every_tile_once(m, n_sm, resident):
    pl = flat_trunk.plan(m, (19, 64, 64, 13), "bulk", 61_000, n_sm, resident)
    assert pl.grid <= n_sm * resident and pl.grid <= pl.tiles
    walked = [t for b in range(pl.grid) for t in flat_trunk.block_tiles(pl, b)]
    assert sorted(walked) == list(range(pl.tiles))
    # the rows of the tiles are the rows of the batch, once each
    rows = [r for t in walked for r in range(t * pl.rows_per_tile,
                                             min(m, (t + 1) * pl.rows_per_tile))]
    assert sorted(rows) == list(range(m))


def test_flat_trunk_launch_plan_loads_the_codes_where_staging_them_does_not_fit(monkeypatch):
    """The launch plan takes the library's shared bytes and resident blocks
    for the codes' route, and falls back to the loads route, before the
    launch, where the bulk route's layout leaves no block room on an SM."""
    asked = []

    def query(device, dims, bits, copy_route):
        asked.append(copy_route)
        return (232_456, 0) if copy_route == "bulk" else (191_496, 1)

    monkeypatch.setattr(flat_trunk, "_query", query)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    codes = [torch.zeros(a, b, dtype=torch.int16) for a, b in ((19, 128), (128, 128), (128, 13))]
    assert flat_trunk.route(codes) == "bulk"
    pl = flat_trunk.launch_plan(torch.zeros(1024, 19), codes, 12)
    assert asked == ["bulk", "loads"]
    assert (pl.route, pl.smem_bytes, pl.grid, pl.k_split) == ("loads", 191_496, 128, (1, 1, 4))
    # where the bulk route fits, it is the only one asked for
    asked.clear()
    fits = {"bulk": (61_000, 3)}
    monkeypatch.setattr(flat_trunk, "_query",
                        lambda device, dims, bits, r: asked.append(r) or fits[r])
    pl = flat_trunk.launch_plan(torch.zeros(10240, 19), codes, 8)
    assert asked == ["bulk"] and (pl.route, pl.grid) == ("bulk", 396)


def test_flat_trunk_route_by_size_and_address():
    layers = _trunk(1)
    codes = [torch.from_numpy(c.astype(np.int32)).to(torch.uint8) for c, *_ in layers]
    assert flat_trunk.route(codes) == "bulk"     # 1 216, 4 096 and 832 bytes
    buf = torch.zeros(64 * 64 + 16, dtype=torch.uint8)
    for offset, want in ((0, "bulk"), (1, "loads"), (8, "loads"), (16, "bulk")):
        codes[1] = buf[offset:offset + 64 * 64].view(64, 64)
        assert flat_trunk.route(codes) == want, offset
    odd = [torch.from_numpy(c.astype(np.int32)).to(torch.uint8) for c, *_ in
           _trunk(9, dims=(10, 30, 5), bits=6)]
    assert flat_trunk.route(odd) == "loads"      # 300 and 150 bytes
