"""The sequence-parallel residual (``seq_parallel_residual``,
``meshctx.seq_parallel``): mamba2-1.3b's residual stream cut along the
sequence over "model" in train and prefill, each layer's input
all-gathered and its ``out_proj`` reduce-scattered along the sequence in
place of the all-reduce, over four gloo ranks of a (2, 2) ("data",
"model") mesh on the CPU.

Reduced mamba2-1.3b (2 layers, float32, 16 heads), drawn from a seed
(``init_params``: under a mesh each rank keeps its blocks of the
one-process draw). The ranks are spawned once. Each, with the flag on and
off (``cfg.replace(seq_parallel_residual=False)``), prefills its rows of a
(4, 12) prompt, takes one decode step, takes one AdamW step on its rows of
a (4, 16) batch, and runs the edges where the flag does not apply: a
13-token prompt on a model axis of 2 and a prefill of the whole batch
under ``whole_batch()``; every run logs its collectives.

Held: the prefill and decode logits within 1e-5 of max|logit| of the
flag-off program's and of one process's; every rank's cache shard within
1e-5 of each leaf's largest of the flag-off shard; the step's metrics
within 1e-5 relative and its parameters within 0.1 x lr of both (the
bounds of ``tests/test_torch_tp_blocks.py``); each rank's logs equal to
the ``CountingMesh``'s on meta; the flag-on logs the flag-off logs with
each layer's ``out_proj`` all-reduce turned into an all-gather of the
normed input and a reduce-scatter of the output, and one all-gather at
the stack's end; the edges' and the decode's logs equal to the flag-off
program's exactly. On meta: a train step's peak falls by at least half of
the layers' kept residuals' 1 - 1/model. The other block types' program
is held in ``tests/test_torch_seq_parallel_blocks.py``.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (CountingMesh, Mesh, ProcessMesh, collective_log,
                                     collectives_record, moved_bytes, spawn)
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import init_params, meshctx
from repro_torch.models import sharding as shd
from repro_torch.models.model import Model

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

MESH = (("data", "model"), (2, 2))
ARCH, LAYERS, SEED = "mamba2-1.3b", 2, 0
BATCH, PROMPT, ODD, SLOTS = 4, 12, 13, 16
SEQ, LR = 16, 3e-4
TOL = 1e-5            # logits x max|logit|; metrics relative; cache x the leaf's largest
PARAM_TOL = 0.1 * LR  # parameters after one step, absolute
METRICS = ("loss", "ce", "aux", "grad_norm")
FLAGS = (True, False)


def cfg_of(flag=True, arch=ARCH, layers=LAYERS):
    return reduced(get_config(arch), n_layers=layers).replace(seq_parallel_residual=flag)


def inputs():
    """The prompt (4, 12), the odd prompt (4, 13), the decode step's token
    (4, 1) and the train batch (4, 16) with next-token labels, some
    ignored; from numpy's seeded generator."""
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.integers(0, 512, shape, dtype=np.int64))
    prompt, odd, token, tokens = t(BATCH, PROMPT), t(BATCH, ODD), t(BATCH, 1), t(BATCH, SEQ)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    return {"prompt": prompt, "odd": odd, "token": token,
            "batch": {"tokens": tokens, "labels": labels}}


def rows_of(mesh):
    b = BATCH // meshctx.dp_size(mesh)
    i = mesh.index(meshctx.dp_axes(mesh))
    return slice(i * b, (i + 1) * b)


@torch.no_grad()
def serve(model, cfg, prompt, token):
    """A prefill of ``prompt`` and one decode step of ``token``: (prefill
    logits, decode logits, cache, prefill log, decode log)."""
    with collective_log() as pre_log:
        logits, cache = make_prefill_step(cfg, SLOTS)(model, prompt)
    with collective_log() as dec_log:
        out, cache = make_serve_step(cfg)(model, cache, token, prompt.shape[1])
    return logits, out, cache, list(pre_log), list(dec_log)


def train(model, cfg, batch):
    """One AdamW step: (metrics, the parameters after it, the log)."""
    train_step, opt_init = make_train_step(cfg, base_lr=LR, warmup=0)
    state = opt_init(model)
    with collective_log() as log:
        model, state, m = train_step(model, state, batch)
    metrics = {k: float(v) for k, v in m.items()} if m["loss"].device.type != "meta" else {}
    return metrics, [p.detach().clone() for p in model.parameters()], list(log)


@torch.no_grad()
def prefill_log(model, cfg, prompt, whole=False):
    """The logits and collective log of a prefill (of a whole batch under
    ``whole_batch()`` where ``whole``)."""
    with collective_log() as log, meshctx.whole_batch(whole):
        logits, _ = make_prefill_step(cfg, SLOTS)(model, prompt)
    return logits, list(log)


def _rank(rank, device, data):
    mesh = ProcessMesh(*MESH)
    rows = rows_of(mesh)
    out = {"coords": {a: mesh.index(a) for a in mesh.axis_names}}
    for flag in FLAGS:
        cfg = cfg_of(flag)
        gen = lambda: torch.Generator().manual_seed(SEED)
        with meshctx.use_mesh(mesh):
            model = init_params(cfg, gen(), "cpu")
            out[flag] = {"serve": serve(model, cfg, data["prompt"][rows], data["token"][rows]),
                         "odd": prefill_log(model, cfg, data["odd"][rows]),
                         "whole": prefill_log(model, cfg, data["prompt"], whole=True),
                         "specs": [getattr(p, "spec", None) for p in model.parameters()]}
            model = init_params(cfg, gen(), "cpu")
            out[flag]["train"] = train(model, cfg, {k: v[rows]
                                                    for k, v in data["batch"].items()})
    return out


@pytest.fixture(scope="module")
def data():
    return inputs()


@pytest.fixture(scope="module")
def ranks(data):
    return spawn(_rank, 4, "gloo", data, device="cpu")


@pytest.fixture(scope="module")
def one(data):
    """One process, no mesh, the flag on (which then changes nothing)."""
    cfg = cfg_of(True)
    gen = lambda: torch.Generator().manual_seed(SEED)
    return {"serve": serve(init_params(cfg, gen(), "cpu"), cfg, data["prompt"], data["token"]),
            "train": train(init_params(cfg, gen(), "cpu"), cfg, data["batch"])}


def counting(coords):
    return CountingMesh(Mesh(*MESH), coords)


def gathered(ranks, flag, i):
    """Serve result ``i`` (0 prefill, 1 decode logits) over the whole
    batch: each data index's rows from its model-0 rank, the model ranks of
    a data index checked equal."""
    by_dp = {}
    for r in ranks:
        got = r[flag]["serve"][i]
        dpi = r["coords"]["data"]
        if dpi in by_dp:
            assert torch.equal(by_dp[dpi], got)
        by_dp[dpi] = got
    return torch.cat([by_dp[k] for k in sorted(by_dp)], dim=0)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def rel_scalar(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def residual_bytes(s):
    """A rank's residual stream (its rows of the batch, ``s`` positions,
    d_model, float32), bytes."""
    cfg = cfg_of()
    return BATCH // MESH[1][0] * s * cfg.d_model * 4


# ---------------------------------------------------------------- values
@pytest.mark.parametrize("i,what", [(0, "prefill"), (1, "decode")])
def test_logits_equal_the_flag_off_program_and_one_process(ranks, one, i, what):
    on = gathered(ranks, True, i)
    assert rel(on, gathered(ranks, False, i)) <= TOL
    assert rel(on, one["serve"][i]) <= TOL


def test_cache_shards_equal_the_flag_off_programs_and_one_process_cut(ranks, one):
    """The cache entries come from the whole sequence, gathered in each
    layer, so they are the flag-off program's: the cache rules' cut."""
    for r in ranks:
        on, off = r[True]["serve"][2], r[False]["serve"][2]
        want = shd.cut_cache(one["serve"][2], counting(r["coords"]))
        assert len(on) == len(off) == len(want) == LAYERS
        for e_on, e_off, e_want in zip(on, off, want):
            assert sorted(e_on) == sorted(e_off) == sorted(e_want)
            for leaf, t in e_want.items():
                assert e_on[leaf].shape == e_off[leaf].shape == t.shape, leaf
                for got in (e_on[leaf], e_off[leaf]):
                    assert float((got - t).abs().max()) <= TOL * float(t.abs().max()), leaf


def test_train_metrics_equal_the_flag_off_program_and_one_process(ranks, one):
    for r in ranks:
        got = r[True]["train"][0]
        for k in METRICS:
            assert rel_scalar(got[k], r[False]["train"][0][k]) <= TOL, k
            assert rel_scalar(got[k], one["train"][0][k]) <= TOL, k


def test_parameters_after_a_step_equal_the_flag_off_program_and_one_process(ranks, one):
    for r in ranks:
        mesh = counting(r["coords"])
        on, off = r[True]["train"][1], r[False]["train"][1]
        for i, spec in enumerate(r[True]["specs"]):
            assert spec == r[False]["specs"][i]
            want = shd.cut(one["train"][1][i], spec, mesh) if spec is not None else \
                one["train"][1][i]
            assert on[i].shape == off[i].shape == want.shape
            assert float((on[i] - off[i]).abs().max()) <= PARAM_TOL, i
            assert float((on[i] - want).abs().max()) <= PARAM_TOL, i


# ------------------------------------------------------------ the program
def meta_logs(flag, coords, prompt_len=PROMPT):
    """The prefill and decode logs and the train step's log of the rank at
    ``coords``, counted on meta under a ``CountingMesh``."""
    cfg = cfg_of(flag)
    mesh = counting(coords)
    b = BATCH // MESH[1][0]
    meta = lambda *shape: torch.empty(shape, dtype=torch.long, device="meta")
    with meshctx.use_mesh(mesh):
        _, _, _, pre, dec = serve(Model(cfg, device="meta"), cfg, meta(b, prompt_len),
                                  meta(b, 1))
        log = train(Model(cfg, device="meta"), cfg,
                    {"tokens": meta(b, SEQ), "labels": meta(b, SEQ)})[2]
    return pre, dec, log


@pytest.mark.parametrize("flag", FLAGS, ids=["on", "off"])
def test_collective_logs_equal_the_counting_mesh(ranks, flag):
    for r in ranks:
        pre, dec, log = meta_logs(flag, r["coords"])
        assert r[flag]["serve"][3] == pre
        assert r[flag]["serve"][4] == dec
        assert r[flag]["train"][2] == log


def test_prefill_log_turns_each_out_proj_all_reduce_into_a_gather_and_a_scatter(ranks):
    """Off: the embedding's all-reduce, then per layer the gated norm's
    all-reduce and ``out_proj``'s, then the head's all-gather. On: per
    layer an all-gather of the normed input (before the mixer, so before
    its norm's all-reduce) and a reduce-scatter of ``out_proj`` along the
    sequence, and the residual's all-gather at the stack's end."""
    m = MESH[1][1]
    res = residual_bytes(PROMPT)
    ag, rs = ("all-gather", res, m), ("reduce-scatter", res // m, m)
    for r in ranks:
        on, off = r[True]["serve"][3], r[False]["serve"][3]
        assert off[0] == ("all-reduce", res, m)
        assert [off[2 + 2 * i] for i in range(LAYERS)] == [("all-reduce", res, m)] * LAYERS
        want = [off[0]]
        for i in range(LAYERS):
            want += [ag, off[1 + 2 * i], rs]
        want += [ag] + off[1 + 2 * LAYERS:]
        assert on == want
        got, base = collectives_record(on), collectives_record(off)
        assert got["moved_bytes"] == base["moved_bytes"] + moved_bytes("all-gather", res, m)


def test_train_log_gathers_in_the_recompute_and_scatters_the_stack_ends_gather(ranks):
    """A train step's log, flag on against off: the forward's and the
    backward's ``out_proj`` all-reduces (two a layer) turn into
    reduce-scatters and all-gathers (the backward's are the forward's
    transposes); the recompute of each layer gathers its input again (its
    reduce-scatter, the group's last product, is not rerun, as the
    all-reduce was not); the stack's end adds an all-gather and, in the
    backward, its reduce-scatter. Moved bytes by the ring rule: the
    flag-off step's, plus a residual's all-gather a layer and the stack
    end's all-gather and reduce-scatter."""
    m = MESH[1][1]
    res = residual_bytes(SEQ)
    ar, ag, rs = ("all-reduce", res, m), ("all-gather", res, m), ("reduce-scatter", res // m, m)
    for r in ranks:
        on, off = r[True]["train"][2], r[False]["train"][2]
        want = collections.Counter(off)
        want[ar] -= 2 * LAYERS
        want[ag] += 3 * LAYERS + 1
        want[rs] += 2 * LAYERS + 1
        assert collections.Counter(on) == +want
        assert collections.Counter(on)[ar] == 2      # the embedding's, forward and backward
        got, base = collectives_record(on), collectives_record(off)
        assert got["moved_bytes"] == (base["moved_bytes"]
                                      + (LAYERS + 1) * moved_bytes("all-gather", res, m)
                                      + moved_bytes("reduce-scatter", res // m, m))


@pytest.mark.parametrize("edge", ["odd", "whole", "decode"])
def test_edges_run_the_flag_off_program_exactly(ranks, edge):
    """S = 13 on a model axis of 2, the whole batch under
    ``whole_batch()``, and decode: the flag changes neither the log nor
    the logits."""
    for r in ranks:
        if edge == "decode":
            on, off = r[True]["serve"], r[False]["serve"]
            assert on[4] == off[4]
            assert not any(k == "reduce-scatter" for k, _, _ in on[4])
            assert rel(on[1], off[1]) <= TOL
            continue
        (l_on, log_on), (l_off, log_off) = r[True][edge], r[False][edge]
        assert log_on == log_off
        assert not any(k == "reduce-scatter" for k, _, _ in log_on)
        assert rel(l_on, l_off) <= TOL


# --------------------------------------------------------------- on meta
@pytest.mark.parametrize("s,mode,whole,want", [
    (12, "train", False, True), (12, "prefill", False, True), (12, "decode", False, False),
    (13, "prefill", False, False), (1, "prefill", False, False), (12, "train", True, False)])
def test_the_predicate(s, mode, whole, want):
    x = torch.empty((2, s, 8), device="meta")
    with meshctx.use_mesh(counting({})), meshctx.whole_batch(whole):
        assert meshctx.seq_parallel(cfg_of(True), x, mode) is want
        assert meshctx.seq_parallel(cfg_of(False), x, mode) is False
    assert meshctx.seq_parallel(cfg_of(True), x, mode) is False      # no mesh
    with meshctx.use_mesh(CountingMesh(Mesh(("data", "model"), (4, 1)))):
        assert meshctx.seq_parallel(cfg_of(True), x, mode) is False  # one rank on "model"


def test_a_train_steps_peak_falls_by_the_kept_residuals_cut():
    """The dry-run's count of a rank's train step on meta, 4 layers on a
    (4, 256) batch: each remat group keeps the rank's block of the
    residual, 1 / model of it, so the peak falls by about the layers'
    kept residuals times (1 - 1/model); held to at least half of that."""
    layers, s = 4, 256
    shape = InputShape("train_4k", s, BATCH, "train")
    peaks = {}
    for flag in FLAGS:
        _, memory, _ = dryrun.counted_rank(cfg_of(flag, layers=layers), shape, Mesh(*MESH))
        peaks[flag] = memory["peak_memory_in_bytes"]
    m = MESH[1][1]
    kept = layers * residual_bytes(s) * (1 - 1 / m)
    drop = peaks[False] - peaks[True]
    print(f"train step peak a rank: flag off {peaks[False]} B, on {peaks[True]} B, drop {drop} B; "
          f"{layers} layers' kept residuals x (1 - 1/{m}) = {kept:.0f} B")
    assert drop >= kept / 2


def test_a_mixer_the_model_axis_does_not_cut_takes_its_block_of_out_proj():
    """On a model axis of 3, which divides neither d_inner 512 nor the
    vocab, every rank runs the whole mixer: each layer gathers its input
    and takes its block of ``out_proj``'s product, with no reduce-scatter
    (``tp.row_out``); the stack's end gathers the residual."""
    cfg = cfg_of(True)
    mesh = CountingMesh(Mesh(("data", "model"), (1, 3)), {"model": 2})
    b, s = 2, 12
    with meshctx.use_mesh(mesh), collective_log() as log, torch.no_grad():
        model = Model(cfg, device="meta")
        assert model.blocks[0].mixer.out_proj.spec == (None, None)
        logits, _ = make_prefill_step(cfg, SLOTS)(
            model, torch.empty((b, s), dtype=torch.long, device="meta"))
    assert logits.shape == (b, cfg.vocab_size)
    assert list(log) == [("all-gather", b * s * cfg.d_model * 4, 3)] * (LAYERS + 1)

