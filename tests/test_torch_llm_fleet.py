"""Parity of the port's LLM-decode offloading scenario with the JAX
reference: ``overhead.decode_layer_costs``, ``split.llm_decode_split_table``
at every context rung and ``fleets.make_llm_mixed_fleet``. They are numpy
on both sides over the same configs, so the tables agree within 1e-6
relative (they are in fact equal) and feasibility is exact. Then the fleet
demo's ``--llm`` run on the CPU, whose env must be the reference's for the
same fleet, pool and frame length.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import fleets as jfleets
from repro.core import overhead as joh
from repro.core import split as jsplit
from repro.env import mecenv as jenv
from repro_torch.configs import get_config
from repro_torch.core import fleets, split
from repro_torch.core import overhead as oh
from repro_torch.launch import fleet_demo

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers

ARCHS = ("qwen3-1.7b", "mamba2-1.3b")
TABLES = ("t_local", "e_local", "t_comp", "e_comp", "f_bits")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_layer_costs_match_reference(arch):
    for kv in (0, 8):
        cfg, jcfg = (get_config(arch).replace(kv_quant_bits=kv),
                     jget_config(arch).replace(kv_quant_bits=kv))
        for ctx in (1, 256, 1024, 4096):
            got, want = oh.decode_layer_costs(cfg, ctx), joh.decode_layer_costs(jcfg, ctx)
            assert len(got) == len(want) == cfg.n_layers
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                _close([g[k] for k in w], [w[k] for k in w])
    # the VLM's image layers are costed too: an xattn layer reads its
    # image context's K/V, whatever the context length
    xcfg, jxcfg = (get_config(arch).replace(block_pattern=("xattn",), n_aux_tokens=64),
                   jget_config(arch).replace(block_pattern=("xattn",), n_aux_tokens=64))
    assert oh.decode_layer_costs(xcfg, 16) == joh.decode_layer_costs(jxcfg, 16)
    assert oh.decode_layer_costs(xcfg, 16) == oh.decode_layer_costs(xcfg, 4096)


@pytest.mark.parametrize("arch", ARCHS)
def test_llm_decode_split_tables_match_reference(arch):
    for ctx in fleets.LLM_CTX_RUNGS:
        for kw in ({}, {"kv_bits": 8, "gen_tokens": 16}, {"kv_bits": 0, "n_points": 3}):
            got = split.llm_decode_split_table(get_config(arch), ctx, **kw)
            want = jsplit.llm_decode_split_table(jget_config(arch), ctx, **kw)
            assert (got.name, got.points, got.device) == (want.name, want.points, want.device)
            for f in TABLES:
                _close(getattr(got, f), getattr(want, f))
            np.testing.assert_array_equal(got.feasible, want.feasible)


def test_llm_mixed_fleet_matches_reference():
    assert fleets.LLM_CTX_RUNGS == jfleets.LLM_CTX_RUNGS
    for kw in ({}, {"n_cnn": 3, "ctx_rungs": (512, 2048)}):
        got, want = fleets.make_llm_mixed_fleet(**kw), jfleets.make_llm_mixed_fleet(**kw)
        assert got.names == want.names
        assert [p.name for p in got.profiles] == [p.name for p in want.profiles]
        for f in TABLES + ("p_compute",):
            _close(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(got.feasible, want.feasible)
    # the payload grows with context at every split that ships the cache
    f_bits = fleets.make_llm_mixed_fleet().f_bits[2:, 1:-1]
    assert (np.diff(f_bits, axis=0) > 0).all()


def test_fleet_demo_llm_runs_on_the_cpu(capsys):
    out = fleet_demo.main(["--device", "cpu", "--iterations", "1", "--llm"])
    text = capsys.readouterr().out
    for line in ("LLM context rungs: (256, 1024, 4096)", "qwen3-1.7b-decode-ctx4096",
                 "srv0: tpu-v5e", "srv1: edge-gpu", "fused pair-scorer kernel path",
                 "context-length shift"):
        assert line in text, line
    assert "zero-shot on an UNSEEN" not in text
    env = out["env"]
    assert not env.randomizable and isinstance(out["llm_shift"], bool)
    assert len(out["splits"]) == 5 and np.isfinite(out["history"][0]["reward_mean"])
    jpool = jfleets.EdgePool((
        joh.ServerProfile.from_device(joh.TPU_V5E, utilization=0.025),
        joh.ServerProfile.from_device(joh.EDGE_GPU, dist_scale=1.4)))
    want = jenv.make_env_params(jfleets.make_llm_mixed_fleet(), n_channels=2, t0=2.0,
                                pool=jpool)
    for f in ("l_new", "n_new", "feasible", "p_compute", "omega", "server_dist", "t_edge"):
        np.testing.assert_array_equal(getattr(env.params, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert env.params.t0 == float(want.t0) == 2.0
    for k in ("mahppo", "greedy", "nearest", "loadbal"):
        res = out[k]
        val = res["t_task"] + env.params.beta * res["e_task"] if k == "mahppo" \
            else res["overhead"]
        assert np.isfinite(val), k
