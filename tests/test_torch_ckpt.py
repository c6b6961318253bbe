"""The port's checkpoints (``ckpt/checkpoint.py``) against the reference's
``src/repro/ckpt/checkpoint.py``: a round trip of a nested tree in the
port, and files of each package loaded by the other leaf for leaf (float32
and integer leaves: the reference's files hold no bfloat16 where numpy
lacks it), and a model's parameters through the reference's tree."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.ckpt import load_checkpoint as jload
from repro.ckpt import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import init_params as jinit_params
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import init_params
from repro_torch.weights import from_jax_params, to_reference_tree

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def _tree(rng):
    return {"w": [torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
                  (torch.arange(5, dtype=torch.int32), np.float32(2.5))],
            "a": {"z": torch.from_numpy(rng.normal(size=(2,)).astype(np.float32)),
                  "bf": torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32)).to(
                      torch.bfloat16),
                  "none": None},
            "count": np.int32(7)}


def _leaves(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                       else x) for x in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def test_round_trip_of_a_nested_tree(tmp_path):
    tree = _tree(np.random.default_rng(0))
    save_checkpoint(str(tmp_path / "ck"), tree, step=12, extra={"note": "x"})
    got, meta = load_checkpoint(str(tmp_path / "ck"), tree)
    assert meta["step"] == 12 and meta["extra"] == {"note": "x"} and meta["n_leaves"] == 6
    assert meta["dtypes"] == {"leaf_0": "bfloat16"}     # leaves in sorted-key order
    assert got["a"]["bf"].dtype == torch.bfloat16 and torch.equal(got["a"]["bf"], tree["a"]["bf"])
    assert isinstance(got["w"][1], tuple) and got["a"]["none"] is None
    assert torch.equal(got["w"][0], tree["w"][0]) and got["w"][1][0].dtype == torch.int32
    assert float(got["w"][1][1]) == 2.5 and int(got["count"]) == 7


def _float_tree(rng):
    return {"b": [rng.normal(size=(3,)).astype(np.float32),
                  (rng.normal(size=(2, 2)).astype(np.float32), np.arange(4, dtype=np.int32))],
            "a": {"y": rng.normal(size=(5,)).astype(np.float32), "x": np.float32(1.5)}}


def test_a_reference_file_loads_in_the_port_and_back(tmp_path):
    tree = _float_tree(np.random.default_rng(1))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jsave(str(tmp_path / "j"), jtree, step=3, extra={"k": 1})
    like = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)
    got, meta = load_checkpoint(str(tmp_path / "j"), like)
    assert meta["step"] == 3 and meta["extra"] == {"k": 1}
    for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    save_checkpoint(str(tmp_path / "p"), got, step=4)
    back, jmeta = jload(str(tmp_path / "p"), jtree)
    assert jmeta["step"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def test_a_models_parameters_load_in_the_reference_tree(tmp_path):
    """The port's model saved through ``to_reference_tree`` loads into the
    reference's params of the same config, leaf for leaf, and back into a
    port model."""
    cfg = reduced(get_config("mamba2-1.3b"), n_layers=2)
    jcfg = jreduced(jget_config("mamba2-1.3b"), n_layers=2)
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    save_checkpoint(str(tmp_path / "m"), to_reference_tree(model), step=1)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    loaded, _ = jload(str(tmp_path / "m"), jparams)
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = from_jax_params(jax.tree_util.tree_map(np.asarray, loaded), cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))
