"""Tree checkpointing, the port of ``src/repro/ckpt/checkpoint.py``: the
leaves in ``<path>.npz`` as ``leaf_{i}``, and ``<path>.json`` with
``n_leaves``, ``step`` and ``extra``, each written atomically (a temporary
file, then ``os.replace``).

A tree is nested dicts, lists and tuples of tensors, numpy arrays and
Python scalars (``None`` is an empty subtree, as in ``jax.tree_util``).
Leaves are taken in ``jax.tree_util``'s order, dict keys sorted, so a file
written by either package loads in the other, leaf for leaf.

Where the files differ from the reference's: numpy has no bfloat16 where
``ml_dtypes`` is missing, so a bfloat16 leaf is stored as its raw 16 bits
(uint16) and the JSON's ``"dtypes"`` names it ``{"leaf_i": "bfloat16"}``;
the reference's loader would read such a leaf as uint16. The JSON's
``"treedef"`` describes the tree in the port's own words (the reference
never reads it back: it restores into the structure of ``like``).
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def _flatten(tree):
    """(leaves, a description of the tree) in jax.tree_util's order."""
    if isinstance(tree, dict):
        parts = [_flatten(tree[k]) for k in sorted(tree)]
        return ([l for p in parts for l in p[0]],
                {"dict": {k: p[1] for k, p in zip(sorted(tree), parts)}})
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return [l for p in parts for l in p[0]], {type(tree).__name__: [p[1] for p in parts]}
    if tree is None:
        return [], None
    return [tree], "*"


def _unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (an iterator) in its leaf slots."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if like is None:
        return None
    return next(leaves)


def _to_numpy(x):
    """(array, dtype name to record or None)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), None
    return np.asarray(x), None


def save_checkpoint(path: str, tree, *, step: int = 0, extra: dict = None):
    """Atomically save a tree to ``<path>.npz`` and ``<path>.json``."""
    leaves, desc = _flatten(tree)
    arrays, dtypes = {}, {}
    for i, x in enumerate(leaves):
        arrays[f"leaf_{i}"], dt = _to_numpy(x)
        if dt:
            dtypes[f"leaf_{i}"] = dt
    meta = {"treedef": json.dumps(desc), "n_leaves": len(leaves), "step": step,
            "extra": extra or {}}
    if dtypes:
        meta["dtypes"] = dtypes
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    os.close(fd)
    np.savez(tmp + ".npz", **arrays)
    os.replace(tmp + ".npz", path + ".npz")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".json")


def load_checkpoint(path: str, like):
    """Restore into the structure of ``like``; shapes and dtypes come from
    the file. A leaf whose slot in ``like`` is a tensor comes back as a
    tensor on that tensor's device; any other leaf as a numpy array (a
    bfloat16 leaf always as a tensor). Returns (tree, meta)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    like_leaves, _ = _flatten(like)
    if len(like_leaves) != meta["n_leaves"]:
        raise ValueError(f"load_checkpoint: {path} holds {meta['n_leaves']} leaves, the tree "
                         f"to restore into {len(like_leaves)}")
    dtypes = meta.get("dtypes", {})
    out = []
    with np.load(path + ".npz") as data:
        for i, ref in enumerate(like_leaves):
            a = data[f"leaf_{i}"]
            if dtypes.get(f"leaf_{i}") == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                out.append(t.to(ref.device) if isinstance(ref, torch.Tensor) else t)
            elif isinstance(ref, torch.Tensor):
                out.append(torch.from_numpy(a.copy()).to(ref.device))
            else:
                out.append(a)
    return _unflatten(like, iter(out)), meta
