"""The reference's GSPMD sharding rules (``src/repro/models/sharding.py``)
as byte arithmetic over a mesh's axis sizes: no device is touched.

The baseline scheme, rule for rule the reference's:

* tensor parallel over "model": attention head / d_ff / expert / vocab dims;
* data parallel over ("pod", "data"): the batch dims of activations and
  caches;
* an ``fsdp`` config also shards the non-TP parameter dim over "data".

A dim is sharded only when the axis size divides it (``_guard``).

A spec is the reference's ``PartitionSpec`` as a tuple with one entry a
dim: an axis name, a tuple of axis names, or None. A tree is a dict from
the reference's path (its dict keys and sequence indices, as a tuple) to a
tensor whose shape and dtype are the leaf's; the rules read only those, so
``meta`` tensors stand in for the leaves (``reference_params``,
``reference_cache``). The rules apply to the reference's leaves, not to the
port's per-layer tensors: the reference stacks each block parameter of a
pattern position on a leading group axis, which stays unsharded, and keeps
a tail layer's leaves unstacked (``weights.reference_leaves``); its cache
stacks the entries of its ``blocks`` groups the same way, where the port's
``make_cache`` holds one entry a layer.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.model import layer_plan
from repro_torch.weights import reference_leaves


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axsize(mesh, axis):
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _ok(mesh, dim, axis):
    return axis is not None and dim % _axsize(mesh, axis) == 0


def _guard(mesh, shape, spec):
    """Drop axes that don't divide their dim."""
    return tuple(ax if _ok(mesh, dim, ax) else None for dim, ax in zip(shape, spec))


def _names(path):
    return [p for p in path if isinstance(p, str)]


def param_pspec(path, leaf, cfg, mesh):
    """The spec of the reference's parameter leaf at ``path``."""
    names = _names(path)
    name = names[-1] if names else ""
    stacked = "blocks" in names  # scan-stacked: leading group dim unsharded
    fsdp = "data" if cfg.fsdp else None
    shape = tuple(leaf.shape[1:] if stacked else leaf.shape)

    def out(*spec):
        spec = _guard(mesh, shape, spec)
        return (None,) + spec if stacked else spec

    nd = len(shape)
    if name == "embed":
        return out("model", fsdp)
    if name == "lm_head":
        return out(fsdp, "model")
    if name in ("wi", "wg", "wo") and nd == 3:          # MoE experts (E, ., .)
        if name == "wo":
            return out("model", None, fsdp)
        return out("model", fsdp, None)
    if name in ("wq", "wk", "wv", "wi", "wg", "wx", "wz", "wdt", "wgate",
                "shared_wi", "shared_wg") and nd == 2:
        return out(fsdp, "model")
    if name in ("wbc", "conv_bc") and nd == 2:   # head-shared B/C: replicate
        return out(None, None)
    if name in ("wo", "out_proj", "out", "shared_wo") and nd == 2:
        return out("model", fsdp)
    if name in ("wa",) and nd == 2:                     # RG-LRU gates (D, D)
        return out(None, "model")
    if name == "router":
        return out(fsdp, None)
    if name in ("conv_w", "conv_x"):
        return out(None, "model")
    if name in ("bq", "bk", "bv", "conv_b", "conv_x_b") and nd == 1:
        return out("model")
    return out(*([None] * nd))


def reference_params(model):
    """The reference's params tree of ``model`` as ``{path: meta tensor}``:
    a stacked leaf of G groups is (G, *shape), in the parameters' dtype."""
    params = list(model.parameters())
    tree = {}
    for leaf in reference_leaves(model):
        p = params[leaf.index[0]]
        shape = ((len(leaf.index),) if leaf.stacked else ()) + tuple(p.shape)
        tree[leaf.path] = torch.empty(shape, dtype=p.dtype, device="meta")
    return tree


def params_pspecs(mesh, params, cfg):
    return {path: param_pspec(path, leaf, cfg, mesh) for path, leaf in params.items()}


def shard_shape(shape, spec, mesh):
    """One device's block of ``shape`` under ``spec`` (missing trailing
    entries replicate); raises on a dim the axes do not divide, as
    ``NamedSharding.shard_shape`` does."""
    shape = tuple(int(d) for d in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape} has dims")
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, spec):
        n = 1 if ax is None else _axsize(mesh, ax)
        if dim % n:
            raise ValueError(f"dim {dim} of shape {shape} is not divisible by {n}, the size "
                             f"of mesh axis {ax} in spec {spec}")
        out.append(dim // n)
    return tuple(out)


def bytes_per_device(tree, specs, mesh):
    """Per-device bytes of a tree of (meta) tensors under ``specs`` (the
    same paths)."""
    if tree.keys() != specs.keys():
        raise ValueError("the tree and its specs hold different paths")
    return sum(math.prod(shard_shape(t.shape, specs[path], mesh)) * t.element_size()
               for path, t in tree.items())


def batch_pspec(mesh):
    return (dp_axes(mesh),)


def batch_pspecs(mesh, tree):
    """Shard the leading (batch) dim of every leaf over the dp axes (the
    reference's ``batch_shardings``)."""
    dp = dp_axes(mesh)
    out = {}
    for path, leaf in tree.items():
        spec = [dp] + [None] * (leaf.dim() - 1)
        if leaf.shape[0] % _axsize(mesh, dp) != 0:
            spec[0] = None
        out[path] = tuple(spec)
    return out


def reference_cache(cfg, cache):
    """The port's serving cache (one entry dict a layer, on any device) as
    the reference's cache tree, ``{path: meta tensor}``: the entries of
    pattern position j's groups stacked under ``("blocks", j, name)`` as
    (G, *shape), the tail layers' under ``("tail", t, name)``."""
    pattern, n_groups, tail = layer_plan(cfg)
    if len(cache) != cfg.n_layers:
        raise ValueError(f"{len(cache)} cache entries for {cfg.n_layers} layers")
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    tree = {}
    for j in range(len(pattern) if n_groups else 0):
        for name, t in cache[j].items():
            tree[("blocks", j, name)] = meta((n_groups,) + tuple(t.shape), t.dtype)
    whole = n_groups * len(pattern)
    for i, entry in enumerate(cache[whole:]):
        for name, t in entry.items():
            tree[("tail", i, name)] = meta(tuple(t.shape), t.dtype)
    return tree


def cache_pspecs(mesh, cache, cfg):
    """Caches (the reference's ``cache_shardings``): batch over dp; the
    length dim of the KV cache over "model" (its kv-head dim where the
    length does not divide), ``pos`` and the int8 scales likewise, the SSM
    and RG-LRU states' head / width dims and the conv tails' channels over
    "model" where they divide. ``cache`` is the reference's tree
    (``reference_cache``); a ``blocks`` leaf's group dim stays unsharded."""
    dp = dp_axes(mesh)
    model = mesh.shape["model"]
    out = {}
    for path, leaf in cache.items():
        names = _names(path)
        stacked = "blocks" in names
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        name = names[-1] if names else ""
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % _axsize(mesh, dp) == 0:
            spec[0] = dp
        if name in ("k", "v", "ck", "cv") and len(shape) == 4:
            # sequence-parallel KV cache: the length dim over "model"
            if shape[1] % model == 0:
                spec[1] = "model"
            elif shape[2] % model == 0:
                spec[2] = "model"
        if name == "pos" and len(shape) == 2 and shape[1] % model == 0:
            spec[1] = "model"
        if name in ("k_scale", "v_scale") and len(shape) == 3 and shape[1] % model == 0:
            spec[1] = "model"
        if name == "h" and len(shape) == 4 and shape[1] % model == 0:     # SSM (B, H, P, N)
            spec[1] = "model"
        if name in ("conv", "conv_x") and len(shape) == 3 and shape[2] % model == 0:
            spec[2] = "model"
        if name == "h" and len(shape) == 2 and shape[1] % model == 0:     # RG-LRU (B, D)
            spec[1] = "model"
        out[path] = tuple([None] + spec if stacked else spec)
    return out
