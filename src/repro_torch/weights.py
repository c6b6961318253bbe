"""Carry weights from the JAX reference into the port.

``from_jax_params`` takes the output of the reference's
``models.init_params`` as a tree of numpy arrays (the caller does the
``np.asarray`` on the JAX side; this module imports no JAX) and returns the
port's ``Model``. The reference stacks each block parameter of a pattern
position on a leading group axis (``params["decoder"]["blocks"][j][...]``
has shape ``(n_groups, ...)``) and keeps the layers past the last whole
group unstacked (``params["decoder"]["tail"]``); the port keeps one module
per layer, in the same (d_in, d_out) layouts, so the stacks are only
unstacked. ``reference_leaves`` describes the reference's leaves once, in
the port's terms; the tree carriers, the decay mask and Adafactor read it.

Under a mesh (``models.meshctx.use_mesh``, or ``from_jax_params``' own
``mesh``) the model holds a rank's block of every leaf, cut by the
reference's rules (``models.sharding.cut``); an MoE layer's experts are
cut by ``shard_moe_params`` (the reference's ``init_moe`` tree), a case of
the same cut, and ``moe_from_jax`` builds the layer from it.

``cache_from_jax`` carries a serving cache the reference built (its
``prefill`` output, numpy leaves) into the port's per-layer list, so a
decode can continue in the port from state the reference made.

``entity_actor_from_jax``, ``flat_trunk_from_jax``, ``actor_from_jax``
and ``actor_stack_from_jax`` carry the scheduler's policy nets
(``rl.nets.init_entity_actor``, ``init_flat_trunk``,
``rl.distill.quantize_flat_trunk`` and ``init_actor`` outputs, the last
also ``vmap``-stacked over the per-UE actors) the same way, as numpy
trees; ``agent_from_jax`` carries a whole MAHPPO agent.

``env_state_from_jax`` carries an env state (the reference's
``EnvState``, e.g. a stream snapshot a ``_DaggerDispatcher`` recorded)
and ``action_from_jax`` an action dict, so a test can feed the
reference's records to the port.

``cnn_from_jax`` carries a CNN backbone's parameters (``core.cnn``'s
``model.init`` output): the same nesting of lists, tuples and dicts, with
float32 tensors in place of the arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.env.mecenv import EnvState
from repro_torch.kernels.ref import code_dtype
import contextlib

from repro_torch.models import meshctx
from repro_torch.models.model import Model, layer_plan
from repro_torch.models.moe import MoE, expert_shard
from repro_torch.optim import Leaf
from repro_torch.rl.nets import MLP, Actor, EntityActor, Linear, StackedLinear


def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    # float32 first: numpy cannot hand bfloat16 arrays to torch directly,
    # and widening bf16 to f32 is exact.
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        device=device, dtype=dtype)


def _stack_leaves(prefix, blocks, pattern_len, n_groups, ln_f, pos):
    """The leaves of one layer stack (the decoder's or the encoder's): a
    pattern position's parameters stacked over the groups, the tail layers'
    and the final norm's unstacked."""
    out = []
    whole = n_groups * pattern_len
    for j in range(pattern_len if n_groups else 0):
        group = [dict(b.named_parameters()) for b in blocks[j:whole:pattern_len]]
        for name, p in group[0].items():
            sub, leaf = name.split(".", 1)
            out.append(Leaf(tuple(pos[id(g[name])] for g in group), True, p.dim() + 1,
                            prefix + ("blocks", j, sub, leaf)))
    for t, blk in enumerate(blocks[whole:]):
        for name, p in blk.named_parameters():
            sub, leaf = name.split(".", 1)
            out.append(Leaf((pos[id(p)],), False, p.dim(), prefix + ("tail", t, sub, leaf)))
    for name, p in ln_f.named_parameters():
        out.append(Leaf((pos[id(p)],), False, p.dim(), prefix + ("ln_f", name)))
    return out


def reference_leaves(model):
    """Every leaf of the reference's params tree as an ``optim.Leaf``:
    ``embed``, ``lm_head`` (untied), the decoder's stack (``decoder/blocks/
    j/...`` stacked over the groups of pattern position j, ``decoder/tail/
    t/...`` and ``decoder/ln_f``) and, for an encoder-decoder arch, the
    encoder's (``encoder/blocks/0/...`` stacked over its layers and its own
    ``encoder/ln_f``). ``to_reference_tree``, ``from_jax_params``,
    ``reference_decay_mask`` and Adafactor read the reference's layout from
    here."""
    pos = {id(p): i for i, p in enumerate(model.parameters())}
    leaves = [Leaf((pos[id(model.embed)],), False, 2, ("embed",))]
    if model.lm_head is not None:
        leaves.append(Leaf((pos[id(model.lm_head)],), False, 2, ("lm_head",)))
    pattern, n_groups, _ = layer_plan(model.cfg)
    leaves += _stack_leaves(("decoder",), model.blocks, len(pattern), n_groups, model.ln_f, pos)
    if model.encoder is not None:
        enc = model.encoder
        leaves += _stack_leaves(("encoder",), enc.blocks, 1, len(enc.blocks), enc.ln_f, pos)
    return leaves


def _stack_skeleton(pattern_len, n_groups, n_tail):
    return {"blocks": [{} for _ in range(pattern_len if n_groups else 0)],
            "tail": [{} for _ in range(n_tail)], "ln_f": {}}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _whole(p, mesh):
    """Parameter ``p`` whole, as a CPU tensor: a rank's block (``p.spec``,
    an expert leaf's shard included) gathered over each mesh axis its spec
    cuts, along the dim it cuts, the inverse of ``sharding.cut``."""
    t = p.detach()
    for dim, ax in enumerate(getattr(p, "spec", None) or ()):
        if ax is None:
            continue
        if mesh is None:
            raise ValueError("this model holds a rank's blocks; take its tree under the mesh "
                             "it was built under (meshctx.use_mesh)")
        t = mesh.all_gather(t, ax, dim)
    return t.cpu()


@torch.no_grad()
def to_reference_tree(model):
    """The port's Model as the reference's params tree: {"embed", "decoder":
    {"blocks": one subtree a pattern position, each parameter stacked over
    the groups on a leading axis; "tail": one subtree a layer past the last
    whole group; "ln_f"}, ("lm_head"), ("encoder": the same for the encoder
    stack)}, as CPU tensors in their own dtypes (``from_jax_params`` takes
    this tree back).

    A model built under a mesh (``meshctx.use_mesh``) gives the whole
    leaves, as the reference's ``np.asarray`` of a sharded array does:
    every rank calls this under the mesh, each parameter's blocks are
    gathered over the axes that cut it, one at a time and straight to the
    CPU (a rank's card never holds two copies of the model), and every
    rank returns the same tree; one rank writes it (``save_checkpoint``)."""
    params = list(model.parameters())
    mesh = meshctx.get_mesh()
    pattern, n_groups, tail = layer_plan(model.cfg)
    tree = {"decoder": _stack_skeleton(len(pattern), n_groups, len(tail))}
    if model.encoder is not None:
        tree["encoder"] = _stack_skeleton(1, len(model.encoder.blocks), 0)
    for leaf in reference_leaves(model):
        ts = [_whole(params[i], mesh) for i in leaf.index]
        node = tree
        for key in leaf.path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[leaf.path[-1]] = torch.stack(ts) if leaf.stacked else ts[0]
    return tree


def reference_decay_mask(model):
    """Which of ``model.parameters()`` the reference's AdamW decays: its
    rule, rank >= 2, applied to the reference's leaves (``reference_leaves``).
    The reference stacks every block parameter of a whole group on a group
    axis, so those are all decayed (the per-layer norm scales, ``A_log``,
    ``D``, ``dt_bias``, the RG-LRU's ``lam``, the biases and the
    cross-attention gates among them, 1-D or 0-D in the port), as are
    ``embed`` and ``lm_head``; the final norms' vectors are not, nor are a
    tail layer's 1-D leaves (recurrentgemma-9b's two ``"rec"`` layers past
    its 12 groups), which the reference keeps unstacked."""
    mask = [False] * len(list(model.parameters()))
    for leaf in reference_leaves(model):
        for i in leaf.index:
            mask[i] = leaf.rank >= 2
    return mask


@torch.no_grad()
def from_jax_params(tree, cfg, device, mesh=None):
    """The port's Model holding the reference parameters ``tree`` (numpy
    arrays, or tensors as ``to_reference_tree`` gives them), for any block
    pattern, with or without a tail or an encoder. Each parameter keeps its
    own dtype (the Mamba ``A_log``, ``D`` and ``dt_bias``, the RG-LRU's
    ``ba``, ``bi`` and ``lam`` and the MoE router stay float32 in a
    bfloat16 model); stacked MoE leaves are (G, E, d, f) experts and the
    (G, d, E) router. Under ``mesh`` (default: the current one, if any)
    the model holds this rank's block of every leaf (``sharding.cut`` by
    the leaf's ``spec``: for an MoE layer's experts ``shard_moe_params``'
    rule)."""
    from repro_torch.models.sharding import cut
    scope = meshctx.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with scope:
        model = Model(cfg, device=device)
    mesh = meshctx.get_mesh() if mesh is None else mesh
    params = list(model.parameters())
    for leaf in reference_leaves(model):
        a = _at(tree, leaf.path)
        for g, i in enumerate(leaf.index):
            src = a[g] if leaf.stacked else a
            if getattr(params[i], "spec", None) is not None:      # the rank's block
                src = cut(src if isinstance(src, torch.Tensor) else np.asarray(src),
                          params[i].spec, mesh)
            params[i].copy_(_tensor(src, params[i].dtype, device))
    return model


def shard_moe_params(params, cfg, mesh):
    """The rank's shard of one MoE layer's parameters ``params`` (the
    reference's ``init_moe`` tree: "router", "wi", "wg", "wo" and the
    shared experts' leaves, arrays or tensors) under ``mesh``: the expert
    rows ``[lo, lo + E / model)`` of its "model" index, and with ``fsdp``
    its d-slice over "data" (``wi`` and ``wg`` along dim 1, ``wo`` along
    dim 2; the reference's ``wspec_i`` / ``wspec_o``). The router and the
    shared experts stay whole, as do all leaves where the mesh has no
    expert-parallel path for ``cfg``."""
    from repro_torch.models.sharding import cut, expert_spec
    shard = expert_shard(cfg, mesh)
    if shard is None:
        return dict(params)
    return {k: cut(v, expert_spec(k, shard, mesh), mesh) if k in ("wi", "wg", "wo") else v
            for k, v in params.items()}


@torch.no_grad()
def moe_from_jax(params, cfg, device):
    """An ``MoE`` layer holding the reference's ``init_moe`` tree
    ``params``, or under a mesh (``meshctx.use_mesh``) the rank's shard of
    it (``shard_moe_params``)."""
    moe = MoE(cfg, device=device)
    for name, src in shard_moe_params(params, cfg, meshctx.get_mesh()).items():
        p = getattr(moe, name)
        p.copy_(_tensor(src, p.dtype, device))
    return moe


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int8": torch.int8, "bool": torch.bool}


def _leaf(a, device):
    a = np.asarray(a)
    dtype = _DTYPES[str(a.dtype)]
    if dtype.is_floating_point:
        return _tensor(a, dtype, device)
    return torch.from_numpy(a.copy()).to(device)


def cache_from_jax(cache_tree, cfg, device):
    """The reference's cache tree ({"blocks": one dict per pattern position,
    each leaf stacked over the scan groups, "tail": one dict per tail
    layer}, numpy leaves) -> the port's list of per-layer entry dicts, each
    leaf in its own dtype."""
    pattern, n_groups, _ = layer_plan(cfg)
    layers = [{name: _leaf(a[i // len(pattern)], device)
               for name, a in cache_tree["blocks"][i % len(pattern)].items()}
              for i in range(n_groups * len(pattern))]
    return layers + [{name: _leaf(a, device) for name, a in entry.items()}
                     for entry in cache_tree["tail"]]


def ae_from_numpy(ae, device):
    """{"enc": (d, d'), "dec": (d', d)} numpy arrays -> float32 tensors."""
    return {k: _tensor(ae[k], torch.float32, device) for k in ("enc", "dec")}


def _linear(layer, device):
    return Linear(_tensor(layer["w"], torch.float32, device),
                  _tensor(layer["b"], torch.float32, device))


def mlp_from_jax(layers, device):
    """A reference MLP (a list of {"w", "b"} layers, e.g. the entity
    critic of ``nets.init_entity_critic``) -> an :class:`MLP`."""
    return MLP([_linear(layer, device) for layer in layers])


def entity_actor_from_jax(tree, device):
    """``nets.init_entity_actor``'s tree ({"ue_enc", "srv_enc", "scorer",
    "heads"}) -> the port's :class:`EntityActor`."""
    return EntityActor(
        mlp_from_jax(tree["ue_enc"], device), _linear(tree["srv_enc"], device),
        mlp_from_jax(tree["scorer"], device),
        torch.nn.ModuleDict({name: mlp_from_jax(layers, device)
                             for name, layers in tree["heads"].items()}))


def actor_from_jax(tree, device):
    """``nets.init_actor``'s tree ({"trunk", "heads"}) -> an :class:`Actor`."""
    return Actor(mlp_from_jax(tree["trunk"], device),
                 torch.nn.ModuleDict({name: mlp_from_jax(layers, device)
                                      for name, layers in tree["heads"].items()}))


def _stacked_mlp(layers, device):
    return MLP([StackedLinear(_tensor(layer["w"], torch.float32, device),
                              _tensor(layer["b"], torch.float32, device))
                for layer in layers])


def actor_stack_from_jax(tree, device):
    """The per-UE actors (``init_actor`` vmapped over N keys: every leaf
    has a leading actor axis, weights (N, d_in, d_out)) -> one stacked
    :class:`Actor`."""
    return Actor(_stacked_mlp(tree["trunk"], device),
                 torch.nn.ModuleDict({name: _stacked_mlp(layers, device)
                                      for name, layers in tree["heads"].items()}),
                 n_actors=int(np.shape(tree["trunk"][0]["w"])[0]))


def agent_from_jax(tree, device):
    """A MAHPPO agent tree (``mahppo.init_agent``'s: "actors", "actor" or
    "entity_actor", and "critic") -> the port's agent dict."""
    if "actors" in tree:
        actor = ("actors", actor_stack_from_jax(tree["actors"], device))
    elif "actor" in tree:
        actor = ("actor", actor_from_jax(tree["actor"], device))
    elif "entity_actor" in tree:
        actor = ("entity_actor", entity_actor_from_jax(tree["entity_actor"], device))
    else:
        raise ValueError(f"unknown agent with keys {sorted(tree)}")
    return dict([actor, ("critic", mlp_from_jax(tree["critic"], device))])


def flat_trunk_from_jax(tree, device):
    """``{"layers": [...]}`` (the f32 trunk) -> an :class:`MLP`;
    ``{"qlayers": [...], "bits": n}`` (its quantized form) -> the same dict
    with codes and biases as tensors and mn / mx as float32 scalars."""
    if "qlayers" not in tree:
        return mlp_from_jax(tree["layers"], device)
    bits = int(tree["bits"])
    return {"qlayers": [
        {"codes": torch.from_numpy(np.asarray(layer["codes"]).astype(np.int32)).to(
            device=device, dtype=code_dtype(bits)),
         "mn": np.float32(layer["mn"]), "mx": np.float32(layer["mx"]),
         "b": _tensor(layer["b"], torch.float32, device)}
        for layer in tree["qlayers"]], "bits": bits}


def cnn_from_jax(tree, device):
    """A reference CNN parameter tree -> the same tree with float32 tensors
    on ``device``. Lists, tuples and dicts keep their shape; the structural
    entries (VGG's layer kinds, MobileNetV2's block descriptors) stay Python
    values, also where a numpy tree map made them 0-d arrays."""
    if isinstance(tree, dict):
        return {k: cnn_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cnn_from_jax(v, device) for v in tree)
    if tree is None or isinstance(tree, (str, int, float)):
        return tree
    a = np.asarray(tree)
    if a.ndim == 0 and a.dtype.kind in "USiub":
        return a.item()
    return _tensor(a, torch.float32, device)


def env_state_from_jax(state, device):
    """A reference ``EnvState`` (numpy or JAX leaves) -> the port's, each
    leaf in its own dtype; the reference's PRNG key becomes ``gen=None``."""
    leaf = lambda a: None if a is None else _leaf(np.asarray(a), device)
    return EnvState(k=leaf(state.k), l=leaf(state.l), n=leaf(state.n), d=leaf(state.d),
                    t=leaf(state.t), gen=None, active=leaf(state.active),
                    geom=leaf(getattr(state, "geom", None)))


def action_from_jax(actions, device):
    """{head: array} (numpy or JAX) -> {head: tensor}, dtypes kept."""
    return {k: _leaf(np.asarray(v), device) for k, v in actions.items()}
