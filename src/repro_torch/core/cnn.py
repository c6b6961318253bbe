"""The paper's CNN backbones (ResNet18, VGG11, MobileNetV2), the port of
``src/repro/core/cnn.py``: each organized as *modules* separated by the
paper's partitioning points, with an analytic per-module FLOPs walker that
the split tables read (paper §3.4).

Parameters are the reference's tree, with tensors in place of arrays: a
list with one entry per module, the same nesting inside (VGG's
``("M", None)`` / ``("C", {...})`` layers, MobileNetV2's ``("stem", ...)``
and ``(("blk", cin, cout, t, stride), {...})`` items), so
``weights.cnn_from_jax`` carries the reference's parameters across as
they are. Layouts stay NCHW activations and OIHW kernels. BatchNorm always
normalizes with the batch's statistics (no running statistics), as the
reference's does. ``feature_shapes`` and ``module_flops`` are pure Python
and give the reference's integers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def _conv_init(gen, cin, cout, k, device):
    w = torch.randn((cout, cin, k, k), generator=gen) * math.sqrt(2.0 / (cin * k * k))
    return {"w": w.to(device)}


def _conv(p, x, stride, pad, groups=1):
    return F.conv2d(x, p["w"], stride=stride, padding=pad, groups=groups)


def _bn_init(ch, device):
    return {"scale": torch.ones((ch,), device=device), "bias": torch.zeros((ch,), device=device)}


def _bn(p, x, eps=1e-5):
    if x.numel() == x.shape[1]:
        # one value a channel (one image of 1 x 1 maps), which F.batch_norm
        # refuses: the reference's formula, whose variance is 0 here
        mu = x.mean(dim=(0, 2, 3), keepdim=True)
        var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"][None, :, None, None] \
            + p["bias"][None, :, None, None]
    return F.batch_norm(x, None, None, p["scale"], p["bias"], training=True, eps=eps)


def _head_init(gen, cin, num_classes, device):
    return {"w": (torch.randn((cin, num_classes), generator=gen) * 0.01).to(device),
            "b": torch.zeros((num_classes,), device=device)}


@dataclasses.dataclass
class CNNModel:
    name: str
    init: Callable                  # (generator, device=None) -> params (list per module)
    run_module: Callable            # (params_i, i, x) -> x
    n_modules: int
    split_after: Tuple[int, ...]    # the paper's 4 partitioning points (module index)
    feature_shapes: Callable        # in_size -> list of (C, H, W) after each module
    module_flops: Callable          # in_size -> list of flops per module


# ------------------------------------------------------------------ resnet18
def _basic_block_init(gen, cin, cout, stride, device):
    p = {"c1": _conv_init(gen, cin, cout, 3, device), "b1": _bn_init(cout, device),
         "c2": _conv_init(gen, cout, cout, 3, device), "b2": _bn_init(cout, device)}
    if stride != 1 or cin != cout:
        p["cd"] = _conv_init(gen, cin, cout, 1, device)
        p["bd"] = _bn_init(cout, device)
    return p


def _basic_block(p, x, stride):
    h = F.relu(_bn(p["b1"], _conv(p["c1"], x, stride, 1)))
    h = _bn(p["b2"], _conv(p["c2"], h, 1, 1))
    sc = x if "cd" not in p else _bn(p["bd"], _conv(p["cd"], x, stride, 0))
    return F.relu(h + sc)


def make_resnet18(num_classes=101, width=1.0):
    chs = [int(c * width) for c in (64, 64, 128, 256, 512)]

    def init(gen, device=None):
        mods = [{"c": _conv_init(gen, 3, chs[0], 7, device), "b": _bn_init(chs[0], device)}]
        cin = chs[0]
        for si, cout in enumerate(chs[1:]):
            blocks = []
            for bi in range(2):
                blocks.append(_basic_block_init(gen, cin, cout, 2 if (si > 0 and bi == 0) else 1,
                                                device))
                cin = cout
            mods.append(blocks)
        mods.append(_head_init(gen, cin, num_classes, device))
        return mods

    def run_module(p, i, x):
        if i == 0:
            x = F.relu(_bn(p["b"], _conv(p["c"], x, 2, 3)))
            # reduce_window's -inf padding of (1, 1) on each side
            return F.max_pool2d(x, 3, 2, padding=1)
        if i == 5:
            return x.mean(dim=(2, 3)) @ p["w"] + p["b"]
        for bi, bp in enumerate(p):
            x = _basic_block(bp, x, 2 if (i > 1 and bi == 0) else 1)
        return x

    def feature_shapes(in_size):
        s = in_size // 4
        shapes = [(chs[0], s, s)]
        for si, c in enumerate(chs[1:]):
            if si > 0:
                s = (s + 1) // 2
            shapes.append((c, s, s))
        shapes.append((num_classes,))
        return shapes

    def module_flops(in_size):
        s = in_size // 2
        fl = [2 * 3 * chs[0] * 49 * s * s]               # stem conv
        s = in_size // 4
        cin = chs[0]
        for si, c in enumerate(chs[1:]):
            if si > 0:
                s = (s + 1) // 2
            f = 2 * cin * c * 9 * s * s + 2 * c * c * 9 * s * s
            if si > 0:
                f += 2 * cin * c * s * s
            f += 2 * c * c * 9 * s * s * 2 + 2 * c * c * 9 * s * s  # 2nd block
            fl.append(f)
            cin = c
        fl.append(2 * cin * num_classes)
        return fl

    return CNNModel("resnet18", init, run_module, 6, (1, 2, 3, 4), feature_shapes, module_flops)


# -------------------------------------------------------------------- vgg11
_VGG = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


def make_vgg11(num_classes=101, width=1.0):
    cfgs = [int(c * width) if c != "M" else c for c in _VGG]
    # modules end after each of the first 4 max pools; the last = the rest + head
    bounds = [i + 1 for i, c in enumerate(cfgs) if c == "M"]
    mod_slices = ([slice(0, bounds[0])] + [slice(bounds[i], bounds[i + 1]) for i in range(3)]
                  + [slice(bounds[3], len(cfgs))])

    def init(gen, device=None):
        mods, cin = [], 3
        for sl in mod_slices:
            layers = []
            for c in cfgs[sl]:
                if c == "M":
                    layers.append(("M", None))
                else:
                    layers.append(("C", {"c": _conv_init(gen, cin, c, 3, device),
                                         "b": _bn_init(c, device)}))
                    cin = c
            mods.append(layers)
        mods.append(_head_init(gen, cin, num_classes, device))
        return mods

    def run_module(p, i, x):
        if i == 5:
            return x.mean(dim=(2, 3)) @ p["w"] + p["b"]
        for kind, lp in p:
            x = F.max_pool2d(x, 2, 2) if kind == "M" \
                else F.relu(_bn(lp["b"], _conv(lp["c"], x, 1, 1)))
        return x

    def feature_shapes(in_size):
        shapes, s, cin = [], in_size, 3
        for sl in mod_slices:
            for c in cfgs[sl]:
                if c == "M":
                    s //= 2
                else:
                    cin = c
            shapes.append((cin, s, s))
        shapes.append((num_classes,))
        return shapes

    def module_flops(in_size):
        fl, s, cin = [], in_size, 3
        for sl in mod_slices:
            f = 0
            for c in cfgs[sl]:
                if c == "M":
                    s //= 2
                else:
                    f += 2 * cin * c * 9 * s * s
                    cin = c
            fl.append(f)
        fl.append(2 * cin * num_classes)
        return fl

    return CNNModel("vgg11", init, run_module, 6, (1, 2, 3, 4), feature_shapes, module_flops)


# -------------------------------------------------------------- mobilenetv2
_MBV2 = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def _inv_res_init(gen, cin, cout, t, device):
    mid = cin * t
    p = {}
    if t != 1:
        p["e"] = _conv_init(gen, cin, mid, 1, device)
        p["be"] = _bn_init(mid, device)
    p["d"] = {"w": (torch.randn((mid, 1, 3, 3), generator=gen) * math.sqrt(2.0 / 9)).to(device)}
    p["bd"] = _bn_init(mid, device)
    p["p"] = _conv_init(gen, mid, cout, 1, device)
    p["bp"] = _bn_init(cout, device)
    return p


def _inv_res(p, x, cin, cout, t, stride):
    h = x
    if t != 1:
        h = F.relu6(_bn(p["be"], _conv(p["e"], h, 1, 0)))
    h = F.relu6(_bn(p["bd"], _conv(p["d"], h, stride, 1, groups=cin * t)))
    h = _bn(p["bp"], _conv(p["p"], h, 1, 0))
    if stride == 1 and cin == cout:
        h = h + x
    return h


def make_mobilenetv2(num_classes=101, width=1.0):
    stages = [(t, int(c * width), n, s) for (t, c, n, s) in _MBV2]
    c_stem = int(32 * width)
    c_head = int(1280 * width)
    # modules: stem + stage 1 | stage 2 | stage 3 | stages 4-5 | stages 6-7 | head
    groups = [[0], [1], [2], [3, 4], [5, 6]]

    def init(gen, device=None):
        mods, cin = [], c_stem
        first = {"c": _conv_init(gen, 3, c_stem, 3, device), "b": _bn_init(c_stem, device)}
        for gi, g in enumerate(groups):
            blocks = [] if gi else [("stem", first)]
            for si in g:
                t, c, n, s = stages[si]
                for bi in range(n):
                    stride = s if bi == 0 else 1
                    blocks.append((("blk", cin, c, t, stride),
                                   _inv_res_init(gen, cin, c, t, device)))
                    cin = c
            mods.append(blocks)
        mods.append({"c": _conv_init(gen, cin, c_head, 1, device), "b": _bn_init(c_head, device),
                     "w": (torch.randn((c_head, num_classes), generator=gen) * 0.01).to(device),
                     "bias": torch.zeros((num_classes,), device=device)})
        return mods

    def run_module(p, i, x):
        if i == 5:
            x = F.relu6(_bn(p["b"], _conv(p["c"], x, 1, 0)))
            return x.mean(dim=(2, 3)) @ p["w"] + p["bias"]
        for item in p:
            if item[0] == "stem":
                x = F.relu6(_bn(item[1]["b"], _conv(item[1]["c"], x, 2, 1)))
            else:
                (_, cin, c, t, s), bp = item
                x = _inv_res(bp, x, cin, c, t, s)
        return x

    def feature_shapes(in_size):
        shapes, s, cin = [], in_size // 2, c_stem
        for g in groups:
            for si in g:
                t, c, n, st = stages[si]
                if st == 2:
                    s = (s + 1) // 2
                cin = c
            shapes.append((cin, s, s))
        shapes.append((num_classes,))
        return shapes

    def module_flops(in_size):
        fl = []
        s = in_size // 2
        f0 = 2 * 3 * c_stem * 9 * s * s
        cin = c_stem
        for gi, g in enumerate(groups):
            f = f0 if gi == 0 else 0
            f0 = 0
            for si in g:
                t, c, n, st = stages[si]
                for bi in range(n):
                    mid = cin * t
                    s_out = (s + 1) // 2 if (st == 2 and bi == 0) else s
                    if t != 1:
                        f += 2 * cin * mid * s * s
                    f += 2 * mid * 9 * s_out * s_out
                    f += 2 * mid * c * s_out * s_out
                    s = s_out
                    cin = c
            fl.append(f)
        fl.append(2 * cin * c_head * s * s + 2 * c_head * num_classes)
        return fl

    return CNNModel("mobilenetv2", init, run_module, 6, (1, 2, 3, 4), feature_shapes,
                    module_flops)


CNN_FACTORY = {"resnet18": make_resnet18, "vgg11": make_vgg11,
               "mobilenetv2": make_mobilenetv2}


def forward(model: CNNModel, params, x, upto=None):
    """Run modules [0, upto) (None = all). x: (B, 3, H, W)."""
    for i in range(model.n_modules if upto is None else upto):
        x = model.run_module(params[i], i, x)
    return x


def forward_from(model: CNNModel, params, feat, start):
    """Run modules [start, n_modules) from a boundary feature."""
    x = feat
    for i in range(start, model.n_modules):
        x = model.run_module(params[i], i, x)
    return x


def param_leaves(tree):
    """The tensors of a parameter tree (lists, tuples, dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return []


def trainable_copy(tree):
    """The tree with each tensor detached, copied and requiring grad; the
    structural entries (VGG's layer kinds, MobileNetV2's block tuples)
    kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone().requires_grad_(True)
    if isinstance(tree, dict):
        return {k: trainable_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(trainable_copy(v) for v in tree)
    return tree
