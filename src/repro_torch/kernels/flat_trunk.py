"""Fused dequantize-and-MLP forward of the distilled dispatch trunk.

Replaces ``src/repro/kernels/flat_trunk.py::flat_trunk_pallas`` (Pallas
TPU). Per layer: dequantize the weight codes,
``w = codes * ((mx - mn) / levels) + mn`` (paper Eq. 2), then
``h @ w + b``, tanh between layers, linear last. The float32 weights
never reach device memory.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/flat_trunk.cu`` or raises; on a CPU tensor it runs the plain twin.
The kernel is one launch of a persistent grid laid out by ``plan`` (from
``launch_plan``, which takes the kernel's shared memory and the blocks an
SM holds from the library: the kernel owns its layout):
``min(row tiles, SMs x resident blocks)`` blocks, each walking 8-row tiles
with stride ``grid``, so no grid needs a second wave and each block
dequantizes the weights once (with the same two roundings as the plain
twin, so they are bit-equal to it) however many tiles it takes. The codes
arrive by bulk copy (the ``"bulk"`` route, where every layer's codes are a
whole number of 16-byte units on a 16-byte boundary and their staging area
fits beside the rest; else the ``"loads"`` route, ordinary loads), the next tile's rows by ``cp.async`` while the
current tile computes. Each layer runs on the FP64 tensor cores
(``mma.m8n8k4``: an 8-row tile is one fragment; a warp takes 8 columns,
and a part of K where a layer has fewer than 8 column tiles, ``k_split``):
products of f32 values are exact in f64 and sum in f64, rounding once to
f32, so identity rows return the dequantized weights bit for bit. The
layer count and widths travel in a descriptor, so any trunk depth (up to
``MAX_LAYERS``) and width takes the same kernel. At the serving size (a
thousand rows) it is bound by its critical path, not by work: 2 M 6144 is
13 MFLOP at M = 1024. The kernel has no backward: on CUDA tensors in grad
mode the wrapper refuses rows or biases that require grad
(``_build.refuse_grad``), where the twin would pass a gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import _levels
from repro_torch.kernels.ref import code_dtype

MAX_LAYERS = 8
ROWS = 8            # rows of a tile: one m8 fragment of the FP64 tensor cores
WARPS = 8           # a block's warps
SMEM_MAX = 232448   # the shared memory a block may take on Hopper


class Plan(NamedTuple):
    """The kernel's launch: ``tiles`` tiles of ``rows_per_tile`` rows walked by
    a persistent grid of ``grid`` blocks, each layer's K split over
    ``k_split`` warps, ``smem_bytes`` of shared memory, the codes' ``route``."""
    rows_per_tile: int
    tiles: int
    grid: int
    k_split: tuple
    smem_bytes: int
    route: str


def _up(v: int, n: int) -> int:
    return (v + n - 1) // n * n


def route(codes) -> str:
    """``"bulk"`` (the codes by bulk copy) where every layer's codes are a
    whole number of 16-byte units starting on a 16-byte boundary, else
    ``"loads"``."""
    ok = all(c.numel() * c.element_size() % 16 == 0 and c.data_ptr() % 16 == 0 for c in codes)
    return "bulk" if ok else "loads"


def k_split(nin, nout) -> int:
    """Warps that split a layer's K: a layer with fewer 8-column tiles than
    warps splits K into the largest power of two of parts that keeps every
    warp to one tile and every part at least 2 of the 4-deep steps.
    19 -> 64 and 64 -> 64 (8 tiles): 1; 64 -> 13 (2 tiles): 4."""
    tiles, steps = _up(nout, 8) // 8, _up(nin, 4) // 4
    split = 1
    while 2 * split * tiles <= WARPS and 4 * split <= steps:
        split *= 2
    return split


def plan(m, dims, copy_route, smem_bytes, n_sm, resident) -> Plan:
    """The launch for M rows through widths ``dims`` by ``copy_route``, the
    kernel taking ``smem_bytes`` of shared memory, on ``n_sm`` SMs holding
    ``resident`` blocks each: one block a row tile up to one full wave, and
    no more. Raises where the widths need more shared memory than a block
    has or the card holds no block."""
    if smem_bytes > SMEM_MAX or resident < 1:
        raise ValueError(f"flat_trunk: widths {tuple(dims)} need {smem_bytes} bytes of shared "
                         f"memory ({resident} blocks fit an SM; a block may take {SMEM_MAX})")
    tiles = math.ceil(m / ROWS)
    return Plan(ROWS, tiles, min(tiles, n_sm * resident),
                tuple(k_split(a, b) for a, b in zip(dims, dims[1:])), smem_bytes, copy_route)


def block_tiles(pl: Plan, block: int) -> range:
    """The row tiles block ``block`` of the persistent grid walks, in the
    kernel's order."""
    return range(block, pl.tiles, pl.grid)


@functools.lru_cache(maxsize=None)
def _query(device, dims: tuple, bits: int, copy_route: str) -> tuple:
    """(shared bytes, blocks an SM holds) of the kernel for these widths on
    ``device``: the kernel's own layout and the occupancy query."""
    lib = _build.library()
    smem, blocks = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(lib.repro_flat_trunk_plan(
            len(dims) - 1, (ctypes.c_int * len(dims))(*dims), bits, int(copy_route == "bulk"),
            ctypes.byref(smem), ctypes.byref(blocks)), "flat_trunk plan query")
    return smem.value, blocks.value


def launch_plan(x, codes, bits) -> Plan:
    """The launch the wrapper makes for the rows ``x`` (on the card) through
    ``codes``: the route from their sizes and addresses, the shared memory
    and resident blocks from the library, the SM count from the card. Where
    the bulk route's staging area is what leaves no block room on an SM
    (wide trunks with 16-bit codes), the codes take the loads route."""
    dims = (x.shape[1], *(c.shape[1] for c in codes))
    r = route(codes)
    smem, resident = _query(x.device, dims, bits, r)
    if r == "bulk" and resident < 1:
        r = "loads"
        smem, resident = _query(x.device, dims, bits, r)
    return plan(x.shape[0], dims, r, smem, _build.sm_count(x.device), resident)


def dequantized_weights(codes, mn, mx, *, bits=8):
    """One layer's float32 weights with the kernel's association,
    ``codes * ((mx - mn) / levels) + mn``, every step rounded to float32."""
    mn, mx = np.float32(mn), np.float32(mx)
    step = (mx - mn) / _levels(bits)
    return codes.to(torch.float32) * float(step) + float(mn)


def flat_trunk_plain(x, codes, mns, mxs, bs, *, bits=8):
    """The kernel's function in plain PyTorch (the association of
    ``flat_trunk_xla``)."""
    h = x.to(torch.float32)
    for i in range(len(codes)):
        w = dequantized_weights(codes[i], mns[i], mxs[i], bits=bits)
        h = h @ w + bs[i].to(torch.float32)
        if i < len(codes) - 1:
            h = torch.tanh(h)
    return h


def flat_trunk(x, codes, mns, mxs, bs, *, bits=8):
    """x: (M, F) float rows; codes: per-layer (nin_i, nout_i) weight codes
    (uint8 for bits <= 8, else uint16) chaining F -> ... -> W; mns, mxs:
    per-layer float32 calibration scalars (host values); bs: per-layer
    (nout_i,) biases. Returns (M, W) float32."""
    n_layers = len(codes)
    if x.dim() != 2 or n_layers == 0 or not (len(mns) == len(mxs) == len(bs) == n_layers):
        raise ValueError(f"flat_trunk: x must be (M, F) and every layer needs codes, "
                         f"mn, mx and b; got x {tuple(x.shape)} and {n_layers} layers")
    dims = [x.shape[1]] + [c.shape[1] for c in codes]
    for i, c in enumerate(codes):
        if c.dim() != 2 or c.shape[0] != dims[i] or bs[i].shape != (dims[i + 1],):
            raise ValueError(f"flat_trunk: layer {i} codes {tuple(c.shape)} and bias "
                             f"{tuple(bs[i].shape)} do not chain from width {dims[i]}")
    tensors = (x, *codes, *bs)
    if all(t.device.type == "cpu" for t in tensors):
        return flat_trunk_plain(x, codes, mns, mxs, bs, bits=bits)
    _build.refuse_grad("flat_trunk", x, *bs)
    x = x.to(torch.float32).contiguous()
    bs = [b.to(torch.float32).contiguous() for b in bs]
    _build.require_cuda("flat_trunk", x, *codes, *bs)
    _levels(bits)
    if n_layers > MAX_LAYERS:
        raise ValueError(f"flat_trunk: at most {MAX_LAYERS} layers, got {n_layers}")
    for c in codes:
        if c.dtype != code_dtype(bits):
            raise TypeError(f"flat_trunk: {bits}-bit codes must be {code_dtype(bits)}, "
                            f"got {c.dtype}")
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    pl = launch_plan(x, codes, bits)
    lib = _build.library()
    _build.check(lib.repro_flat_trunk(
        x.data_ptr(), out.data_ptr(), x.shape[0], n_layers,
        (ctypes.c_int * (n_layers + 1))(*dims),
        (ctypes.c_void_p * n_layers)(*(c.data_ptr() for c in codes)),
        (ctypes.c_void_p * n_layers)(*(b.data_ptr() for b in bs)),
        (ctypes.c_float * n_layers)(*(float(np.float32(v)) for v in mns)),
        (ctypes.c_float * n_layers)(*(float(np.float32(v)) for v in mxs)),
        (ctypes.c_int * n_layers)(*pl.k_split), bits, pl.grid, int(pl.route == "bulk"),
        _build.stream_of(x)), "flat_trunk")
    _build.LAUNCHES["flat_trunk"] += 1
    return out
