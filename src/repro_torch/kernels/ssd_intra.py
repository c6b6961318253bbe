"""Mamba-2 SSD intra-chunk term,
``y[i] = sum_{j<=i} (C_i . B_j) * exp(la_i - la_j) * dt_j * x_j``.

Replaces ``src/repro/kernels/ssd_intra.py::ssd_intra`` (Pallas TPU), the
quadratic hot spot of ``models/ssm.ssd_chunked``. On a CUDA tensor the
wrapper launches a hand-written kernel of ``csrc/ssd_intra.cu`` or raises;
on a CPU tensor it runs the plain twin.

The kernel is chosen by shape and address before the launch (``route``):

* ``"mma"``, every shape with Q <= 256, P rows of whole 16-byte units, N a
  multiple of 4 and the inputs aligned (both main-path shapes): one launch
  on the tensor cores (``wgmma``). A block owns one chunk, the row tiles
  ``lo`` and ``nt - 1 - lo`` (the same tile products for every pair) and a
  group of heads sized by ``plan`` so the grid fills the card in one wave.
  It computes its tiles' Gram strip C B^T into shared memory and reuses it
  for every head of the group; its two warpgroups then take alternate
  heads, each streaming x tiles in by TMA, building the weights straight
  into the product's register operand and multiplying asynchronously. Both
  products run in 3xTF32 (each f32 operand split into TF32 high and low
  parts, three products summed in f32; a bf16 operand, exact in TF32, is
  not split), so the result is f32-grade, not TF32-grade.
* ``"simt"``, anything else: the lower triangle of C B^T into a (B NC, Q,
  Q) scratch, then 64-row output tiles in SIMT f32 FMA (two launches).

With the products on the tensor cores the least time at the serving shape
is set by bytes (x read and y written once dominate), not by f32
operations; what holds the kernel above it is building the weights and
splitting x, on 8 warps an SM (PERF.md).

The backward (the reference has no kernel for it: it differentiates the
einsum form of ``ssd_chunked``) is ``csrc/ssd_intra_bwd.cu``. With M_ij =
G_ij W_ij dt_j, G = C B^T, W_ij = exp(la_i - la_j) on j <= i and dM_ij =
dy_i . x_j, it gives dx = M^T dy, d dt_j = sum_i dM_ij G_ij W_ij, d la_i =
sum_j S_ij - sum_k S_ki with S = dM o M, and dC = dG B, dB = dG^T C with
dG_ij = sum_h dM_ij W_ij dt_j. Its route is chosen by shape and address
before the launch (``backward_route``):

* ``"mma"``, Q <= 256, P = 64 and N a multiple of 32 up to 256 with x, B
  and C 16-byte aligned (mamba2-1.3b's shapes): a block owns one chunk,
  one column tile j and a group of heads (``mma_backward_plan``). It keeps
  the Gram tiles G_ij of its row tiles in shared memory, and for each head
  its two warpgroups take the row tiles i >= j in turn: dM = dy_i x_j^T and
  dx_j += M^T dy_i on ``wgmma`` in 3xTF32, the weights and every sum built
  from dM's accumulators, dG summed over the group's heads in its scratch
  slot, dx_j summed over i in the accumulators and written once. A short
  finishing launch then sums d dt, d la, dB and dC.
* ``"simt"``, anything else: three SIMT f32 FMA launches, the (row tile,
  column tile) pairs of a chunk for a group of heads (the Gram tile, dM and
  every sum of it), then dx (M^T dy, column tile by column tile), then the
  same finishing launch.

Every sum runs in a fixed order with no float atomics, so the same call
gives the same bits. :class:`SsdIntra` wires the forward and this backward
into autograd; ``ssd_intra_backward_plain`` is the formula in plain
PyTorch, which CPU tensors run.
"""
from __future__ import annotations

import functools
import heapq
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import _FLOAT_CODES
from repro_torch.kernels.ref import ssd_intra_ref

TILE = 64        # rows i, columns j and columns p of a tile product
MAX_Q = 256      # the tensor-core kernel keeps a Q <= 4 tiles Gram strip on chip
CHUNK = 4        # elements a cp.async moves


class Plan(NamedTuple):
    """The tensor-core kernel's grid: blocks of ``heads_per_block`` heads, one
    per (chunk, row-tile pair, head group, P tile)."""
    heads_per_block: int
    n_pairs: int
    n_groups: int
    n_ptiles: int
    blocks: int


class BwdPlan(NamedTuple):
    """The backward's SIMT launch: its pair kernel takes ``heads_per_block``
    heads a block, ``n_groups`` groups a chunk's tile pairs."""
    heads_per_block: int
    n_groups: int
    n_pairs: int
    blocks: int


class MmaBwdPlan(NamedTuple):
    """The backward's tensor-core launch: blocks of ``heads_per_block``
    heads, one per (column tile, chunk, head group); ``span`` is the
    planner's estimate of the busiest SM's work, in head-tiles of one
    warpgroup."""
    heads_per_block: int
    n_groups: int
    n_col_tiles: int
    blocks: int
    span: int


def ssd_intra_plain(xh, dt, la, Bm, Cm):
    """The kernel's function in plain PyTorch: the reference's einsum form,
    in float32."""
    f = lambda t: t.to(torch.float32)
    return ssd_intra_ref(f(xh), f(dt), f(la), f(Bm), f(Cm))


def _wide(*tensors):
    """float64 where every input is float64 (the float64 twin of the
    checks), else float32, the kernels' type."""
    return torch.float64 if all(t.dtype == torch.float64 for t in tensors) else torch.float32


def ssd_intra_backward_plain(dy, xh, dt, la, Bm, Cm):
    """The gradients of ``ssd_intra`` for an incoming ``dy`` (B, NC, Q, H,
    P), as the explicit formula in plain PyTorch (float32; float64 where
    every input is). With M_ij = G_ij W_ij dt_j, G = C B^T and W_ij =
    exp(la_i - la_j) on j <= i, and dM_ij = dy_i . x_j:
    dx = M^T dy; d dt_j = sum_i dM_ij G_ij W_ij; d la_i = sum_j S_ij -
    sum_k S_ki with S = dM o M (its diagonal, which cancels, left out); dG =
    sum_h dM W dt; dC = dG B; dB = dG^T C. Returns (dx, d dt, d la, dB, dC)
    in the dtypes of xh, dt, la, Bm and Cm."""
    wt = _wide(dy, xh, dt, la, Bm, Cm)
    f = lambda t: t.to(wt)
    dyf, x, dtf, laf, b, c = map(f, (dy, xh, dt, la, Bm, Cm))
    q = x.shape[2]
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    strict = torch.tril(lower, diagonal=-1)
    seg = laf[:, :, :, None, :] - laf[:, :, None, :, :]                 # (B,NC,i,j,H)
    w = torch.exp(torch.where(lower[None, None, :, :, None], seg, -torch.inf))
    g = torch.einsum("bcin,bcjn->bcij", c, b)
    gw = g[..., None] * w
    m = gw * dtf[:, :, None, :, :]
    dm = torch.einsum("bcihp,bcjhp->bcijh", dyf, x) * lower[None, None, :, :, None]
    dx = torch.einsum("bcijh,bcihp->bcjhp", m, dyf)
    ddt = (dm * gw).sum(2)
    s = dm * m * strict[None, None, :, :, None]
    dla = s.sum(3) - s.sum(2)
    dg = (dm * w * dtf[:, :, None, :, :]).sum(-1)
    dc = torch.einsum("bcij,bcjn->bcin", dg, b)
    db = torch.einsum("bcij,bcin->bcjn", dg, c)
    return dx.to(xh.dtype), ddt.to(dt.dtype), dla.to(la.dtype), db.to(Bm.dtype), dc.to(Cm.dtype)


def route(xh, Bm, Cm) -> str:
    """``"mma"`` (tensor cores) where Q <= 256, a row of P is a whole number
    of 16-byte units and xh starts on one (the Tensor Memory Accelerator's
    terms for x), and N is a multiple of 4 with Bm and Cm on a four-element
    boundary; else ``"simt"``."""
    q, p, n = xh.shape[2], xh.shape[4], Bm.shape[-1]
    ok = (q <= MAX_Q and p * xh.element_size() % 16 == 0 and xh.data_ptr() % 16 == 0
          and n % CHUNK == 0
          and all(t.data_ptr() % (CHUNK * t.element_size()) == 0 for t in (Bm, Cm)))
    return "mma" if ok else "simt"


def plan(bc, q, h, p, n_sm) -> Plan:
    """Heads a block of the tensor-core kernel: the smallest divisor of H
    whose grid still fits in one wave of ``n_sm`` blocks (one block an SM: its
    shared memory holds the Gram strip), else all H. Fewer heads a block
    means more blocks but more copies of the Gram strip, one a block. At the
    serving shape (8 chunks, Q 256, 64 heads of 64) on 132 SMs: 8 chunks x
    2 pairs x 8 groups of 8 heads = 128 blocks; at 32 chunks, 2 groups of 32
    heads, again 128."""
    nt = math.ceil(q / TILE)
    n_pairs, n_ptiles = (nt + 1) // 2, math.ceil(p / TILE)
    units = bc * n_pairs * n_ptiles
    divisors = [d for d in range(1, h + 1) if h % d == 0]
    hpb = next((d for d in divisors if units * (h // d) <= n_sm), h)
    return Plan(hpb, n_pairs, h // hpb, n_ptiles, units * (h // hpb))


def block_work(pl: Plan, q, h, block):
    """What block ``block`` of the grid computes, decoded in the kernel's
    order: (chunk, its row tiles, its heads, its P tile)."""
    block, pt = divmod(block, pl.n_ptiles)
    block, grp = divmod(block, pl.n_groups)
    bc, lo = divmod(block, pl.n_pairs)
    hi = math.ceil(q / TILE) - 1 - lo
    h0 = grp * pl.heads_per_block
    return bc, sorted({lo, hi}), range(h0, min(h, h0 + pl.heads_per_block)), pt


def ssd_intra(xh, dt, la, Bm, Cm):
    """xh: (B, NC, Q, H, P) float32 or bfloat16; dt, la: (B, NC, Q, H)
    float32; Bm, Cm: (B, NC, Q, N), both float32 or both bfloat16. Returns
    y_intra (B, NC, Q, H, P) float32."""
    if xh.dim() != 5 or dt.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_intra: expected xh (B, NC, Q, H, P), dt/la (B, NC, Q, H) "
                         f"and Bm/Cm (B, NC, Q, N), got {tuple(xh.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}")
    b, nc, q, h, p = xh.shape
    n = Bm.shape[-1]
    if (dt.shape != (b, nc, q, h) or la.shape != dt.shape
            or Bm.shape[:3] != (b, nc, q) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_intra: shapes do not agree: xh {tuple(xh.shape)}, "
                         f"dt {tuple(dt.shape)}, la {tuple(la.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    tensors = (xh, dt, la, Bm, Cm)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_intra_plain(*tensors)
    _build.require_cuda("ssd_intra", *tensors)
    if dt.dtype != torch.float32 or la.dtype != torch.float32:
        raise TypeError(f"ssd_intra: dt and la must be float32, got {dt.dtype} and {la.dtype}")
    if xh.dtype not in _FLOAT_CODES or Bm.dtype not in _FLOAT_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_intra: xh must be float32 or bfloat16 and Bm, Cm share one "
                        f"of them, got {xh.dtype}, {Bm.dtype} and {Cm.dtype}")
    out = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=xh.device)
    if out.numel() == 0:
        return out
    if n == 0:
        raise ValueError("ssd_intra: the state dim N is 0")
    mma = route(xh, Bm, Cm) == "mma"
    if mma:
        gram, hpb = None, plan(b * nc, q, h, p, _build.sm_count(xh.device)).heads_per_block
    else:
        gram, hpb = torch.empty((b * nc, q, q), dtype=torch.float32, device=xh.device), 0
    lib = _build.library()
    _build.check(lib.repro_ssd_intra(
        xh.data_ptr(), dt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if gram is None else gram.data_ptr(), out.data_ptr(), b * nc, q, h, p, n,
        _FLOAT_CODES[xh.dtype], _FLOAT_CODES[Bm.dtype], int(mma), hpb,
        _build.stream_of(xh)), "ssd_intra")
    _build.LAUNCHES["ssd_intra"] += 1
    return out


def backward_plan(bc, q, h, n_sm) -> BwdPlan:
    """Heads a block of the SIMT backward's pair kernel: the smallest divisor of
    H whose grid (chunks x tile pairs x head groups) still fits the two
    blocks an SM holds (its launch bounds), else all H. Each group writes
    its own copy of the chunk's dG, so fewer heads a block trade more
    blocks (a finer spread of the per-head products over the SMs) for more
    dG traffic. At the serving shape (8 chunks, Q 256, 64 heads) on 132
    SMs: 8 x 10 pairs x 2 groups of 32 heads = 160 blocks."""
    nt = math.ceil(q / TILE)
    n_pairs = nt * (nt + 1) // 2
    units = bc * n_pairs
    divisors = [d for d in range(1, h + 1) if h % d == 0]
    hpb = next((d for d in divisors if units * (h // d) <= 2 * n_sm), h)
    return BwdPlan(hpb, h // hpb, n_pairs, units * (h // hpb))


MMA_BWD_P = 64        # the tensor-core backward's P: one 64-column tile
MMA_BWD_N_STEP = 32   # its N: whole stretches of 32 ...
MMA_BWD_MAX_N = 256   # ... up to 256 (the Gram's B_j fits in shared memory)


def backward_route(xh, Bm, Cm) -> str:
    """``"mma"`` (the tensor-core backward) where Q <= 256, P is 64, N is a
    multiple of 32 up to 256 and xh, Bm and Cm start on 16-byte boundaries
    (rows of x, B and C come in as 16-byte loads); else ``"simt"``."""
    q, p, n = xh.shape[2], xh.shape[4], Bm.shape[-1]
    ok = (q <= MAX_Q and p == MMA_BWD_P and n % MMA_BWD_N_STEP == 0 and n <= MMA_BWD_MAX_N
          and all(t.data_ptr() % 16 == 0 for t in (xh, Bm, Cm)))
    return "mma" if ok else "simt"


@functools.lru_cache(maxsize=None)
def mma_backward_plan(bc, q, h, n_sm) -> MmaBwdPlan:
    """Heads a block of the tensor-core backward. Blocks go out column tile
    by column tile, tile 0 (the most row tiles) first, one block an SM; a
    block's work is about (heads + 1) x ceil(row tiles / 2) head-tiles of
    its busier warpgroup (the + 1 its Gram tiles). The planner places the
    blocks in launch order on the least loaded SM and takes the divisor of H
    with the least busiest SM, the larger group on a tie (fewer copies of
    dG). At the serving shape (8 chunks, Q 256, 64 heads) on 132 SMs: groups
    of 8 heads, 256 blocks. Cached: the wrappers call it on every launch."""
    nt = math.ceil(q / TILE)
    best = None
    for d in (d for d in range(1, h + 1) if h % d == 0):
        groups = h // d
        loads = [0] * n_sm
        for jt in range(nt):
            cost = (d + 1) * math.ceil((nt - jt) / 2)
            for _ in range(bc * groups):
                heapq.heapreplace(loads, loads[0] + cost)
        key = (max(loads), -d)
        if best is None or key < best[0]:
            best = (key, MmaBwdPlan(d, groups, nt, bc * nt * groups, max(loads)))
    return best[1]


def ssd_intra_backward(dy, xh, dt, la, Bm, Cm):
    """``ssd_intra_backward_plain``'s gradients by the backward kernel on
    CUDA tensors, its formula on CPU tensors. dy: (B, NC, Q, H, P); the rest
    as ``ssd_intra`` takes them. Returns (dx, d dt, d la, dB, dC) in the
    dtypes of xh, dt, la, Bm and Cm."""
    tensors = (dy, xh, dt, la, Bm, Cm)
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_intra_backward_plain(*tensors)
    dy = dy.to(torch.float32).contiguous()
    if dy.data_ptr() % 16:      # the kernel reads rows of dy as float4
        dy = dy.clone()
    _build.require_cuda("ssd_intra_backward", *tensors[1:], dy)
    if dy.shape != xh.shape:
        raise ValueError(f"ssd_intra_backward: dy {tuple(dy.shape)} is not the shape of "
                         f"xh {tuple(xh.shape)}")
    if dt.dtype != torch.float32 or la.dtype != torch.float32:
        raise TypeError(f"ssd_intra_backward: dt and la must be float32, got {dt.dtype} and "
                        f"{la.dtype}")
    if xh.dtype not in _FLOAT_CODES or Bm.dtype not in _FLOAT_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_intra_backward: xh must be float32 or bfloat16 and Bm, Cm share "
                        f"one of them, got {xh.dtype}, {Bm.dtype} and {Cm.dtype}")
    b, nc, q, h, p = xh.shape
    n = Bm.shape[-1]
    dev = xh.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx, ddt, dla = torch.empty(xh.shape, **f32), torch.empty(dt.shape, **f32), \
        torch.empty(la.shape, **f32)
    db, dc = torch.empty(Bm.shape, **f32), torch.empty(Cm.shape, **f32)
    if dx.numel() and n:
        bc, nt = b * nc, math.ceil(q / TILE)
        mma = backward_route(xh, Bm, Cm) == "mma"
        if mma:
            hpb, gram = mma_backward_plan(bc, q, h, _build.sm_count(dev)).heads_per_block, None
        else:
            hpb = backward_plan(bc, q, h, _build.sm_count(dev)).heads_per_block
            gram = torch.empty((bc, q, q), **f32)
        dg = torch.empty((bc, math.ceil(h / hpb), q, q), **f32)
        sums = torch.empty((3, bc, nt, h, q), **f32)    # row and column sums of S, d dt
        lib = _build.library()
        _build.check(lib.repro_ssd_intra_backward(
            xh.data_ptr(), dt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dy.data_ptr(), None if gram is None else gram.data_ptr(), dg.data_ptr(),
            sums.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dla.data_ptr(), db.data_ptr(),
            dc.data_ptr(), bc, q, h, p, n, _FLOAT_CODES[xh.dtype], _FLOAT_CODES[Bm.dtype],
            int(mma), hpb, _build.stream_of(dy)), "ssd_intra_backward")
        _build.LAUNCHES["ssd_intra_backward"] += 1
    elif dx.numel():
        raise ValueError("ssd_intra_backward: the state dim N is 0")
    return dx.to(xh.dtype), ddt, dla, db.to(Bm.dtype), dc.to(Cm.dtype)


class SsdIntra(torch.autograd.Function):
    """``ssd_intra`` with its gradient: the forward kernel (the twin on CPU
    tensors) and, backward, ``ssd_intra_backward`` (the backward kernel on
    CUDA tensors, its formula on CPU tensors)."""

    @staticmethod
    def forward(ctx, xh, dt, la, Bm, Cm):
        ctx.save_for_backward(xh, dt, la, Bm, Cm)
        return ssd_intra(xh, dt, la, Bm, Cm)

    @staticmethod
    def backward(ctx, dy):
        return ssd_intra_backward(dy, *ctx.saved_tensors)
