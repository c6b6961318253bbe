"""GQA flash-decode attention over a (ring) KV cache: one query token per
sequence against the cache, the edge server's serving hot spot.

Replaces ``src/repro/kernels/decode_attn.py::decode_attention`` (Pallas
TPU). q (B, Hq, D) attends over k, v (B, S, Hkv, D); query head ``h G + j``
reads KV head ``h``; pos (B, S) maps each slot to its absolute position
(-1 = empty) and a slot is valid iff ``0 <= pos <= idx``. It computes what
``ref.decode_attention_ref`` computes, in f32: an invalid score is -1e30
(so a row with no valid slot gives the mean of v), and slots past S are
never read (the TPU kernel's last block reads past a ragged S and returns
NaN there; this one does not).

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/decode_attn.cu`` (one launch: S split over the blocks of a thread
block cluster as ``plan_splits`` says, K and V staged through shared
memory by the Tensor Memory Accelerator, a tile-wise online softmax, the
splits merged through distributed shared memory) or raises. It is bound by
the bytes of the cache. On a CPU tensor the wrapper runs the plain twin.
The kernel has no backward: on CUDA tensors in grad mode the wrapper
refuses a q, k or v that requires grad (``_build.refuse_grad``), where the
twin would pass a gradient and the kernel would drop it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

TILE = 32                     # cache slots a stage of the kernel's ring
MAX_SPLIT = 8                 # blocks of a cluster (the portable size)
GROUPS = (1, 2, 4, 8)         # query heads per KV head the kernel takes
HEAD_DIMS = (32, 64, 128)
_FLOATS = (torch.float32, torch.bfloat16)


def plan_splits(pairs: int, s: int, resident):
    """(n_split, slots_per_split) for ``pairs`` = B Hkv (b, kv head) pairs
    over S slots, where ``resident[c - 1]`` is the number of the kernel's
    blocks the card holds at once in clusters of c blocks (c = 1 ..
    ``MAX_SPLIT``). Each split is a run of whole tiles of slots (the last
    run may be shorter), so no copy fetches a slot of the next split; the
    plan is the one with the fewest tiles a block whose grid of ``pairs *
    n_split`` blocks fits one wave. When the pairs alone exceed a wave, one
    split a pair."""
    if pairs < 1 or s < 1 or len(resident) != MAX_SPLIT:
        raise ValueError(f"plan_splits: pairs {pairs} and S {s} must be >= 1 and resident "
                         f"must hold {MAX_SPLIT} counts, got {len(resident)}")
    tiles = -(-s // TILE)
    for c in range(min(MAX_SPLIT, tiles), 0, -1):
        per = -(-tiles // c) * TILE
        n = -(-s // per)
        if pairs * n <= resident[n - 1]:
            return n, per
    return 1, tiles * TILE


@functools.lru_cache(maxsize=None)
def _resident(index: int, kv_bf16: bool, g: int, d: int) -> tuple:
    lib = _build.library()
    counts = []
    with torch.cuda.device(index):
        for c in range(1, MAX_SPLIT + 1):
            clusters = ctypes.c_int(0)
            _build.check(lib.repro_decode_attention_max_clusters(
                int(kv_bf16), g, d, c, ctypes.byref(clusters)), "decode_attention occupancy")
            counts.append(clusters.value * c)
    return tuple(counts)


def resident_blocks(device: torch.device, kv_dtype: torch.dtype, g: int, d: int) -> tuple:
    """``plan_splits``'s ``resident`` for the kernel that takes a cache of
    ``kv_dtype`` with G and D on ``device``: the card's count of resident
    clusters of each size (cudaOccupancyMaxActiveClusters) times the size,
    asked once a card and kernel."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _resident(index, kv_dtype == torch.bfloat16, g, d)


def decode_attention_plain(q, k, v, pos, idx):
    """The kernel's function in plain PyTorch: the reference's form, in
    float32."""
    return decode_attention_ref(q, k, v, pos, idx)


def decode_attention(q, k, v, pos, idx):
    """q: (B, Hq, D) float32 or bfloat16; k, v: (B, S, Hkv, D), both float32
    or both bfloat16; pos: (B, S) int32; idx: int. Returns (B, Hq, D)
    float32."""
    if q.dim() != 3 or k.dim() != 4 or pos.dim() != 2:
        raise ValueError(f"decode_attention: expected q (B, Hq, D), k/v (B, S, Hkv, D) and "
                         f"pos (B, S), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(pos.shape)}")
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or pos.shape != (b, s)
            or hq % hkv):
        raise ValueError(f"decode_attention: shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, pos {tuple(pos.shape)}")
    tensors = (q, k, v, pos)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_attention_plain(q, k, v, pos, idx)
    _build.refuse_grad("decode_attention", q, k, v)
    _build.require_cuda("decode_attention", *tensors)
    g = hq // hkv
    if g not in GROUPS or d not in HEAD_DIMS or s < 1:
        raise ValueError(f"decode_attention: the kernel takes G in {GROUPS}, D in {HEAD_DIMS} "
                         f"and S >= 1, got G {g}, D {d}, S {s}")
    if q.dtype not in _FLOATS or k.dtype not in _FLOATS or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16 and k, v share one "
                        f"of them, got {q.dtype}, {k.dtype} and {v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, got {pos.dtype}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must start on a 16-byte boundary")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    n_split, per = plan_splits(b * hkv, s, resident_blocks(q.device, k.dtype, g, d))
    lib = _build.library()
    _build.check(lib.repro_decode_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(k.dtype == torch.bfloat16), pos.data_ptr(), int(idx), out.data_ptr(), b, s, hkv,
        g, d, n_split, per, d ** -0.5, _build.stream_of(q)), "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
