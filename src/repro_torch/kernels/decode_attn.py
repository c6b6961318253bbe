"""GQA flash-decode attention over a (ring) KV cache: one query token per
sequence against the cache, the edge server's serving hot spot.

Replaces ``src/repro/kernels/decode_attn.py::decode_attention`` (Pallas
TPU) and computes what the reference model's ``_flash_decode``
(``src/repro/models/attention.py``) computes around it. q (B, Hq, D)
attends over k, v (B, S, Hkv, D); query head ``h G + j`` reads KV head
``h`` (any G = Hq / Hkv >= 1); pos (B, S) maps each slot to its absolute
position (-1 = empty) and a slot is valid iff ``0 <= pos <= idx`` and, with
``window`` W > 0, ``pos > idx - W``. The cache is float32, bfloat16 or int8
codes; an int8 cache comes with per-(slot, kv head) float32 scales
``k_scale``, ``v_scale`` (B, S, Hkv), which multiply a slot's scores and,
after the row's sum of probabilities, its probabilities. It computes what
``ref.decode_attention_ref`` computes, in f32: an invalid score is -1e30
(so a row with no valid slot gives the mean of v), and slots past S are
never read (the TPU kernel's last block reads past a ragged S and returns
NaN there; this one does not). Where the reference rounds q * scale and the
probabilities to a bf16 cache's (or an int8 cache's q's) dtype, the kernel
and its twin keep them f32.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/decode_attn.cu`` (one launch: S split over the blocks of a thread
block cluster as ``plan_splits`` says, the query rows of a kv head in
``block_rows`` row groups, K and V staged through shared memory by the
Tensor Memory Accelerator, a tile-wise online softmax, the splits merged
through distributed shared memory) or raises. It is bound by the bytes of
the cache. On CPU or meta tensors the wrapper runs the plain twin. The kernel has
no backward: on CUDA tensors in grad mode the wrapper refuses a q, k or v
that requires grad (``_build.refuse_grad``), where the twin would pass a
gradient and the kernel would drop it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

TILE = 32                     # cache slots a stage of the kernel's ring
MAX_SPLIT = 8                 # blocks of a cluster (the portable size)
ROWS = (1, 2, 4, 8, 16)        # query rows a block of the kernel takes (padded)
HEAD_DIMS = (32, 64, 128, 256)
_FLOATS = (torch.float32, torch.bfloat16)
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def block_rows(g: int, d: int):
    """(rows, groups): the kernel's block takes ``rows`` query rows of its
    kv head (the least of ``ROWS`` that holds G, at most 16, or 8 where D =
    256, which keeps a lane's accumulators at 64 floats), and the G rows
    of a kv head are ``groups`` = ceil(G / rows) row groups of the grid."""
    if g < 1:
        raise ValueError(f"block_rows: G must be >= 1, got {g}")
    cap = 8 if d > 128 else 16
    rows = next(r for r in ROWS if r >= min(g, cap))
    return rows, -(-g // rows)


def plan_splits(pairs: int, s: int, resident):
    """(n_split, slots_per_split) for ``pairs`` = B Hkv (b, kv head) pairs
    (times ``block_rows``' row groups) over S slots, where
    ``resident[c - 1]`` is the number of the kernel's blocks the card holds
    at once in clusters of c blocks (c = 1 .. ``MAX_SPLIT``). Each split is
    a run of whole tiles of slots (the last run may be shorter), so no copy
    fetches a slot of the next split; the plan is the one with the fewest
    tiles a block whose grid of ``pairs * n_split`` blocks fits one wave.
    When the pairs alone exceed a wave, one split a pair."""
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
def _resident(index: int, kv_type: int, rows: int, d: int) -> tuple:
    lib = _build.library()
    counts = []
    with torch.cuda.device(index):
        for c in range(1, MAX_SPLIT + 1):
            clusters = ctypes.c_int(0)
            _build.check(lib.repro_decode_attention_max_clusters(
                kv_type, rows, d, c, ctypes.byref(clusters)), "decode_attention occupancy")
            counts.append(clusters.value * c)
    return tuple(counts)


def resident_blocks(device: torch.device, kv_dtype: torch.dtype, g: int, d: int) -> tuple:
    """``plan_splits``'s ``resident`` for the kernel that takes a cache of
    ``kv_dtype`` (float32, bfloat16 or int8) with G and D on ``device``: the
    card's count of resident clusters of each size
    (cudaOccupancyMaxActiveClusters) times the size, asked once a card and
    kernel (the cache type, ``block_rows``' rows and D)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _resident(index, _KV_TYPES[kv_dtype], block_rows(g, d)[0], d)


def decode_attention_plain(q, k, v, pos, idx, *, k_scale=None, v_scale=None, window=0):
    """The kernel's function in plain PyTorch: the reference's form, in
    float32."""
    return decode_attention_ref(q, k, v, pos, idx, k_scale=k_scale, v_scale=v_scale,
                                window=window)


def decode_attention(q, k, v, pos, idx, *, k_scale=None, v_scale=None, window=0):
    """q: (B, Hq, D) float32 or bfloat16; k, v: (B, S, Hkv, D), both float32,
    both bfloat16, or both int8 codes with ``k_scale``, ``v_scale`` (B, S,
    Hkv) float32; pos: (B, S) int32; idx: int; window: int (0 = none).
    Returns (B, Hq, D) float32."""
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
    scaled = k_scale is not None
    if scaled != (v_scale is not None) or scaled != (k.dtype == torch.int8):
        raise TypeError(f"decode_attention: an int8 cache takes k_scale and v_scale and a "
                        f"float cache neither, got k {k.dtype} with k_scale "
                        f"{'given' if scaled else 'None'} and v_scale "
                        f"{'None' if v_scale is None else 'given'}")
    if scaled and (k_scale.shape != (b, s, hkv) or v_scale.shape != (b, s, hkv)):
        raise ValueError(f"decode_attention: k_scale and v_scale must be {(b, s, hkv)}, got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    if int(window) < 0:
        raise ValueError(f"decode_attention: window must be >= 0, got {window}")
    tensors = (q, k, v, pos) + ((k_scale, v_scale) if scaled else ())
    if _build.takes_twin("decode_attention", *tensors):
        return decode_attention_plain(q, k, v, pos, idx, k_scale=k_scale, v_scale=v_scale,
                                      window=window)
    _build.refuse_grad("decode_attention", q, k, v)
    _build.require_cuda("decode_attention", *tensors)
    g = hq // hkv
    if d not in HEAD_DIMS or s < 1:
        raise ValueError(f"decode_attention: the kernel takes D in {HEAD_DIMS} and S >= 1, "
                         f"got D {d}, S {s}")
    kv_dtypes = _FLOATS + (torch.int8,)
    if q.dtype not in _FLOATS or k.dtype not in kv_dtypes or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16 and k, v share one "
                        f"of float32, bfloat16 and int8, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, got {pos.dtype}")
    if scaled and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"decode_attention: k_scale and v_scale must be float32, got "
                        f"{k_scale.dtype} and {v_scale.dtype}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v must start on a 16-byte boundary")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    rows, groups = block_rows(g, d)
    n_split, per = plan_splits(b * hkv * groups, s, resident_blocks(q.device, k.dtype, g, d))
    lib = _build.library()
    _build.check(lib.repro_decode_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        _KV_TYPES[k.dtype], k_scale.data_ptr() if scaled else None,
        v_scale.data_ptr() if scaled else None, pos.data_ptr(), int(idx), int(window),
        out.data_ptr(), b, s, hkv, g, rows, d, n_split, per, d ** -0.5, _build.stream_of(q)),
        "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
