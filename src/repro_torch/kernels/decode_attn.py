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

On a CUDA tensor the wrapper launches the hand-written kernels of
``csrc/decode_attn.cu`` (split-S flash decoding: one block per (b, kv head)
and ``SPLIT`` slots, one warp per slot with lanes across D, an online
softmax in registers, then a merge launch over the splits) or raises. It is
bound by the bytes of the cache. On a CPU tensor the wrapper runs the plain
twin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

SPLIT = 128                   # cache slots per block of the kernel
GROUPS = (1, 2, 4, 8)         # query heads per KV head the kernel takes
HEAD_DIMS = (32, 64, 128)
_FLOATS = (torch.float32, torch.bfloat16)


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
    n_split = -(-s // SPLIT)
    part_acc = torch.empty((b * hkv, n_split, g, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * hkv, n_split, g, 2), dtype=torch.float32, device=q.device)
    lib = _build.library()
    _build.check(lib.repro_decode_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(k.dtype == torch.bfloat16), pos.data_ptr(), int(idx), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(), b, s, hkv, g, d, SPLIT, d ** -0.5,
        _build.stream_of(q)), "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out
