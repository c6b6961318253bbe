"""Huffman codec for JALAD's entropy-coding stage, the port's copy of
``src/repro/core/huffman.py`` (numpy and Python, bit for bit the
reference's, heap tie-breaks included).

The scheduling experiments only need coded *sizes* (``core/jalad.py``
estimates them information-theoretically); this module is the real codec
that validates the estimate end to end: canonical Huffman over the 8-bit
quantized feature codes, encode -> bitstream -> decode. It runs on the
host (the UE's CPU in the paper's system); it is not a kernel.
"""
from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np


def build_code(symbols: np.ndarray) -> Dict[int, str]:
    """Canonical Huffman code lengths from symbol frequencies."""
    freq = Counter(symbols.tolist())
    if not freq:
        return {}
    if len(freq) == 1:
        (s, _), = freq.items()
        return {s: "0"}
    heap = [(n, i, sym) for i, (sym, n) in enumerate(freq.items())]
    heapq.heapify(heap)
    # (count, tiebreak, payload) where payload is a symbol or a merged node
    nodes = {i: (sym, None, None) for i, (_, i, sym) in enumerate(heap)}
    next_id = len(nodes)
    heap = [(n, i) for (n, i, _) in heap]
    heapq.heapify(heap)
    while len(heap) > 1:
        n1, i1 = heapq.heappop(heap)
        n2, i2 = heapq.heappop(heap)
        nodes[next_id] = (None, i1, i2)
        heapq.heappush(heap, (n1 + n2, next_id))
        next_id += 1
    root = heap[0][1]
    code: Dict[int, str] = {}

    def walk(i, prefix):
        sym, l, r = nodes[i]
        if sym is not None:
            code[sym] = prefix or "0"
        else:
            walk(l, prefix + "0")
            walk(r, prefix + "1")

    walk(root, "")
    return code


def encode(symbols: np.ndarray) -> Tuple[bytes, Dict[int, str], int]:
    """Returns (bitstream bytes, code table, n_symbols)."""
    code = build_code(symbols)
    if not code:
        return b"", code, 0
    bits = "".join(code[s] for s in symbols.tolist())
    pad = (-len(bits)) % 8
    bits += "0" * pad
    by = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return by, code, len(symbols)


def decode(stream: bytes, code: Dict[int, str], n: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, np.int64)
    if not code:
        raise ValueError("empty code table with n > 0")
    rev = {v: k for k, v in code.items()}
    maxlen = max(len(v) for v in code.values())
    bits = "".join(f"{b:08b}" for b in stream)
    out = np.empty(n, np.int64)
    pos = 0
    cur = ""
    for i in range(n):
        while True:
            cur += bits[pos]
            pos += 1
            if cur in rev:
                out[i] = rev[cur]
                cur = ""
                break
            if len(cur) > maxlen:
                raise ValueError("corrupt stream")
    return out


def coded_size_bits(symbols: np.ndarray) -> int:
    """Exact Huffman-coded payload size in bits (excluding the table)."""
    code = build_code(symbols)
    freq = Counter(symbols.tolist())
    return sum(len(code[s]) * n for s, n in freq.items())
