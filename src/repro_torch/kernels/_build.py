"""Build, load and count the port's hand-written CUDA kernels.

The ``csrc/*.cu`` sources have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all run
at once, then one link) into a single shared library under
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing here runs at import
time, so the CPU tests can import every module.

``LAUNCHES`` counts, per kernel, the launches made by the wrappers; a
wrapper adds one where it launches its kernel and nowhere else.
``takes_twin`` is each wrapper's one test of which version runs.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "quant.cu", CSRC / "bottleneck.cu", CSRC / "ssd_intra.cu",
           CSRC / "ssd_intra_bwd.cu", CSRC / "pair_scorer.cu", CSRC / "pair_scorer_bwd.cu",
           CSRC / "flat_trunk.cu", CSRC / "decode_attn.cu", CSRC / "decode_attn_f32.cu",
           CSRC / "decode_attn_bf16.cu", CSRC / "decode_attn_i8.cu")
HEADERS = (CSRC / "quant.cuh", CSRC / "tf32_mma.cuh", CSRC / "mbarrier.cuh",
           CSRC / "wgmma.cuh", CSRC / "decode_attn.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# No --use_fast_math: the kernels' roundings must match the plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()

_c = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes; every entry point returns cudaGetLastError() as int
    "repro_quantize": [_c, _c, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, _c],
    "repro_dequantize": [_c, _c, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_float, ctypes.c_float, _c],
    # ..., mn, mx, route (1 tensor cores, 0 SIMT), K split, stream
    "repro_bottleneck_encode": [_c, _c, _c, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                ctypes.c_int, _c],
    # ..., x and B/C dtypes, route (1 tensor cores, 0 SIMT), heads a block, stream
    "repro_ssd_intra": [_c] * 7 + [ctypes.c_int] * 9 + [_c],
    # x, dt, la, bm, cm, dy; gram, dG, sums scratch; dx, ddt, dla, db, dc;
    # BC, Q, H, P, N, x and B/C dtypes, route (1 tensor cores, 0 SIMT),
    # heads a block, stream
    "repro_ssd_intra_backward": [_c] * 14 + [ctypes.c_int] * 9 + [_c],
    # ..., n, E, d_ue, S, H, envs, ue-term K split, route (1 bulk copy, 0
    # loads), shared bytes, stream
    "repro_pair_scorer": [_c] * 14 + [ctypes.c_int] * 8 + [ctypes.c_longlong, _c],
    # 11 inputs, srv, g, g_srv; d ue, dw_srv, db_srv, dw1, db1, dw2, db2;
    # the blocks' partials, the split envs' sums, the barrier; n, E, d_ue,
    # S, H, envs, envs a unit, chunk rows, units, grid, route (1 bulk copy,
    # 0 loads); shared bytes, stream
    "repro_pair_scorer_backward": [_c] * 24 + [ctypes.c_int] * 11 + [ctypes.c_longlong, _c],
    # n, E, envs, d_ue, S, H, envs a unit, chunk rows -> shared bytes,
    # partial floats a block, split sums' floats, resident blocks
    "repro_pair_scorer_backward_plan": [ctypes.c_int] * 8
    + [ctypes.POINTER(ctypes.c_longlong)] * 3 + [ctypes.POINTER(ctypes.c_int)],
    # the descriptor arrays are host arrays: widths, code and bias pointers,
    # each layer's (mn, mx) and K split; then bits, grid, route (1 bulk
    # copy, 0 loads), stream
    "repro_flat_trunk": [_c, _c, ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
                         ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _c],
    # layers, widths, bits, route -> shared bytes, blocks an SM holds
    "repro_flat_trunk_plan": [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                              ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                              ctypes.POINTER(ctypes.c_int)],
    # q, q bf16, k, v, kv type (0 f32, 1 bf16, 2 int8), k_scale, v_scale,
    # pos, idx, window, out, b, S, Hkv, G, rows a block, D, n_split, per,
    # scale, stream
    "repro_decode_attention": [_c, ctypes.c_int, _c, _c, ctypes.c_int, _c, _c, _c,
                               ctypes.c_longlong, ctypes.c_int, _c] + [ctypes.c_int] * 8
    + [ctypes.c_float, _c],
    "repro_decode_attention_max_clusters": [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
}

_lib = None


def reset_launches() -> None:
    LAUNCHES.clear()


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME/bin`` (``$CUDA_PATH``, then
    the toolkit's default prefix, when that is unset); raises if none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or DEFAULT_CUDA_HOME
    if (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def compile_commands(nvcc: str, objdir: Path, out: Path):
    """(per-source compile commands, link command)."""
    objs = [objdir / (src.stem + ".o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(SOURCES, objs)]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            *map(str, objs), "-o", str(out)]
    return compiles, link


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")


def build() -> Path:
    """Compile the library if this exact source set has not been built."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        compiles, link = compile_commands(nvcc, tmp, tmp / out.name)
        with ThreadPoolExecutor(len(compiles)) as pool:
            for fut in [pool.submit(_run, c) for c in compiles]:
                fut.result()
        _run(link)
        os.replace(tmp / out.name, out)   # atomic: concurrent builds agree
    return out


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's streaming multiprocessors (the planners' wave size)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def takes_twin(name: str, *tensors) -> bool:
    """Whether a wrapper runs its plain twin: every input on the CPU, or
    every input on ``meta``, where the twin's result is shapes and dtypes
    only (``meta`` executes nothing: the dry-run counts through it). Inputs
    that mix ``meta`` with another device raise. Any other inputs go to the
    kernel, which launches or raises: no tensor a card could compute reaches
    the twin."""
    types = {t.device.type for t in tensors}
    if "meta" in types and len(types) > 1:
        raise ValueError(f"{name}: inputs mix the meta device with {sorted(types - {'meta'})}")
    return types == {"cpu"} or types == {"meta"}


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device "
                             f"(CPU tensors take the plain version), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def refuse_grad(name: str, *inputs) -> None:
    """Raise where autograd would want a gradient through a forward-only
    kernel: grad mode is on and an input that the plain twin differentiates
    requires grad. The kernel's output has no autograd node, so the
    gradient would be dropped without a word; run such a call under
    ``torch.inference_mode()`` or ``torch.no_grad()``, or on detached
    tensors."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in inputs):
        raise RuntimeError(f"{name}: the kernel has no backward and an input requires grad in "
                           f"grad mode; call it under torch.no_grad() / inference_mode() or on "
                           f"detached tensors")
