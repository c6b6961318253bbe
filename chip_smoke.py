#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

  python3 chip_smoke.py

Phases, one line or more each, any failure exits non-zero before the last
line:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch twin on the card, at the
   serving shapes and ragged ones, in float32 and bfloat16, 4 and 8 bits;
   then the kernel, plain and library times (CUDA events, median of 25)
   beside the least time the card could take;
4. small split forward: the split-serving path at a small f32 config on the
   card (kernels) against the same model on the CPU (plain twins);
5. serve: qwen3-1.7b at its published widths, 28 layers, bf16, seeded
   random weights, 4 requests of (4, 256) tokens through the split forward;
   the launch counts show every request went through bottleneck_encode and
   dequantize, and one request's boundary codes are held to the oracle;
6. profile: one request's device time by kernel (informative);
7. the kernels as one JSON line, then the result as the last line.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
ROUTES = {  # name: (source, the TPU kernel it replaces)
    "quantize": ("src/repro_torch/kernels/csrc/quant.cu",
                 "src/repro/kernels/quant.py:62"),
    "dequantize": ("src/repro_torch/kernels/csrc/quant.cu",
                   "src/repro/kernels/quant.py:83"),
    "bottleneck_encode": ("src/repro_torch/kernels/csrc/bottleneck.cu",
                          "src/repro/kernels/bottleneck.py:45"),
}
SERVE = dict(requests=4, batch=4, seq=256)


class Failed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failed(what)


def device_ms(fn, reps=25, warmup=3):
    """Median device time of ``fn`` in ms. A sleep kernel holds the stream
    while the host enqueues every timed call, so host overhead between calls
    does not reach the timing: each pair of events brackets one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n_bytes, n_flops):
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def code_diff(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def phase_kernels(dev, kq, kb, ref):
    """Hold each kernel to its plain twin; returns {name: max_abs_err}."""
    g = torch.Generator(device=dev).manual_seed(0)
    err = {"quantize": 0, "dequantize": 0.0, "bottleneck_encode": 0}
    for shape in [(1024, 512), (17, 130), (15, 384), (513, 96), (100, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
            for bits in (4, 8):
                q = kq.quantize_2d(x, -9.0, 9.0, bits=bits)
                dq = code_diff(q, kq.quantize_plain(x, -9.0, 9.0, bits=bits))
                check(dq == 0 if dtype == torch.float32 else dq <= 1,
                      f"quantize {shape} {dtype} {bits}b differs by {dq} codes")
                err["quantize"] = max(err["quantize"], dq)
                for out_dtype in (torch.float32, torch.bfloat16):
                    d = kq.dequantize_2d(q, -9.0, 9.0, bits=bits, out_dtype=out_dtype)
                    p = kq.dequantize_plain(q, -9.0, 9.0, bits=bits, out_dtype=out_dtype)
                    dd = float((d.float() - p.float()).abs().max())
                    check(torch.equal(d, p), f"dequantize {shape} {bits}b {out_dtype} "
                          f"not bit-equal (max {dd})")
                    err["dequantize"] = max(err["dequantize"], dd)
    x = torch.rand((1024, 512), generator=g, device=dev) * 10 - 5
    oracle = 0.0
    for bits in (4, 8):
        q = kq.quantize_2d(x, -5.0, 5.0, bits=bits)
        d = kq.dequantize_2d(q, -5.0, 5.0, bits=bits)
        rt = float((d - x).abs().max())
        check(rt <= 10.0 / ((1 << bits) - 1) / 2 + 1e-5, f"round trip {bits}b off by {rt}")
        oracle = max(oracle, float((d - ref.dequantize_ref(q, -5.0, 5.0, bits)).abs().max()))
    check(oracle <= 1e-5, f"dequantize differs from the oracle by {oracle}")
    print(f"kernels: quantize bit-equal in f32 (max {err['quantize']} code overall), "
          f"dequantize bit-equal (oracle's association within {oracle:.2e}), "
          f"round trip within step/2", flush=True)
    # the last shapes take the kernel's element-wise loads: d and d' not
    # multiples of 4, and an x that starts 4 bytes into its buffer
    for t, d, dp, offset in [(1024, 2048, 512, 0), (513, 384, 96, 0), (100, 260, 64, 0),
                             (64, 128, 32, 0), (100, 257, 63, 0), (96, 256, 64, 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            buf = torch.randn((t * d + offset,), generator=g, device=dev).to(dtype)
            x = buf[offset:].view(t, d)
            w = (torch.randn((d, dp), generator=g, device=dev) * 0.05).to(dtype)
            for bits in (4, 8):
                c = kb.bottleneck_encode(x, w, -4.0, 4.0, bits=bits)
                p = kb.bottleneck_encode_plain(x, w, -4.0, 4.0, bits=bits)
                diff = code_diff(c, p)
                share = float((c != p).float().mean())
                check(diff <= 1, f"bottleneck_encode ({t},{d})->{dp} {dtype} {bits}b "
                      f"differs by {diff} codes")
                err["bottleneck_encode"] = max(err["bottleneck_encode"], diff)
                print(f"kernels: bottleneck_encode ({t},{d})->{dp}{' offset' if offset else ''} "
                      f"{str(dtype)[6:]} {bits}b: max {diff} code, "
                      f"{100 * share:.4f}% of codes differ",
                      flush=True)
    return err


def phase_timing(dev, kq, kb):
    """Kernel, plain and library times at the serving shapes."""
    g = torch.Generator(device=dev).manual_seed(1)
    t, d, dp = SERVE["batch"] * SERVE["seq"], 2048, 512
    mn, mx, levels = -4.0, 4.0, 255
    z = torch.randn((t, dp), generator=g, device=dev) * 2
    codes = kq.quantize_2d(z, mn, mx)
    x = torch.randn((t, d), generator=g, device=dev)
    w = torch.randn((d, dp), generator=g, device=dev) * 0.05
    step = (mx - mn) / levels
    zp = int(round(-mn / step))
    qt = torch.quantize_per_tensor(z, step, zp, torch.quint8)
    scale = torch.tensor(levels / (mx - mn), device=dev)
    n = t * dp
    rows = {
        "quantize": dict(
            kernel=lambda: kq.quantize_2d(z, mn, mx),
            plain=lambda: kq.quantize_plain(z, mn, mx),
            # one PyTorch call for affine uint8 quantization (its zero point
            # is an integer, so a code may differ by one: a yardstick only)
            library=lambda: torch.quantize_per_tensor(z, step, zp, torch.quint8),
            bound=bound(n * (4 + 1), 5 * n)),
        "dequantize": dict(
            kernel=lambda: kq.dequantize_2d(codes, mn, mx),
            plain=lambda: kq.dequantize_plain(codes, mn, mx),
            library=lambda: qt.dequantize(),
            bound=bound(n * (1 + 4), 2 * n)),
        "bottleneck_encode": dict(
            kernel=lambda: kb.bottleneck_encode(x, w, mn, mx),
            plain=lambda: kb.bottleneck_encode_plain(x, w, mn, mx),
            library=lambda: torch.clamp(torch.round((x @ w - mn) * scale), 0,
                                        levels).to(torch.uint8),
            bound=bound(4 * t * d + 4 * d * dp + t * dp, 2 * t * d * dp + 5 * t * dp)),
    }
    out = {}
    for name, r in rows.items():
        ms = device_ms(r["kernel"])
        plain_ms = device_ms(r["plain"])
        library_ms = device_ms(r["library"])
        bound_ms, bound_by = r["bound"]
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"timing: {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"library {library_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of bound", flush=True)
    return out


def phase_small_split(dev, cs, cfg, init_params, pca):
    """The split forward at a small f32 config: card against CPU."""
    cfg = cfg.replace(n_heads=4, n_kv_heads=2, d_head=64)
    cpu = torch.device("cpu")
    model_cpu = init_params(cfg, torch.Generator().manual_seed(3), cpu)
    model_dev = init_params(cfg, torch.Generator().manual_seed(3), cpu).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        feats = cs.boundary_hidden(model_cpu, tokens, 2).reshape(-1, cfg.d_model)
        ae = pca(feats, cfg.d_model // 4)
        ae_dev = {k: v.to(dev) for k, v in ae.items()}
        want, want_bits = cs.run_split_forward(model_cpu, cfg, tokens, 2, ae)
        got, got_bits = cs.run_split_forward(model_dev, cfg, tokens.to(dev), 2, ae_dev)
        b_cpu = cs.ue_side(model_cpu, tokens, 2, ae)
        b_dev = cs.ue_side(model_dev, tokens.to(dev), 2, ae_dev)
    diff = code_diff(b_dev.codes.cpu(), b_cpu.codes)
    err = float((got.cpu() - want).abs().max())
    check(got_bits == want_bits, f"small split forward: payload {got_bits} != {want_bits}")
    check(diff <= 1, f"small split forward: codes differ by {diff}")
    # f32 through 4 blocks on two devices, plus at most one code at the boundary
    check(err <= 2e-3, f"small split forward: logits differ by {err}")
    print(f"small split forward: card vs CPU payload equal ({got_bits} bits), codes "
          f"max {diff}, logits max abs diff {err:.3e}", flush=True)


def phase_serve(dev, cs, cfg, build_mod, kref):
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = cs.serve(cfg, device=dev, log=lambda s: print(f"serve: {s}", flush=True), **SERVE)
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    wall = time.perf_counter() - t0
    n = SERVE["requests"]
    for name in ("bottleneck_encode", "dequantize"):
        check(launches.get(name, 0) == n,
              f"serve: {name} launched {launches.get(name, 0)} times for {n} requests")
    d_prime = cfg.d_model // cfg.bottleneck_ratio
    for st in res.stats:
        check(st["logits_finite"], f"serve: request {st['request']} has non-finite logits")
        check(st["logits_shape"] == (SERVE["batch"], SERVE["seq"], cfg.vocab_size),
              f"serve: logits shape {st['logits_shape']}")
        check(st["payload_kbit"] * 1e3 == SERVE["batch"] * SERVE["seq"] * d_prime * 8,
              f"serve: payload {st['payload_kbit']} kbit")
    with torch.inference_mode():
        tokens = res.requests[0]
        x = cs.boundary_hidden(res.model, tokens, res.split)
        b = cs.ue_side(res.model, tokens, res.split, res.ae, res.bits)
        oracle = kref.bottleneck_encode_ref(x.reshape(-1, cfg.d_model), res.ae["enc"],
                                            b.mn, b.mx, res.bits)
    diff = code_diff(b.codes.reshape(-1, d_prime), oracle)
    share = float((b.codes.reshape(-1, d_prime) != oracle).float().mean())
    check(diff <= 1, f"serve: boundary codes differ from the oracle by {diff}")
    print(f"serve: {n} requests in {wall:.1f} s (build and calibration included), "
          f"launches {launches}, boundary codes vs oracle max {diff} "
          f"({100 * share:.4f}% differ), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, res


def phase_profile(cs, res):
    """Device time of one request's split forward, by kernel (informative:
    no check rests on it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = (res.model, res.model.cfg, res.requests[0], res.split, res.ae, res.bits)
    cs.run_split_forward(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs.run_split_forward(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = lambda e: getattr(e, "self_device_time_total", 0.0)
    total = sum(us(e) for e in kernels)
    wall = statistics.median(st["split_forward_ms"] for st in res.stats)
    if total <= 0:
        print("profile: the profiler saw no device time", flush=True)
        return
    print(f"profile: one split forward: {total / 1e3:.2f} ms of device time in "
          f"{sum(e.count for e in kernels)} kernel launches; median wall time "
          f"{wall:.2f} ms, so the card idles {100 * (1 - total / 1e3 / wall):.0f}% "
          f"of a request", flush=True)
    for e in sorted(kernels, key=us, reverse=True)[:8]:
        print(f"profile:   {us(e) / 1e3:8.3f} ms {100 * us(e) / total:5.1f}% "
              f"x{e.count:<4d} {e.key[:90]}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    from repro_torch import full_precision_matmuls
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.compressor import pca_init_autoencoder
    from repro_torch.kernels import _build, bottleneck, quant
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import collab_serve
    from repro_torch.models import init_params

    full_precision_matmuls()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    err = phase_kernels(dev, quant, bottleneck, kref)
    times = phase_timing(dev, quant, bottleneck)
    phase_small_split(dev, collab_serve, reduced(get_config("qwen3-1.7b"), n_layers=4),
                      init_params, pca_init_autoencoder)
    launches, res = phase_serve(dev, collab_serve, get_config("qwen3-1.7b"), _build, kref)
    phase_profile(collab_serve, res)

    kernels = []
    for name, (source, replaces) in ROUTES.items():
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches.get(name, 0), max_abs_err=err[name],
                            **times[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
