"""Serving launcher of the port (``src/repro/launch/serve.py``): a batched
prefill builds the KV cache (or the Mamba-2 or RG-LRU state), then a
greedy decode loop appends one token per step, for each request, reporting
per-phase times and cache sizes. It is the edge half of the paper's
collaborative-inference pipeline.

  python -m repro_torch.launch.serve        # qwen3-1.7b, 28 layers, 4 x 2048 + 32
  python -m repro_torch.launch.serve --arch mamba2-1.3b --batch 2 --prompt-len 1024
  python -m repro_torch.launch.serve --arch recurrentgemma-9b --requests 1
  python -m repro_torch.launch.serve --arch qwen2-7b-kv8 --requests 1   # int8 KV cache
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --requests 1
  python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b --layers 1 --requests 1
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --requests 1
  python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --layers 30 --requests 1
  python -m repro_torch.launch.serve --device cpu --reduce --prompt-len 64

``--arch`` takes every arch of the registry (the reference's ten
``ARCH_IDS``) and the qwen2-7b-kv8 variant; ``--layers`` cuts the depth
(kimi-k2-1t-a32b's bf16 weights take ~34 GB a layer, so one card holds
one layer; llama-3.2-vision-90b's 1.7 GB a layer, so it holds 30). An
encoder-decoder or VLM arch is fed the reference's zero ``aux_embeds``
(B, n_aux_tokens, d_model), the stubbed frontend's output.

``serve(cfg, mesh=...)`` answers the requests on every rank of a process
mesh (``launch.mesh.ProcessMesh``), the steps running unchanged under
``meshctx.use_mesh``: each rank holds its shard of the batch (its own
requests' rows), its blocks of the parameters under the reference's
sharding rules (heads, d_ff, the SSM's heads, the RG-LRU's width and
vocab over "model", with ``fsdp`` the other dim over "data") and of the
cache (a KV cache's and a context cache's length over "model", the
recurrent states' heads or width), and runs each block type's
tensor-parallel program, the MoE layers on the expert-parallel paths;
``aux_embeds`` are cut by the batch rule, as the tokens are. The reference has no serving
flag for this, and neither has the CLI.

Runs on the CUDA card at the arch's full width by default; ``--device cpu``
runs the plain PyTorch twins of the kernels instead, and ``--reduce``
shrinks the config as the reference's launcher does (4 layers, d_model
256). Times are on the host clock around work that ends in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass, field

import torch

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.configs import ALL_ARCHS, get_config, reduced
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import init_params, meshctx
from repro_torch.models.moe import routing_log


@dataclass
class ServeResult:
    model: torch.nn.Module
    attn_len: int
    build_s: float                              # seconds to build the seeded weights
    stats: list = field(default_factory=list)   # one dict per request
    cache: list = None                          # the last request's final cache


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cache_bytes(cache):
    return sum(t.numel() * t.element_size() for entry in cache for t in entry.values())


@torch.inference_mode()
def serve(cfg, *, device=None, batch=4, prompt_len=2048, gen=32, requests=2, seed=0,
          aux_embeds=None, log=print, mesh=None) -> ServeResult:
    """Build ``cfg`` with seeded random weights and answer ``requests``
    requests of (batch, prompt_len) random prompt tokens, each with a
    prefill and ``gen - 1`` greedy decode steps (the prefill's argmax is
    generated token 0), into caches of ``prompt_len + gen`` slots. Each
    request's stats: prefill ms, cache bytes, decode ms per token, decode
    tokens per second (batch x steps over the decode time), the generated
    tokens (batch, gen) and, for an MoE arch, the share of expert
    assignments its capacity dropped at prefill and at decode (None
    without MoE layers), and the logits of the prefill's last position and
    of the last step. An arch with ``n_aux_tokens`` (encoder-decoder,
    VLM) is prefilled with ``aux_embeds``, by default the reference's zeros
    (B, n_aux_tokens, d_model).

    Under ``mesh`` (a ``ProcessMesh``, on every rank) the model is built
    and run inside ``meshctx.use_mesh(mesh)``: every rank draws the whole
    batch's prompts and keeps the rows of its data index, ``batch / dp``
    of them, and the stats hold its rows (the logits whole over the
    vocab); ``cache_bytes`` are the rank's."""
    device = resolve_device(device)
    full_precision_matmuls()
    rows = slice(None)
    if mesh is not None:
        dp = meshctx.dp_size(mesh)
        if batch % dp:
            raise ValueError(f"a batch of {batch} does not split over {dp} data ranks")
        i, b = mesh.index(meshctx.dp_axes(mesh)), batch // dp
        rows = slice(i * b, (i + 1) * b)
    with meshctx.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        return _serve(cfg, device, batch, prompt_len, gen, requests, seed, aux_embeds, log,
                      rows)


def _serve(cfg, device, batch, prompt_len, gen, requests, seed, aux_embeds, log, rows):
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    _sync(device)
    build_s = time.perf_counter() - t0
    host = torch.Generator().manual_seed(seed + 1)
    attn_len = prompt_len + gen
    prefill_step = make_prefill_step(cfg, attn_len)
    serve_step = make_serve_step(cfg)
    out = ServeResult(model, attn_len, build_s)
    n_steps = max(gen - 1, 0)
    if cfg.n_aux_tokens and aux_embeds is None:
        aux_embeds = torch.zeros((batch, cfg.n_aux_tokens, cfg.d_model), device=device)
    if aux_embeds is not None:
        aux_embeds = aux_embeds[rows]
    for r in range(requests):
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                               generator=host)[rows].to(device)
        _sync(device)
        t0 = time.perf_counter()
        with routing_log() as pre:
            logits, cache = prefill_step(model, tokens, aux_embeds)
        _sync(device)
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = cache_bytes(cache)
        prefill_logits = logits
        tok = logits.argmax(-1)[:, None]
        outs = [tok]
        t0 = time.perf_counter()
        with routing_log() as dec:
            for i in range(n_steps):
                logits, cache = serve_step(model, cache, tok, prompt_len + i)
                tok = logits.argmax(-1)[:, None]
                outs.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
        st = {"request": r, "prefill_ms": prefill_ms, "cache_bytes": nbytes,
              "decode_ms_per_token": 1e3 * decode_s / max(n_steps, 1),
              "tokens_per_s": batch * n_steps / decode_s if n_steps else 0.0,
              "tokens": torch.cat(outs, dim=1), "logits_finite": bool(torch.isfinite(logits).all()),
              "moe_dropped_prefill": pre.dropped_share(),
              "moe_dropped_decode": dec.dropped_share(),
              "prefill_logits": prefill_logits, "last_logits": logits}
        out.stats.append(st)
        out.cache = cache
        drops = ("" if st["moe_dropped_prefill"] is None else
                 f"; MoE assignments dropped {100 * st['moe_dropped_prefill']:.2f}% at prefill, "
                 f"{100 * (st['moe_dropped_decode'] or 0.0):.2f}% at decode")
        log(f"request {r}: prefill {batch}x{prompt_len} {prefill_ms:.1f} ms, cache "
            f"{nbytes / 1e6:.1f} MB; {n_steps} decode steps {st['decode_ms_per_token']:.2f} "
            f"ms/token, {st['tokens_per_s']:.0f} tokens/s (batch {batch}){drops}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ALL_ARCHS)
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction, default=False,
                    help="shrink the config (4 layers, d_model 256) for a CPU rehearsal")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers (default: its full depth)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises when there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, n_layers=4, d_model=256)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    res = serve(cfg, device=device, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, requests=args.requests, seed=args.seed)
    print(f"sample continuation (seq 0): {res.stats[-1]['tokens'][0][:16].tolist()}")
    return res


if __name__ == "__main__":
    main()
