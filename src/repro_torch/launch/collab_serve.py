"""Collaborative split serving of a transformer or a Mamba-2 SSM, ported
from the single-UE split forward of ``examples/collaborative_serve.py``.

The UE runs the embedding and layers ``0..split``, then compresses the
boundary hidden state with the fused ``bottleneck_encode`` kernel (the AE
encoder matmul with the Eq. 1 quantize as its epilogue). The codes cross a
simulated uplink (``env/channel.py``). The edge dequantizes them with the
``dequantize`` kernel (Eq. 2), decodes with the AE decoder and finishes
layers ``split..n_layers``, the final norm and the tied head.

The quirks of the reference are kept as they are: the quantization range is
taken from the UE-side hidden state x, not from z = x W_enc (so codes
clip); x and W_enc go to the bottleneck in f32; x_hat is cast back to x's
dtype.

The example first pre-trains its backbone (the AE exploits the anisotropy
of trained features): ``--pretrain N`` trains the model N steps on the
synthetic Markov corpus (``make_train_step`` at base rate 3e-3, 20 steps of
warmup, batches of 16), and the requests are then drawn from the same
stream. ``--reduced`` is the example's own configuration: the arch cut to 4
layers (``reduced``, a uniform ``("dense",)`` pattern where the arch's is
not uniform) at ``--seq 32 --batch 4``.

  python -m repro_torch.launch.collab_serve            # qwen3-1.7b, 28 layers
  python -m repro_torch.launch.collab_serve --requests 8 --seq 512
  python -m repro_torch.launch.collab_serve --arch mamba2-1.3b --batch 2 --seq 1024
  python -m repro_torch.launch.collab_serve --arch qwen2-7b --requests 1
  python -m repro_torch.launch.collab_serve --arch qwen3-moe-30b-a3b --requests 1
  python -m repro_torch.launch.collab_serve --reduced --pretrain 150   # the example

The split forward takes the uniform-pattern archs (qwen3-1.7b,
stablelm-1.6b, phi4-mini-3.8b, qwen2-7b, mamba2-1.3b, qwen3-moe-30b-a3b;
kimi-k2-1t-a32b too, on a card that holds it); recurrentgemma-9b's
(rec, rec, lattn) pattern is refused, as the reference example asserts,
and serves through ``launch/serve.py``. Runs on the CUDA card;
``--device cpu`` runs the plain PyTorch twins of the kernels instead.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import torch

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core.compressor import pca_init_autoencoder
from repro_torch.data.synthetic import TokenPipelineConfig, token_batch_stream
from repro_torch.env.channel import channel_gain, uplink_rates
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import default_positions, init_params, layer_plan
from repro_torch.models.moe import routing_log


@dataclass
class Boundary:
    """What the UE sends: the codes and the range to dequantize them."""
    codes: torch.Tensor
    mn: float
    mx: float
    dtype: torch.dtype      # the hidden state's dtype, restored at the edge


def boundary_hidden(model, tokens, split_layer):
    """UE-side hidden state after layers 0..split_layer (embedding by
    lookup, with no cast, as the reference's split forward)."""
    positions = default_positions(*tokens.shape, tokens.device)
    return model.run_layers(model.embed_tokens(tokens), 0, split_layer, positions)


def ue_side(model, tokens, split_layer, ae, bits=8) -> Boundary:
    x = boundary_hidden(model, tokens, split_layer)
    mn, mx = float(x.min()), float(x.max())
    codes = ops.bottleneck_encode(x.to(torch.float32), ae["enc"].to(torch.float32),
                                  mn, mx, bits=bits)
    return Boundary(codes, mn, mx, x.dtype)


def edge_side(model, boundary: Boundary, split_layer, ae, bits=8):
    z = ops.dequantize(boundary.codes, boundary.mn, boundary.mx, bits=bits)
    x_hat = (z @ ae["dec"]).to(boundary.dtype)
    b, s, _ = boundary.codes.shape
    positions = default_positions(b, s, boundary.codes.device)
    x = model.run_layers(x_hat, split_layer, model.cfg.n_layers, positions)
    return model.logits(model.ln_f(x))


def check_split(cfg):
    """The split forward takes uniform-pattern decoder-only archs: the
    cross-attention layers of an encoder-decoder or VLM arch attend to
    ``aux_embeds``, which it does not carry."""
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(f"the split forward takes decoder-only archs; {cfg.name}'s "
                         f"cross-attention layers attend to aux_embeds")
    if len(layer_plan(cfg)[0]) != 1:
        raise ValueError("the split forward takes uniform-pattern archs")


@torch.inference_mode()
def run_split_forward(model, cfg, tokens, split_layer, ae, bits=8):
    """UE part -> compress -> (channel) -> decompress -> edge part.
    Returns (logits, payload_bits)."""
    check_split(cfg)
    boundary = ue_side(model, tokens, split_layer, ae, bits)
    payload_bits = boundary.codes.numel() * bits
    return edge_side(model, boundary, split_layer, ae, bits), payload_bits


@dataclass
class ServeResult:
    model: torch.nn.Module
    ae: dict
    split: int
    bits: int
    requests: list = field(default_factory=list)   # token batches served
    stats: list = field(default_factory=list)      # one dict per request
    train_losses: list = field(default_factory=list)   # one a pre-training step


def example_config(cfg):
    """The example's reduced configuration of an arch: 4 layers, and a
    uniform ``("dense",)`` block pattern where the arch's is not uniform."""
    cfg = reduced(cfg, n_layers=4)
    return cfg if len(cfg.block_pattern) == 1 else cfg.replace(block_pattern=("dense",))


def pretrain(model, cfg, stream, steps, lr):
    """``steps`` training steps of ``make_train_step(cfg, base_lr=lr,
    warmup=20, total=steps)`` on ``stream``'s batches, as the example
    pre-trains its backbone. Returns the losses, one a step (tensors)."""
    train_step, opt_init = make_train_step(cfg, base_lr=lr, warmup=20, total=steps)
    opt, losses = opt_init(model), []
    for _ in range(steps):
        model, opt, m = train_step(model, opt, next(stream))
        losses.append(m["loss"])
    return losses


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, device=None, requests=4, batch=4, seq=256, seed=0, pretrain_steps=0,
          pretrain_batch=16, pretrain_lr=3e-3, log=print) -> ServeResult:
    """Build ``cfg`` with seeded random weights, pre-train it for
    ``pretrain_steps`` steps on the synthetic Markov corpus (batches of
    ``pretrain_batch`` sequences of ``seq`` tokens, base rate
    ``pretrain_lr``), split it after half its layers, calibrate a PCA AE (d
    -> d / bottleneck_ratio) on 8 random sequences at the split, and answer
    ``requests`` requests of (batch, seq) tokens through the split forward
    with ``quant_bits``-bit codes: random tokens without pre-training, else
    the first ``batch`` sequences of the corpus's next batches. Each
    request's stats carry, for an MoE arch, the share of the split
    forward's expert assignments that capacity dropped (None without MoE
    layers)."""
    check_split(cfg)
    device = resolve_device(device)
    full_precision_matmuls()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    losses = []
    if pretrain_steps:
        stream = token_batch_stream(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, batch=pretrain_batch), seed=seed,
            device=device)
        losses = pretrain(model, cfg, stream, pretrain_steps, pretrain_lr)
        _sync(device)
        log(f"pre-trained {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) for {pretrain_steps} steps in "
            f"{time.perf_counter() - t0:.1f} s: final train loss {float(losses[-1]):.3f}")
    with torch.inference_mode():
        out = _serve(model, cfg, device, requests, batch, seq, seed,
                     (lambda: next(stream)["tokens"][:batch]) if pretrain_steps else None,
                     log, t0)
    out.train_losses = losses
    return out


def _serve(model, cfg, device, requests, batch, seq, seed, corpus, log, t0) -> ServeResult:
    split, ratio, bits = cfg.n_layers // 2, cfg.bottleneck_ratio, cfg.quant_bits
    d = cfg.d_model
    host = torch.Generator().manual_seed(seed + 9)
    draw = lambda b: torch.randint(0, cfg.vocab_size, (b, seq), generator=host).to(device)

    # Closed-form optimal linear AE: PCA of the boundary features of a
    # calibration batch, as the reference example does.
    feats = boundary_hidden(model, draw(8), split).reshape(-1, d).to(torch.float32)
    ae = pca_init_autoencoder(feats, d // ratio)
    _sync(device)
    log(f"built {cfg.name} ({cfg.n_layers}L d={d}, {cfg.param_dtype}) and "
        f"calibrated the AE ({d}->{d // ratio}) in {time.perf_counter() - t0:.1f} s")

    # Simulated channel: one UE at 50 m sending at 0.3 W.
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    rate = float(uplink_rates(f32([0.3]), torch.tensor([0]),
                              channel_gain(f32([50.0])), torch.tensor([True]),
                              omega=f32([1e6]), sigma=f32([1e-9]))[0])

    out = ServeResult(model, ae, split, bits)
    for i in range(requests):
        tokens = draw(batch) if corpus is None else corpus()
        ref_top1 = model(tokens).argmax(-1)
        _sync(device)
        t1 = time.perf_counter()
        with routing_log() as moe_log:
            logits, payload_bits = run_split_forward(model, cfg, tokens, split, ae, bits)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t1)
        st = {
            "request": i, "tokens": tokens.numel(), "payload_kbit": payload_bits / 1e3,
            "rate_R": tokens.numel() * d * 32 / payload_bits,
            "uplink_mbps": rate / 1e6, "tx_ms": 1e3 * payload_bits / rate,
            "top1_agree": float((logits.argmax(-1) == ref_top1).float().mean()),
            "split_forward_ms": ms, "logits_finite": bool(torch.isfinite(logits).all()),
            "logits_shape": tuple(logits.shape), "moe_dropped": moe_log.dropped_share(),
        }
        out.requests.append(tokens)
        out.stats.append(st)
        log(f"request {i}: payload {st['payload_kbit']:.1f} kbit, R={st['rate_R']:.0f}x, "
            f"uplink {st['uplink_mbps']:.2f} Mb/s -> tx {st['tx_ms']:.1f} ms, "
            f"top-1 agreement {100 * st['top1_agree']:.1f}%, "
            f"split forward {ms:.1f} ms"
            + ("" if st["moe_dropped"] is None else
               f", MoE assignments dropped {100 * st['moe_dropped']:.2f}%"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="the example's config: 4 layers, d_model 256 (default --seq 32 "
                         "--batch 4)")
    ap.add_argument("--pretrain", type=int, default=0, metavar="N",
                    help="pre-train the backbone N steps first (the example: 150)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=None, help="default 4")
    ap.add_argument("--seq", type=int, default=None, help="default 256, 32 with --reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises when there is none)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = example_config(cfg)
    res = serve(cfg, device=device, requests=args.requests,
                batch=4 if args.batch is None else args.batch,
                seq=(32 if args.reduced else 256) if args.seq is None else args.seq,
                seed=args.seed, pretrain_steps=args.pretrain)
    if args.pretrain:
        st = res.stats
        print(f"final train loss {float(res.train_losses[-1]):.3f}; payload "
              f"{st[0]['payload_kbit']:.1f} kbit, R={st[0]['rate_R']:.0f}x; top-1 agreement with "
              f"the uncompressed forward {100 * sum(x['top1_agree'] for x in st) / len(st):.1f}% "
              f"over {len(st)} requests (PCA linear AE, ratio {cfg.bottleneck_ratio}x + "
              f"{cfg.quant_bits}-bit codes)")
    else:
        print("random weights: top-1 agreement is informative only")
    return res


if __name__ == "__main__":
    main()
