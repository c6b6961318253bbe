"""Training launcher of the port (``src/repro/launch/train.py``): ``--arch``
selects an assigned architecture (the reference's ten ``ARCH_IDS``), whose
config names its optimizer (AdamW, or Adafactor for llama-3.2-vision-90b
and kimi-k2-1t-a32b); ``--reduce`` takes the reduced config (4 layers,
d_model 256) that a CPU or a single card runs for every arch.

  python -m repro_torch.launch.train --arch qwen3-1.7b --reduce --steps 100 --batch 8 --seq 128
  python -m repro_torch.launch.train --arch llama-3.2-vision-90b --reduce --steps 3
  python -m repro_torch.launch.train --arch seamless-m4t-large-v2 --reduce --device cpu --steps 2

Each step is ``launch.steps.make_train_step`` (the reference's warmup,
``min(20, steps // 5)``, and cosine to ``--steps``) on the synthetic
token stream, with the reference's zero ``aux_embeds`` (batch,
n_aux_tokens, d_model) for an encoder-decoder or VLM arch. The first step
and every 10th append ``{step, loss, grad_norm, elapsed_s}`` (host clock
since the first step) to ``<out>/<arch>.jsonl``; ``--ckpt-every N`` saves
``<out>/<arch>_<step>`` every N steps and the end saves
``<out>/<arch>_final`` (``ckpt.save_checkpoint``, the reference's params
tree). Runs on the CUDA card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.synthetic import TokenPipelineConfig, token_batch_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import init_params
from repro_torch.weights import to_reference_tree


def train(arch, *, reduce=False, steps=100, batch=8, seq=128, lr=1e-3, ckpt_every=0,
          out="artifacts/train", device=None, seed=0, log=print):
    """Train ``arch`` for ``steps`` steps; returns (model, the JSONL records
    as dicts, every step's loss as a tensor on the device)."""
    device = resolve_device(device)
    full_precision_matmuls()
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg, n_layers=4, d_model=256)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    n = sum(p.numel() for p in model.parameters())
    log(f"[train] arch={arch} params={n / 1e6:.1f}M optimizer={cfg.optimizer} on {device}")
    train_step, opt_init = make_train_step(cfg, base_lr=lr, warmup=min(20, steps // 5),
                                           total=steps)
    opt = opt_init(model)
    stream = token_batch_stream(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                    batch=batch), seed=seed, device=device)
    aux = (torch.zeros((batch, cfg.n_aux_tokens, cfg.d_model), device=device)
           if cfg.n_aux_tokens else None)
    os.makedirs(out, exist_ok=True)
    records, losses = [], []
    with open(os.path.join(out, f"{arch}.jsonl"), "w") as logf:
        t0 = time.perf_counter()
        for step in range(1, steps + 1):
            batch_ = next(stream)
            if aux is not None:
                batch_ = dict(batch_, aux_embeds=aux)
            model, opt, m = train_step(model, opt, batch_)
            losses.append(m["loss"])
            if step % 10 == 0 or step == 1:
                rec = {"step": step, "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "elapsed_s": round(time.perf_counter() - t0, 1)}
                log(f"[train] {rec}")
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
                records.append(rec)
            if ckpt_every and step % ckpt_every == 0:
                save_checkpoint(os.path.join(out, f"{arch}_{step}"), to_reference_tree(model),
                                step=step)
    save_checkpoint(os.path.join(out, f"{arch}_final"), to_reference_tree(model), step=steps)
    log(f"[train] done; checkpoints and logs in {out}/")
    return model, records, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--reduce", action="store_true",
                    help="the reduced config (4 layers, d_model 256)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--out", default="artifacts/train")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises when there is none)")
    args = ap.parse_args(argv)
    return train(args.arch, reduce=args.reduce, steps=args.steps, batch=args.batch,
                 seq=args.seq, lr=args.lr, ckpt_every=args.ckpt_every, out=args.out,
                 device=args.device)


if __name__ == "__main__":
    main()
