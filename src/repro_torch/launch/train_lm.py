"""End-to-end LM training, the twin of ``examples/train_lm.py``: a ~100M-
parameter dense LM (the qwen3 family cut to 12 layers of d_model 768, vocab
8192, float32) trained on the synthetic Markov corpus, with CSV metrics
and a final checkpoint.

  python -m repro_torch.launch.train_lm --steps 300
  python -m repro_torch.launch.train_lm --device cpu --layers 2 --d-model 64 --steps 5

Every 10th step (and the first) it prints and appends to
``<out>/metrics.csv`` the reference's columns ``step, loss, ce, grad_norm,
lr, ms_per_step`` (ms a step averaged since the last row, on the host clock
around synchronized steps); at the end it saves the parameters, in the
reference's tree (``weights.to_reference_tree``), to ``<out>/final.npz`` and
``<out>/final.json`` (``ckpt.save_checkpoint``). Runs on the CUDA card;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import full_precision_matmuls, resolve_device
from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenPipelineConfig, token_batch_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import init_params
from repro_torch.weights import to_reference_tree


def lm_config(layers=12, d_model=768, vocab=8192):
    """The example's model: qwen3-1.7b's family at 12 heads of 64 (4 KV
    heads), d_ff 4 d_model, float32, attention chunks of 128."""
    return get_config("qwen3-1.7b").replace(
        n_layers=layers, d_model=d_model, n_heads=12, n_kv_heads=4, d_head=64,
        d_ff=4 * d_model, vocab_size=vocab, param_dtype="float32", compute_dtype="float32",
        remat=False, attn_chunk=128)


def train(*, steps=300, layers=12, d_model=768, vocab=8192, seq=256, batch=8, lr=1e-3,
          out="artifacts/train_lm", device=None, seed=0, log=print):
    """Train and checkpoint; returns (model, the CSV rows as dicts)."""
    device = resolve_device(device)
    full_precision_matmuls()
    cfg = lm_config(layers, d_model, vocab)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {layers}L d={d_model} -> {n_params / 1e6:.1f}M params on {device}")
    train_step, opt_init = make_train_step(cfg, base_lr=lr, warmup=20, total=steps)
    opt = opt_init(model)
    stream = token_batch_stream(TokenPipelineConfig(vocab_size=vocab, seq_len=seq, batch=batch),
                                seed=seed, device=device)
    os.makedirs(out, exist_ok=True)
    rows = []
    with open(os.path.join(out, "metrics.csv"), "w") as csv:
        csv.write("step,loss,ce,grad_norm,lr,ms_per_step\n")
        t_last = time.perf_counter()
        for step in range(1, steps + 1):
            model, opt, m = train_step(model, opt, next(stream))
            if step % 10 == 0 or step == 1:
                row = {k: float(m[k]) for k in ("loss", "ce", "grad_norm", "lr")}
                now = time.perf_counter()
                row["ms_per_step"] = (now - t_last) / (10 if step > 1 else 1) * 1e3
                row["step"] = step
                t_last = now
                log(f"step {step:4d} loss={row['loss']:.4f} ce={row['ce']:.4f} "
                    f"gnorm={row['grad_norm']:.2f} {row['ms_per_step']:.0f}ms/step")
                csv.write(f"{step},{row['loss']:.5f},{row['ce']:.5f},{row['grad_norm']:.4f},"
                          f"{row['lr']:.2e},{row['ms_per_step']:.1f}\n")
                csv.flush()
                rows.append(row)
    save_checkpoint(os.path.join(out, "final"), to_reference_tree(model), step=steps,
                    extra={"config": cfg.name})
    log(f"saved checkpoint to {out}/final.npz")
    return model, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="artifacts/train_lm")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises when there is none)")
    args = ap.parse_args(argv)
    return train(steps=args.steps, layers=args.layers, d_model=args.d_model, vocab=args.vocab,
                 seq=args.seq, batch=args.batch, lr=args.lr, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
