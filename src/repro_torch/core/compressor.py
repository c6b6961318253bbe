"""Autoencoder-based intermediate feature compression (paper §2), the
port of ``src/repro/core/compressor.py``.

The encoder and decoder are single 1x1 convolutions over the channel dim:
an einsum over C for CNN features (B, C, H, W) and a d -> d' matmul for
transformer hidden states (B, S, d). Quantization is linear min-max to
``bits`` bits (Eq. 1-2); the overall rate is R = (ch * 32) / (ch' * bits)
(Eq. 3). These functions are plain tensor code, as the reference's are;
the fused, kernel-backed encode of the serving path is
``repro_torch.kernels.ops.bottleneck_encode``.

Training (paper §2.4) splits a CNN backbone after a module: stage 1 trains
the AE alone against the frozen backbone on Eq. 4, L2(feature,
reconstruction) + xi * CE(prediction); stage 2 fine-tunes AE and backbone
together at a small rate. AdamW is ``repro_torch.optim``'s, over the
flattened leaves (float32 moments, as the reference keeps them). The
rate-distortion sweep keeps, at each split point, the highest rate whose
accuracy stays within ``acc_drop`` of the baseline (the paper's Fig. 4
rule).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import cnn as cnn_lib
from repro_torch.kernels.ref import code_dtype
from repro_torch.optim import adamw_init, adamw_update


def quantize(x, bits, minv=None, maxv=None):
    """Eq. 1. Returns (codes, minv, maxv); codes are integers in
    [0, 2^bits - 1] in the smallest sufficient unsigned dtype."""
    minv = x.min() if minv is None else minv
    maxv = x.max() if maxv is None else maxv
    levels = (1 << bits) - 1
    scale = levels / torch.clamp(torch.as_tensor(maxv - minv), min=1e-12)
    y = torch.clamp(torch.round((x - minv) * scale), 0, levels)
    return y.to(code_dtype(bits)), minv, maxv


def dequantize(y, bits, minv, maxv):
    """Eq. 2."""
    levels = (1 << bits) - 1
    return y.to(torch.float32) * (maxv - minv) / levels + minv


def compression_rate(ch, ch_prime, bits):
    """Eq. 3: R = R_c * R_q."""
    return (ch * 32.0) / (ch_prime * bits)


def init_autoencoder(generator, ch, ch_prime, *, device=None):
    """Random AE: enc (ch, ch') ~ N(0, 1/ch), dec (ch', ch) ~ N(0, 1/ch')."""
    enc = torch.randn((ch, ch_prime), generator=generator, device=device)
    dec = torch.randn((ch_prime, ch), generator=generator, device=device)
    return {"enc": enc / math.sqrt(ch), "dec": dec / math.sqrt(ch_prime)}


def pca_init_autoencoder(feats, ch_prime):
    """Closed-form optimal linear AE: the top principal components of the
    boundary features. feats: (B, C, H, W) (samples over B*H*W) or (..., C)
    channel-last (samples over all leading axes). The sign of each
    component is whatever the SVD returns."""
    if feats.dim() == 4:
        f = torch.movedim(feats, 1, -1).reshape(-1, feats.shape[1])
    else:
        f = feats.reshape(-1, feats.shape[-1])
    mu = f.mean(0)
    _, _, vt = torch.linalg.svd(f - mu, full_matrices=False)
    pcs = vt[:ch_prime].T.contiguous()
    return {"enc": pcs, "dec": pcs.T.contiguous()}


def encode(ae, feat):
    """feat: (B, C, H, W) or (B, S, C) -> bottleneck along the channel dim."""
    if feat.dim() == 4:
        return torch.einsum("bchw,cd->bdhw", feat, ae["enc"])
    return feat @ ae["enc"]


def decode(ae, z):
    if z.dim() == 4:
        return torch.einsum("bdhw,dc->bchw", z, ae["dec"])
    return z @ ae["dec"]


def roundtrip(ae, feat, bits=None):
    """encode -> (optional quantize/dequantize) -> decode."""
    z = encode(ae, feat)
    if bits is not None:
        q, mn, mx = quantize(z, bits)
        z = dequantize(q, bits, mn, mx).to(feat.dtype)
    return decode(ae, z)


# ------------------------------------------------- two-stage training (CNN)
def ae_loss(ae, backbone_params, model, split_module, x, labels, xi=0.1, bits=None):
    """Paper Eq. 4 for a CNN backbone split after module ``split_module``:
    (L2 + xi * CE, (L2, CE)), L2 = sqrt(sum (feat - feat_hat)^2 + 1e-12) / B."""
    feat = cnn_lib.forward(model, backbone_params, x, upto=split_module + 1)
    feat_hat = roundtrip(ae, feat, bits)
    logits = cnn_lib.forward_from(model, backbone_params, feat_hat, split_module + 1)
    l2 = torch.sqrt(torch.sum(torch.square(feat - feat_hat)) + 1e-12) / x.shape[0]
    tgt = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    ce = torch.mean(torch.logsumexp(logits, dim=-1) - tgt)
    return l2 + xi * ce, (l2, ce)


def train_autoencoder(generator, model, backbone_params, split_module, data_iter, *, ch,
                      ch_prime, steps=100, lr=1e-3, xi=0.1, finetune_steps=0, ft_lr=1e-4,
                      pca_init=True):
    """Stage 1: the AE alone, the backbone frozen (AdamW at ``lr``, no
    weight decay). Stage 2 (``finetune_steps`` > 0): AE and backbone
    together at ``ft_lr``. ``data_iter`` yields (x, labels) on the
    backbone's device; the AE starts from the PCA of the first batch's
    boundary features, or (``pca_init=False``) from a random init drawn
    from ``generator``. Returns (ae, backbone_params, logs): the
    backbone's tree is a new one after stage 2 and the caller's
    otherwise; one log a step, {"stage", "loss", "l2", "ce"} in stage 1
    and {"stage", "loss"} in stage 2, as the reference's."""
    if pca_init:
        x0, _ = next(data_iter)
        with torch.no_grad():
            feats = cnn_lib.forward(model, backbone_params, x0, upto=split_module + 1)
        ae = pca_init_autoencoder(feats, ch_prime)
    else:
        dev = cnn_lib.param_leaves(backbone_params)[0].device
        ae = {k: v.to(dev) for k, v in
              init_autoencoder(generator, ch, ch_prime, device=generator.device).items()}
    ae = cnn_lib.trainable_copy(ae)
    leaves = cnn_lib.param_leaves(ae)
    opt = adamw_init(leaves)
    logs = []
    for _ in range(steps):
        x, y = next(data_iter)
        loss, (l2, ce) = ae_loss(ae, backbone_params, model, split_module, x, y, xi)
        grads = torch.autograd.grad(loss, leaves)
        opt = adamw_update(grads, opt, leaves, lr, weight_decay=0.0)[1]
        loss, l2, ce = torch.stack([loss, l2, ce]).detach().tolist()
        logs.append({"stage": 1, "loss": loss, "l2": l2, "ce": ce})

    if finetune_steps:
        backbone_params = cnn_lib.trainable_copy(backbone_params)
        leaves = leaves + cnn_lib.param_leaves(backbone_params)
        opt = adamw_init(leaves)
        for _ in range(finetune_steps):
            x, y = next(data_iter)
            loss, _ = ae_loss(ae, backbone_params, model, split_module, x, y, xi)
            grads = torch.autograd.grad(loss, leaves)
            opt = adamw_update(grads, opt, leaves, ft_lr, weight_decay=0.0)[1]
            logs.append({"stage": 2, "loss": float(loss.detach())})
        for t in cnn_lib.param_leaves(backbone_params):
            t.requires_grad_(False)
    for t in cnn_lib.param_leaves(ae):
        t.requires_grad_(False)
    return ae, backbone_params, logs


@torch.no_grad()
def accuracy_with_ae(model, backbone_params, ae, split_module, x, labels, bits=8):
    """Top-1 accuracy (a 0-d float32 tensor) of the split forward with the
    AE and ``bits``-bit codes at the boundary."""
    feat = cnn_lib.forward(model, backbone_params, x, upto=split_module + 1)
    logits = cnn_lib.forward_from(model, backbone_params, roundtrip(ae, feat, bits),
                                  split_module + 1)
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def measure_rate_distortion(model, backbone_params, data_iter_fn, eval_batch_fn, *,
                            points=None, ratios=(4, 8, 16), bits=8, steps=30, lr=3e-3,
                            xi=0.1, acc_drop=0.02, base_acc=None, seed=0):
    """Per-split-point rate-distortion by the paper's Fig. 4 rule: at each
    point train one AE per channel-reduction ratio and keep the HIGHEST
    rate whose accuracy stays within ``acc_drop`` of the baseline; with no
    ratio qualifying, quantization alone (ch' = ch, R = 32 / bits).

    data_iter_fn(pi) -> a fresh (x, labels) iterator for point pi;
    eval_batch_fn(pi) -> the (x, labels) batch of its accuracy check.
    ``base_acc`` defaults to the mean accuracy of the backbone alone over
    the points' eval batches. Returns one row a point, {point, module,
    channels, ch_prime, bits, rate, acc, base_acc}, as the reference's."""
    points = list(model.split_after) if points is None else list(points)
    if base_acc is None:
        accs = []
        with torch.no_grad():
            for pi in range(len(points)):
                x, y = eval_batch_fn(pi)
                logits = cnn_lib.forward(model, backbone_params, x)
                accs.append(float(torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))))
        base_acc = float(sum(accs) / len(accs))
    rows = []
    for pi, k in enumerate(points):
        x_eval, y_eval = eval_batch_fn(pi)
        with torch.no_grad():
            ch = int(cnn_lib.forward(model, backbone_params, x_eval[:1], upto=k + 1).shape[1])
        best = {"ch_prime": ch, "rate": compression_rate(ch, ch, bits), "acc": base_acc}
        for rc in ratios:
            chp = max(1, ch // rc)
            gen = torch.Generator(device=x_eval.device).manual_seed(seed + pi * 10 + rc)
            ae, _, _ = train_autoencoder(gen, model, backbone_params, k, data_iter_fn(pi),
                                         ch=ch, ch_prime=chp, steps=steps, lr=lr, xi=xi)
            acc = float(accuracy_with_ae(model, backbone_params, ae, k, x_eval, y_eval,
                                         bits=bits))
            rate = compression_rate(ch, chp, bits)
            if acc >= base_acc - acc_drop and rate > best["rate"]:
                best = {"ch_prime": chp, "rate": rate, "acc": acc}
        rows.append({"point": pi + 1, "module": k, "channels": ch, "bits": bits,
                     "base_acc": base_acc, **best})
    return rows
