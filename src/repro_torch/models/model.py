"""Model assembly of the port: embedding -> blocks -> final norm -> head
(``src/repro/models/model.py``), in the modes train, prefill and decode,
with the serving entry points ``prefill`` and ``decode_step``. The
reference scans over layer-stacked parameters; the port keeps one module
per layer, so a split forward can run layers ``lo..hi`` on their own
(``Model.run_layers``), and its cache is a list of per-layer entries.
``loss_fn`` is the reference's training loss, the MoE layers' load-balance
loss included.

With ``cfg.remat`` set (the reference's default) a train-mode forward
under grad recomputes activations as the reference's ``jax.checkpoint``
does: each layer group of ``layer_plan`` (``len(cfg.block_pattern)``
layers; an encoder layer alone) runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
the group's input and runs the group again in the backward, stopping at
the last tensor the backward needs (the group's last product is not
rerun, as XLA drops it). The tail layers run outside it, as the
reference's do. The recompute issues the group's collectives again
(under a mesh, as GSPMD's rematerialised program holds them) and its
kernels (a mamba2 layer's ``ssd_intra``), but records no MoE routing
(``moe.unlogged``); a group returns the sum of its MoE aux losses, as the
reference's ``group_body`` returns ``aux_tot``. Without grad, or with
``remat`` off, every layer runs once, unchanged.

With ``cfg.seq_parallel_residual`` set, in train and prefill under a mesh
whose "model" axis divides the sequence (``meshctx.seq_parallel``), the
residual stream is sequence-parallel (Megatron-style): the embedding's
output is cut to this rank's contiguous block of S / model positions
(``tp.seq_block``), every layer runs on the block (so a remat group keeps
only the block), and the block is all-gathered whole after the last
layer, before ``ln_f`` and the head (``tp.seq_gather``). Each layer
gathers its normed input and reduce-scatters its row-parallel output
along the sequence, where it would all-reduce it: the same values, the
same moved bytes by the ring rule (a train step's recompute gathers each
layer's input once more), 1 / model of the residual kept a rank. Every
block type has this program (``models/blocks.py``). The encoder stack of
an encoder-decoder arch runs in train mode, as the reference's does, so
under the flag its residual is sequence-parallel in train and in prefill
alike (``Encoder.forward``), gathered whole before its ``ln_f``.

An encoder-decoder arch (``family == "encdec"``) has an encoder stack of
``"enc"`` layers with its own final norm, run over ``aux_embeds`` (the
stubbed frontend's frame embeddings) in train mode, roped at positions
0..n_frames-1; its output is the context the ``"decx"`` layers attend to.
A VLM (``family == "vlm"``) attends to ``aux_embeds`` (the stubbed image
patches) itself. Both read the context in train and prefill mode only: at
decode the cross-attention layers read its K/V from the cache."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import meshctx, tp
from repro_torch.models.blocks import make_block
from repro_torch.models.layers import Norm, dense_init, dtype_of, embed_init
from repro_torch.models.moe import expert_leaf_shape, shard_expert_leaf, unlogged


def layer_plan(cfg):
    """(pattern, n_groups, tail block types), as the reference."""
    pat = tuple(cfg.block_pattern)
    n_groups = cfg.n_layers // len(pat)
    tail = tuple(pat[i % len(pat)]
                 for i in range(n_groups * len(pat), cfg.n_layers))
    return pat, n_groups, tail


class Model(nn.Module):
    """Built under a mesh (``meshctx.use_mesh``), each parameter is this
    rank's block of it, empty, with its live spec and whole shape
    (``sharding.localize``); every block type runs its tensor-parallel
    program under it."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        mesh = meshctx.get_mesh()
        if mesh is not None:
            target, device = device, "meta"
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=dt, device=device))
        self.blocks = nn.ModuleList(make_block(cfg, bt, device=device)
                                    for bt in cfg.block_types())
        self.ln_f = Norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, dtype=dt, device=device)))
        self.encoder = Encoder(cfg, device=device) if cfg.family == "encdec" else None
        if mesh is not None:
            from repro_torch.models.sharding import localize
            localize(self, mesh, target)

    def embed_tokens(self, tokens):
        """Token embeddings, in the parameters' dtype (no cast); the vocab
        rows cut over "model" under a mesh (``tp.embed``)."""
        return tp.embed(self.embed, tokens)

    def run_layers(self, x, lo, hi, positions, aux=None, context=None, seq_parallel=False):
        """Train-mode layers ``lo..hi``, each run once (no recompute); each
        MoE layer appends its aux loss to the list ``aux`` when one is
        given; the cross-attention layers attend to ``context``. With
        ``seq_parallel`` x is this rank's block of the sequence (the
        module's docstring)."""
        for blk in self.blocks[lo:hi]:
            x = blk(x, positions, aux=aux, context=context, seq_parallel=seq_parallel)
        return x

    def train_layers(self, x, positions, aux=None, context=None):
        """Every layer in train mode; with ``cfg.remat`` and grad enabled
        each whole group of ``layer_plan`` under a checkpoint and the tail
        after them (the module's docstring), else ``run_layers``. Each
        group with MoE layers appends its aux losses' sum to ``aux``. Where
        ``meshctx.seq_parallel`` holds, the layers run on this rank's block
        of the sequence of x, gathered whole at the end."""
        cfg = self.cfg
        seq = meshctx.seq_parallel(cfg, x, "train")
        x = tp.seq_block(x) if seq else x
        lo = 0
        if cfg.remat and torch.is_grad_enabled():
            pattern, n_groups, _ = layer_plan(cfg)
            p = len(pattern)
            for g in range(n_groups):
                x = remat_group(self.blocks[g * p:(g + 1) * p], x, positions, aux, context,
                                seq_parallel=seq)
            lo = n_groups * p
        x = self.run_layers(x, lo, cfg.n_layers, positions, aux=aux, context=context,
                            seq_parallel=seq)
        return tp.seq_gather(x) if seq else x

    def context(self, aux_embeds, dtype):
        """What the cross-attention layers attend to: for an encoder-decoder
        arch the encoder's output over ``aux_embeds``, for a VLM
        ``aux_embeds`` itself, in ``dtype``; None for the other families,
        which ignore ``aux_embeds``."""
        cfg = self.cfg
        if cfg.family not in ("encdec", "vlm"):
            return None
        if aux_embeds is None:
            raise ValueError(f"{cfg.name} ({cfg.family}) needs aux_embeds, the (B, "
                             f"{cfg.n_aux_tokens}, {cfg.d_model}) embeddings of its stubbed "
                             f"{'audio frontend' if cfg.family == 'encdec' else 'vision encoder'}")
        ctx = aux_embeds.to(dtype)
        return self.encoder(ctx) if self.encoder is not None else ctx

    def logits(self, x):
        """The head: the tied embedding or ``lm_head``; under a mesh each
        rank's vocab columns, all-gathered over "model" (``tp.head``)."""
        if self.lm_head is None:
            return tp.head(x, self.embed, tied=True)
        return tp.head(x, self.lm_head)

    def forward(self, tokens, positions=None, aux_embeds=None):
        return apply_model(self, tokens, positions=positions, aux_embeds=aux_embeds)


class Encoder(nn.Module):
    """The encoder stack of an encoder-decoder arch: ``cfg.encoder.n_layers``
    bidirectional ``"enc"`` layers and their own final norm, in train mode
    over frames (B, F, d) at positions 0..F-1."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.remat = cfg.remat
        self.blocks = nn.ModuleList(make_block(cfg, "enc", device=device)
                                    for _ in range(cfg.encoder.n_layers))
        self.ln_f = Norm(cfg, device=device)

    def forward(self, x):
        """With ``cfg.remat`` and grad enabled each layer is a group of its
        own under a checkpoint, as the reference runs the encoder as a
        stack of pattern ("enc",). Where ``meshctx.seq_parallel`` holds in
        train mode (the reference's encoder mode, whatever the decoder's)
        the layers run on this rank's block of the frames, gathered whole
        before ``ln_f``."""
        positions = default_positions(x.shape[0], x.shape[1], x.device)
        remat = self.remat and torch.is_grad_enabled()
        seq = meshctx.seq_parallel(self.cfg, x, "train")
        x = tp.seq_block(x) if seq else x
        for blk in self.blocks:
            x = (remat_group([blk], x, positions, seq_parallel=seq) if remat
                 else blk(x, positions, seq_parallel=seq))
        return self.ln_f(tp.seq_gather(x) if seq else x)


class _Group:
    """A layer group's body for ``checkpoint``: ``(x, the sum of its MoE
    aux losses, or None)``. Its second run is the checkpoint's recompute,
    which records no routing."""

    def __init__(self, blocks, seq_parallel=False):
        self.blocks = blocks
        self.seq_parallel = seq_parallel
        self.runs = 0

    def __call__(self, x, positions, context):
        auxes = []
        with unlogged() if self.runs else contextlib.nullcontext():
            self.runs += 1
            for blk in self.blocks:
                x = blk(x, positions, aux=auxes, context=context,
                        seq_parallel=self.seq_parallel)
        return x, (sum(auxes[1:], auxes[0]) if auxes else None)


def remat_group(blocks, x, positions, aux=None, context=None, seq_parallel=False):
    """Train-mode ``blocks`` under ``checkpoint(use_reentrant=False)``: only
    ``x`` is kept, the rest is recomputed in the backward (the forward
    draws no random numbers, so no RNG state is kept). The group's aux
    sum is appended to the list ``aux`` when there is one. With
    ``seq_parallel`` x, and so what is kept, is this rank's block of the
    sequence."""
    x, group_aux = checkpoint(_Group(blocks, seq_parallel), x, positions, context,
                              use_reentrant=False, preserve_rng_state=False)
    if aux is not None and group_aux is not None:
        aux.append(group_aux)
    return x


def default_positions(b, s, device):
    """Positions 0..s-1 for each of the b sequences."""
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _run_stack(model, tokens, *, positions, mode, cache, idx, attn_len, aux=None,
               aux_embeds=None):
    """Embedding and every block; returns (x before the final norm, the new
    cache: one entry per layer, or None in train mode). The MoE layers
    append their aux losses to the list ``aux`` when one is given; the
    cross-attention layers attend to ``model.context(aux_embeds)`` in train
    and prefill mode."""
    cfg = model.cfg
    b, s = tokens.shape
    if mode == "decode" and (cache is None or idx is None):
        raise ValueError("decode needs the cache and idx, the token's position")
    if positions is None:
        if mode == "decode":
            positions = torch.full((b, s), idx, dtype=torch.int32, device=tokens.device)
        else:
            positions = default_positions(b, s, tokens.device)
    x = model.embed_tokens(tokens).to(dtype_of(cfg.compute_dtype))
    context = None if mode == "decode" else model.context(aux_embeds, x.dtype)
    if mode == "train":
        return model.train_layers(x, positions, aux=aux, context=context), None
    seq = meshctx.seq_parallel(cfg, x, mode)
    x = tp.seq_block(x) if seq else x
    new_cache = []
    for i, blk in enumerate(model.blocks):
        x, entry = blk(x, positions, mode=mode, cache=None if cache is None else cache[i],
                       idx=idx, attn_len=attn_len, aux=aux, context=context,
                       seq_parallel=seq)
        new_cache.append(entry)
    return (tp.seq_gather(x) if seq else x), new_cache


def apply_model(model, tokens, *, positions=None, aux_embeds=None, mode="train", cache=None,
                idx=None, attn_len=0):
    """tokens: (B, S) int; aux_embeds: (B, n_aux, d_model), the stubbed
    frontend's output, which an encoder-decoder or VLM arch needs in train
    and prefill mode. mode "train" returns logits (B, S, vocab);
    "prefill" (cache entries of ``attn_len`` slots) and "decode" (``cache``,
    ``idx`` the int position of the token) return (logits, new cache), the
    cache a list with one entry per layer. Default positions are 0..S-1, or
    ``idx`` in decode, as the reference's."""
    x, new_cache = _run_stack(model, tokens, positions=positions, mode=mode, cache=cache,
                              idx=idx, attn_len=attn_len, aux_embeds=aux_embeds)
    logits = model.logits(model.ln_f(x))
    return logits if mode == "train" else (logits, new_cache)


def loss_fn(model, batch):
    """batch: {"tokens": (B, S), "labels": (B, S) (-100 = ignore), and
    "aux_embeds" (B, n_aux, d_model) for an encoder-decoder or VLM arch}. Returns
    (loss, metrics) as the reference's ``loss_fn``: the masked mean cross
    entropy of the train-mode logits (in float32) plus ``aux``, the sum of
    the MoE layers' load-balance losses (0 for a stack without MoE);
    metrics {"ce", "aux", "ppl_proxy"}. Differentiable: on the card the
    mamba2 mixers run the ``ssd_intra`` forward and backward kernels (the
    forward twice under ``cfg.remat``: once more in the recompute).

    Under a mesh (``meshctx``) it is the global loss on every rank: the
    rank's masked sum and mask count are summed over the data axes (one
    all-reduce; the count carries no gradient), and the MoE layers' aux
    losses are already those of the global batch. A whole batch
    (``meshctx.whole_batch``) takes no such sum."""
    auxes = []
    x, _ = _run_stack(model, batch["tokens"], positions=None, mode="train", cache=None,
                      idx=None, attn_len=0, aux=auxes, aux_embeds=batch.get("aux_embeds"))
    logits = model.logits(model.ln_f(x)).to(torch.float32)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    total, count = ((lse - tgt) * mask).sum(), mask.sum()
    mesh = meshctx.get_mesh()
    if mesh is not None and not meshctx.batch_is_whole():
        total, count = mesh.all_reduce(torch.stack([total, count]), meshctx.dp_axes(mesh))
        count = count.detach()
    ce = total / torch.clamp(count, min=1.0)
    aux = sum(auxes, torch.zeros((), dtype=torch.float32, device=logits.device))
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}


def prefill(model, tokens, *, attn_len, aux_embeds=None):
    """Full forward building the decode cache (an encoder-decoder or VLM
    arch reads ``aux_embeds``). Returns (last_logits (B, vocab), cache).
    The head runs at the last position only: the norm and the head are per
    position, so the logits are the reference's
    ``logits[:, -1]`` (up to the product's rounding) and the (B, S, vocab)
    logits, 2.49 GB at (4, 2048) in bf16, are never formed."""
    x, cache = _run_stack(model, tokens, positions=None, mode="prefill", cache=None,
                          idx=None, attn_len=attn_len, aux_embeds=aux_embeds)
    return model.logits(model.ln_f(x[:, -1])), cache


def decode_step(model, cache, token, idx):
    """One-token decode. token: (B, 1) int; idx: int absolute position of
    this token. Returns (logits (B, vocab), new cache); attention layers
    update their entries in place."""
    logits, new_cache = apply_model(model, token, mode="decode", cache=cache, idx=idx)
    return logits[:, 0], new_cache


SLAB_ELEMENTS = 1 << 28     # f32 elements drawn at once for a 3-D leaf (1 GiB)


@torch.no_grad()
def init_params(cfg, generator, device):
    """A model with the reference's initializers, drawn from ``generator``
    (which must live on ``device``): normal(0, 1/sqrt(fan_in)) matrices
    (the Mamba and RG-LRU conv kernels included: fan-in d_conv = 4; the
    MoE router in f32), normal(0, 0.02) embeddings, unit norm, qk-norm and
    Mamba ``D`` / ``norm_scale``, the RG-LRU's ``lam`` at 0.3, zero biases,
    ``A_log``, ``dt_bias`` and cross-attention gates. An (E, d, f) expert leaf takes the
    reference's fan-in, its first axis E, and is drawn in slabs of experts
    of at most ``SLAB_ELEMENTS``, so no f32 copy of a whole leaf is made
    (kimi-k2's ``wi`` would take 22.5 GB). Built under a mesh
    (``meshctx.use_mesh``), an MoE layer holds the rank's shard of its
    experts: every slab of the whole leaf is drawn, in the same order, and
    the rank keeps its part, so the shards are cut from the draw a single
    process makes. Every other leaf is drawn whole under a mesh, one at a
    time, and the rank keeps its block (``sharding.cut``), so the sharded
    model holds the one-process model's numbers."""
    model = Model(cfg, device=device)
    mesh = meshctx.get_mesh()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        whole = getattr(p, "whole", tuple(p.shape))
        if name == "embed" or (p.dim() == 2 and len(whole) == 2):
            init = embed_init if name == "embed" else dense_init
            w = init(generator, whole, p.dtype, device)
            if mesh is not None:      # the whole leaf drawn, the rank's block kept
                from repro_torch.models.sharding import cut
                w = cut(w, p.spec, mesh)
            p.copy_(w)
            del w
        elif p.dim() == 3:
            shard = getattr(model.get_submodule(name.rsplit(".", 1)[0]), "shard", None)
            full = p.shape if shard is None else expert_leaf_shape(cfg, leaf)
            std = 1.0 / np.sqrt(full[0])
            step = max(1, SLAB_ELEMENTS // (full[1] * full[2]))
            for i in range(0, full[0], step):
                slab = torch.randn((min(step, full[0] - i),) + tuple(full[1:]),
                                   generator=generator, dtype=torch.float32,
                                   device=device).mul_(float(std))
                if shard is None:
                    p[i:i + step].copy_(slab)
                    continue
                # a rank keeps its shard of the slab (a mesh's MoE module)
                rows, dsl = shard
                lo, hi = max(i, rows.start), min(i + len(slab), rows.stop)
                if lo < hi:
                    p[lo - rows.start:hi - rows.start].copy_(
                        shard_expert_leaf(leaf, slab, (slice(lo - i, hi - i), dsl)))
        elif leaf in ("scale", "q_scale", "k_scale", "D", "norm_scale"):
            p.fill_(1.0)
        elif leaf == "lam":
            p.fill_(0.3)
        else:
            p.zero_()
    return model
