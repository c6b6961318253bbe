"""Train big, serve small: distill the entity policy into a flat trunk; the
port of ``src/repro/rl/distill.py``.

The policy prices a dispatch decision for every task arrival, so its own
forward latency sits on the serving path. The entity policy earns its cost
at training time (pair scoring generalizes across fleets and pools), but a
deployment serves one pool. This module turns the trained teacher into a
deployment student: a small flat MLP (``nets.init_flat_trunk``) over
``observe_per_ue``'s rows that emits every action head in one pass, and
its int8 weight form for the ``flat_trunk`` kernel.

The distillation is DAgger-style: roll out episodes (round 0 under the
sampled teacher, later rounds under the sampled student, so training visits
the states the student induces), label every visited state with
``label_samples`` actions sampled from the teacher's distribution (a
Monte-Carlo cross-entropy whose minimizer is the teacher's per-state
distribution, continuous heads included), aggregate the dataset across
rounds, and fit with full-batch AdamW epochs (no weight decay).

The reference's ``jit(vmap(episode))`` is a loop over frames with the
envs on the leading axis of one batched state (``env.reset(gen,
n_envs=E)``). The teacher reads ``observe_entities`` (the unfused scorer),
as the reference's does. Random draws (resets, labels, actions) come from
a ``torch.Generator`` on the env's device seeded with ``seed + 1``, the
student's init from a CPU one seeded with ``seed``.

Fixed fleet, fixed pool: distill against the env you will serve.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.env.mecenv import MECEnv
from repro_torch.kernels import ops
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.rl import nets


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """``iterations`` DAgger rounds of ``n_envs`` x ``frames`` rollout
    states each; every round refits on the aggregated dataset for
    ``epochs`` full-batch AdamW steps. ``label_samples`` teacher draws per
    state set the Monte-Carlo resolution of the KL match."""
    iterations: int = 3
    frames: int = 64
    n_envs: int = 4
    label_samples: int = 4
    epochs: int = 80
    lr: float = 3e-3
    hidden: tuple = (64, 64)


def _const_masks(env: MECEnv):
    """The complete per-actor mask dict of a static fleet (state-
    independent, so the dataset stores no per-state masks)."""
    if env.dynamic:
        raise ValueError("distillation targets a fixed deployment fleet; "
                         "dynamic-churn envs have state-dependent masks")
    return env.action_space.broadcast_masks(env.action_masks(), env.params.n_ue,
                                            device=env.device)


def _expand_samples(dist, n_samples):
    """A distribution dict over (..., N) actors -> the same dict with a
    sample axis before the actor axis, (..., S, N, ...), so ``log_prob``
    scores S label draws at once."""
    out = {}
    for name, d in dist.items():
        if isinstance(d, dict):
            out[name] = {k: v.unsqueeze(-2) for k, v in d.items()}
        else:
            out[name] = d.unsqueeze(-3).expand(*d.shape[:-2], n_samples, *d.shape[-2:])
    return out


@torch.no_grad()
def collect(env: MECEnv, teacher, cfg: DistillConfig, gen, student=None):
    """One round's rollouts: ``cfg.n_envs`` envs from a random reset for
    ``cfg.frames`` frames, acting with the sampled ``student`` (the
    sampled teacher when None). Returns (rows (E, T, N, F) of
    ``observe_per_ue``, labels {head: (E, T, S, N)} of ``label_samples``
    teacher draws a state)."""
    space = env.action_space
    masks = _const_masks(env)
    actor = teacher["entity_actor"]
    s = env.reset(gen, n_envs=cfg.n_envs)
    rows, labels = [], []
    for _ in range(cfg.frames):
        tdist = nets.entity_actor_forward(actor, space, env.observe_entities(s), masks)
        draws = [space.sample(gen, tdist, masks) for _ in range(cfg.label_samples)]
        labels.append({h: torch.stack([d[h] for d in draws], dim=1) for h in draws[0]})
        feats = env.observe_per_ue(s)
        bdist = tdist if student is None else nets.flat_trunk_forward(student, space, feats,
                                                                      masks)
        raw = space.sample(gen, bdist, masks)
        s, _, _, _ = env.step(s, space.execute(raw))
        rows.append(feats)
    return (torch.stack(rows, dim=1),
            {h: torch.stack([lab[h] for lab in labels], dim=1) for h in labels[0]})


def distill_loss(student, space, rows, labels, masks):
    """Mean negative log-prob of the teacher's labels under the student:
    rows (M, N, F), labels {head: (M, S, N)}."""
    dist = nets.flat_trunk_forward(student, space, rows, masks)
    n_samples = next(iter(labels.values())).shape[-2]
    return -space.log_prob(_expand_samples(dist, n_samples), labels).mean()


def distill_entity_policy(env: MECEnv, teacher, cfg: DistillConfig = None, *, seed=0,
                          log_cb=None):
    """Distill an entity ``teacher`` ({"entity_actor": ...}) into a flat
    trunk student on the deployment ``env``. Returns (student, history):
    the student is an :class:`nets.MLP` for ``nets.flat_trunk_forward``;
    each history row has the round's dataset size, its last loss (mean negative
    label log-prob) and the student-teacher mode agreement on fresh
    states."""
    if "entity_actor" not in teacher:
        raise ValueError("distillation needs an entity teacher "
                         "({'entity_actor': ...}); train with "
                         "MAHPPOConfig(entity_policy=True)")
    cfg = cfg or DistillConfig()
    space = env.action_space
    masks = _const_masks(env)
    student = nets.init_flat_trunk(torch.Generator().manual_seed(seed), env.ue_feat_dim, space,
                                   hidden=cfg.hidden, device=env.device)
    params = list(student.parameters())
    opt = adamw_init(params)
    gen = torch.Generator(device=env.device).manual_seed(seed + 1)
    rows_all, labels_all = None, None
    history = []
    for it in range(cfg.iterations):
        rows, labels = collect(env, teacher, cfg, gen, None if it == 0 else student)
        rows = rows.flatten(0, 1)                                   # (E*T, N, F)
        labels = {h: v.flatten(0, 1) for h, v in labels.items()}    # {h: (E*T, S, N)}
        if rows_all is None:
            rows_all, labels_all = rows, labels
        else:
            rows_all = torch.cat([rows_all, rows])
            labels_all = {h: torch.cat([labels_all[h], labels[h]]) for h in labels}
        loss = torch.tensor(float("inf"))
        for _ in range(cfg.epochs):
            loss = distill_loss(student, space, rows_all, labels_all, masks)
            grads = torch.autograd.grad(loss, params)
            adamw_update(grads, opt, params, cfg.lr, weight_decay=0.0)
        agree = action_agreement(env, teacher, student, states=min(128, rows.shape[0]),
                                 seed=seed + 1000 + it)
        row = {"iteration": it, "states": int(rows_all.shape[0]), "loss": float(loss.detach()),
               "agreement": agree["all"]}
        history.append(row)
        if log_cb:
            log_cb(row)
    return student, history


@torch.inference_mode()
def action_agreement(env: MECEnv, teacher, student, *, states=256, seed=0):
    """Deterministic-mode agreement between teacher and student on states
    visited under the sampled teacher (one env from a random reset, a
    generator on the env's device seeded with ``seed``): per discrete head
    the fraction of matching (state, UE) slots, their conjunction ("all"),
    and the mean absolute gap of the squashed continuous heads
    ("power_gap")."""
    space = env.action_space
    n_ue = env.params.n_ue
    masks = _const_masks(env)
    frames = (states + n_ue - 1) // max(n_ue, 1)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    s = env.reset(gen)
    match = {h.name: [] for h in space.discrete}
    gaps = []
    for _ in range(frames):
        tdist = nets.entity_actor_forward(teacher["entity_actor"], space,
                                          env.observe_entities(s), masks)
        sdist = nets.flat_trunk_forward(student, space, env.observe_per_ue(s), masks)
        t_raw, s_raw = space.mode(tdist, masks), space.mode(sdist, masks)
        raw = space.sample(gen, tdist, masks)
        s, _, _, _ = env.step(s, space.execute(raw))
        t_phys, s_phys = space.execute(t_raw), space.execute(s_raw)
        for h in space.discrete:
            match[h.name].append(t_raw[h.name] == s_raw[h.name])
        gaps.append(sum(torch.abs(t_phys[h.name] - s_phys[h.name]) for h in space.continuous))
    match = {k: torch.stack(v) for k, v in match.items()}
    both = torch.stack(list(match.values())).all(dim=0)
    vals = torch.stack([m.float().mean() for m in match.values()]
                       + [both.float().mean(), torch.stack(gaps).mean()]).tolist()
    return dict(zip(list(match) + ["all", "power_gap"], vals))


@torch.no_grad()
def quantize_flat_trunk(p, bits=8):
    """Per-layer min-max weight quantization of the float32 trunk (paper
    Eq. 1 on the weights, one (mn, mx) pair per layer, through the same
    ``ops.quantize`` codes as the feature compressor). Biases stay float32;
    mn and mx are float32 host scalars. The result feeds
    ``nets.flat_trunk_forward``."""
    qlayers = []
    for layer in p.layers:
        w = layer.w.detach().contiguous()
        mn, mx = (np.float32(v.item()) for v in torch.aminmax(w))
        qlayers.append({"codes": ops.quantize(w, mn, mx, bits=bits), "mn": mn, "mx": mx,
                        "b": layer.b.detach().to(torch.float32)})
    return {"qlayers": qlayers, "bits": int(bits)}
