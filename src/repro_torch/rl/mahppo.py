"""MAHPPO (paper §5, Algorithm 1), the port of ``src/repro/rl/mahppo.py``:
multi-actor hybrid-action PPO with one global critic, and policy
evaluation.

Training is generic over the env's :class:`HybridActionSpace` and over
three actor modes, chosen by ``MAHPPOConfig.shared_policy`` /
``entity_policy``:

* per-UE actors (default): N parameter sets over the flat global
  observation (``env.observe``), held as one stacked :class:`nets.Actor`;
* shared policy: ONE actor over every UE's ``env.observe_per_ue`` row, and
  a critic over the mean of the rows;
* entity policy: the entity-set actor and its value head over
  ``env.observe_entities``, dist and value from one trunk pass; with
  ``fused_scorer`` over ``env.observe_entities_raw``, the route scorer
  running through the ``pair_scorer`` kernel forward and backward (one
  launch each for every env or minibatch sample), and with
  ``randomize_pool`` every env drawing its own pool geometry at each
  reset.

The reference's iteration is one jitted function: a ``lax.scan`` over the
horizon with ``vmap`` over ``n_envs``, then a scan over minibatch updates.
Here the envs are one batched state (leaves of (E, N)) stepped together,
the horizon and the updates are Python loops of device work, and nothing in
an iteration reads a value back to the host; ``train_mahppo`` reads each
iteration's record once, as the reference's ``float(v)`` does. Random draws
(actions, minibatch indices, the envs' auto-resets) come from
``torch.Generator``\\ s, so the streams are not the reference's.

On a dynamic fleet (churn) the rollout builds each env's masks from its
state every frame, so inactive UEs take only full-local; the loss keeps
the static masks and weighs each actor by the frames it was active, as
the reference's does. ``evaluate_policy`` runs ``n_envs`` eval episodes
as one batched state, one policy forward a frame for all of them.

With ``n_shards`` > 1 the envs are sharded over the ``n_shards`` ranks of
an initialised ``torch.distributed`` world (``launch.mesh.spawn``), which
the reference shards over devices with ``shard_map``. A rank steps its
``n_envs / n_shards`` envs; every draw is made for all the envs and the
rank keeps its own (``actionspace.Rows``), where the reference folds the
shard index into its key, so a sharded run draws, env for env, what the
one-process run does. Training gathers the trajectory and the last values
along the env axis and every rank runs the same update with the same
minibatch draws, so the agent stays the same on every rank (the gathers
GSPMD inserts for the reference). Sharded evaluation gathers the per-env
rows of every frame once, at the end, before the summary.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.env.mecenv import MECEnv
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.rl import nets
from repro_torch.rl.actionspace import Rows
from repro_torch.rl.gae import gae

_SUMMARY = ("reward", "t_sum", "e_sum", "w_sum", "completed", "n_active", "done")


@dataclasses.dataclass(frozen=True)
class MAHPPOConfig:
    horizon: int = 1024          # ||M|| (split across n_envs)
    batch: int = 256
    reuse: int = 10              # K
    gamma: float = 0.95
    lam: float = 0.95
    clip: float = 0.2
    ent_coef: float = 0.001      # zeta
    lr: float = 1e-4
    n_envs: int = 8
    iterations: int = 50
    norm_adv: bool = True
    shared_policy: bool = False  # one weight-shared actor over per-UE rows
    entity_policy: bool = False  # entity-set obs + per-server route scorer
    randomize_pool: bool = False  # resample EdgePool geometry per episode
    n_shards: int = 1            # devices to shard the env axis across
    fused_scorer: bool = False   # fused pair-scorer kernel (entity mode)

    def __post_init__(self):
        if self.shared_policy and self.entity_policy:
            raise ValueError("pick one of shared_policy / entity_policy")
        if self.horizon % self.n_envs != 0:
            # collect runs T = horizon // n_envs steps per env: a remainder
            # would be dropped silently
            raise ValueError(
                f"horizon={self.horizon} is not divisible by "
                f"n_envs={self.n_envs}: collect() would silently drop "
                f"the {self.horizon % self.n_envs} remainder frames — "
                f"pick horizon as a multiple of n_envs")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_envs % self.n_shards != 0:
            raise ValueError(
                f"n_envs={self.n_envs} must be divisible by "
                f"n_shards={self.n_shards}: rollouts shard whole envs "
                f"across devices")
        if self.fused_scorer and not self.entity_policy:
            raise ValueError("fused_scorer fuses the entity route "
                             "scorer — set entity_policy=True")
        if self.randomize_pool and not self.entity_policy:
            raise ValueError("randomize_pool trains on resampled pool "
                             "geometry that only the entity observation "
                             "exposes — set entity_policy=True")


def env_rows(n_shards: int):
    """This rank's block of the env axis sharded over ``n_shards`` ranks,
    None for ``n_shards`` 1. The ranks are the whole initialised
    ``torch.distributed`` world; raises a ``ValueError`` that says how to
    launch them when there is none, or a world of another size."""
    if n_shards == 1:
        return None
    hint = (f"launch {n_shards} ranks with repro_torch.launch.mesh.spawn (on the CPU with "
            f"backend 'gloo'), or fleet_demo --n-shards {n_shards}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"n_shards={n_shards} shards the envs over the ranks of "
                         f"torch.distributed, and no process group is initialised: {hint}")
    if dist.get_world_size() != n_shards:
        raise ValueError(f"n_shards={n_shards} but the world has {dist.get_world_size()} "
                         f"rank(s): {hint}")
    return Rows(dist.get_rank(), n_shards)


def gather_envs(t, dim):
    """Every rank's ``t``, concatenated along its env axis ``dim`` in rank
    order."""
    flag = t.dtype == torch.bool          # gathered as bytes
    t = t.to(torch.uint8) if flag else t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    out = torch.cat(parts, dim)
    return out.bool() if flag else out


def init_agent(gen: torch.Generator, env: MECEnv, *, shared_policy=False,
               entity_policy=False):
    """Per-UE actors ({"actors": a stacked Actor}); with ``shared_policy``
    ONE actor over ``observe_per_ue`` rows ({"actor"}) and a critic over
    their mean; with ``entity_policy`` the entity actor and its value head
    ({"entity_actor"}). Drawn from ``gen`` (a CPU generator), then put on
    the env's device."""
    if shared_policy and entity_policy:
        raise ValueError("pick one of shared_policy / entity_policy")
    space, dev = env.action_space, env.device
    if entity_policy:
        return {"entity_actor": nets.init_entity_actor(gen, env.entity_dims, space, dev),
                "critic": nets.init_entity_critic(gen, dev)}
    if shared_policy:
        return {"actor": nets.init_actor(gen, env.ue_feat_dim, space, dev),
                "critic": nets.init_critic(gen, env.ue_feat_dim, dev)}
    return {"actors": nets.init_actor_stack(gen, env.params.n_ue, env.obs_dim, space, dev),
            "critic": nets.init_critic(gen, env.obs_dim, dev)}


def agent_parameters(agent):
    """The agent's parameters in a fixed order (actor, then critic)."""
    return [p for key in sorted(agent) for p in agent[key].parameters()]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class TrainFns(NamedTuple):
    sample_step: Callable
    collect: Callable
    loss_fn: Callable
    update: Callable
    iteration: Callable


def make_train_fns(env: MECEnv, cfg: MAHPPOConfig) -> TrainFns:
    """The reference's ``make_train_fns`` written out as functions of
    (agent, optimizer state, generator, states). ``iteration`` collects
    ``cfg.horizon`` frames over the batched envs, then runs the minibatch
    updates, updating the agent and optimizer state in place; its metrics
    stay on the device. With ``cfg.n_shards`` > 1 the states are the
    rank's block of the envs (``init_states``), and ``iteration`` gathers
    the trajectory over the ranks before the update."""
    rows = env_rows(cfg.n_shards)
    space = env.action_space
    n_ue = env.params.n_ue
    shared, entity = cfg.shared_policy, cfg.entity_policy
    masks0 = env.action_masks()
    # shared and entity actors take a complete mask dict; the per-UE stack
    # masks only the split head, as the reference's vmap over actors does
    masks = space.broadcast_masks(masks0, n_ue, device=env.device) \
        if (shared or entity) else masks0

    def state_masks(states):
        """A dynamic fleet's per-env masks (E, N, n), complete for the shared
        and entity actors; the static ones otherwise."""
        if not env.dynamic:
            return masks
        m = env.action_masks(states)
        return space.broadcast_masks(m, n_ue, device=env.device) if (shared or entity) else m

    observe = (env.observe_entities_raw if cfg.fused_scorer else env.observe_entities) \
        if entity else env.observe_per_ue if shared else env.observe

    def value_of(agent, obs):
        if entity:
            return nets.entity_value_forward(agent["entity_actor"], agent["critic"], obs)
        return nets.critic_forward(agent["critic"], obs.mean(dim=-2) if shared else obs)

    def policy_value(agent, obs, masks):
        """(per-head dist with an actor axis, value) for a batch of
        observations."""
        if entity:
            return nets.entity_policy_value(agent["entity_actor"], agent["critic"], space,
                                            obs, masks)
        key = "actor" if shared else "actors"
        return nets.actor_forward(agent[key], space, obs, masks), value_of(agent, obs)

    def sample_step(agent, gen, states):
        """One frame of every env: states batched over E envs."""
        obs = observe(states)
        active = states.active.to(torch.float32)                      # (E, N)
        step_masks = state_masks(states)
        dist, value = policy_value(agent, obs, step_masks)
        actions = space.sample(gen, dist, step_masks, rows=states.rows)
        logp = space.log_prob(dist, actions, active)
        nstates, reward, done, info = env.step(states, space.execute(actions))
        tr = {"obs": obs, "actions": actions, "logp": logp, "reward": reward,
              "done": done, "value": value, "active": active,
              "completed": info["completed"], "energy": info["energy"]}
        return nstates, tr

    @torch.no_grad()
    def collect(agent, gen, states):
        if rows is not None:
            # the critic's input rows gathered over the ranks: a product
            # with one output column takes another BLAS route for another
            # row count, so every rank runs it over all the envs (the
            # one-process run's rows and bits) and keeps its own
            critic = agent["critic"]
            agent = dict(agent, critic=lambda h: rows.keep(critic(gather_envs(h, 0))))
        steps = []
        for _ in range(cfg.horizon // cfg.n_envs):
            states, tr = sample_step(agent, gen, states)
            steps.append(tr)
        last_v = value_of(agent, observe(states))
        return states, _tree_stack(steps), last_v

    def loss_fn(agent, batch):
        act = batch["active"]                                          # (B, N)
        dist, v = policy_value(agent, batch["obs"], masks)
        logp = space.log_prob(dist, batch["actions"], act)
        ratio = torch.exp(logp - batch["logp"])                        # (B, N)
        a = batch["adv"][:, None]
        surr = torch.minimum(ratio * a, torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * a)
        ent = space.entropy(dist, act)
        # per-actor mean over the samples where that actor was active
        n_act = torch.clamp(act.sum(dim=0), min=1.0)                   # (N,)
        actor_loss = -(((surr * act).sum(dim=0) / n_act).sum()
                       + cfg.ent_coef * ((ent * act).sum(dim=0) / n_act).sum())
        critic_loss = torch.mean((v - batch["ret"]) ** 2)
        total = actor_loss + critic_loss
        return total, {"actor_loss": actor_loss, "value_loss": critic_loss,
                       "entropy": ent.mean(), "ratio": ratio.mean()}

    def update(agent, opt, gen, traj, last_v, indices=None):
        """``cfg.reuse`` epochs of minibatch steps over the flattened
        trajectory. The minibatch indices are drawn from ``gen`` without
        replacement; ``indices`` (a list of index tensors) replaces the
        draws, so a test can feed the reference's."""
        with torch.no_grad():
            adv, ret = gae(traj["reward"], traj["value"], traj["done"], last_v,
                           gamma=cfg.gamma, lam=cfg.lam)
            T, E = adv.shape
            M = T * E
            flat = {"obs": _tree_map(lambda x: x.reshape((M,) + x.shape[2:]), traj["obs"]),
                    "actions": _tree_map(lambda x: x.reshape(M, n_ue), traj["actions"]),
                    "logp": traj["logp"].reshape(M, n_ue),
                    "active": traj["active"].reshape(M, n_ue),
                    "adv": adv.reshape(M), "ret": ret.reshape(M)}
            if cfg.norm_adv:
                a = flat["adv"]
                flat["adv"] = (a - a.mean()) / (a.std(correction=0) + 1e-8)
        # replace=False draws cannot exceed the population: clamp the batch
        bsz = min(cfg.batch, M)
        n_updates = cfg.reuse * max(M // bsz, 1)
        if indices is None:
            keys = torch.rand((n_updates, M), generator=gen, device=adv.device)
            indices = torch.argsort(keys, dim=-1)[:, :bsz]
        params = agent_parameters(agent)
        metrics = None
        for i in range(n_updates):
            mb = _tree_map(lambda x, idx=indices[i]: x[idx], flat)
            total, metrics = loss_fn(agent, mb)
            grads = torch.autograd.grad(total, params)
            opt.update(adamw_update(grads, opt, params, cfg.lr, weight_decay=0.0)[1])
        return {k: v.detach() for k, v in metrics.items()}

    def iteration(agent, opt, gen, states):
        states, traj, last_v = collect(agent, gen, states)
        if rows is not None:            # every rank updates on every env's frames
            traj = _tree_map(lambda x: gather_envs(x, 1), traj)
            last_v = gather_envs(last_v, 0)
        metrics = update(agent, opt, gen, traj, last_v)
        metrics.update(reward_mean=traj["reward"].mean(), completed=traj["completed"].mean(),
                       energy=traj["energy"].mean())
        return agent, opt, states, metrics

    return TrainFns(sample_step, collect, loss_fn, update, iteration)


def init_states(env: MECEnv, cfg: MAHPPOConfig, gen: torch.Generator):
    """Batched initial states for training, (n_envs, N) leaves drawn from
    ``gen`` (on the env's device), which the states keep for their
    auto-resets; with ``cfg.randomize_pool`` each env draws its own pool
    geometry (and redraws it at each auto-reset). With ``cfg.n_shards`` >
    1 the rank's block of them, ``n_envs / n_shards`` envs."""
    return env.reset(gen, n_envs=cfg.n_envs // cfg.n_shards, randomize=cfg.randomize_pool,
                     rows=env_rows(cfg.n_shards))


def train_mahppo(env: MECEnv, cfg: MAHPPOConfig, seed=0, log_cb: Callable = None):
    """Train an agent for ``cfg.iterations`` iterations; returns (agent,
    history), one record per iteration with the reference's keys. The agent
    is drawn from a CPU generator seeded with ``seed``, the envs' states
    from a device generator seeded with ``seed + 1`` and the actions and
    minibatches from one seeded with ``seed + 2``."""
    agent = init_agent(torch.Generator().manual_seed(seed), env,
                       shared_policy=cfg.shared_policy, entity_policy=cfg.entity_policy)
    opt = adamw_init(agent_parameters(agent))
    states = init_states(env, cfg, torch.Generator(device=env.device).manual_seed(seed + 1))
    gen = torch.Generator(device=env.device).manual_seed(seed + 2)
    fns = make_train_fns(env, cfg)
    history = []
    for it in range(cfg.iterations):
        agent, opt, states, metrics = fns.iteration(agent, opt, gen, states)
        names = sorted(metrics)
        rec = dict(zip(names, torch.stack([metrics[k] for k in names]).tolist()))
        rec["iteration"] = it
        rec["env_steps"] = (it + 1) * cfg.horizon
        history.append(rec)
        if log_cb:
            log_cb(rec)
    return agent, history


# ----------------------------------------------------------------- eval
@torch.inference_mode()
def evaluate_policy(env: MECEnv, agent, *, frames=64, seed=0, deterministic=True,
                    fused_scorer=False, n_envs=1, n_shards=1, trace=None):
    """Run one eval-mode episode of ``frames`` frames, or ``n_envs``
    independent ones together; report the per-task latency and energy
    (Eq. 7/8, weighted by completions) and the mean reward, completions,
    active UEs and done flag per frame.

    ``agent`` is a MAHPPO agent (per-UE actors {"actors": ...} on
    ``observe``, a shared actor {"actor": ...} on ``observe_per_ue``, an
    entity agent {"entity_actor": ...} on ``observe_entities``, or on
    ``observe_entities_raw`` through the fused pair scorer with
    ``fused_scorer``) or a distilled trunk ({"flat_trunk": f32 MLP or its
    int8 form}, on ``observe_per_ue``). The reference's ``lax.scan`` is a
    loop over frames with no host sync inside; the summary is read once at
    the end. ``deterministic=False`` samples actions from a generator
    seeded with ``seed + 1`` (the env's, seeded with ``seed``, drives its
    auto-resets). ``trace``, a list, receives each frame's {"dist",
    "actions", "active"} and its summary fields ("reward", "t_sum",
    "e_sum", "w_sum", "completed", "n_active", "done"). On a dynamic fleet
    the masks are built from the state every frame (inactive UEs take only
    full-local), and the per-task overhead weighs active UEs only.

    ``n_envs`` > 1 runs that many episodes over one state with a leading
    env axis (``env.reset(n_envs=...)``, one generator drawing every env's
    auto-resets and churn as one block): one policy forward a frame for all
    envs, so an entity agent with ``fused_scorer`` makes one ``pair_scorer``
    launch a frame whatever ``n_envs`` is. The summary is the reference's:
    each field's mean over envs and frames, and ``t_task = mean(t_sum) /
    max(mean(w_sum), 1e-9)``, ``e_task`` the same way. ``n_envs`` = 1 runs
    the single-env state ((N,) leaves). ``n_shards`` > 1 runs the rank's
    ``n_envs / n_shards`` of the episodes (``env_rows``: the ranks of the
    torch.distributed world), one forward a frame, drawing what the
    unsharded run draws for them; the per-env rows are gathered over the
    ranks at the end, so every rank returns the unsharded summary, and
    ``trace`` receives the rank's own envs."""
    if n_envs % n_shards != 0:
        raise ValueError(f"n_envs={n_envs} must be divisible by n_shards={n_shards}")
    rows = env_rows(n_shards)
    kinds = [k for k in ("actors", "actor", "entity_actor", "flat_trunk") if k in agent]
    if not kinds:
        raise ValueError(f"unknown agent with keys {sorted(agent)}")
    kind = kinds[0]
    if fused_scorer and kind != "entity_actor":
        raise ValueError("fused_scorer needs an entity agent")
    space, n_ue, dev = env.action_space, env.params.n_ue, env.device
    obs_entities = env.observe_entities_raw if fused_scorer else env.observe_entities
    gen_act = torch.Generator(device=dev).manual_seed(seed + 1)
    s = env.reset(torch.Generator(device=dev).manual_seed(seed), eval_mode=True,
                  n_envs=None if n_envs == 1 else n_envs // n_shards, rows=rows)

    def masks_of(s):
        # the per-UE actors see the split mask only, as the reference's vmap
        return env.action_masks(s) if kind == "actors" \
            else space.broadcast_masks(env.action_masks(s), n_ue, device=dev)

    masks = masks_of(s)          # a static fleet's masks do not change
    frames_out = []
    for _ in range(frames):
        if env.dynamic:
            masks = masks_of(s)
        if kind == "entity_actor":
            dist = nets.entity_actor_forward(agent[kind], space, obs_entities(s), masks)
        elif kind == "flat_trunk":
            dist = nets.flat_trunk_forward(agent[kind], space, env.observe_per_ue(s), masks)
        elif kind == "actor":
            dist = nets.shared_actor_forward(agent[kind], space, env.observe_per_ue(s), masks)
        else:
            dist = nets.actor_forward(agent[kind], space, env.observe(s), masks)
        actions = space.mode(dist, masks) if deterministic \
            else space.sample(gen_act, dist, masks, rows=rows)
        phys = space.execute(actions)
        s2, reward, done, info = env.step(s, phys)
        t_task, e_task = env.task_overhead(s, phys)
        # completion-weighted per-task overhead; a tensor numerator, since
        # scalar / tensor would multiply by 1 / t_task
        w = torch.where(t_task > 0, torch.full_like(t_task, env.params.t0) / t_task, 0.0) \
            * (s.k > 0) * s.active
        # (7,) a frame, or (7, n_envs)
        frames_out.append(torch.stack([reward, (t_task * w).sum(-1), (e_task * w).sum(-1),
                                 w.sum(-1), info["completed"],
                                 info["n_active"].to(torch.float32), done.to(torch.float32)]))
        if trace is not None:
            trace.append(dict(zip(_SUMMARY, frames_out[-1]), dist=dist, actions=actions,
                              active=s.active))
        s = s2
    out = torch.stack(frames_out)
    if rows is not None:
        out = gather_envs(out, 2)
    out = out.cpu().numpy()
    res = {k: float(out[:, i].mean()) for i, k in enumerate(_SUMMARY)}
    res["t_task"] = res.pop("t_sum") / max(res["w_sum"], 1e-9)
    res["e_task"] = res.pop("e_sum") / max(res.pop("w_sum"), 1e-9)
    return res
