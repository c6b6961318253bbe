"""DNN decoupling: split plans and the per-split overhead tables that define
the env's action space (paper §3.2-3.4); the port's copy of the analytic
builders of ``src/repro/core/split.py`` (numpy only): the CNN backbones'
tables and the decoder-only transformers'.

A split decision b in {0, 1, ..., B+1} means:
  b = 0    offload the raw input
  b = k    run layers up to candidate point k on the UE, compress the
           boundary feature with the AE (+ quantization), transmit
  b = B+1  full local inference

``cnn_jalad_table`` is the JALAD baseline's table (8-bit codes, entropy
coding, no channel reduction); ``llm_decode_split_table`` the LLM-decode
offloading table, whose payload carries the UE-side serving cache. The
measured CNN tables (``measured_cnn_split_table``) need FLOP counting of a
compiled graph and come with the launch and sharding slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import overhead as oh
from repro_torch.core.cnn import CNNModel


@dataclasses.dataclass
class SplitPlan:
    name: str
    points: List[int]            # entry k (1-based) = number of UE-side modules
    t_local: np.ndarray          # (B+2,) cumulative UE compute latency
    e_local: np.ndarray
    t_comp: np.ndarray           # compressor latency at each b
    e_comp: np.ndarray
    f_bits: np.ndarray           # offload payload (bits); 0 for b = B+1
    feasible: np.ndarray         # bool (B+2,)
    device: Optional[str] = None  # UE device the tables were built for

    @property
    def n_actions(self):
        return len(self.f_bits)


def _finalize(name, points, rows, device=None):
    t_l, e_l, t_c, e_c, fb, feas = (np.array([r[i] for r in rows])
                                    for i in range(6))
    if t_l[0] != 0.0:
        raise ValueError(f"{name}: raw offload (b=0) must cost no UE compute")
    if np.any(np.diff(t_l[1:-1]) < -1e-9):
        raise ValueError(f"{name}: cumulative t_local must be monotone over "
                         f"split points, got {t_l[1:-1]}")
    if fb[-1] != 0.0:
        raise ValueError(f"{name}: full-local (b=B+1) must offload 0 bits")
    return SplitPlan(name, points, t_l, e_l, t_c, e_c, fb,
                     feas.astype(bool), device=device)


@dataclasses.dataclass
class FleetPlan:
    """Per-UE split tables of a heterogeneous fleet, padded to a shared
    action space: index 0 = raw offload, 1..B = the UE's split points, then
    infeasible padding, and the LAST index is always full-local."""
    names: List[str]
    profiles: List[oh.DeviceProfile]
    t_local: np.ndarray          # (N, B_max+2)
    e_local: np.ndarray
    t_comp: np.ndarray
    e_comp: np.ndarray
    f_bits: np.ndarray
    feasible: np.ndarray         # (N, B_max+2) bool; False on padding
    p_compute: np.ndarray        # (N,) W per local compute second

    @property
    def n_ue(self):
        return len(self.names)

    @property
    def n_actions(self):
        return self.t_local.shape[1]


def _pad_row(vals: np.ndarray, width: int, fill=0.0) -> np.ndarray:
    """Pad a (B+2,) table to (width,) keeping full-local last."""
    out = np.full((width,), fill, dtype=np.float64)
    out[: len(vals) - 1] = vals[:-1]
    out[-1] = vals[-1]
    return out


def build_fleet(plans: Sequence[SplitPlan],
                profiles: Optional[Sequence[Union[oh.DeviceProfile,
                                                  oh.DeviceModel]]] = None
                ) -> FleetPlan:
    """Stack a mix of SplitPlans into per-UE tables; padded action slots
    are infeasible and cost nothing."""
    if not plans:
        raise ValueError("build_fleet needs at least one SplitPlan")
    if profiles is None:
        profiles = [oh.DeviceProfile.from_device(oh.JETSON_NANO)] * len(plans)
    if len(profiles) != len(plans):
        raise ValueError(f"{len(plans)} plans but {len(profiles)} profiles")
    profiles = [p if isinstance(p, oh.DeviceProfile)
                else oh.DeviceProfile.from_device(p) for p in profiles]
    for plan, prof in zip(plans, profiles):
        if plan.device is not None and prof.device.name != plan.device:
            raise ValueError(
                f"plan '{plan.name}' has tables built for {plan.device} but "
                f"its profile is {prof.device.name}; rebuild the split table "
                f"with ue_dev={prof.device.name}")
    width = max(p.n_actions for p in plans)
    stack = {f: np.stack([_pad_row(getattr(p, f), width) for p in plans])
             for f in ("t_local", "e_local", "t_comp", "e_comp", "f_bits")}
    feas = np.zeros((len(plans), width), dtype=bool)
    for i, p in enumerate(plans):
        feas[i, : p.n_actions - 1] = p.feasible[:-1]
        feas[i, -1] = p.feasible[-1]
    return FleetPlan(
        names=[p.name for p in plans], profiles=list(profiles),
        feasible=feas,
        p_compute=np.array([pr.p_compute for pr in profiles]), **stack)


def homogeneous_fleet(plan: SplitPlan, n_ue: int,
                      profile: Optional[Union[oh.DeviceProfile,
                                              oh.DeviceModel]] = None
                      ) -> FleetPlan:
    """N identical plans and devices; the default profile follows the
    device the plan was built for."""
    if profile is None:
        if plan.device is None:
            dev = oh.JETSON_NANO
        elif plan.device in oh.UE_TIERS:
            dev = oh.UE_TIERS[plan.device]
        else:
            raise ValueError(
                f"plan '{plan.name}' was built for '{plan.device}', which is "
                f"not a known UE tier {sorted(oh.UE_TIERS)}; pass an explicit "
                f"DeviceProfile")
        prof = oh.DeviceProfile.from_device(dev)
    else:
        prof = profile
    return build_fleet([plan] * n_ue, [prof] * n_ue)


def cnn_split_table(model: CNNModel, in_size: int, *,
                    dev=oh.JETSON_NANO, ae_ratio=(16, 12, 8, 4),
                    quant_bits=8, batch=1,
                    input_bits_per_px=8) -> SplitPlan:
    """The split table of a CNN backbone on UE device ``dev``. ae_ratio:
    the per-split-point channel-reduction factors R_c (the paper's Fig. 4:
    early features compress best), or one scalar for every point."""
    flops = model.module_flops(in_size)
    shapes = model.feature_shapes(in_size)
    points = list(model.split_after)
    if not hasattr(ae_ratio, "__len__"):
        ae_ratio = [ae_ratio] * len(points)
    raw_bits = batch * 3 * in_size * in_size * input_bits_per_px
    rows = [(0.0, 0.0, 0.0, 0.0, raw_bits, True)]       # b = 0: raw input offload
    for pi, k in enumerate(points):
        fl = sum(flops[:k + 1]) * batch
        t, e = oh.module_time_energy(fl, fl / 8, dev)
        c, h, w = shapes[k]
        cp = max(1, c // ae_ratio[pi])
        enc_fl = 2 * c * cp * h * w * batch
        tc, ec = oh.module_time_energy(enc_fl, enc_fl / 4, dev)
        rows.append((t, e, tc, ec, batch * cp * h * w * quant_bits, True))
    fl = sum(flops) * batch
    t, e = oh.module_time_energy(fl, fl / 8, dev)
    rows.append((t, e, 0.0, 0.0, 0.0, True))
    return _finalize(model.name, points, rows, device=dev.name)


def cnn_jalad_table(model: CNNModel, in_size: int, *, dev=oh.JETSON_NANO,
                    entropy_bits=5.0, batch=1) -> SplitPlan:
    """JALAD baseline: 8-bit quantization and entropy coding, no channel
    reduction; the coder's latency from its symbols/s throughput (the
    paper's Fig. 7 point that entropy coding of large features
    dominates)."""
    from repro_torch.core.jalad import ENTROPY_CODER_SYMBOLS_PER_S as CPS
    flops = model.module_flops(in_size)
    shapes = model.feature_shapes(in_size)
    points = list(model.split_after)
    raw_bits = batch * 3 * in_size * in_size * 8
    rows = [(0.0, 0.0, 0.0, 0.0, raw_bits, True)]
    for k in points:
        fl = sum(flops[:k + 1]) * batch
        t, e = oh.module_time_energy(fl, fl / 8, dev)
        c, h, w = shapes[k]
        n = batch * c * h * w
        tc = n / CPS
        rows.append((t, e, tc, tc * dev.active_power, n * entropy_bits, True))
    fl = sum(flops) * batch
    t, e = oh.module_time_energy(fl, fl / 8, dev)
    rows.append((t, e, 0.0, 0.0, 0.0, True))
    return _finalize(model.name + "-jalad", points, rows, device=dev.name)


def transformer_split_table(cfg: ModelConfig, *, seq_len=128,
                            ue_dev=oh.PHONE_NPU, n_points=4,
                            ae_ratio=None, quant_bits=None,
                            batch=1) -> SplitPlan:
    """The split table of a transformer stack: b = 0 ships the raw input
    (the token ids; for a VLM also the raw image patches, for an
    encoder-decoder arch the stub mel frames), b = k runs layers [0, k) on
    the UE (an encoder-decoder arch's whole encoder too, costed as dense
    layers over its frames) and ships the AE-compressed boundary sequence
    (recurrent state does not cross the boundary: edge-side layers rebuild
    their own; a VLM also ships its AE'd image embeddings while an image
    layer lies at or past the split, an encoder-decoder arch its encoder's
    output at every split), b = B+1 runs the whole model. A split is
    feasible when the UE-side parameters fit UE memory."""
    ae_ratio = ae_ratio or cfg.bottleneck_ratio
    quant_bits = quant_bits or cfg.quant_bits
    layers = oh.layer_costs(cfg, seq_len)
    L = len(layers)
    emb = oh.embed_costs(cfg, seq_len)
    btypes = cfg.block_types()
    points = [max(1, round(L * (i + 1) / (n_points + 1)))
              for i in range(n_points)]

    embed_pb = cfg.vocab_size * cfg.d_model * 2
    cum_fl = np.cumsum([l["flops"] for l in layers]) * batch
    cum_pb = np.cumsum([l["param_bytes"] for l in layers])

    # family extras
    last_x = max((i for i, bt in enumerate(btypes) if bt == "xattn"), default=-1)
    aux_bits_raw = 0
    if cfg.family == "vlm":
        aux_bits_raw = cfg.n_aux_tokens * cfg.d_model * 16 * batch
    enc_flops = 0
    if cfg.family == "encdec":
        enc_layers = oh.layer_costs(
            cfg.replace(block_pattern=("dense",), n_layers=cfg.encoder.n_layers),
            cfg.encoder.n_frames)
        enc_flops = sum(l["flops"] for l in enc_layers) * batch
        aux_bits_raw = cfg.encoder.n_frames * cfg.d_model * 16 * batch

    if cfg.family == "encdec":
        raw_bits = cfg.encoder.n_frames * 80 * 32 * batch + seq_len * 32 * batch
    elif cfg.family == "vlm":
        # raw pixels of the patches (14 x 14 x 3 at 8 bits each)
        raw_bits = cfg.n_aux_tokens * 14 * 14 * 3 * 8 * batch + seq_len * 32 * batch
    else:
        raw_bits = seq_len * 32 * batch
    rows = [(0.0, 0.0, 0.0, 0.0, raw_bits, True)]
    d = cfg.d_model
    dprime = max(1, d // ae_ratio)
    rate = (d * 32.0) / (dprime * quant_bits)
    for k in points:
        fl = cum_fl[k - 1] + (enc_flops if cfg.family == "encdec" else 0)
        t, e = oh.module_time_energy(fl, fl / 4, ue_dev)
        enc_fl = 2 * seq_len * d * dprime * batch
        tc, ec = oh.module_time_energy(enc_fl, enc_fl / 4, ue_dev)
        bits = seq_len * dprime * quant_bits * batch
        if cfg.family == "vlm" and k <= last_x:
            bits += aux_bits_raw * 32 / (16 * rate)   # the embeddings, AE'd and quantized
        if cfg.family == "encdec":
            bits += cfg.encoder.n_frames * dprime * quant_bits * batch
        ue_pb = embed_pb + cum_pb[k - 1]
        rows.append((t, e, tc, ec, bits, ue_pb <= ue_dev.mem_bytes))
    fl_full = cum_fl[-1] + emb["flops"] * batch \
        + (enc_flops if cfg.family == "encdec" else 0)
    t, e = oh.module_time_energy(fl_full, fl_full / 4, ue_dev)
    total_pb = embed_pb + cum_pb[-1] + (emb["param_bytes"] - embed_pb)
    rows.append((t, e, 0.0, 0.0, 0.0, total_pb <= ue_dev.mem_bytes))
    return _finalize(cfg.name, points, rows, device=ue_dev.name)


def llm_decode_split_table(cfg: ModelConfig, ctx_len: int, *, gen_tokens=32,
                           ue_dev=oh.PHONE_NPU, n_points=4, ae_ratio=None, quant_bits=None,
                           kv_bits=None, batch=1) -> SplitPlan:
    """LLM decode offloading, where the intermediate feature is the serving
    state and its size grows with the context length.

    A task serves one request of ``ctx_len`` context tokens and
    ``gen_tokens`` generated ones. b = 0 ships the raw token ids; b = k
    prefills layers [0, k) on the UE, then ships the AE-compressed boundary
    hidden states (ctx_len x d') and the UE-side layers' serving cache
    (``models.cache.entry_payload_bits``: KV at ``kv_bits``, 0 for 16-bit;
    O(1) SSM state), so the edge finishes the prefill at layer k and
    decodes through the whole stack; b = B+1 prefills and decodes
    ``gen_tokens`` steps on the UE. A split is feasible when the UE-side
    parameters and cache fit UE memory."""
    from repro_torch.models.cache import entry_payload_bits

    ctx_len = int(ctx_len)
    if kv_bits is not None:
        cfg = cfg.replace(kv_quant_bits=kv_bits)
    ae_ratio = ae_ratio or cfg.bottleneck_ratio
    quant_bits = quant_bits or cfg.quant_bits
    btypes = cfg.block_types()
    L = len(btypes)
    pre = oh.layer_costs(cfg, ctx_len)
    dec = oh.decode_layer_costs(cfg, ctx_len)
    points = [max(1, round(L * (i + 1) / (n_points + 1))) for i in range(n_points)]

    embed_pb = cfg.vocab_size * cfg.d_model * 2
    cum_fl = np.cumsum([l["flops"] for l in pre]) * batch
    cum_by = np.cumsum([l["bytes"] for l in pre]) * batch
    cum_pb = np.cumsum([l["param_bytes"] for l in pre])
    cum_kv = np.cumsum([entry_payload_bits(cfg, bt, batch, ctx_len) for bt in btypes])

    d = cfg.d_model
    dprime = max(1, d // ae_ratio)
    rows = [(0.0, 0.0, 0.0, 0.0, ctx_len * 32 * batch, True)]   # b = 0: raw token ids
    for k in points:
        t, e = oh.module_time_energy(cum_fl[k - 1], cum_by[k - 1], ue_dev)
        enc_fl = 2 * ctx_len * d * dprime * batch
        tc, ec = oh.module_time_energy(enc_fl, enc_fl / 4, ue_dev)
        bits = ctx_len * dprime * quant_bits * batch + cum_kv[k - 1]
        ue_bytes = embed_pb + cum_pb[k - 1] + cum_kv[k - 1] / 8
        rows.append((t, e, tc, ec, bits, ue_bytes <= ue_dev.mem_bytes))
    # b = B+1: prefill and decode on the UE (several frames on a seconds scale)
    emb = oh.embed_costs(cfg, 1)
    dec_fl = sum(l["flops"] for l in dec) * batch + emb["flops"] * batch
    dec_by = sum(l["bytes"] for l in dec) * batch + emb["bytes"]
    t, e = oh.module_time_energy(cum_fl[-1] + gen_tokens * dec_fl,
                                 cum_by[-1] + gen_tokens * dec_by, ue_dev)
    total_pb = embed_pb + cum_pb[-1] + (emb["param_bytes"] - embed_pb)
    rows.append((t, e, 0.0, 0.0, 0.0, total_pb + cum_kv[-1] / 8 <= ue_dev.mem_bytes))
    return _finalize(f"{cfg.name}-decode-ctx{ctx_len}", points, rows, device=ue_dev.name)


def split_table(target, **kw) -> SplitPlan:
    """target: a CNNModel (``in_size`` defaults to 224) or a ModelConfig."""
    if isinstance(target, CNNModel):
        return cnn_split_table(target, kw.pop("in_size", 224), **kw)
    return transformer_split_table(target, **kw)
