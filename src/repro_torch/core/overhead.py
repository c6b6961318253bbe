"""Per-module latency/energy tables (paper §3.4, Fig. 7), the port's copy
of ``src/repro/core/overhead.py`` (numpy only, on the port's configs).

The tables come from an analytic device model

    t(module) = max(flops / peak_flops, bytes / mem_bw)
    e(module) = t * active_power

calibrated so a full ResNet18(224) inference costs ~50 ms / ~0.11 J on the
UE. The device tiers below are simulated devices of the MEC scenario (UEs
and edge servers inside the env), not measurements of any machine.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float           # effective FLOP/s (incl. utilization)
    mem_bw: float               # B/s
    active_power: float         # W while computing
    mem_bytes: float            # capacity for feasibility checks


# Jetson-Nano-like UE in 5 W low-power mode.
JETSON_NANO = DeviceModel("jetson-nano", 7.2e10, 2.56e10 * 0.6, 2.1, 4e9)
# A phone-class NPU UE, used for transformer UEs.
PHONE_NPU = DeviceModel("phone-npu", 2.0e12, 5.0e10, 3.0, 8e9)
# Low-end IoT tier (Pi-Zero-class SoC).
IOT_SOC = DeviceModel("iot-soc", 5.0e9, 2.0e9, 0.8, 5.12e8)
# The simulated cell-center edge server of the scenario.
TPU_V5E = DeviceModel("tpu-v5e", 197e12 * 0.5, 819e9, 170.0, 16e9)

UE_TIERS = {d.name: d for d in (JETSON_NANO, PHONE_NPU, IOT_SOC)}


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-UE runtime profile: the device the UE's split table was built
    for plus the compute power the env charges per local second."""
    name: str
    p_compute: float            # W charged per local compute second
    device: DeviceModel = JETSON_NANO

    @classmethod
    def from_device(cls, dev: DeviceModel) -> "DeviceProfile":
        return cls(dev.name, dev.active_power, dev)


# Weaker simulated edge tiers for multi-server pools.
EDGE_GPU = DeviceModel("edge-gpu", 5.0e12, 3.0e11, 70.0, 1.2e10)
EDGE_NUC = DeviceModel("edge-nuc", 8.0e11, 6.0e10, 28.0, 8e9)


@dataclasses.dataclass(frozen=True)
class ServerProfile:
    """One edge server of an EdgePool as the env sees it: ``dist_scale``
    scales each UE's distance to it, ``bw_scale`` its channels'
    bandwidth, ``edge_speed`` the FLOP/s it gives an offloaded task
    (0.0 = the paper's instantaneous edge)."""
    name: str
    device: DeviceModel = TPU_V5E
    dist_scale: float = 1.0
    bw_scale: float = 1.0
    edge_speed: float = 0.0

    @property
    def is_paper_default(self) -> bool:
        return (self.dist_scale == 1.0 and self.bw_scale == 1.0
                and self.edge_speed == 0.0)

    @classmethod
    def from_device(cls, dev: DeviceModel, *, dist_scale=1.0, bw_scale=1.0,
                    utilization=0.3) -> "ServerProfile":
        return cls(dev.name, dev, dist_scale, bw_scale,
                   dev.peak_flops * utilization)


def module_time_energy(flops: float, bytes_moved: float, dev: DeviceModel):
    t = max(flops / dev.peak_flops, bytes_moved / dev.mem_bw)
    return t, t * dev.active_power


def task_latency_energy(l_b, n_b, rate, p_compute, p_tx, t_edge=None):
    """Eq. 7/8 per-task latency and energy:
    ``t = l_b + n_b / rate [+ t_edge]``, ``e = l_b p_compute + (n_b / rate) p_tx``,
    with the reference's op order (one division, reused)."""
    tx = n_b / rate
    t = l_b + tx
    if t_edge is not None:
        t = t + t_edge
    e = l_b * p_compute + tx * p_tx
    return t, e


def _ffn_costs(cfg: ModelConfig, bt: str, s: int):
    """(flops, param_bytes, bytes read) of an attention block's FFN over
    ``s`` tokens: the MLP, or for ``"moe"`` the router and the top-k and
    shared experts, whose weights alone stream from memory, as the
    reference counts them."""
    d = cfg.d_model
    if bt == "moe":
        m = cfg.moe
        active = m.top_k + m.n_shared_experts
        flops = 2 * s * d * m.n_experts + 6 * s * d * m.d_expert * active
        return (flops, (m.n_experts + m.n_shared_experts) * 3 * d * m.d_expert * 2,
                3 * d * m.d_expert * active * 2)
    mult = 3 if cfg.act == "swiglu" else 2
    fp = mult * d * cfg.d_ff * 2
    return mult * 2 * s * d * cfg.d_ff, fp, fp


def layer_costs(cfg: ModelConfig, seq_len: int) -> List[dict]:
    """Per-layer {flops, bytes, param_bytes} for a seq_len-token forward of
    every block type (dense, local and bidirectional attention, MoE, RG-LRU
    + MLP, mamba2, the cross-attention layers ``"xattn"`` and ``"decx"``).
    bytes = params read once (of an MoE, the activated experts') +
    activations in/out (bf16)."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s = seq_len
    act = 2 * s * d * 2
    out = []
    for bt in cfg.block_types():
        if bt == "mamba2":
            ss = cfg.ssm
            di = ss.expand * d
            h = di // ss.head_dim
            n = ss.d_state
            proj = 2 * s * d * (2 * di + 2 * n + h) + 2 * s * di * d
            ssd = 2 * s * h * ss.head_dim * n * 3 + 2 * s * ss.chunk * (
                n + h * ss.head_dim)
            pbytes = (d * (2 * di + 2 * n + h) + di * d) * 2
            out.append({"flops": proj + ssd, "bytes": pbytes + act,
                        "param_bytes": pbytes})
        elif bt == "rec":
            drnn = d
            fl = 2 * s * d * drnn * 2 + 2 * s * drnn * drnn * 2 \
                + 2 * s * drnn * d + 6 * s * d * f
            pbytes = (2 * d * drnn + 2 * drnn * drnn + drnn * d + 3 * d * f) * 2
            out.append({"flops": fl, "bytes": pbytes + act, "param_bytes": pbytes})
        else:
            fl, a_params = _attention_costs(cfg, bt, s)
            ffl, fp, fbytes = _ffn_costs(cfg, bt, s)
            out.append({"flops": fl + ffl, "bytes": a_params + fbytes + act,
                        "param_bytes": a_params + fp})
    return out


def _attention_costs(cfg: ModelConfig, bt: str, s: int, ctx=None):
    """(flops, param_bytes) of an attention block's attention over ``s``
    tokens against ``ctx`` keys (default ``s``, capped at the window for a
    ``"lattn"`` layer), as the reference counts them: an ``"xattn"``
    layer's query and output projections, its scores over the
    ``n_aux_tokens`` context and the context's K/V projections; a
    ``"decx"`` layer's self-attention plus its cross-attention's query and
    output projections and scores over the encoder's ``n_frames`` (its
    parameters twice)."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    ctx = s if ctx is None else ctx
    if bt == "lattn":
        ctx = min(ctx, cfg.window)
    a_params = (d * (hq + 2 * hkv) * dh + hq * dh * d) * 2
    fl = 2 * s * d * (hq + 2 * hkv) * dh + 2 * s * hq * dh * d + 4 * s * ctx * hq * dh
    if bt == "xattn":
        fl = 2 * s * d * hq * dh + 2 * s * hq * dh * d \
            + 4 * s * cfg.n_aux_tokens * hq * dh \
            + 2 * cfg.n_aux_tokens * d * 2 * hkv * dh
    elif bt == "decx":
        nf = cfg.encoder.n_frames if cfg.encoder else 0
        fl += 2 * s * d * hq * dh + 2 * s * hq * dh * d + 4 * s * nf * hq * dh
        a_params *= 2
    return fl, a_params


def decode_layer_costs(cfg: ModelConfig, ctx_len: int) -> List[dict]:
    """Per-layer {flops, bytes, param_bytes} of one decode step at context
    length ``ctx_len`` for every block type (an MoE layer reads the
    activated experts' weights only): s = 1 projections,
    attention scores over the context (capped at the window for a
    ``"lattn"`` layer; an ``"xattn"`` layer's over its image context, a
    ``"decx"`` layer's over both) and the layer's serving-cache bytes read
    a token (decode is memory-bound, so the cache traffic is the term that
    grows with context); mamba2 and RG-LRU layers update O(1) state."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    act = 2 * d * 2  # in and out hidden of the one token, bf16
    kv_el = 1 if cfg.kv_quant_bits else 2   # int8 codes or bf16
    out = []
    for bt in cfg.block_types():
        if bt == "mamba2":
            ss = cfg.ssm
            di = ss.expand * d
            h = di // ss.head_dim
            n = ss.d_state
            proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d
            step = 2 * h * ss.head_dim * n * 3
            pbytes = (d * (2 * di + 2 * n + h) + di * d) * 2
            state_b = h * ss.head_dim * n * 4 + (ss.d_conv - 1) * (di + 2 * n) * 2
            out.append({"flops": proj + step, "bytes": pbytes + state_b + act,
                        "param_bytes": pbytes})
        elif bt == "rec":
            drnn = d
            fl = 2 * d * drnn * 2 + 2 * drnn * drnn * 2 + 2 * drnn * d + 6 * d * f
            pbytes = (2 * d * drnn + 2 * drnn * drnn + drnn * d + 3 * d * f) * 2
            out.append({"flops": fl, "bytes": pbytes + drnn * 4 + act,
                        "param_bytes": pbytes})
        else:
            ctx = min(ctx_len, cfg.window) if bt == "lattn" else ctx_len
            fl, a_params = _attention_costs(cfg, bt, 1, ctx)
            cache_b = 2 * ctx * hkv * dh * kv_el \
                + (2 * ctx * hkv * 4 if cfg.kv_quant_bits else 0)
            if bt == "xattn":   # the context's K / V are read from the cache, not projected
                fl = 2 * d * hq * dh + 2 * hq * dh * d + 4 * cfg.n_aux_tokens * hq * dh
                cache_b = 2 * cfg.n_aux_tokens * hkv * dh * 2
            elif bt == "decx":
                cache_b += 2 * cfg.encoder.n_frames * hkv * dh * 2
            ffl, fp, fbytes = _ffn_costs(cfg, bt, 1)
            out.append({"flops": fl + ffl,
                        "bytes": a_params + fbytes + cache_b + act,
                        "param_bytes": a_params + fp})
    return out


def embed_costs(cfg: ModelConfig, seq_len: int) -> dict:
    pb = cfg.vocab_size * cfg.d_model * 2
    return {"flops": 2 * seq_len * cfg.d_model * cfg.vocab_size,
            "bytes": pb * 2, "param_bytes": pb * (1 if cfg.tie_embeddings else 2)}
