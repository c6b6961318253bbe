#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --timing-only [--src OTHER_TREE/src]

Phases, one line or more each, any failure exits non-zero before the last
line (``--timing-only`` runs only the build and the kernel timings, of the
port under ``--src``, so two trees' kernels can be timed in one session):

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch twin on the card, at the
   serving shapes and ragged ones, in float32 and bfloat16 (4 and 8 bits
   for the codes, and bottleneck_encode at both serving shapes also at 12
   and 16 bits, where a single-TF32 product would miss by many codes;
   quantize and dequantize also on views at every element offset;
   ssd_intra with the route it takes, at the serving and calibration
   shapes too, and against float64 at the serving shape and a ragged Q;
   the ssd_intra backward against its formula and the formula in float64
   at the serving shape, at B = 8, at the shapes of both forward routes and
   at the example's pre-training shape, the same bits twice); then the kernel, plain and library times (CUDA events,
   median of 25) beside the least time the card could take, quantize,
   bottleneck_encode and ssd_intra at both of their main-path shapes (the
   last two with their 3xTF32 and f32-FMA bounds, ssd_intra with its plan),
   the ssd_intra backward at the serving shape (and by the profiler, with
   its route and plan) and at B = 8;
4. small split forwards: the split-serving path at small f32 configs of
   qwen3-1.7b and mamba2-1.3b on the card (kernels) against the same
   models on the CPU (plain twins);
5. serve, the main paths: qwen3-1.7b (28 layers, bf16, 4 requests of
   (4, 256) tokens) and mamba2-1.3b (48 layers, bf16, 4 requests of
   (2, 1024) tokens) at their published widths with seeded random weights,
   through the split forward; the launch counts, reset before each and
   read after it, equal the number the path makes, and one request's
   boundary codes are held to the oracle; later (phase 12z) the zoo's
   dense archs the same way;
6. profile: one request's device time by kernel, for each model
   (informative);
7. scheduling kernels: pair_scorer and flat_trunk against their twins at
   the reference's shapes, the serving ones and ragged fleets (bitwise-equal
   logits for equal occupancy, bit-equal dequantized trunk weights, the same
   bits from the same call twice), then timed beside the launch floor (an
   empty kernel timed the same way) and by the profiler, with their plans
   (flat_trunk also at M = 8, a stream dispatch's rows);
8. a small scheduling run (16 UEs, 3 servers, 8 frames, the entity agent
   through the fused scorer and the int8 trunk), card against CPU;
9. dispatch serve, the scheduling main path: a 1024-UE fleet over the
   3-server pool for 64 frames with each agent, its launch counts reset
   before and read after, then one profiled frame of each agent;
10. decode attention (one launch a call: S split over a thread block
   cluster, K and V staged by the Tensor Memory Accelerator, a tile-wise
   softmax): the kernel against its plain twin on the reference's grid
   (f32 within 2e-5, a bf16 cache within 5e-2, and every case within 2e-5
   of the twin, which reads the same values), at a ragged S, at the
   split planner's edges (S = 1, a tile and either side of it, B Hkv not
   dividing the SM count, a split with every slot empty), on a row with no
   valid slot, at the benchmark's shape and at the serving shape (and
   there against a float64 twin); then at the zoo's G and D (G 3, 7 and
   16 at D 256, f32 and bf16 caches, windows 0 and 64, a wrapped ring),
   each zoo arch's serving shape (bf16 caches: stablelm-1.6b's
   (4, 2080, 32, 1, 64), phi4-mini-3.8b's (4, 2080, 8, 3, 128), qwen2-7b's
   (4, 2080, 4, 7, 128); qwen2-7b-kv8's int8 cache with its scales at that
   shape; recurrentgemma-9b's local attention (4, 2048, 1, 16, 256) with
   its 2048 window; the MoE archs' G 8, qwen3-moe-30b-a3b's
   (4, 2080, 4, 8, 128) and kimi-k2-1t-a32b's (4, 2080, 8, 8, 128);
   seamless-m4t-large-v2's (4, 2080, 16, 1, 64) and
   llama-3.2-vision-90b's (4, 2080, 8, 8, 128)), a
   1000 window there, and an f32 cache at D 256, each serving shape also
   against float64; then timed beside scaled_dot_product_attention and the
   bound, at the serving shape, a short cache (informative) and the zoo's
   seven serving shapes (SDPA for the float caches; no library call for
   int8);
11. small prefill + decode serving: reduced f32 qwen3-1.7b (GQA kept),
   mamba2-1.3b, recurrentgemma-9b (5 layers: a tail, and an 80-token
   prompt over its 64-slot window) and qwen2-7b (G 7), 80 prompt tokens
   and 8 decode steps, card against CPU; reduced qwen2-7b-kv8 (G 7) over
   its int8 cache (codes within one step and equal at 99.9 % or more,
   logits within 5e-2 x max|logit|); reduced qwen3-moe-30b-a3b (G 8,
   capacity factor 1.25: drops at prefill and at a batch of 4's decode)
   and kimi-k2-1t-a32b (a shared expert), the routing first (equal top-k
   sets wherever a token's k-th and (k+1)-th probabilities differ by more
   than 1e-4, equal kept masks and ranks where no set differs; near-ties
   and flips counted), then the logits within 1e-4 + 1e-4 |cpu| at every
   step before a flip; reduced seamless-m4t-large-v2 (2 encoder and 3
   decx layers) and llama-3.2-vision-90b (4 dense and one xattn layer,
   G 8) with their cross-attention gates and aux_embeds drawn from
   N(0, 1), within 1e-4 + 1e-4 |cpu|;
12. decode serve, the KV-cache main path: qwen3-1.7b (28 layers, bf16, 2
   requests of a (4, 2048) prefill and 31 decode steps) and mamba2-1.3b
   (48 layers, bf16, 2 requests of (2, 1024) and 31 steps), launch counts
   reset before each and read after it, decode against the full forward,
   then one profiled qwen3 decode step;
12z. the model zoo, main paths at full width with seeded random bf16
   weights: the split forward of stablelm-1.6b, phi4-mini-3.8b and
   qwen2-7b (one request of (4, 256) each, exactly one bottleneck_encode
   and one dequantize); then the KV-cache serve of stablelm-1.6b,
   phi4-mini-3.8b, qwen2-7b, qwen2-7b-kv8 (int8 cache) and
   recurrentgemma-9b (RG-LRU and local attention), one request of a (4,
   2048) prefill and 31 decode steps each, exactly attention layers x 31
   decode_attention launches and no other kernel, prefill ms, decode ms a
   token, tokens/s, cache bytes and peak memory, each model freed before
   the next; recurrentgemma-9b's decode over a wrapped ring (a 2100-token
   prompt) against its full forward, and one profiled decode step of it;
   the phase's seconds;
12m. the mixture-of-experts stack, main paths at full width with seeded
   random bf16 weights: the split forward of qwen3-moe-30b-a3b (one
   request of (4, 256), split after layer 24: exactly one
   bottleneck_encode and one dequantize, codes within one of the oracle),
   its KV-cache serve at its full 48 layers (one request of a (4, 2048)
   prefill and 31 decode steps, exactly 1 488 decode_attention launches)
   and one profiled decode step, then kimi-k2-1t-a32b's KV-cache serve at
   1 of its 61 layers (31 launches); each prints the seconds to build its
   weights, prefill ms, decode ms a token, cache bytes, peak memory and the
   share of expert assignments dropped at prefill and at decode; the
   phase's seconds;
12e. the encoder-decoder and VLM stacks, main paths at full width with
   seeded random bf16 weights and the reference's zero aux_embeds: the
   KV-cache serve of seamless-m4t-large-v2 at its full 24 + 24 layers and
   of llama-3.2-vision-90b cut to 30 of its 100 layers (6 whole groups:
   its bf16 weights take 1.75 GB a layer), one request of a (4, 2048)
   prefill and 31 decode steps each, exactly 24 x 31 decode_attention
   launches each (the decx and dense layers; the xattn layers read their
   cached context and launch none), the seconds to build the weights,
   prefill ms, decode ms a token, cache bytes and peak memory, and one
   profiled decode step each; the phase's seconds;
12b. the loss gradient, a main path: one loss-and-gradient pass of
   mamba2-1.3b (48 layers, bf16, (2, 1024)) through ``models.loss_fn`` and
   autograd, exactly 48 ssd_intra and 48 ssd_intra_backward launches, its
   wall and device ms and peak memory; then at full width, 2 layers and
   f32 the card's gradient against the CPU's;
12c. LM training, a main path: three ``launch.steps.make_train_step``
   steps of mamba2-1.3b (48 layers, bf16, (2, 1024)), exactly 48 + 48 ssd
   launches a step and nothing else, the first step (rate 0) moving no
   parameter and the second every leaf a step of the rate can move, then a
   step's wall and device ms split into forward, backward and optimizer,
   its top device kernels and the peak memory; one timed qwen3-1.7b step
   (no kernel); two 2-layer full-width f32 mamba2 steps, card against CPU,
   the gradients clipped under AdamW's eps: each parameter within 1e-3 of
   its leaf's largest change, and the step less its weight decay within
   1e-3 of its leaf's largest, which the same card steps with the
   intra-chunk gradient dropped must fail;
12t. the --arch training launcher, a main path: ``launch.train --reduce``
   for every arch of ARCH_IDS, 3 steps of (2, 64) each into a temporary
   --out (Adafactor for llama-3.2-vision-90b and kimi-k2-1t-a32b, the
   tail's decay mask for recurrentgemma-9b): every loss finite, the final
   checkpoint written, exactly 12 ssd_intra and 12 ssd_intra_backward
   launches for mamba2-1.3b's 4 layers and none elsewhere; then one
   full-width train step of llama-3.2-vision-90b at one 5-layer group
   (Adafactor) and of seamless-m4t-large-v2 at full depth (AdamW) at
   (2, 512) with drawn aux_embeds, split as 12c's, the optimizer's share
   and peak memory;
12d. the example's pre-training, a main path: ``collab_serve --reduced
   --pretrain 150`` for qwen3-1.7b (final loss at most 3.9, top-1
   agreement at least 70 %, beside the JAX example's 3.576 and 86.7 %) and
   mamba2-1.3b (at most 4.3, at least 70 %), exactly the launches the path
   makes (600 ssd_intra_backward for mamba2, none for qwen3), then the
   ``train_lm`` twin at its defaults for 100 steps (the loss at the end
   below step 1's);
13. training, the paper's own pipeline: the quickstart twin
   (``repro_torch.launch.quickstart``) at examples/quickstart.py's defaults
   (qwen3-1.7b's split table, 5 UEs on 2 channels, MAHPPO per-UE actors,
   30 iterations of 1024 frames over 8 envs, 64 eval frames), seed 0: every
   reward finite, no kernel launched, MAHPPO's t + beta e overhead below
   full-local's; then seconds per iteration (rollout and update apart,
   synchronized), one profiled iteration (device time, launches, idle
   share, and the rollout and the update alone), and one update on the card
   held to the same update on the CPU;
14. the pair scorer's backward (pair_scorer_bwd.cu) against its plain
   formula and a float64 twin, within 1e-5 of each gradient's largest, at
   the fleet demo's rollout (4, 4, 2) and minibatch (256, 4, 2) shapes, the
   zero-shot pool (E 3), the dispatch fleet (1, 1024, 3), a ragged N and E
   1 and 5, in f32 and with bf16 observations, the same bits twice; the
   batched forward bit-equal to B single-env launches; both timed at the
   rollout, minibatch and dispatch shapes beside the launch floor, their
   bounds and the profiler's kernels (the backward as called: one launch);
15. training through the scorer kernels, a main path: the fleet demo
   (``repro_torch.launch.fleet_demo``) at its defaults, the example's
   ``--fleet --entity-policy --fused-scorer --servers 2`` (the mixed fleet,
   15 iterations of 512 frames over 4 envs on resampled pool geometry),
   seed 0: every reward finite, exactly the scorer launches the path makes
   and no other kernel, MAHPPO against greedy, nearest, load-balanced and
   the zero-shot 3-server pool; then seconds per iteration, one profiled
   iteration, and one fused update on the card held to the CPU's;
15b. a dynamic fleet through the scorer kernels, a main path:
   ``fleet_demo --churn`` (join intensity 0.2, leave probability 0.1 a
   frame; otherwise phase 15's run): exactly phase 15's scorer launches,
   every reward and overhead finite, a 24-frame membership trace with a
   leave and a join, a mean evaluated fleet strictly between 0 and N, and
   greedy, nearest and load-balanced scored on the traced membership;
15c. distillation into the int8 trunk, a main path: ``fleet_demo
   --distill`` at the example's settings (its own teacher, phase 15's
   training; then 2 DAgger rounds of 48 frames over 4 envs on the static
   pool, 120 epochs a round, seed 1): exactly the scorer launches of the
   training, 3 ``quantize`` and 64 + 21 ``flat_trunk`` (the int8
   student's eval frames and the batch-1 readout's warm and 20 timed
   calls); every loss and the int8-over-teacher overhead ratio finite;
15d. the mixed CNN + LLM-decode fleet, a main path: ``fleet_demo --llm``
   (two ResNet18 UEs and one qwen3-1.7b decode UE a context rung, 256,
   1024 and 4096, on the thin v5e slice and the edge GPU, 2-second frames,
   15 iterations through the scorer kernels): exactly their launches,
   every reward and overhead finite, each UE's split and the
   context-length shift printed;
15e. the streaming runtime, a main path: the ``streaming_serve`` twin at
   its defaults (8 UEs, 2 servers, MAHPPO 30 iterations, the streaming
   fine-tune 14, then 10 s of Poisson arrivals at 8 tasks/s a UE through
   the asyncio daemon for the tuned and zero-shot entity policy,
   nearest-server and full-local; no kernel), the oracle on the same
   arrivals, the daemon against the event heap on the card (identical
   records), the tuned teacher distilled and quantized (3 ``quantize``),
   and the same arrivals through the int8 trunk: exactly one
   ``flat_trunk`` launch a dispatch; every ledger balanced and report well
   formed; the seconds of each part, dispatches a second, host syncs a
   dispatch and one profiled dispatch of the entity, oracle and int8
   trunk dispatchers;
15f. the trained compressor (paper §2, Eq. 4 and Fig. 4), a main path:
   ResNet18 at full width, 101 classes, 224-px synthetic images,
   pre-trained 150 steps (AdamW 3e-3, batch 32), then
   ``measure_rate_distortion`` at the four split points (ratios 4, 8, 16,
   30 AE steps each, 8 bits): every loss finite, the base accuracy at least
   0.5, each row's rate Eq. 3 of its (ch, ch', bits) and the highest
   qualifying ratio or the ch' = ch fallback; one two-stage AE from a random
   init whose stage 1 lowers the loss; JALAD's size and a Huffman round trip
   of one image's feature at point 2, within 5 % of the entropy estimate;
   then the same sweep at bench_compression.py's size (width 0.5, 32 px);
   no kernel launched, seconds and peak memory printed;
15g. the dry-run without running (``repro_torch.launch.dryrun.run_one``,
   all on meta): each arch of ARCH_IDS at one input shape
   (``DRYRUN_SHAPES``, every input shape among them: the 80
   combinations take minutes of host time) on both production meshes,
   one line a combination with the params' and the optimizer state's or
   cache's bytes a device, each and together against the card's 80 GB,
   and the step's flops, dot_flops and bytes_accessed: every figure
   positive and finite, collectives and memory analysis null; the
   phase's seconds;
15h. the byte rules against the card: at a 1 x 1 mesh every spec is
   unsharded, so the rules' bytes of qwen3-1.7b's parameters (built on
   the card by ``init_params``, as the serving entries build them) and of
   its ``make_cache(cfg, 4, 2080)`` cache (the KV-cache serve's) must
   equal the bytes of their storages on the card, to the byte;
15i. counting on the card against counting on meta:
   ``measured_cnn_module_costs`` of ResNet18 (101 classes) at 224 px,
   identical flops, dot_flops and bytes_accessed for every module on
   meta and on the card (real tensors, TF32 off); the measured table's
   t_local, f_bits and feasibility printed;
15j. batched evaluation, a main path: the dispatch fleet (1024 UEs, 3
   servers, 64 frames), its entity agent through the fused scorer and its
   int8 trunk, each evaluated by ``mahppo.evaluate_policy`` with 8 eval
   episodes a frame: exactly 64 pair_scorer (one a frame for all envs),
   64 flat_trunk and 3 quantize launches after a 2-frame warm-up, every
   summary finite and equal to a single-env run's within 1e-5 relative
   (an eval episode draws nothing, so the 8 are the one episode), ms a
   frame of both; pair_scorer on the inputs batched evaluation's first
   frame gives it at (8, 1024, 3) with every env's queues and distances
   drawn apart, against its plain twin within 1e-5 + 1e-5|plain| and
   timed beside its bound; then phase 8's small run with 4 envs, each
   env's queues and distances drawn on the host (the same on both
   devices, different in each env), card against CPU within 1e-5
   relative;
16. the card's name and power limit again, the kernels as one JSON line,
   then the result as the last line.
"""
import argparse
import collections
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = None      # H100 SXM HBM3: the port's mesh.HBM_BW, read in main
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM TF32 on the tensor cores, dense
FP64_TC_FLOP_PER_S = 67e12  # H100 SXM FP64 on the tensor cores, dense
ROUTES = {  # name: (source, the TPU kernel it replaces)
    "quantize": ("src/repro_torch/kernels/csrc/quant.cu",
                 "src/repro/kernels/quant.py:62"),
    "dequantize": ("src/repro_torch/kernels/csrc/quant.cu",
                   "src/repro/kernels/quant.py:83"),
    "bottleneck_encode": ("src/repro_torch/kernels/csrc/bottleneck.cu",
                          "src/repro/kernels/bottleneck.py:45"),
    "ssd_intra": ("src/repro_torch/kernels/csrc/ssd_intra.cu",
                  "src/repro/kernels/ssd_intra.py:49"),
    "pair_scorer": ("src/repro_torch/kernels/csrc/pair_scorer.cu",
                    "src/repro/kernels/pair_scorer.py:112"),
    "flat_trunk": ("src/repro_torch/kernels/csrc/flat_trunk.cu",
                   "src/repro/kernels/flat_trunk.py:54"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attn.cuh",
                         "src/repro/kernels/decode_attn.py:59"),
    # no TPU kernel: the reference differentiates pair_scorer_xla
    "pair_scorer_backward": ("src/repro_torch/kernels/csrc/pair_scorer_bwd.cu",
                             "src/repro/kernels/pair_scorer.py:164"),
    # no TPU kernel: the reference differentiates ssd_chunked's einsum form
    "ssd_intra_backward": ("src/repro_torch/kernels/csrc/ssd_intra_bwd.cu",
                           "src/repro/models/ssm.py:81"),
}
SERVE = {"qwen3-1.7b": dict(requests=4, batch=4, seq=256),
         "mamba2-1.3b": dict(requests=4, batch=2, seq=1024)}
# the zoo's dense archs through the split forward: one request each
ZOO_SPLIT = ("stablelm-1.6b", "phi4-mini-3.8b", "qwen2-7b")
SERVE.update({name: dict(requests=1, batch=4, seq=256) for name in ZOO_SPLIT})
CALIB_BATCH = 8      # collab_serve.serve calibrates the AE on 8 sequences
DISPATCH = dict(n_ue=1024, n_servers=3, frames=64, seed=0, bits=8)
BATCHED_ENVS = 8             # batched evaluation: 8 eval episodes a frame, one forward
SMALL_BATCHED_ENVS = 4       # the small card-against-CPU batched check
DECODE_SERVE = {"qwen3-1.7b": dict(requests=2, batch=4, prompt_len=2048, gen=32),
                "mamba2-1.3b": dict(requests=2, batch=2, prompt_len=1024, gen=32)}
# the model zoo through the KV-cache path at full width: one request of a
# (4, 2048) prefill and 31 decode steps each
ZOO = ("stablelm-1.6b", "phi4-mini-3.8b", "qwen2-7b", "qwen2-7b-kv8", "recurrentgemma-9b")
DECODE_SERVE.update({name: dict(requests=1, batch=4, prompt_len=2048, gen=32) for name in ZOO})
# recurrentgemma-9b's decode against its full forward: a prompt longer than
# its 2048-slot window, so the decode reads a ring that has wrapped
RG_CONSISTENCY_PROMPT = 2100
# the mixture-of-experts stack at full width: qwen3-moe-30b-a3b split after
# layer 24 (one request of (4, 256)) and KV-cache served at its full 48
# layers; kimi-k2-1t-a32b KV-cache served at 1 of its 61 layers (one layer's
# 384 experts take 33.8 GB of bf16, two would not fit beside the embedding
# and head); one request of a (4, 2048) prefill and 31 decode steps each
MOE = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
MOE_LAYERS = {"kimi-k2-1t-a32b": 1}
SERVE["qwen3-moe-30b-a3b"] = dict(requests=1, batch=4, seq=256)
DECODE_SERVE.update({name: dict(requests=1, batch=4, prompt_len=2048, gen=32) for name in MOE})
# the encoder-decoder and VLM stacks at full width, fed the reference's zero
# aux_embeds: seamless-m4t-large-v2 at its full 24 + 24 layers (1.63 B
# parameters); llama-3.2-vision-90b cut from 100 layers to 30, 6 whole groups
# of its 5-layer pattern (24 dense and 6 xattn layers: 55.5 GB of bf16
# weights with the embedding and head; all 100 would take 175 GB); one
# request of a (4, 2048) prefill and 31 decode steps each
ENCDEC = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")
ENCDEC_LAYERS = {"llama-3.2-vision-90b": 30}
DECODE_SERVE.update({name: dict(requests=1, batch=4, prompt_len=2048, gen=32) for name in ENCDEC})
# one full-width train step each at (2, 512) with drawn aux_embeds:
# llama-3.2-vision-90b at one 5-layer group (Adafactor), seamless-m4t-large-v2
# at its full depth (AdamW)
ENCDEC_TRAIN_LAYERS = {"llama-3.2-vision-90b": 5}
ENCDEC_TRAIN_BATCH = (2, 512)
# the --arch training launcher on the card: every arch of ARCH_IDS reduced
LAUNCHER = dict(steps=3, batch=2, seq=64)
# the dry-run on meta, one input shape an arch on both production meshes,
# each of the four shapes taken and the cheapest counts chosen: all 80
# combinations take minutes of host time, most of it the prefill_32k
# counts of the attention archs (python -m repro_torch.launch.dryrun --all
# --both-meshes; PERF.md); kimi-k2-1t-a32b's decode_32k holds the most
# bytes a device of all 80
DRYRUN_SHAPES = {"seamless-m4t-large-v2": "train_4k", "qwen2-7b": "decode_32k",
                 "kimi-k2-1t-a32b": "decode_32k", "qwen3-1.7b": "long_500k",
                 "phi4-mini-3.8b": "long_500k", "recurrentgemma-9b": "decode_32k",
                 "stablelm-1.6b": "decode_32k", "qwen3-moe-30b-a3b": "long_500k",
                 "mamba2-1.3b": "prefill_32k", "llama-3.2-vision-90b": "decode_32k"}
CARD_BYTES = 80 * 2 ** 30   # the card's 80 GB, 85 899 345 920 bytes
CNN_COUNT = dict(classes=101, img=224)   # resnet18 counted on meta and on the card
# decode_attention at each zoo arch's serving shape (b, S, Hkv, G, D, cache,
# window), as DECODE_SERVE serves it (main checks them against the configs):
# stablelm-1.6b's MHA at D 64, phi4-mini-3.8b's G 3, qwen2-7b's G 7 over a
# bf16 cache and over qwen2-7b-kv8's int8 cache with its scales,
# recurrentgemma-9b's local attention (MQA over a 2048-slot ring), the MoE
# archs' G 8: qwen3-moe-30b-a3b's 32 query on 4 KV heads, kimi's 64 on 8;
# seamless-m4t-large-v2's MHA at D 64 (16 heads) and llama-3.2-vision-90b's
# 64 query on 8 KV heads
ZOO_DECODE_SHAPES = {"stablelm-1.6b": (4, 2080, 32, 1, 64, torch.bfloat16, 0),
                     "phi4-mini-3.8b": (4, 2080, 8, 3, 128, torch.bfloat16, 0),
                     "qwen2-7b": (4, 2080, 4, 7, 128, torch.bfloat16, 0),
                     "qwen2-7b-kv8": (4, 2080, 4, 7, 128, torch.int8, 0),
                     "recurrentgemma-9b": (4, 2048, 1, 16, 256, torch.bfloat16, 2048),
                     "qwen3-moe-30b-a3b": (4, 2080, 4, 8, 128, torch.bfloat16, 0),
                     "kimi-k2-1t-a32b": (4, 2080, 8, 8, 128, torch.bfloat16, 0),
                     "seamless-m4t-large-v2": (4, 2080, 16, 1, 64, torch.bfloat16, 0),
                     "llama-3.2-vision-90b": (4, 2080, 8, 8, 128, torch.bfloat16, 0)}
# the small MoE decodes, card against CPU: a router gap above this between
# a token's k-th and (k+1)-th probability cannot flip on either device
ROUTE_GAP = 1e-4
TRUNK_DIMS = (19, 64, 64, 13)    # the flat trunk's published widths
STREAM_M = 8                     # the trunk's rows on a stream dispatch: the 8-UE fleet
# the streaming serve's distillation of its tuned teacher, the settings of
# benchmarks/bench_policy_latency.py's quick run
STREAM_DISTILL = dict(iterations=3, frames=64, n_envs=4, label_samples=4, epochs=150)
STREAM_REPORT_KEYS = {"tasks", "completed", "dropped", "drop_rate", "miss_rate", "sojourn_mean",
                      "energy_task", "sojourn_p50", "sojourn_p95", "sojourn_p99", "throughput",
                      "arrivals"}
TRAIN_TIMED = 3                  # iterations timed with a sync between rollout and update
# the scorer's shapes on the fleet demo's path (envs, UEs, servers): the
# rollout, the minibatch, the zero-shot pool, the dispatch fleet, a ragged
# N and E 1 and 5
SCORER_GRAD_SHAPES = {"rollout": (4, 4, 2), "minibatch": (256, 4, 2), "zero-shot": (1, 4, 3),
                      "dispatch": (1, 1024, 3), "ragged N": (3, 13, 2), "E 1": (2, 20, 1),
                      "E 5": (2, 20, 5)}
# the ssd_intra backward beyond the serving shape: a ragged Q (the forward's
# tensor-core route), a ragged P and N (its SIMT route), and the example's
# pre-training of reduced mamba2-1.3b (16 sequences of 32 tokens, chunk 16,
# 16 heads of 32, d_state 16: the backward's SIMT route)
SSD_BWD_SHAPES = {"Q=200": (2, 2, 200, 3, 64, 128), "ragged P, N": (1, 2, 100, 2, 130, 24),
                  "pre-training": (16, 2, 16, 16, 32, 16)}
LOSS_BATCH = (2, 1024)    # mamba2-1.3b's loss gradient and train step at full width
LOSS_CHECK = (2, 640)     # card against CPU at full width and 2 layers: a ragged last chunk
# card against CPU, each parameter's gradient over its largest: f32 on both
# sides with products summed in other orders (cuBLAS and the ssd kernels'
# 3xTF32 forward on the card, MKL and the einsum twin on the CPU) through
# full-width layers and a 50 280-way head; a dropped intra-chunk gradient
# moves the mixers' gradients by O(1) of their largest
LOSS_GRAD_TOL = 1e-3
# the train steps on the card: rate 0 at the first step (the schedule's
# warmup starts at 0), then 1e-3, large enough to move every bf16 leaf
TRAIN_STEP_LR = dict(base_lr=1e-3, warmup=1, total=100)
TRAIN_STEPS = 3
# card against CPU after two train steps, each parameter over its leaf's
# largest change: the bound tests/test_torch_train.py holds MAHPPO's update to
TRAIN_STEP_TOL = 1e-3
# the clip of the checked card-against-CPU steps: it scales the global norm
# to 1e-9, so every gradient lies under AdamW's eps (1e-8), where the step is
# about linear in the gradient instead of about its sign; and their rate,
# 1e-2, so a leaf near 1.0 (D, the norm scales) moves by far more than one
# f32 step (1.2e-7) while the clipped step stays at most 0.1 of the rate
TRAIN_CHECK_CLIP = 1e-9
TRAIN_CHECK_LR = dict(base_lr=1e-2, warmup=1, total=100)
# AdamW's moment rates and eps as make_train_step runs them (adamw_update's
# defaults): the gradient-driven part of a step is rebuilt from its moments
ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8)
# the example's pre-training (examples/collaborative_serve.py: 150 steps of
# its reduced arch, 4 layers) and what the JAX example prints on a CPU host
# at its defaults (--arch qwen3-1.7b and --arch mamba2-1.3b): final train
# loss and top-1 agreement
PRETRAIN_STEPS = 150
PRETRAIN_JAX = {"qwen3-1.7b": (3.576, 0.867), "mamba2-1.3b": (4.176, 0.781)}
# final loss at most, agreement at least: qwen3's set from the JAX example's
# reading; mamba2's from the port's on the card (4.036 and 80.7 %, NVIDIA
# H100 80GB HBM3 at 700 W) with qwen3's margin over its own card reading
# (3.652: 1.07 x), above the JAX example's 4.176
PRETRAIN_LIMITS = {"qwen3-1.7b": (3.9, 0.70), "mamba2-1.3b": (4.3, 0.70)}
TRAIN_LM_STEPS = 100
# the trained compressor at the paper's Caltech-101 input size: ResNet18 at
# full width, 101 classes, 224-px synthetic images, the backbone pre-trained
# as benchmarks/bench_compression.py does (AdamW 3e-3, batch 32, 150 steps),
# then the Fig. 4 sweep at the four split points (ratios 4, 8 and 16, 30 AE
# steps each, 8-bit codes), accuracies on 64-image batches; and
# bench_compression.run(quick=True)'s own size (width 0.5, 32 px), the
# yardstick beside the reference's run on a CPU host
COMPRESS = dict(width=1.0, img=224, classes=101, batch=32, pretrain=150, lr=3e-3,
                ratios=(4, 8, 16), steps=30, bits=8, eval_batch=64, acc_batches=4,
                acc_drop=0.02)
COMPRESS_BENCH = dict(COMPRESS, width=0.5, img=32)
# one two-stage AE at point 2 (ratio 8) from a random init: 30 stage-1 steps
# at the sweep's rate, 10 stage-2 steps at 1e-4
COMPRESS_FINETUNE = dict(ratio=8, steps=30, finetune_steps=10, ft_lr=1e-4)
# the base accuracy must stand at least this high, 50 x chance (1 / 101):
# the 2 % rule compares accuracies 2 points apart on 64 images, and near
# chance every ratio would pass on noise, so the rows would measure nothing
COMPRESS_BASE_ACC = 0.5
# a Huffman code is within one bit a symbol of the entropy and, on 8-bit
# codes of a feature map (~3-6 bits a symbol), within a few percent of it
HUFFMAN_GAP = 0.05


class Failed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failed(what)


def device_ms(fn, reps=25, warmup=3):
    """Median device time of ``fn`` in ms. A sleep kernel holds the stream
    while the host enqueues every timed call, so host overhead between calls
    does not reach the timing: each pair of events brackets one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n_bytes, n_flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_flops / flop_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bottleneck_bounds(t, d, dp):
    """(3xTF32 bound, f32-FMA bound), each (ms, by): x, W read once and the
    codes written once; 2 T d d' flops of the product (three times over in
    3xTF32 on the tensor cores, once in f32 FMA) and 5 T d' of Eq. 1."""
    n_bytes, prod, eq1 = 4 * t * d + 4 * d * dp + t * dp, 2 * t * d * dp, 5 * t * dp
    ops_ms = 1e3 * (3 * prod / TF32_FLOP_PER_S + eq1 / F32_FLOP_PER_S)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    tf32 = (t_bytes, "bytes") if t_bytes >= ops_ms else (ops_ms, "operations")
    return tf32, bound(n_bytes, prod + eq1)


def code_diff(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def phase_kernels(dev, kq, kb, ref):
    """Hold each kernel to its plain twin; returns {name: max_abs_err}."""
    g = torch.Generator(device=dev).manual_seed(0)
    err = {"quantize": 0, "dequantize": 0.0, "bottleneck_encode": 0}
    for shape in [(1024, 512), (17, 130), (15, 384), (513, 96), (100, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
            for bits in (4, 8):
                q = kq.quantize_2d(x, -9.0, 9.0, bits=bits)
                dq = code_diff(q, kq.quantize_plain(x, -9.0, 9.0, bits=bits))
                check(torch.equal(q, kq.quantize_plain(x, -9.0, 9.0, bits=bits)),
                      f"quantize {shape} {dtype} {bits}b not bit-equal ({dq} codes)")
                err["quantize"] = max(err["quantize"], dq)
                for out_dtype in (torch.float32, torch.bfloat16):
                    d = kq.dequantize_2d(q, -9.0, 9.0, bits=bits, out_dtype=out_dtype)
                    p = kq.dequantize_plain(q, -9.0, 9.0, bits=bits, out_dtype=out_dtype)
                    dd = float((d.float() - p.float()).abs().max())
                    check(torch.equal(d, p), f"dequantize {shape} {bits}b {out_dtype} "
                          f"not bit-equal (max {dd})")
                    err["dequantize"] = max(err["dequantize"], dd)
    x = torch.rand((1024, 512), generator=g, device=dev) * 10 - 5
    oracle = 0.0
    for bits in (4, 8):
        q = kq.quantize_2d(x, -5.0, 5.0, bits=bits)
        d = kq.dequantize_2d(q, -5.0, 5.0, bits=bits)
        rt = float((d - x).abs().max())
        check(rt <= 10.0 / ((1 << bits) - 1) / 2 + 1e-5, f"round trip {bits}b off by {rt}")
        oracle = max(oracle, float((d - ref.dequantize_ref(q, -5.0, 5.0, bits)).abs().max()))
    check(oracle <= 1e-5, f"dequantize differs from the oracle by {oracle}")
    # views of the inputs 0-15 bytes past a 16-byte boundary, n no multiple
    # of 16: the kernels' scalar heads and tails and their unaligned stores
    for dtype in (torch.float32, torch.bfloat16):
        step = dtype.itemsize
        for offset in range(0, 16, step):
            buf = (torch.randn((37 * 41 + offset // step,), generator=g, device=dev) * 3).to(dtype)
            x = buf[offset // step:].view(37, 41)
            for bits in (8, 12):
                check(torch.equal(kq.quantize_2d(x, -9.0, 9.0, bits=bits),
                                  kq.quantize_plain(x, -9.0, 9.0, bits=bits)),
                      f"quantize {dtype} {bits}b view at byte offset {offset} not bit-equal")
    for bits in (8, 12):
        code = torch.uint8 if bits <= 8 else torch.uint16
        step = code.itemsize
        for offset in range(0, 16, step):
            buf = torch.randint(0, 1 << bits, (37 * 41 + offset // step,), generator=g,
                                device=dev).to(code)
            y = buf[offset // step:].view(37, 41)
            for out_dtype in (torch.float32, torch.bfloat16):
                check(torch.equal(kq.dequantize_2d(y, -9.0, 9.0, bits=bits, out_dtype=out_dtype),
                                  kq.dequantize_plain(y, -9.0, 9.0, bits=bits,
                                                      out_dtype=out_dtype)),
                      f"dequantize {bits}b view at byte offset {offset} not bit-equal")
    print(f"kernels: quantize bit-equal in f32 and bf16 (max {err['quantize']} code overall), "
          f"dequantize bit-equal, both also on views at every element offset (oracle's "
          f"association within {oracle:.2e}), round trip within step/2", flush=True)
    # the serving shapes (T = 1024 and 2048) at every width, then ragged
    # shapes; the last two take the SIMT kernel: d and d' not multiples of
    # 4, and an x that starts 4 bytes into its buffer
    for t, d, dp, offset in [(1024, 2048, 512, 0), (2048, 2048, 512, 0), (513, 384, 96, 0),
                             (100, 260, 64, 0), (64, 128, 32, 0), (100, 257, 63, 0),
                             (96, 256, 64, 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            buf = torch.randn((t * d + offset,), generator=g, device=dev).to(dtype)
            x = buf[offset:].view(t, d)
            w = (torch.randn((d, dp), generator=g, device=dev) * 0.05).to(dtype)
            serving = d == 2048 and dtype == torch.float32
            for bits in (4, 8, 12, 16) if serving else (4, 8):
                c = kb.bottleneck_encode(x, w, -4.0, 4.0, bits=bits)
                p = kb.bottleneck_encode_plain(x, w, -4.0, 4.0, bits=bits)
                diff = code_diff(c, p)
                share = float((c != p).float().mean())
                check(diff <= 1, f"bottleneck_encode ({t},{d})->{dp} {dtype} {bits}b "
                      f"differs by {diff} codes")
                err["bottleneck_encode"] = max(err["bottleneck_encode"], diff)
                print(f"kernels: bottleneck_encode ({t},{d})->{dp}{' offset' if offset else ''} "
                      f"{str(dtype)[6:]} {bits}b ({kb.route(x, w)}): max {diff} code, "
                      f"{100 * share:.4f}% of codes differ",
                      flush=True)
    return err


def ssd_inputs(dev, g, b, nc, q, h, p, n, dtype=torch.float32):
    """Inputs of ssd_intra as the SSD mixer gives them: dt after softplus,
    la the cumulative log decay of each chunk."""
    xh = torch.randn((b, nc, q, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=g, device=dev))
    la = -torch.cumsum(dt * 0.3, dim=2)
    bm, cm = (torch.randn((b, nc, q, n), generator=g, device=dev).to(dtype) for _ in range(2))
    return xh, dt, la, bm, cm


def ssd_route(kssd, args, dev):
    """The route the wrapper takes for these inputs, with the tensor-core
    kernel's plan (a parent tree without them: "simt")."""
    if not hasattr(kssd, "route"):
        return "simt"
    r = kssd.route(args[0], args[3], args[4])
    if r != "mma":
        return r
    b, nc, q, h, p = args[0].shape
    pl = kssd.plan(b * nc, q, h, p, torch.cuda.get_device_properties(dev).multi_processor_count)
    return (f"mma, {pl.blocks} blocks of {pl.heads_per_block} heads ({b * nc} chunks x "
            f"{pl.n_pairs} row-tile pairs x {pl.n_groups} head groups x {pl.n_ptiles} P tiles)")


def phase_ssd_kernel(dev, kssd, kref, serve_shape, calib_shape):
    """Hold ssd_intra to its plain twin; returns the max abs error. At the
    reference's shapes (tests/test_ssd_kernel.py) the bound is the
    reference's elementwise rtol = atol (1e-5 in f32, 5e-2 with bf16
    inputs); at larger N and Q f32 itself breaks that (max |y| in the
    hundreds), so there the bound is max|kernel - plain| <= tol * max|plain|.
    Kernel and twin sum in different orders, so both are also held to the
    same function in float64 at the serving shape and at a ragged Q."""
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    shapes = [("reference", (2, 2, 16, 2, 8, 8)), ("reference", (2, 2, 32, 4, 16, 8)),
              ("reference", (2, 2, 64, 2, 32, 16)), ("reduced Q=16", (2, 3, 16, 16, 32, 16)),
              ("Q=200", (2, 2, 200, 3, 64, 128)), ("ragged P, N", (1, 2, 100, 2, 130, 24)),
              ("serving", serve_shape), ("calibration", calib_shape)]
    for kind, shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 5e-2
            args = ssd_inputs(dev, g, *shape, dtype=dtype)
            got = kssd.ssd_intra(*args)
            want = kssd.ssd_intra_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if kind == "reference":
                excess = float((err - tol * want.abs()).max())
                check(excess <= tol, f"ssd_intra {shape} {dtype}: |kernel - plain| exceeds "
                      f"{tol} + {tol}|plain| by {excess - tol:.3e}")
                allowed = f"{tol} + {tol}|plain| elementwise"
            else:
                bound_err = tol * float(want.abs().max())
                check(float(err.max()) <= bound_err, f"ssd_intra {shape} {dtype}: max error "
                      f"{float(err.max()):.3e} > {bound_err:.3e}")
                allowed = f"{bound_err:.3e} = {tol} max|plain|"
            worst = max(worst, float(err.max()))
            print(f"kernels: ssd_intra {kind} (B,NC,Q,H,P,N)={shape} {str(dtype)[6:]} "
                  f"({ssd_route(kssd, args, dev).split(',')[0]}): max abs err "
                  f"{float(err.max()):.3e}, max |plain| {float(want.abs().max()):.3e}, "
                  f"allowed {allowed}", flush=True)
    for kind, shape in (("serving", serve_shape), ("Q=200", (2, 2, 200, 3, 64, 128))):
        args = ssd_inputs(dev, g, *shape)
        exact = kref.ssd_intra_ref(*(a.double() for a in args))
        scale = float(exact.abs().max())
        k64 = float((kssd.ssd_intra(*args).double() - exact).abs().max())
        p64 = float((kssd.ssd_intra_plain(*args).double() - exact).abs().max())
        check(k64 <= 1e-5 * scale, f"ssd_intra {kind} f32: {k64:.3e} from float64 "
              f"> 1e-5 max|y| = {1e-5 * scale:.3e}")
        print(f"kernels: ssd_intra {kind} (B,NC,Q,H,P,N)={shape} float32 against float64: "
              f"kernel max abs err {k64:.3e}, plain {p64:.3e}, max |y| {scale:.3e}, allowed "
              f"{1e-5 * scale:.3e}", flush=True)
    return worst


def ssd_work(b, nc, q, h, p, n):
    """(bytes, flops) the least any ssd_intra needs: each input read once,
    the f32 output written once, and only the causal half of the (i, j)
    pairs: W x (2 P flops per pair and head), the Gram matrix (2 N per
    pair), the weights (about 4 per pair and head)."""
    pairs = b * nc * q * (q + 1) // 2
    n_bytes = 4 * b * nc * q * h * p * 2 + 4 * b * nc * q * h * 2 + 4 * b * nc * q * n * 2
    return n_bytes, 2 * p * pairs * h + 2 * n * pairs + 4 * pairs * h


def ssd_bounds(shape):
    """(3xTF32 bound, f32-FMA bound), each (ms, by), of ``ssd_work``: the
    tensor-core kernel runs both products (W x and the Gram matrix) three
    times over on the tensor cores and the weights in f32 outside them."""
    b, nc, q, h, p, n = shape
    n_bytes, flops = ssd_work(*shape)
    weights = 4 * (b * nc * q * (q + 1) // 2) * h
    ops_ms = 1e3 * (3 * (flops - weights) / TF32_FLOP_PER_S + weights / F32_FLOP_PER_S)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    tf32 = (t_bytes, "bytes") if t_bytes >= ops_ms else (ops_ms, "operations")
    return tf32, bound(n_bytes, flops)


def phase_timing(dev, kq, kb, kssd, ssd_shape, calib_shape):
    """Kernel, plain and library times at the serving shapes: the JSON line
    takes qwen3-1.7b's (1024, 512) feature and (1024, 2048) @ (2048, 512)
    encode and mamba2-1.3b's serving ssd_intra; quantize is also timed at
    the trunk's (64, 64) layer, the shape its main path gives it,
    bottleneck_encode at mamba2-1.3b's (2048, 2048) @ (2048, 512) and
    ssd_intra at the calibration batch's shape."""
    g = torch.Generator(device=dev).manual_seed(1)
    serve = SERVE["qwen3-1.7b"]
    t, d, dp = serve["batch"] * serve["seq"], 2048, 512
    mn, mx, levels = -4.0, 4.0, 255
    z = torch.randn((t, dp), generator=g, device=dev) * 2
    codes = kq.quantize_2d(z, mn, mx)
    step = (mx - mn) / levels
    zp = int(round(-mn / step))
    qt = torch.quantize_per_tensor(z, step, zp, torch.quint8)
    scale = torch.tensor(levels / (mx - mn), device=dev)
    n = t * dp
    trunk = torch.randn(TRUNK_DIMS[1:3], generator=g, device=dev) * 0.4
    t_mamba = SERVE["mamba2-1.3b"]["batch"] * SERVE["mamba2-1.3b"]["seq"]
    enc = {tt: (torch.randn((tt, d), generator=g, device=dev),
                torch.randn((d, dp), generator=g, device=dev) * 0.05) for tt in (t, t_mamba)}

    xb, wb = (a.to(torch.bfloat16) for a in enc[t])

    def encode_row(tt):
        x, w = enc[tt]
        return dict(kernel=lambda: kb.bottleneck_encode(x, w, mn, mx),
                    plain=lambda: kb.bottleneck_encode_plain(x, w, mn, mx),
                    library=lambda: torch.clamp(torch.round((x @ w - mn) * scale), 0,
                                                levels).to(torch.uint8),
                    bound=bottleneck_bounds(tt, d, dp)[0])

    ssd_args = {sh: ssd_inputs(dev, g, *sh) for sh in (ssd_shape, calib_shape)}

    def ssd_row(sh):
        # f32 inputs, as the SSD mixer gives them; no single PyTorch call
        # computes this function, so it has no library yardstick
        args = ssd_args[sh]
        return dict(kernel=lambda: kssd.ssd_intra(*args), plain=lambda: kssd.ssd_intra_plain(*args),
                    library=None, bound=ssd_bounds(sh)[0])

    extra = {
        f"ssd_intra (B,NC,Q,H,P,N)={calib_shape}": ssd_row(calib_shape),
        f"quantize {TRUNK_DIMS[1:3]}": dict(
            kernel=lambda: kq.quantize_2d(trunk, -1.0, 1.0),
            plain=lambda: kq.quantize_plain(trunk, -1.0, 1.0),
            library=lambda: torch.quantize_per_tensor(trunk, 2.0 / levels, 128, torch.quint8),
            bound=bound(trunk.numel() * 5, 5 * trunk.numel())),
        f"bottleneck_encode ({t_mamba},{d})->{dp}": encode_row(t_mamba),
        # bf16 inputs take one TF32 product, not three: beside the f32 row,
        # the share of the time the products take (no library call: a bf16
        # cuBLAS product rounds z to bf16)
        f"bottleneck_encode ({t},{d})->{dp} bf16": dict(
            kernel=lambda: kb.bottleneck_encode(xb, wb, mn, mx),
            plain=lambda: kb.bottleneck_encode_plain(xb, wb, mn, mx),
            library=None,
            bound=bound(2 * t * d + 2 * d * dp + t * dp, 2 * t * d * dp, TF32_FLOP_PER_S)),
    }
    rows = {
        "quantize": dict(
            kernel=lambda: kq.quantize_2d(z, mn, mx),
            plain=lambda: kq.quantize_plain(z, mn, mx),
            # one PyTorch call for affine uint8 quantization (its zero point
            # is an integer, so a code may differ by one: a yardstick only)
            library=lambda: torch.quantize_per_tensor(z, step, zp, torch.quint8),
            bound=bound(n * (4 + 1), 5 * n)),
        "dequantize": dict(
            kernel=lambda: kq.dequantize_2d(codes, mn, mx),
            plain=lambda: kq.dequantize_plain(codes, mn, mx),
            library=lambda: qt.dequantize(),
            bound=bound(n * (1 + 4), 2 * n)),
        "bottleneck_encode": encode_row(t),
        "ssd_intra": ssd_row(ssd_shape),
    }
    out = {}
    for name, r in {**rows, **extra}.items():
        ms = device_ms(r["kernel"])
        plain_ms = device_ms(r["plain"])
        library_ms = None if r["library"] is None else device_ms(r["library"])
        bound_ms, bound_by = r["bound"]
        if name in rows:    # the JSON line's shapes
            out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        lib = "none" if library_ms is None else f"{library_ms:.5f} ms"
        print(f"timing: {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"library {lib}, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of bound", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for tt in (t, t_mamba):
        x, w = enc[tt]
        (tf32_ms, _), (f32_ms, _) = bottleneck_bounds(tt, d, dp)
        print(f"timing: bottleneck_encode ({tt},{d})->{dp}: route {kb.route(x, w)}, K split "
              f"over {kb.plan_split(tt, d, dp, n_sm)} blocks; bound in 3xTF32 "
              f"{tf32_ms:.5f} ms, in f32 FMA {f32_ms:.5f} ms", flush=True)
    for sh in (ssd_shape, calib_shape):
        (tf32_ms, tf32_by), (f32_ms, f32_by) = ssd_bounds(sh)
        print(f"timing: ssd_intra (B,NC,Q,H,P,N)={sh}: route {ssd_route(kssd, ssd_args[sh], dev)}; "
              f"bound in 3xTF32 {tf32_ms:.5f} ms ({tf32_by}), in f32 FMA {f32_ms:.5f} ms "
              f"({f32_by})", flush=True)
    return out


# ------------------------------------------------- the SSD backward and the loss gradient
def ssd_bwd_work(b, nc, q, h, p, n):
    """(bytes, product flops, other flops) the least the ssd_intra backward
    needs: x, dy, dt, la, B and C read once, dx, d dt, d la, dB and dC
    written once (f32), and over the causal half of the (i, j) pairs the
    two per-head products dM = dy x^T and dx = M^T dy (2 P flops each a
    pair and head), the Gram matrix again, dC and dB (2 N each a pair), the
    weights and the sums of dM (12 flops a pair and head)."""
    pairs = b * nc * q * (q + 1) // 2
    n_bytes = 4 * (3 * b * nc * q * h * p + 4 * b * nc * q * h + 4 * b * nc * q * n)
    return n_bytes, pairs * (4 * p * h + 6 * n), pairs * 12 * h


def ssd_bwd_bounds(shape):
    """(3xTF32 bound, f32-FMA bound), each (ms, by), of ``ssd_bwd_work``: the
    products three times over on the tensor cores and the rest in f32, or
    everything in f32 FMA (the SIMT kernel's)."""
    n_bytes, prod, other = ssd_bwd_work(*shape)
    ops_ms = 1e3 * (3 * prod / TF32_FLOP_PER_S + other / F32_FLOP_PER_S)
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    tf32 = (t_bytes, "bytes") if t_bytes >= ops_ms else (ops_ms, "operations")
    return tf32, bound(n_bytes, prod + other)


def ssd_grad_inputs(dev, g, shape, dtype=torch.float32):
    """An incoming dy (f32) and ssd_intra's inputs."""
    args = ssd_inputs(dev, g, *shape, dtype=dtype)
    return (torch.randn(args[0].shape, generator=g, device=dev), *args)


def ssd_grad_excess(got, want, bf16):
    """The largest amount by which a gradient exceeds 1e-5 of its largest
    magnitude (a gradient returned in bf16 also one bf16 step, 2^-7 of the
    element), and the largest difference over a gradient's largest."""
    excess, rel = -float("inf"), 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.double(), b.double()
        top = float(b.abs().max())
        tol = 1e-5 * top + (2.0 ** -7 * b.abs() if bf16 and i in (0, 3, 4) else 0.0)
        excess = max(excess, float(((a - b).abs() - tol).max()))
        rel = max(rel, float((a - b).abs().max()) / max(top, 1e-30))
    return excess, rel


def ssd_bwd_route(kssd, args, dev):
    """The backward's route for these inputs, with its plan (a parent tree
    without the tensor-core backward: "simt")."""
    b, nc, q, h, _ = args[0].shape
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if hasattr(kssd, "backward_route") and kssd.backward_route(args[0], args[3], args[4]) == "mma":
        pl = kssd.mma_backward_plan(b * nc, q, h, n_sm)
        return (f"mma, {pl.blocks} blocks of {pl.heads_per_block} heads ({b * nc} chunks x "
                f"{pl.n_col_tiles} column tiles x {pl.n_groups} head groups)")
    return f"simt, {kssd.backward_plan(b * nc, q, h, n_sm)}"


def phase_ssd_backward(dev, kssd, build_mod, serve_shape, calib_shape):
    """The ssd_intra backward kernel against its plain formula and against
    the formula in float64, each gradient within 1e-5 of its largest (bf16
    gradients also one bf16 step), at the serving shape, at B = 8 and at
    SSD_BWD_SHAPES, in f32 and bf16; one launch a call and
    the same bits twice. Returns the max abs error against the formula in
    f32."""
    g = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0
    for label, shape in {"serving": serve_shape, "B=8": calib_shape,
                         **SSD_BWD_SHAPES}.items():
        for dtype in (torch.float32, torch.bfloat16):
            dy, *args = ssd_grad_inputs(dev, g, shape, dtype)
            build_mod.reset_launches()
            got = kssd.ssd_intra_backward(dy, *args)
            again = kssd.ssd_intra_backward(dy, *args)
            torch.cuda.synchronize()
            check(dict(build_mod.LAUNCHES) == {"ssd_intra_backward": 2},
                  f"ssd_intra backward {label}: launches {dict(build_mod.LAUNCHES)}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"ssd_intra backward {label} {dtype}: the same call twice gave other bits")
            check([t.dtype for t in got] == [dtype, torch.float32, torch.float32, dtype, dtype],
                  f"ssd_intra backward {label}: dtypes {[t.dtype for t in got]}")
            bf16 = dtype == torch.bfloat16
            plain = kssd.ssd_intra_backward_plain(dy, *args)
            ex_p, rel_p = ssd_grad_excess(got, plain, bf16)
            wide = kssd.ssd_intra_backward_plain(*(t.double() for t in (dy, *args)))
            ex_w, rel_w = ssd_grad_excess(got, wide, bf16)
            _, rel_pw = ssd_grad_excess(plain, wide, bf16)
            del wide
            check(ex_p <= 0 and ex_w <= 0, f"ssd_intra backward {label} {shape} {dtype}: beyond "
                  f"1e-5 of a gradient's largest (by {ex_p:.2e} against the formula, {ex_w:.2e} "
                  f"against float64)")
            if not bf16:
                worst = max(worst, max(float((a - b).abs().max()) for a, b in zip(got, plain)))
            print(f"kernels: ssd_intra_backward {label} (B,NC,Q,H,P,N)={shape} "
                  f"{str(dtype)[6:]} (route {ssd_bwd_route(kssd, args, dev)}; forward route "
                  f"{ssd_route(kssd, args, dev).split(',')[0]}): "
                  f"largest difference over a gradient's largest {rel_p:.2e} against the "
                  f"formula, {rel_w:.2e} against float64 (the f32 formula {rel_pw:.2e}; 1e-5 "
                  f"allowed{', bf16 gradients plus one bf16 step' if bf16 else ''}); the same "
                  f"bits twice", flush=True)
            del got, again, plain
            torch.cuda.empty_cache()
    return worst


def phase_ssd_backward_timing(dev, kssd, shape, calib_shape=None):
    """The ssd_intra backward at the serving shape as the loss gradient
    calls it: kernel (its launches, as called), plain and bound times, the
    profiler's time by kernel, the route and plan (no single PyTorch call
    computes this function: no library time); at B = 8 the kernel's time
    beside its bound. Returns the JSON row."""
    g = torch.Generator(device=dev).manual_seed(22)
    dy, *args = ssd_grad_inputs(dev, g, shape)
    kernel = lambda: kssd.ssd_intra_backward(dy, *args)
    ms, plain_ms = device_ms(kernel), device_ms(lambda: kssd.ssd_intra_backward_plain(dy, *args))
    prof_ms, names = profiled_ms(kernel)
    kernel()
    torch.cuda.synchronize()

    def ten_calls():
        for _ in range(10):
            kernel()
        torch.cuda.synchronize()
    kernels, us = device_kernels(ten_calls)
    split = ", ".join(f"{e.key.split('(')[0].split('::')[-1][:24]} {us(e) / 1e4:.5f} ms"
                      for e in kernels)
    (tf32_ms, tf32_by), (f32_ms, f32_by) = ssd_bwd_bounds(shape)
    prof = "not measured" if prof_ms is None else f"{prof_ms:.5f} ms ({names})"
    # the bound is the card's, the products in 3xTF32 as the forward's row
    # takes it; the f32-FMA figure is what a SIMT kernel's own arithmetic
    # could reach, printed only beside it
    print(f"timing: ssd_intra_backward (B,NC,Q,H,P,N)={shape}: kernel {ms:.5f} ms, profiler "
          f"{prof} a call, plain {plain_ms:.5f} ms, library none, bound {tf32_ms:.5f} ms "
          f"({tf32_by}), {100 * tf32_ms / ms:.1f}% of bound; in f32 FMA {f32_ms:.5f} ms "
          f"({f32_by}); route {ssd_bwd_route(kssd, args, dev)}; by kernel a call: {split}",
          flush=True)
    del dy, args
    if calib_shape is not None:
        dy, *args = ssd_grad_inputs(dev, g, calib_shape)
        ms8 = device_ms(lambda: kssd.ssd_intra_backward(dy, *args))
        (b8_ms, b8_by), _ = ssd_bwd_bounds(calib_shape)
        print(f"timing: ssd_intra_backward (B,NC,Q,H,P,N)={calib_shape}: kernel {ms8:.5f} ms, "
              f"bound {b8_ms:.5f} ms ({b8_by}), {100 * b8_ms / ms8:.1f}% of bound; route "
              f"{ssd_bwd_route(kssd, args, dev)}", flush=True)
        del dy, args
    torch.cuda.empty_cache()
    return {"ssd_intra_backward": dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                       bound_ms=tf32_ms, bound_by=tf32_by)}


def loss_batch(cfg, b, s, gen, dev):
    """Next-token labels of random tokens, the first 16 positions and the
    last ignored (-100); for an encoder-decoder or VLM arch aux_embeds
    drawn from N(0, 1)."""
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    labels = tokens.roll(-1, dims=1)
    labels[:, -1] = -100
    labels[:, :16] = -100
    batch = {"tokens": tokens.to(dev), "labels": labels.to(dev)}
    if cfg.n_aux_tokens:
        batch["aux_embeds"] = torch.randn((b, cfg.n_aux_tokens, cfg.d_model), generator=gen).to(dev)
    return batch


def phase_loss_grad(dev, model_lib, init_params, cfg, build_mod):
    """A main path: one loss-and-gradient pass of mamba2-1.3b at its
    published widths (seeded random bf16 weights) at LOSS_BATCH, the way a
    training step takes it (``models.loss_fn``, then autograd): exactly one
    ssd_intra and one ssd_intra_backward launch a layer and no other
    kernel, a finite loss and every gradient finite and nonzero; the wall
    and device ms of the forward and the backward, peak memory. Then at
    full width and 2 layers in f32, the card's gradient against the CPU's
    (the twin and the formula), each parameter within LOSS_GRAD_TOL of its
    largest. Returns the full-width pass's launches."""
    b, s = LOSS_BATCH
    n_ssd = sum(bt == "mamba2" for bt in cfg.block_types())
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(7), dev)
    params = list(model.parameters())
    batch = loss_batch(cfg, b, s, torch.Generator().manual_seed(8), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build_mod.reset_launches()
    loss, metrics = model_lib.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    want = {"ssd_intra": n_ssd, "ssd_intra_backward": n_ssd}
    check(launches == want, f"loss gradient {cfg.name}: launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    value = float(loss.detach())
    check(math.isfinite(value), f"loss gradient {cfg.name}: loss {value}")
    check(all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in grads),
          f"loss gradient {cfg.name}: a gradient is not finite or is zero")
    ce = float(metrics["ce"].detach())
    del loss, metrics, grads
    # the wall of a second pass (the first one pays for first-call set-up)
    t0 = time.perf_counter()
    loss = model_lib.loss_fn(model, batch)[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del loss
    box = {}

    def forward():
        box["loss"] = model_lib.loss_fn(model, batch)[0]
        torch.cuda.synchronize()

    def backward():
        torch.autograd.grad(box.pop("loss"), params)
        torch.cuda.synchronize()

    device = {}
    for label, fn in (("forward", forward), ("backward", backward)):
        kernels, us = device_kernels(fn)
        ssd = sum(us(e) for e in kernels if "ssd_" in e.key)
        device[label] = (sum(us(e) for e in kernels) / 1e3, sum(e.count for e in kernels),
                         ssd / 1e3)
    print(f"loss gradient: {cfg.name} ({cfg.n_layers} layers, {cfg.param_dtype}) at ({b}, {s}): "
          f"loss {value:.6f} (ce {ce:.6f}, log vocab {math.log(cfg.vocab_size):.6f}); wall of a "
          f"second pass: forward {1e3 * (t1 - t0):.1f} ms, backward {1e3 * (t2 - t1):.1f} ms; device "
          + ", ".join(f"{k} {v[0]:.3f} ms in {v[1]} launches (ssd kernels {v[2]:.3f} ms)"
                      for k, v in device.items())
          + f"; launches {launches} as expected; every gradient finite and nonzero; peak "
            f"memory {peak:.2f} GiB", flush=True)
    del model, params, box
    torch.cuda.empty_cache()

    small = cfg.replace(n_layers=2, param_dtype="float32", compute_dtype="float32")
    cpu = torch.device("cpu")
    b2, s2 = LOSS_CHECK
    batch2 = loss_batch(small, b2, s2, torch.Generator().manual_seed(9), cpu)
    res = {}
    for d in (dev, cpu):
        m = init_params(small, torch.Generator().manual_seed(10), cpu).to(d)
        build_mod.reset_launches()
        l, _ = model_lib.loss_fn(m, {k: v.to(d) for k, v in batch2.items()})
        res[d.type] = (float(l.detach()), [t.cpu() for t in torch.autograd.grad(
            l, list(m.parameters()))], dict(build_mod.LAUNCHES))
    n2 = sum(bt == "mamba2" for bt in small.block_types())
    check(res[dev.type][2] == {"ssd_intra": n2, "ssd_intra_backward": n2},
          f"loss gradient check: launches {res[dev.type][2]}")
    worst = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for a, c in zip(res[dev.type][1], res["cpu"][1]))
    check(worst <= LOSS_GRAD_TOL, f"loss gradient check: the card's gradient is {worst:.2e} of "
          f"a parameter's largest from the CPU's ({LOSS_GRAD_TOL} allowed)")
    print(f"loss gradient: {cfg.name} at full width, 2 layers, f32, ({b2}, {s2}): loss card "
          f"{res[dev.type][0]:.6f}, CPU {res['cpu'][0]:.6f}; the largest difference of a "
          f"parameter's gradient over its largest {worst:.2e} ({LOSS_GRAD_TOL} allowed), the "
          f"card through {res[dev.type][2]}", flush=True)
    return launches


def step_split(train_step, model, opt, batch, model_lib, label, top=12):
    """One train step's device and wall ms split into forward, backward
    and optimizer: the forward alone, the forward and backward, and the
    whole step, each run and profiled on its own (the parts by difference);
    then the step's top device kernels. Returns (wall, device) dicts."""
    params = list(model.parameters())

    def forward():
        model_lib.loss_fn(model, batch)
        torch.cuda.synchronize()

    def forward_backward():
        torch.autograd.grad(model_lib.loss_fn(model, batch)[0], params)
        torch.cuda.synchronize()

    def step():
        train_step(model, opt, batch)
        torch.cuda.synchronize()

    wall, device, step_kernels = {}, {}, None
    for name, fn in (("forward", forward), ("forward+backward", forward_backward),
                     ("step", step)):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        wall[name] = min(times)
        kernels, us = device_kernels(fn)
        device[name] = sum(us(e) for e in kernels) / 1e3
        if name == "step":
            step_kernels = (kernels, us)
    parts = lambda d: {"forward": d["forward"],
                       "backward": d["forward+backward"] - d["forward"],
                       "optimizer": d["step"] - d["forward+backward"]}
    wall_p, dev_p = parts(wall), parts(device)
    print(f"train step: {label}: wall {wall['step']:.1f} ms a step (forward {wall_p['forward']:.1f}, "
          f"backward {wall_p['backward']:.1f}, optimizer {wall_p['optimizer']:.1f}); device "
          f"{device['step']:.3f} ms (forward {dev_p['forward']:.3f}, backward "
          f"{dev_p['backward']:.3f}, optimizer {dev_p['optimizer']:.3f}); the card idles "
          f"{100 * (1 - device['step'] / wall['step']):.0f}% of a step", flush=True)
    kernels, us = step_kernels
    total = sum(us(e) for e in kernels)
    if total > 0:
        print(f"train step: {label}: top device kernels of a step ({sum(e.count for e in kernels)} "
              f"launches):", flush=True)
        for e in sorted(kernels, key=us, reverse=True)[:top]:
            print(f"train step:   {us(e) / 1e3:8.3f} ms {100 * us(e) / total:5.1f}% "
                  f"x{e.count:<5d} {e.key[:100]}", flush=True)
    return wall, device


def phase_train_step(dev, steps_lib, model_lib, init_params, cfg, build_mod):
    """A main path: ``launch.steps.make_train_step`` on mamba2-1.3b at its
    published widths (seeded random bf16 weights) at LOSS_BATCH, TRAIN_STEPS
    steps: exactly one ssd_intra and one ssd_intra_backward launch a layer a
    step and no other kernel, every loss finite, no parameter moved by the
    first step (rate 0) and every leaf moved by the second but bf16 ones
    too large everywhere for a step of the rate to change (the norm scales
    at 1.0); then a step's
    wall and device ms split into forward, backward and optimizer, its top
    device kernels, and the peak memory. Returns the launches."""
    b, s = LOSS_BATCH
    n_ssd = sum(bt == "mamba2" for bt in cfg.block_types())
    want = {"ssd_intra": n_ssd, "ssd_intra_backward": n_ssd}
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(7), dev)
    batch = loss_batch(cfg, b, s, torch.Generator().manual_seed(8), dev)
    train_step, opt_init = steps_lib.make_train_step(cfg, **TRAIN_STEP_LR)
    opt = opt_init(model)
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, losses, walls = collections.Counter(), [], []
    for k in range(TRAIN_STEPS):
        build_mod.reset_launches()
        t0 = time.perf_counter()
        model, opt, metrics = train_step(model, opt, batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        got = {n: v for n, v in build_mod.LAUNCHES.items() if v}
        check(got == want, f"train step {cfg.name} step {k + 1}: launches {got}, expected {want}")
        launches.update(got)
        losses.append(float(metrics["loss"]))
        check(math.isfinite(losses[-1]), f"train step {cfg.name}: loss {losses[-1]}")
        if k == 0:
            check(all(torch.equal(a, p) for a, p in zip(before, model.parameters())),
                  f"train step {cfg.name}: the first step (rate 0) moved a parameter")
        if k == 1:
            # a bf16 element of magnitude 0.5 or more keeps its value under a
            # step of about the rate (1e-3 < half its bf16 step, 2^-9): the
            # norm scales, all 1.0 at the start, may not move
            still = [p for a, p in zip(before, model.parameters()) if torch.equal(a, p)]
            check(all(p.dtype == torch.bfloat16 and float(p.abs().min()) >= 0.5 for p in still),
                  f"train step {cfg.name}: {len(still)} leaves did not move at the second step")
            n_still = len(still)
            del before, still
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train step: {cfg.name} ({cfg.n_layers} layers, {cfg.param_dtype}) at ({b}, {s}), "
          f"{TRAIN_STEPS} steps of make_train_step({TRAIN_STEP_LR}): losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}, rates "
          f"0 then {TRAIN_STEP_LR['base_lr']}; wall {', '.join(f'{w:.1f}' for w in walls)} ms; "
          f"launches {dict(launches)} ({n_ssd} + {n_ssd} a step, nothing else); the first step "
          f"moved no parameter, the second every leaf but {n_still} bf16 leaves of magnitude "
          f">= 0.5 everywhere (the norm scales at 1.0: a 1e-3 step is under half a bf16 step); "
          f"peak memory {peak:.2f} GiB", flush=True)
    check(peak < 80, f"train step {cfg.name}: peak memory {peak:.2f} GiB")
    build_mod.reset_launches()
    step_split(train_step, model, opt, batch, model_lib, f"{cfg.name} at ({b}, {s})")
    del model, opt, batch
    torch.cuda.empty_cache()
    return launches


def phase_train_step_timing(dev, steps_lib, model_lib, init_params, cfg, build_mod,
                            shape=LOSS_BATCH):
    """A full-width train step of a model no hand-written kernel runs in
    (qwen3-1.7b, bf16, LOSS_BATCH; the encoder-decoder and VLM stacks at
    ENCDEC_TRAIN_BATCH): one step to warm, then a timed one split as
    ``step_split`` splits it, and the optimizer's share of it; no kernel
    launches."""
    b, s = shape
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(7), dev)
    batch = loss_batch(cfg, b, s, torch.Generator().manual_seed(8), dev)
    train_step, opt_init = steps_lib.make_train_step(cfg, **TRAIN_STEP_LR)
    opt = opt_init(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build_mod.reset_launches()
    model, opt, metrics = train_step(model, opt, batch)
    torch.cuda.synchronize()
    got = {n: v for n, v in build_mod.LAUNCHES.items() if v}
    check(got == {}, f"train step {cfg.name}: launches {got}, expected none")
    loss = float(metrics["loss"])
    check(math.isfinite(loss), f"train step {cfg.name}: loss {loss}")
    wall, device = step_split(train_step, model, opt, batch, model_lib,
                              f"{cfg.name} at ({b}, {s})", top=8)
    share = lambda d: (f"{100 * (d['step'] - d['forward+backward']) / d['step']:.1f}%"
                       if d["step"] > 0 else "not measured")
    print(f"train step: {cfg.name} ({cfg.n_layers} layers, {cfg.param_dtype}, {cfg.optimizer}) at "
          f"({b}, {s}): loss {loss:.6f}, no kernel launched; the optimizer {share(wall)} of "
          f"the wall and {share(device)} of the device time of a step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, opt, batch
    torch.cuda.empty_cache()


def gradient_step(opt, lr):
    """The gradient-driven part of the step that left AdamW's state
    ``opt``: ``lr (m / bc1) / (sqrt(v / bc2) + eps)`` from its moments, in
    float64 on the CPU. It is the step less its weight decay, with no
    rounding against the parameters, and depends on every step's clipped
    gradient through the moments."""
    t = int(opt["step"])
    bc1, bc2 = 1 - ADAMW["b1"] ** t, 1 - ADAMW["b2"] ** t
    return [lr * (m.detach().double().cpu() / bc1)
            / ((v.detach().double().cpu() / bc2).sqrt() + ADAMW["eps"])
            for m, v in zip(opt["m"], opt["v"])]


def leaf_gap(got, want, scale):
    """The largest ``|got - want|`` of any leaf over the largest magnitude
    of that leaf's ``scale``, and the leaf's index."""
    ratios = [float((a - c).abs().max()) / max(float(r.abs().max()), 1e-30)
              for a, c, r in zip(got, want, scale)]
    i = max(range(len(ratios)), key=ratios.__getitem__)
    return ratios[i], i


def phase_train_check(dev, steps_lib, init_params, cfg, build_mod, kssd):
    """Two train steps of ``cfg`` at full width, 2 layers and f32 at
    LOSS_CHECK on the card and on the CPU from the same weights and batch,
    through ``make_train_step`` at TRAIN_CHECK_LR and ``clip =
    TRAIN_CHECK_CLIP``: every gradient, clipped, lies under AdamW's eps,
    where the step is about linear in the gradient. Checked, each within
    TRAIN_STEP_TOL of its leaf's largest on the CPU:

    * every parameter against its change (the whole step, weight decay
      included: at this clip the decay, the same on both devices, is most
      of a decayed leaf's largest change);
    * the gradient-driven part of the second step (``gradient_step``: the
      step less its decay, from each device's moments, so from both
      steps' gradients), which holds every leaf's gradient, the O(1)
      leaves' (A_log, D, dt_bias, the norm scales) too.

    Then a control: the card's two steps again with ``SsdIntra``'s backward
    returning zeros (the intra-chunk gradient dropped) must fail the
    second check."""
    small = cfg.replace(n_layers=2, param_dtype="float32", compute_dtype="float32")
    cpu = torch.device("cpu")
    batch = loss_batch(small, *LOSS_CHECK, torch.Generator().manual_seed(9), cpu)
    names, start = zip(*((n, p.detach().clone()) for n, p in init_params(
        small, torch.Generator().manual_seed(10), cpu).named_parameters()))
    n2 = sum(bt == "mamba2" for bt in small.block_types())

    def two_steps(d):
        m = init_params(small, torch.Generator().manual_seed(10), cpu).to(d)
        train_step, opt_init = steps_lib.make_train_step(small, clip=TRAIN_CHECK_CLIP,
                                                         **TRAIN_CHECK_LR)
        opt = opt_init(m)
        build_mod.reset_launches()
        losses = []
        for _ in range(2):
            m, opt, metrics = train_step(m, opt, {k: v.to(d) for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
        launches = {n: v for n, v in build_mod.LAUNCHES.items() if v}
        return ([p.detach().cpu() for p in m.parameters()],
                gradient_step(opt, float(metrics["lr"])), losses, launches)

    card, ref = two_steps(dev), two_steps(cpu)
    if dev.type == "cuda":
        check(card[3] == {"ssd_intra": 2 * n2, "ssd_intra_backward": 2 * n2},
              f"train step check: launches {card[3]}")
    changes = [c - s0 for c, s0 in zip(ref[0], start)]
    p_gap, p_leaf = leaf_gap(card[0], ref[0], changes)
    g_gap, g_leaf = leaf_gap(card[1], ref[1], ref[1])
    check(p_gap <= TRAIN_STEP_TOL, f"train step check: a card parameter is {p_gap:.2e} of its "
          f"leaf's largest change from the CPU's ({names[p_leaf]}; {TRAIN_STEP_TOL} allowed)")
    check(g_gap <= TRAIN_STEP_TOL, f"train step check: the card's gradient-driven step is "
          f"{g_gap:.2e} of its leaf's largest from the CPU's ({names[g_leaf]}; "
          f"{TRAIN_STEP_TOL} allowed)")
    top = max(float(u.abs().max()) for u in ref[1])
    print(f"train step: {small.name} at full width, 2 layers, f32, ({LOSS_CHECK[0]}, "
          f"{LOSS_CHECK[1]}), two steps at clip {TRAIN_CHECK_CLIP}, rate "
          f"{TRAIN_CHECK_LR['base_lr']}: losses card {card[2]}, CPU {ref[2]}; the largest "
          f"difference over its leaf's largest on the CPU: of a parameter against its change "
          f"{p_gap:.2e} ({names[p_leaf]}), of the gradient-driven step {g_gap:.2e} "
          f"({names[g_leaf]}) ({TRAIN_STEP_TOL} allowed for each; the largest gradient-driven "
          f"element {top:.2e} = {top / TRAIN_CHECK_LR['base_lr']:.2e} of the rate); the card "
          f"through {card[3]}", flush=True)

    # the control: the same card steps with the intra-chunk gradient dropped
    saved = kssd.SsdIntra.__dict__["backward"]
    kssd.SsdIntra.backward = staticmethod(
        lambda ctx, dy: tuple(torch.zeros_like(t) for t in ctx.saved_tensors))
    try:
        dropped = two_steps(dev)
    finally:
        kssd.SsdIntra.backward = saved
    cp_gap, cp_leaf = leaf_gap(dropped[0], ref[0], changes)
    cg_gap, cg_leaf = leaf_gap(dropped[1], ref[1], ref[1])
    check(cg_gap > TRAIN_STEP_TOL, f"train step check: with the intra-chunk gradient dropped "
          f"the gradient-driven step is still within {cg_gap:.2e} of the CPU's")
    print(f"train step: the control, the card's steps with SsdIntra's backward returning "
          f"zeros: the gradient-driven step {cg_gap:.2e} of its leaf's largest from the CPU's "
          f"({names[cg_leaf]}; fails the check, as it must), a parameter {cp_gap:.2e} of its "
          f"leaf's largest change ({names[cp_leaf]}; "
          f"{'fails' if cp_gap > TRAIN_STEP_TOL else 'passes'} the parameter check)", flush=True)


def pretrain_launches(cfg, steps, requests):
    """The launches ``collab_serve --reduced --pretrain steps`` makes: one
    ssd_intra forward and backward a mamba2 layer a step, then what
    ``serve`` makes at its split (``expected_launches``)."""
    want = expected_launches(cfg, cfg.n_layers // 2, requests)
    n_ssd = sum(bt == "mamba2" for bt in cfg.block_types())
    want["ssd_intra"] += steps * n_ssd
    want["ssd_intra_backward"] += steps * n_ssd
    return {n: v for n, v in want.items() if v}


def phase_pretrain(dev, collab_serve, build_mod):
    """A main path, the example's own: ``collab_serve --reduced --pretrain
    150`` (4 layers, d_model 256, batches of 16 x 32 tokens) for qwen3-1.7b
    and mamba2-1.3b, then 4 requests through the split forward: exactly the
    launches the path makes (``pretrain_launches``: 600 ssd_intra_backward
    for mamba2, none for qwen3), the final train loss and the top-1
    agreement of the compressed split forward held to PRETRAIN_LIMITS,
    beside the JAX example's on a CPU host. Returns the launches."""
    launches = collections.Counter()
    for arch in ("qwen3-1.7b", "mamba2-1.3b"):
        build_mod.reset_launches()
        t0 = time.perf_counter()
        res = collab_serve.main(["--arch", arch, "--reduced", "--pretrain", str(PRETRAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: v for n, v in build_mod.LAUNCHES.items() if v}
        want = pretrain_launches(res.model.cfg, PRETRAIN_STEPS, len(res.stats))
        check(got == want, f"pre-training {arch}: launches {got}, expected {want}")
        launches.update(got)
        loss = float(res.train_losses[-1])
        agree = sum(st["top1_agree"] for st in res.stats) / len(res.stats)
        check(math.isfinite(loss) and all(st["logits_finite"] for st in res.stats),
              f"pre-training {arch}: loss {loss}")
        ml, ma = PRETRAIN_LIMITS[arch]
        check(loss <= ml and agree >= ma, f"pre-training {arch}: final loss {loss:.3f}, "
              f"agreement {100 * agree:.1f}% (at most {ml}, at least {100 * ma:.0f}%)")
        jax_note = ""
        if arch in PRETRAIN_JAX:
            jl, ja = PRETRAIN_JAX[arch]
            jax_note = f"; the JAX example on a CPU host: {jl} and {100 * ja:.1f}%"
        print(f"pre-training: {arch} reduced, {PRETRAIN_STEPS} steps: final train loss "
              f"{loss:.3f}, top-1 agreement {100 * agree:.1f}% over {len(res.stats)} requests at "
              f"R={res.stats[0]['rate_R']:.0f}x (held to a loss of at most {ml} and an "
              f"agreement of at least {100 * ma:.0f}%{jax_note}); {wall:.1f} s; launches {got} "
              f"(as expected)", flush=True)
        del res
    return launches


def phase_train_lm(dev, train_lm):
    """The examples/train_lm.py twin at its defaults (12 layers, d_model
    768, vocab 8192, seq 256, batch 8, rate 1e-3, 20 steps of warmup) for
    TRAIN_LM_STEPS steps: every logged loss finite and the last below the
    first; its CSV and checkpoint under the ignored build/."""
    out = Path(__file__).resolve().parent / "build" / "train_lm"
    t0 = time.perf_counter()
    model, rows = train_lm.train(steps=TRAIN_LM_STEPS, out=str(out), log=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(math.isfinite(r["loss"]) for r in rows) and rows[-1]["loss"] < rows[0]["loss"],
          f"train_lm: losses {[r['loss'] for r in rows]}")
    n = sum(p.numel() for p in model.parameters())
    print(f"train_lm: {n / 1e6:.1f}M parameters, {TRAIN_LM_STEPS} steps in {wall:.1f} s: loss "
          f"{rows[0]['loss']:.4f} at step 1, {rows[-1]['loss']:.4f} at step {rows[-1]['step']}; "
          f"{rows[-1]['ms_per_step']:.1f} ms a step over the last 10 (host clock); "
          f"{out.name}/metrics.csv and final.npz written", flush=True)
    del model
    torch.cuda.empty_cache()


def phase_small_split(dev, cs, cfg, seq, init_params, pca):
    """The split forward at a small f32 config: card against CPU."""
    cpu = torch.device("cpu")
    model_cpu = init_params(cfg, torch.Generator().manual_seed(3), cpu)
    model_dev = init_params(cfg, torch.Generator().manual_seed(3), cpu).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        feats = cs.boundary_hidden(model_cpu, tokens, 2).reshape(-1, cfg.d_model)
        ae = pca(feats, cfg.d_model // 4)
        ae_dev = {k: v.to(dev) for k, v in ae.items()}
        want, want_bits = cs.run_split_forward(model_cpu, cfg, tokens, 2, ae)
        got, got_bits = cs.run_split_forward(model_dev, cfg, tokens.to(dev), 2, ae_dev)
        b_cpu = cs.ue_side(model_cpu, tokens, 2, ae)
        b_dev = cs.ue_side(model_dev, tokens.to(dev), 2, ae_dev)
    diff = code_diff(b_dev.codes.cpu(), b_cpu.codes)
    err = float((got.cpu() - want).abs().max())
    name = f"small split forward ({cfg.name}, {cfg.n_layers}L d={cfg.d_model}, seq {seq})"
    check(got_bits == want_bits, f"{name}: payload {got_bits} != {want_bits}")
    check(diff <= 1, f"{name}: codes differ by {diff}")
    # f32 through 4 blocks on two devices, plus at most one code at the boundary
    check(err <= 2e-3, f"{name}: logits differ by {err}")
    print(f"{name}: card vs CPU payload equal ({got_bits} bits), codes max {diff}, "
          f"logits max abs diff {err:.3e} (bound 2e-3)", flush=True)


def expected_launches(cfg, split, requests):
    """The launches ``serve`` makes: the calibration batch runs layers
    0..split; each request runs the uncompressed forward (all layers) and
    the split forward (all layers, one encode and one dequantize)."""
    ssd = lambda lo, hi: sum(bt == "mamba2" for bt in cfg.block_types()[lo:hi])
    n = cfg.n_layers
    return {"quantize": 0, "bottleneck_encode": requests, "dequantize": requests,
            "ssd_intra": ssd(0, split) + requests * (ssd(0, n) + ssd(0, n)),
            "pair_scorer": 0, "flat_trunk": 0, "decode_attention": 0,
            "pair_scorer_backward": 0, "ssd_intra_backward": 0}


def phase_serve(dev, cs, cfg, build_mod, kref):
    serve = SERVE[cfg.name]
    torch.cuda.reset_peak_memory_stats()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = cs.serve(cfg, device=dev, log=lambda s: print(f"serve: {s}", flush=True), **serve)
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    wall = time.perf_counter() - t0
    n, split = serve["requests"], cfg.n_layers // 2
    check(res.split == split, f"serve: split after layer {res.split}, expected {split}")
    want = expected_launches(cfg, split, n)
    for name in ROUTES:
        check(launches.get(name, 0) == want[name],
              f"serve {cfg.name}: {name} launched {launches.get(name, 0)} times, "
              f"expected {want[name]} for {n} requests")
    d_prime = cfg.d_model // cfg.bottleneck_ratio
    for st in res.stats:
        check(st["logits_finite"], f"serve: request {st['request']} has non-finite logits")
        check(st["logits_shape"] == (serve["batch"], serve["seq"], cfg.vocab_size),
              f"serve: logits shape {st['logits_shape']}")
        check(st["payload_kbit"] * 1e3 == serve["batch"] * serve["seq"] * d_prime * 8,
              f"serve: payload {st['payload_kbit']} kbit")
    with torch.inference_mode():
        tokens = res.requests[0]
        x = cs.boundary_hidden(res.model, tokens, res.split)
        b = cs.ue_side(res.model, tokens, res.split, res.ae, res.bits)
        oracle = kref.bottleneck_encode_ref(x.reshape(-1, cfg.d_model), res.ae["enc"],
                                            b.mn, b.mx, res.bits)
    diff = code_diff(b.codes.reshape(-1, d_prime), oracle)
    share = float((b.codes.reshape(-1, d_prime) != oracle).float().mean())
    check(diff <= 1, f"serve: boundary codes differ from the oracle by {diff}")
    print(f"serve: {cfg.name} ({cfg.n_layers} layers, {cfg.param_dtype}), {n} requests of "
          f"({serve['batch']}, {serve['seq']}) in {wall:.1f} s (calibration included), "
          f"launches {launches} as expected, boundary codes vs oracle max {diff} "
          f"({100 * share:.4f}% differ), logits finite {tuple(res.stats[0]['logits_shape'])}, "
          f"payload exact, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if cfg.moe is not None:
        print(f"serve: {cfg.name} split forward: MoE assignments dropped "
              f"{100 * res.stats[0]['moe_dropped']:.3f}% (capacity "
              f"{moe_capacity(cfg, serve['batch'] * serve['seq'])})", flush=True)
    return launches, res


# the CUDA kernels of each port kernel, as the profiler names them
KERNEL_NAMES = {"ssd_intra": ("ssd_intra_mma_kernel", "gram_kernel", "intra_kernel"),
                "bottleneck_encode": ("bottleneck_mma_kernel",),
                "dequantize": ("dequantize_vec_kernel",),
                "pair_scorer": ("pair_scorer_fused_kernel",),
                "flat_trunk": ("flat_trunk_persistent_kernel",),
                "pair_scorer_backward": ("pair_scorer_backward_kernel",),
                "ssd_intra_backward": ("ssd_bwd_mma_kernel", "ssd_bwd_pair_kernel",
                                       "ssd_bwd_dx_kernel", "ssd_bwd_finish_kernel"),
                "decode_attention": ("decode_attn_cluster_kernel",)}


def device_kernels(fn):
    """One torch.profiler window around ``fn`` (which synchronizes): the
    CUDA kernels it saw, and each one's device time in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return kernels, lambda e: getattr(e, "self_device_time_total", 0.0)


def profiled_ms(fn, calls=10):
    """Device time of one call of ``fn`` by the profiler: every CUDA kernel
    in one window around ``calls`` calls, over the calls, with the kernels'
    names (None if the profiler saw no device time)."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, us = device_kernels(run)
    total = sum(us(e) for e in kernels)
    names = ", ".join(f"{e.key[:40]} x{e.count}" for e in kernels)
    return (total / 1e3 / calls if total > 0 else None), names


def profile_device(label, fn, wall_ms, unit):
    """Profile one call of ``fn`` (torch.profiler): device time by kernel,
    launches and the idle share against ``wall_ms`` (informative: no check
    rests on it)."""
    fn()
    torch.cuda.synchronize()

    def run():
        fn()
        torch.cuda.synchronize()
    kernels, us = device_kernels(run)
    total = sum(us(e) for e in kernels)
    if total <= 0:
        print(f"profile: {label}: the profiler saw no device time", flush=True)
        return
    print(f"profile: {label}: one {unit}: {total / 1e3:.3f} ms of device time in "
          f"{sum(e.count for e in kernels)} kernel launches; median wall time "
          f"{wall_ms:.3f} ms, so the card idles {100 * (1 - total / 1e3 / wall_ms):.0f}% "
          f"of a {unit}", flush=True)
    for port_name, parts in KERNEL_NAMES.items():
        mine = [e for e in kernels if any(p in e.key for p in parts)]
        if mine:
            t = sum(us(e) for e in mine)
            names = ", ".join(f"{p} x{sum(e.count for e in mine if p in e.key)}" for p in parts
                              if any(p in e.key for e in mine))
            print(f"profile:   {port_name}: {t / 1e3:.4f} ms, {100 * t / total:.1f}% of device "
                  f"time, {sum(e.count for e in mine)} CUDA launches ({names})", flush=True)
    for e in sorted(kernels, key=us, reverse=True)[:8]:
        print(f"profile:   {us(e) / 1e3:8.4f} ms {100 * us(e) / total:5.1f}% "
              f"x{e.count:<4d} {e.key[:90]}", flush=True)


def phase_profile(cs, res):
    """Device time of one request's split forward, by kernel."""
    args = (res.model, res.model.cfg, res.requests[0], res.split, res.ae, res.bits)
    wall = statistics.median(st["split_forward_ms"] for st in res.stats)
    profile_device(res.model.cfg.name, lambda: cs.run_split_forward(*args), wall, "request")


# ------------------------------------------------------------- scheduling
def scorer_inputs(dev, g, n, e, dtype=torch.float32):
    """The pair scorer's inputs at the magnitudes of tests/test_kernels.py:
    the observation block in ``dtype``, the weights in float32."""
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    obs = [torch.tanh(r(n, 128)), 1 + 99 * u(n), 5e7 + 4.5e8 * u(n), (u(n) < 0.7).float(),
           0.5 + 1.5 * u(e, 3),
           torch.tensor([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e-12], device=dev)]
    return [t.to(dtype) for t in obs] + [r(4, 32) * 0.5, torch.zeros(32, device=dev),
                                         r(163, 48) * 0.1, torch.zeros(48, device=dev),
                                         r(48, 1) * 0.01, torch.zeros(1, device=dev)]


def trunk_inputs(dev, g, kq, bits, dims=TRUNK_DIMS):
    """A quantized trunk: (codes, mns, mxs, bs), the codes from the quantize
    kernel."""
    codes, mns, mxs, bs = [], [], [], []
    for d_in, d_out in zip(dims, dims[1:]):
        w = torch.randn((d_in, d_out), generator=g, device=dev) * 0.4
        mn, mx = float(w.min()), float(w.max())
        codes.append(kq.quantize_2d(w, mn, mx, bits=bits))
        mns.append(mn)
        mxs.append(mx)
        bs.append(torch.randn((d_out,), generator=g, device=dev) * 0.1)
    return codes, mns, mxs, bs


def phase_dispatch_kernels(dev, kps, kft, kq):
    """Hold pair_scorer and flat_trunk to their twins (the reference's
    tolerances: 1e-5 in f32, 5e-2 with bf16 inputs); returns max errors."""
    g = torch.Generator(device=dev).manual_seed(5)
    err = {"pair_scorer": 0.0, "flat_trunk": 0.0}
    for n, e in [(1, 1), (7, 2), (64, 3), (300, 5), (1024, 3), (1023, 3), (1025, 3), (1024, 8)]:
        for dtype in (torch.float32, torch.bfloat16):
            tol = 1e-5 if dtype == torch.float32 else 5e-2
            args = scorer_inputs(dev, g, n, e, dtype)
            (lk, sk), (lp, sp) = kps.pair_scorer(*args), kps.pair_scorer_plain(*args)
            torch.cuda.synchronize()
            for got, want, what in ((lk, lp, "logits"), (sk, sp, "server embeddings")):
                excess = float(((got - want).abs() - tol * want.abs()).max())
                check(excess <= tol, f"pair_scorer (N,E)=({n},{e}) {dtype} {what}: "
                      f"|kernel - plain| exceeds {tol} + {tol}|plain| by {excess - tol:.3e}")
            worst = max(float((lk - lp).abs().max()), float((sk - sp).abs().max()))
            err["pair_scorer"] = max(err["pair_scorer"], worst)
            print(f"kernels: pair_scorer (N,E)=({n},{e}) {str(dtype)[6:]}: max abs err "
                  f"{worst:.3e}, max |logit| {float(lp.abs().max()):.3e}, allowed {tol} + "
                  f"{tol}|plain| elementwise", flush=True)
    # the occupancy is the only coupling: equal occupancy, equal bits
    args = scorer_inputs(dev, g, 1024, 3)
    a1, a2 = torch.zeros(1024, device=dev), torch.zeros(1024, device=dev)
    a1[:300], a2[-300:] = 1.0, 1.0
    l1, _ = kps.pair_scorer(*args[:3], a1, *args[4:])
    l2, _ = kps.pair_scorer(*args[:3], a2, *args[4:])
    check(torch.equal(l1, l2), "pair_scorer: equal occupancy gave logits that are not bit-equal")
    check(torch.equal(l1, kps.pair_scorer(*args[:3], a1, *args[4:])[0]),
          "pair_scorer: the same call twice gave logits that are not bit-equal")
    print("kernels: pair_scorer (1024,3): two masks of equal occupancy give bit-equal logits; "
          "the same call twice gives the same bits", flush=True)
    for bits in (4, 8, 12):
        codes, mns, mxs, bs = trunk_inputs(dev, g, kq, bits)
        # a one-layer trunk on the identity rows with a zero bias returns
        # the kernel's dequantized weights exactly (x 1 and + 0 are exact)
        for c, mn, mx in zip(codes, mns, mxs):
            eye = torch.eye(c.shape[0], device=dev)
            w_kernel = kft.flat_trunk(eye, [c], [mn], [mx], [torch.zeros(c.shape[1], device=dev)],
                                      bits=bits)
            w_plain = kft.dequantized_weights(c, mn, mx, bits=bits)
            check(torch.equal(w_kernel, w_plain),
                  f"flat_trunk {bits}b: dequantized weights not bit-equal to the twin's")
        for rows in [(1,), (7,), (4, 8), (600,), (1024,), (10240,)]:
            for dtype in (torch.float32, torch.bfloat16):
                tol = 1e-5 if dtype == torch.float32 else 5e-2
                x = torch.randn((*rows, TRUNK_DIMS[0]), generator=g, device=dev).to(dtype)
                x2 = x.reshape(-1, TRUNK_DIMS[0])
                got = kft.flat_trunk(x2, codes, mns, mxs, bs, bits=bits)
                want = kft.flat_trunk_plain(x2, codes, mns, mxs, bs, bits=bits)
                torch.cuda.synchronize()
                excess = float(((got - want).abs() - tol * want.abs()).max())
                check(excess <= tol, f"flat_trunk {rows} {dtype} {bits}b: |kernel - plain| "
                      f"exceeds {tol} + {tol}|plain| by {excess - tol:.3e}")
                worst = float((got - want).abs().max())
                err["flat_trunk"] = max(err["flat_trunk"], worst)
                check(torch.equal(got, kft.flat_trunk(x2, codes, mns, mxs, bs, bits=bits)),
                      f"flat_trunk {rows} {dtype} {bits}b: the same call twice differs")
        print(f"kernels: flat_trunk {bits}b: dequantized weights bit-equal to the twin's; "
              f"rows 1, 7, 4x8, 600, 1024, 10240 in f32 and bf16 within the reference's "
              f"tolerance, the same bits from the same call twice (max abs err so far "
              f"{err['flat_trunk']:.3e})", flush=True)
    return err


def scorer_work(n, e, d_ue=128, s_dim=32, hid=48, b=1):
    """(bytes, flops) the least any pair scorer needs for ``b`` envs: each
    input read once (every env's UE rows, three per-UE vectors, geometry,
    the constants and weights once), the logits and embeddings written
    once; per env the ue term of the first layer once per UE, the server
    rows and their term once, and per pair the edge block, the hidden layer
    and the logit."""
    weights = 4 * s_dim + s_dim + (d_ue + s_dim + 3) * hid + 2 * hid + 1
    n_bytes = 4 * (b * (n * d_ue + 3 * n + 3 * e + n * e + e * s_dim) + 8 + weights)
    flops = b * (2 * n * d_ue * hid + e * (2 * 4 * s_dim + 2 * s_dim * hid)
                 + n * e * (2 * 3 * hid + 2 * hid))
    return n_bytes, flops


def trunk_work(m, dims=TRUNK_DIMS, code_bytes=1):
    """(bytes, flops): rows and codes read once, biases, the output written
    once; 2 M nin nout per layer."""
    pairs = list(zip(dims, dims[1:]))
    n_bytes = 4 * m * dims[0] + code_bytes * sum(a * b for a, b in pairs) \
        + 4 * sum(b for _, b in pairs) + 4 * m * dims[-1]
    return n_bytes, 2 * m * sum(a * b for a, b in pairs)


def dispatch_plans(kps, kft, sargs, targs, x):
    """The launch each wrapper plans for these inputs (a parent tree without
    planners: none)."""
    if not hasattr(kps, "plan"):
        return {}
    f32 = [a.to(torch.float32).contiguous() for a in sargs]
    (n, d_ue), e, s_dim, hid = f32[0].shape, f32[4].shape[0], f32[6].shape[1], f32[8].shape[1]
    out = {f"pair_scorer (N,E)=({n},{e})": kps.plan(n, e, d_ue, s_dim, hid,
                                                   kps.route(f32[0], f32[8]))}
    for m in x:
        out[f"flat_trunk M={m}"] = kft.launch_plan(x[m], targs[0], DISPATCH["bits"])
    return out


def phase_dispatch_timing(dev, kps, kft, kq):
    """Kernel, plain and bound times at the serving shapes (no single
    PyTorch call computes either function: no library time); beside them
    the launch floor (an empty kernel timed the same way, a yardstick the
    port never calls), each kernel's time above it, and its device time by
    the profiler."""
    g = torch.Generator(device=dev).manual_seed(6)
    n, e = DISPATCH["n_ue"], DISPATCH["n_servers"]
    sargs = scorer_inputs(dev, g, n, e)
    targs = trunk_inputs(dev, g, kq, DISPATCH["bits"])
    x = {m: torch.randn((m, TRUNK_DIMS[0]), generator=g, device=dev)
         for m in (n, 10 * n, STREAM_M)}
    rows = {f"pair_scorer (N,E)=({n},{e})": ("pair_scorer", lambda: kps.pair_scorer(*sargs),
                                             lambda: kps.pair_scorer_plain(*sargs),
                                             scorer_work(n, e))}
    for m in x:
        rows[f"flat_trunk M={m}"] = ("flat_trunk", lambda m=m: kft.flat_trunk(x[m], *targs),
                                     lambda m=m: kft.flat_trunk_plain(x[m], *targs),
                                     trunk_work(m))
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    print(f"timing: launch floor (an empty kernel, torch.cuda._sleep(0)): {floor_ms:.5f} ms",
          flush=True)
    plans = dispatch_plans(kps, kft, sargs, targs, x)
    out = {}
    for label, (name, kernel, plain, work) in rows.items():
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        prof_ms, prof_names = profiled_ms(kernel)
        bound_ms, bound_by = bound(*work)
        prof = "not measured" if prof_ms is None else f"{prof_ms:.5f} ms ({prof_names})"
        print(f"timing: {label}: kernel {ms:.5f} ms, {ms - floor_ms:.5f} ms above the launch "
              f"floor, profiler {prof} a call, plain {plain_ms:.5f} ms, library none, "
              f"bound {bound_ms:.7f} ms ({bound_by}), {100 * bound_ms / ms:.2f}% of bound",
              flush=True)
        if label in plans:
            print(f"timing: {label}: {plans[label]}", flush=True)
        if name == "flat_trunk":
            # its products run on the FP64 tensor cores (mma.m8n8k4)
            print(f"timing: {label}: bound on the FP64 tensor cores "
                  f"{bound(*work, FP64_TC_FLOP_PER_S)[0]:.5f} ms (operations)", flush=True)
        if name not in out:    # the serving shape goes to the JSON line
            out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                             bound_by=bound_by)
    return out


def scale_last_layers(actor, trunk, factor):
    """Scale the last layer of every head, the scorer and the trunk, so no
    two choices nearly tie and card and CPU must pick the same."""
    with torch.no_grad():
        for mlp in list(actor.heads.values()) + [actor.scorer, trunk]:
            mlp.layers[-1].w.mul_(factor)
            mlp.layers[-1].b.mul_(factor)


def draw_on_host(env, seed):
    """Make ``env``'s resets draw (an eval reset draws nothing, so batched
    eval episodes would all be one episode), each call's queues and
    distances from a CPU generator seeded with ``seed`` and the call's
    number: the same variates on the card and on the CPU, and every env
    its own."""
    p, calls = env.params, [0]

    def tasks(gen, shape):
        g = torch.Generator().manual_seed(seed + calls[0])
        calls[0] += 1
        k = torch.poisson(torch.full(shape, p.lam_tasks), generator=g)
        d = p.d_low + torch.rand(shape, generator=g) * (p.d_high - p.d_low)
        return k.to(env.device), d.to(env.device)

    reset = env.reset
    env._draw_tasks = tasks
    env.reset = lambda gen=None, **kw: reset(gen, **dict(kw, eval_mode=False))


def phase_small_dispatch(dev, ds, mahppo, quantize_flat_trunk, n_envs=1):
    """The scheduling path at N = 16, E = 3, 8 frames: card against CPU
    from the same weights and states. With ``n_envs`` > 1 the eval episodes
    are batched and each env starts from its own drawn queues and
    distances (``draw_on_host``), so envs that were mixed up would
    differ from the CPU's."""
    runs = {}
    for d in (dev, torch.device("cpu")):
        env = ds.dispatch_env(16, 3, d)
        if n_envs > 1:
            draw_on_host(env, seed=9)
        actor, trunk = ds.init_agents(env, seed=3)
        scale_last_layers(actor, trunk, 1000.0)
        agents = {"entity": ({"entity_actor": actor}, True),
                  "int8 trunk": ({"flat_trunk": quantize_flat_trunk(trunk)}, False)}
        runs[d.type] = {}
        for name, (agent, fused) in agents.items():
            trace = []
            st = mahppo.evaluate_policy(env, agent, frames=8, fused_scorer=fused, trace=trace,
                                        n_envs=n_envs)
            runs[d.type][name] = (st, trace)
    for name in runs["cpu"]:
        (st_d, tr_d), (st_c, tr_c) = runs[dev.type][name], runs["cpu"][name]
        if n_envs > 1:
            rewards = torch.stack([fr["reward"] for fr in tr_c])       # (frames, n_envs)
            check(all(not torch.equal(rewards[:, 0], rewards[:, i]) for i in range(1, n_envs)),
                  f"small dispatch {name}: two batched envs ran the same episode")
        worst, margin = 0.0, float("inf")
        for fd, fc in zip(tr_d, tr_c):
            for head, a in fc["actions"].items():
                got = fd["actions"][head].cpu()
                if head == "power":
                    check(torch.allclose(got, a, rtol=1e-5, atol=1e-5), f"{name}: power differs")
                else:
                    check(torch.equal(got, a), f"small dispatch {name}: {head} actions differ")
                    top = torch.topk(fc["dist"][head], 2, dim=-1).values
                    margin = min(margin, float((top[..., 0] - top[..., 1]).min()))
            for head, v in fc["dist"].items():
                pairs = [(fd["dist"][head][k], v[k]) for k in ("mu", "log_std")] \
                    if isinstance(v, dict) else [(fd["dist"][head], v)]
                for got, want in pairs:
                    excess = float(((got.cpu() - want).abs() - 1e-5 * want.abs()).max())
                    check(excess <= 1e-5, f"small dispatch {name}: {head} differs from the CPU "
                          f"by more than 1e-5 + 1e-5|cpu|")
                    worst = max(worst, float((got.cpu() - want).abs().max()))
        for k, v in st_c.items():
            check(abs(st_d[k] - v) <= 1e-5 * abs(v), f"small dispatch {name}: {k} "
                  f"{st_d[k]} on the card, {v} on the CPU")
        print(f"small dispatch ({name}, N=16, E=3, 8 frames, {n_envs} env"
              f"{'s, each its own drawn episode' if n_envs > 1 else ''}): card vs CPU actions equal "
              f"(least top-2 margin {margin:.3e}), logits max abs diff {worst:.3e} (bound "
              f"1e-5 + 1e-5|cpu|), summary within 1e-5 relative: completed "
              f"{st_d['completed']:.2f}/frame, t_task {st_d['t_task']:.6f} s", flush=True)


def phase_dispatch_serve(dev, ds, build_mod):
    """The scheduling main path at the slice's configuration."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = ds.serve_dispatch(device=dev, log=lambda m: print(f"dispatch: {m}", flush=True),
                            **DISPATCH)
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    wall = time.perf_counter() - t0
    frames = DISPATCH["frames"]
    want = {name: 0 for name in ROUTES}
    want.update(pair_scorer=frames, flat_trunk=frames, quantize=len(TRUNK_DIMS) - 1)
    for name in ROUTES:
        check(launches.get(name, 0) == want[name], f"dispatch: {name} launched "
              f"{launches.get(name, 0)} times, expected {want[name]}")
    for name, st in res.stats.items():
        check(all(math.isfinite(v) for v in st.values()), f"dispatch {name}: {st}")
        check(st["n_active"] == DISPATCH["n_ue"] and st["done"] == 0.0,
              f"dispatch {name}: {st['n_active']} active, done {st['done']}")
        check(st["t_task"] > 0 and st["e_task"] > 0, f"dispatch {name}: {st}")
    print(f"dispatch: {DISPATCH['n_ue']} UEs x {frames} frames, both agents, in {wall:.1f} s "
          f"(tables and quantization included), launches {launches} as expected", flush=True)
    return launches, res


def phase_dispatch_profile(mahppo, res):
    """One profiled frame of each agent."""
    for name, (agent, fused) in res.agents.items():
        profile_device(f"dispatch {name}", lambda: mahppo.evaluate_policy(
            res.env, agent, frames=1, fused_scorer=fused), res.stats[name]["ms_per_frame"],
            "frame")

# ------------------------------------------------- the scorer's envs and backward
def grad_inputs(dev, g, b, n, e, dtype=torch.float32):
    """Batched scorer inputs at the training path's magnitudes (slowness in
    s/FLOP and edge work in FLOPs, so every edge feature is O(1) and the
    hidden layer does not saturate); the observation block in ``dtype``."""
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    geom = torch.stack([0.9 + 1.1 * u(b, e), 0.5 + 0.75 * u(b, e), 4.2e-12 * u(b, e)], -1)
    obs = [torch.tanh(r(b, n, 128)), 1 + 99 * u(b, n), 1e8 + 4.9e9 * u(b, n),
           (u(b, n) < 0.7).float(), geom]
    consts = torch.tensor([3.0, 0.5, 1e-9, 0.1, 0.5, e * 2.0, 100.0, 1e12], device=dev)
    return [t.to(dtype) for t in obs] + [consts, r(4, 32) * 0.5, r(32) * 0.1, r(163, 48) * 0.1,
                                         r(48) * 0.1, r(48, 1) * 0.3, r(1)]


SCORER_GRADS = (0, 6, 7, 8, 9, 10, 11)      # ue_emb and the weights


def float64_grads(kps, args, g_logits, g_srv):
    """Autograd of the plain twin in float64 from the same inputs."""
    wide = [a.detach().double().requires_grad_(i in SCORER_GRADS) for i, a in enumerate(args)]
    logits, srv = kps.pair_scorer_plain(*wide)
    loss = (logits * g_logits.double()).sum() + (srv * g_srv.double()).sum()
    return torch.autograd.grad(loss, [wide[i] for i in SCORER_GRADS])


def grad_excess(got, want, bf16_ue):
    """The largest amount by which a gradient exceeds 1e-5 of its largest
    magnitude (d ue in bf16: plus one bf16 step, 2^-7 of the element), and
    the largest such relative difference."""
    excess, rel = -float("inf"), 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.double(), b.double()
        top = float(b.abs().max())
        tol = 1e-5 * top + (2.0 ** -7 * b.abs() if bf16_ue and i == 0 else 0.0)
        excess = max(excess, float(((a - b).abs() - tol).max()))
        rel = max(rel, float((a - b).abs().max()) / max(top, 1e-30))
    return excess, rel


def phase_scorer_backward(dev, kps, build_mod):
    """(a) The backward kernel against its plain formula and a float64 twin
    at every shape of the fleet demo's path and beyond, in f32 and with bf16
    observations, and the same bits from the same call twice; (b) the
    batched forward against B single-env launches (bitwise) and its twin.
    Returns (backward max abs error, forward max abs error)."""
    g = torch.Generator(device=dev).manual_seed(31)
    err_b = err_f = 0.0
    for label, (b, n, e) in SCORER_GRAD_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = grad_inputs(dev, g, b, n, e, dtype)
            g_l = torch.randn((b, n, e), generator=g, device=dev)
            g_s = torch.randn((b, e, 32), generator=g, device=dev)
            build_mod.reset_launches()
            _, srv = kps.pair_scorer(*args)
            got = kps.pair_scorer_backward(g_l, g_s, *args, srv=srv)
            again = kps.pair_scorer_backward(g_l, g_s, *args, srv=srv)
            torch.cuda.synchronize()
            check(dict(build_mod.LAUNCHES) == {"pair_scorer": 1, "pair_scorer_backward": 2},
                  f"scorer backward {label}: launches {dict(build_mod.LAUNCHES)}")
            check(got[0].dtype == dtype, f"scorer backward {label}: d ue is {got[0].dtype}")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"scorer backward {label} {dtype}: the same call twice gave other bits")
            bf16 = dtype == torch.bfloat16
            plain = kps.pair_scorer_backward_plain(g_l, g_s, *args)
            ex_p, rel_p = grad_excess(got, plain, bf16)
            ex_w, rel_w = grad_excess(got, float64_grads(kps, args, g_l, g_s), bf16)
            check(ex_p <= 0 and ex_w <= 0, f"scorer backward {label} (B,N,E)=({b},{n},{e}) "
                  f"{dtype}: beyond 1e-5 of a gradient's largest (by {ex_p:.2e} against the "
                  f"formula, {ex_w:.2e} against float64)")
            if not bf16:
                err_b = max(err_b, max(float((x - y).abs().max()) for x, y in zip(got, plain)))
            print(f"kernels: pair_scorer_backward {label} (B,N,E)=({b},{n},{e}) "
                  f"{str(dtype)[6:]}: largest difference over a gradient's largest "
                  f"{rel_p:.2e} against the formula, {rel_w:.2e} against float64 (1e-5 "
                  f"allowed{', d ue plus one bf16 step' if bf16 else ''}); the same bits twice",
                  flush=True)
    for b, n, e in [(4, 4, 2), (256, 4, 2), (3, 37, 3), (2, 1025, 5)]:
        args = grad_inputs(dev, g, b, n, e)
        logits, srv = kps.pair_scorer(*args)
        single = [kps.pair_scorer(*(a[i] for a in args[:5]), *args[5:]) for i in range(b)]
        lp, sp = kps.pair_scorer_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(logits[i], l1) and torch.equal(srv[i], s1)
                  for i, (l1, s1) in enumerate(single)),
              f"pair_scorer (B,N,E)=({b},{n},{e}): the batched launch differs from B single "
              f"launches")
        worst = max(float((logits - lp).abs().max()), float((srv - sp).abs().max()))
        excess = max(float(((logits - lp).abs() - 1e-5 * lp.abs()).max()),
                     float(((srv - sp).abs() - 1e-5 * sp.abs()).max()))
        check(excess <= 1e-5, f"pair_scorer (B,N,E)=({b},{n},{e}): |kernel - plain| exceeds "
              f"1e-5 + 1e-5|plain| by {excess - 1e-5:.2e}")
        err_f = max(err_f, worst)
        print(f"kernels: pair_scorer batched (B,N,E)=({b},{n},{e}): bit-equal to {b} single-env "
              f"launches; against the twin max abs err {worst:.3e} (1e-5 + 1e-5|plain|)",
              flush=True)
    return err_b, err_f


def scorer_grad_work(b, n, e, d_ue=128, s_dim=32, hid=48):
    """(bytes, flops) the least the backward (with its two W1u products)
    needs: the inputs (ue rows, three per-UE vectors, geometry, constants,
    W1, b1, w2, the forward's embeddings, both incoming gradients) read
    once, d ue and the weight gradients written once; the ue and server
    terms of the first layer, per (pair, hidden unit) the edge term, the
    sum, da and g h (12 flops) and its five reductions (10), the server
    side's products and the two W1u products."""
    k1 = d_ue + s_dim + 3
    n_bytes = 4 * (b * n * d_ue + 3 * b * n + 3 * b * e + 8 + k1 * hid + 2 * hid
                   + 2 * b * e * s_dim + b * n * e
                   + b * n * d_ue + 5 * s_dim + k1 * hid + 2 * hid + 1)
    flops = (2 * b * n * d_ue * hid + 2 * b * e * s_dim * hid + 22 * b * n * e * hid
             + 2 * 2 * b * e * s_dim * hid + 2 * 4 * b * e * s_dim
             + 2 * 2 * b * n * d_ue * hid)
    return n_bytes, flops


def phase_scorer_timing(dev, kps):
    """(c) The batched forward and the backward at the fleet demo's rollout
    and minibatch shapes and the dispatch shape: kernel, plain and bound
    times, beside the launch floor, and each call's kernels by the profiler
    (no single PyTorch call computes either: no library time). The backward
    is timed as the path calls it (with a parent tree, its kernel and the
    two W1u GEMMs)."""
    g = torch.Generator(device=dev).manual_seed(32)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    out = {}
    for label in ("rollout", "minibatch", "dispatch"):
        b, n, e = SCORER_GRAD_SHAPES[label]
        args = grad_inputs(dev, g, b, n, e)
        g_l = torch.randn((b, n, e), generator=g, device=dev)
        g_s = torch.randn((b, e, 32), generator=g, device=dev)
        srv = kps.pair_scorer(*args)[1]
        fwd_bytes, fwd_flops = scorer_work(n, e)
        weights = 4 * (4 * 32 + 32 + 163 * 48 + 2 * 48 + 1)
        rows = {"pair_scorer": (lambda: kps.pair_scorer(*args),
                                lambda: kps.pair_scorer_plain(*args),
                                (b * (fwd_bytes - weights) + weights, b * fwd_flops)),
                "pair_scorer_backward": (
                    lambda: kps.pair_scorer_backward(g_l, g_s, *args, srv=srv),
                    lambda: kps.pair_scorer_backward_plain(g_l, g_s, *args),
                    scorer_grad_work(b, n, e))}
        for name, (kernel, plain, work) in rows.items():
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            prof_ms, names = profiled_ms(kernel)
            bound_ms, bound_by = bound(*work)
            prof = "not measured" if prof_ms is None else f"{prof_ms:.5f} ms ({names})"
            print(f"timing: {name} {label} (B,N,E)=({b},{n},{e}): kernel {ms:.5f} ms, "
                  f"{ms - floor_ms:.5f} ms above the launch floor ({floor_ms:.5f}), profiler "
                  f"{prof} a call, plain {plain_ms:.5f} ms, library none, bound "
                  f"{bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of bound",
                  flush=True)
            if name == "pair_scorer_backward" and label == "minibatch":
                out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                                 bound_by=bound_by)
        if hasattr(kps, "backward_plan"):
            print(f"timing: pair_scorer_backward {label}: "
                  f"{kps.backward_plan(b, n, e, 128, 32, 48, dev, kps.route(args[0], args[8]))}",
                  flush=True)
    return out


def fleet_demo_launches(cfg):
    """The scorer launches of ``train_mahppo`` under ``cfg`` (the demo's
    evaluations take the unfused path): each iteration's rollout, one
    forward a step and one for the last values, and each minibatch step's
    forward and backward."""
    steps = cfg.horizon // cfg.n_envs
    m = steps * cfg.n_envs
    updates = cfg.reuse * max(m // min(cfg.batch, m), 1)
    return {"pair_scorer": cfg.iterations * (steps + 1 + updates),
            "pair_scorer_backward": cfg.iterations * updates}


def phase_fleet_demo(dev, fleet_demo, build_mod):
    """(d) The fleet demo at its defaults (the entity agent through the
    scorer kernels over resampled geometry), seed 0, as a user runs it:
    every reward finite, the scorer's launches exactly those the path
    makes, no other kernel."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = fleet_demo.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    cfg = fleet_demo.fleet_config(len(res["history"]), entity_policy=True, randomize_pool=True,
                                  fused_scorer=True)
    want = fleet_demo_launches(cfg)
    check(launches == want, f"fleet demo: launches {launches}, expected {want}")
    hist = res["history"]
    check(len(hist) == 15 and all(math.isfinite(r["reward_mean"]) for r in hist),
          f"fleet demo: rewards {[r['reward_mean'] for r in hist]}")
    beta = res["env"].params.beta
    ovh = res["mahppo"]["t_task"] + beta * res["mahppo"]["e_task"]
    values = [ovh, res["greedy"]["overhead"], res["nearest"]["overhead"],
              res["loadbal"]["overhead"], res["zero_shot"]["overhead"],
              res["zero_shot"]["nearest"]["overhead"]]
    check(all(math.isfinite(v) for v in values), f"fleet demo: overheads {values}")
    print(f"fleet demo: 15 iterations in {res['seconds']:.1f} s ({wall:.1f} s with the "
          f"evaluations and baselines), launches {launches} as expected; reward "
          f"{hist[0]['reward_mean']:.4f} -> {hist[-1]['reward_mean']:.4f}; overhead MAHPPO "
          f"{ovh:.4f}, greedy {values[1]:.4f}, nearest {values[2]:.4f}, load-balanced "
          f"{values[3]:.4f}; zero-shot on 3 servers {values[4]:.4f} against nearest "
          f"{values[5]:.4f}", flush=True)
    return launches, res


def phase_fleet_timing(dev, fleet_demo, mahppo, optim, build_mod, res):
    """Seconds per iteration of the demo's training (rollout and update
    apart, synchronized), one profiled iteration, rollout and update; then
    (e) one fused update on the card held to the same update on the CPU
    (test_torch_scorer_grad.py's configuration: horizon 64, 2 envs, batch
    32), each leaf's change within 1e-3 of its largest, the scorer's last
    bias (a zero gradient in exact arithmetic) to AdamW's bound of lr a
    step."""
    env = res["env"]
    cfg = fleet_demo.fleet_config(TRAIN_TIMED, entity_policy=True, randomize_pool=True,
                                  fused_scorer=True)
    fns = mahppo.make_train_fns(env, cfg)
    agent = res["agent"]
    opt = optim.adamw_init(mahppo.agent_parameters(agent))
    states = mahppo.init_states(env, cfg, torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    rollout, update = [], []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, traj, last_v = fns.collect(agent, gen, states)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fns.update(agent, opt, gen, traj, last_v)
        torch.cuda.synchronize()
        rollout.append(1e3 * (t1 - t0))
        update.append(1e3 * (time.perf_counter() - t1))
    print("fleet demo: ms an iteration (rollout + update, synchronized): "
          + ", ".join(f"{r:.1f} + {u:.1f}" for r, u in zip(rollout, update)), flush=True)
    wall_r, wall_u = statistics.median(rollout), statistics.median(update)
    box = {"states": states}

    def one_iteration():
        box["states"] = fns.iteration(agent, opt, gen, box["states"])[2]

    def one_rollout():
        box["traj"] = fns.collect(agent, gen, box["states"])

    profile_device("fleet demo iteration", one_iteration, wall_r + wall_u, "iteration")
    profile_device("fleet demo rollout", one_rollout, wall_r, "rollout")
    _, traj, last_v = box["traj"]
    profile_device("fleet demo update", lambda: fns.update(agent, opt, gen, traj, last_v),
                   wall_u, "update")

    env_cpu = fleet_demo.fleet_env(fleet_demo.make_mixed_fleet(), fleet_demo.make_edge_pool(2),
                                   randomize=True, device="cpu")
    small = mahppo.MAHPPOConfig(horizon=64, n_envs=2, batch=32, entity_policy=True,
                                randomize_pool=True, fused_scorer=True)
    agent0 = mahppo.init_agent(torch.Generator().manual_seed(3), env, entity_policy=True)
    states0 = mahppo.init_states(env, small, torch.Generator(device=dev).manual_seed(4))
    _, traj0, last_v0 = mahppo.make_train_fns(env, small).collect(agent0, gen, states0)
    n_updates = small.reuse * max(small.horizon // small.batch, 1)
    keys = torch.rand((n_updates, small.horizon), generator=gen, device=dev)
    idx = torch.argsort(keys, dim=-1)[:, :small.batch]
    shift = [p is agent0["entity_actor"].scorer.layers[-1].b
             for p in mahppo.agent_parameters(agent0)].index(True)
    moved = {run: update_moves(mahppo, optim, mahppo.make_train_fns(e, small), agent0, traj0,
                               last_v0, idx, d, dt)
             for run, e, d, dt in (("card", env, dev, torch.float32),
                                   ("cpu", env_cpu, torch.device("cpu"), torch.float32),
                                   ("cpu64", env_cpu, torch.device("cpu"), torch.float64))}
    worst = {pair: max(float((x - y).abs().max() / y.abs().max())
                       for i, (x, y) in enumerate(zip(moved[pair[0]], moved[pair[1]]))
                       if i != shift)
             for pair in (("card", "cpu"), ("card", "cpu64"), ("cpu", "cpu64"))}
    bias_step = float(moved["card"][shift].abs().max())
    print(f"fleet demo: one fused update (horizon 64, 2 envs, batch 32, {n_updates} AdamW "
          f"steps), the largest difference of a leaf's change over that leaf's largest: "
          + ", ".join(f"{x} against {y} {r:.2e}" for (x, y), r in worst.items())
          + f" (cpu64: float64 forward and backward); the scorer's last bias moved "
            f"{bias_step:.2e} (bound {n_updates * small.lr:.1e})", flush=True)
    check(worst[("card", "cpu")] <= 1e-3,
          f"fleet demo: the card's update is {worst[('card', 'cpu')]:.2e} of a leaf's largest "
          f"change from the CPU's (1e-3 allowed)")
    check(bias_step <= n_updates * small.lr * (1 + 1e-5),
          f"fleet demo: the scorer's last bias moved {bias_step:.2e}")


def phase_fleet_churn(dev, fleet_demo, build_mod):
    """The fleet demo on a dynamic fleet, ``fleet_demo --churn`` (join
    intensity 0.2, leave probability 0.1 a frame), the way a user runs it:
    the scorer's launches exactly those of the static demo (churn adds
    none), every reward and overhead finite, a membership trace with a leave
    and a join, and a mean evaluated fleet strictly between 0 and N."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = fleet_demo.main(["--churn"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    cfg = fleet_demo.fleet_config(len(res["history"]), entity_policy=True, randomize_pool=True,
                                  fused_scorer=True)
    want = fleet_demo_launches(cfg)
    check(launches == want, f"churned fleet demo: launches {launches}, expected {want}")
    hist, env = res["history"], res["env"]
    check(env.dynamic and len(hist) == 15
          and all(math.isfinite(r["reward_mean"]) for r in hist),
          f"churned fleet demo: rewards {[r['reward_mean'] for r in hist]}")
    n = env.params.n_ue
    rows = ["#" * n] + res["membership"]         # the reset's fleet is whole
    leaves = sum(a == "#" and b == "." for r0, r1 in zip(rows, rows[1:]) for a, b in zip(r0, r1))
    joins = sum(a == "." and b == "#" for r0, r1 in zip(rows, rows[1:]) for a, b in zip(r0, r1))
    check(leaves >= 1 and joins >= 1,
          f"churned fleet demo: {leaves} leaves and {joins} joins in {res['membership']}")
    fleet = res["mahppo"]["n_active"]
    check(0 < fleet < n, f"churned fleet demo: mean evaluated fleet {fleet} of {n}")
    beta = env.params.beta
    ovh = res["mahppo"]["t_task"] + beta * res["mahppo"]["e_task"]
    values = [ovh, res["greedy"]["overhead"], res["nearest"]["overhead"],
              res["loadbal"]["overhead"], res["zero_shot"]["overhead"]]
    check(all(math.isfinite(v) for v in values), f"churned fleet demo: overheads {values}")
    print(f"churned fleet demo: {len(hist)} iterations in {res['seconds']:.1f} s ({wall:.1f} s "
          f"with the trace, evaluations and baselines; "
          f"{1e3 * res['seconds'] / len(hist):.1f} ms an iteration), launches {launches} as "
          f"expected; membership trace {leaves} leaves, {joins} joins; "
          f"mean evaluated fleet {fleet:.2f} of {n}; reward {hist[0]['reward_mean']:.4f} -> "
          f"{hist[-1]['reward_mean']:.4f}; overhead MAHPPO {ovh:.4f}, and on the traced "
          f"membership {res['snapshot'].astype(int).tolist()} greedy {values[1]:.4f}, nearest "
          f"{values[2]:.4f}, load-balanced {values[3]:.4f}; zero-shot on 3 servers "
          f"{values[4]:.4f}", flush=True)
    return launches, res


def phase_fleet_distill(dev, fleet_demo, build_mod):
    """``fleet_demo --distill`` at the example's settings, as a user runs
    it: it trains its own teacher (the default demo's 15 iterations through
    the scorer kernels; phase 15's agent is not reused), distills it on the
    static pool, quantizes the student (exactly 3 ``quantize`` launches),
    scores the int8 student (one ``flat_trunk`` launch an eval frame, 64)
    and times the batch-1 forwards (one warm call and 20 timed of each);
    every loss and the int8-over-teacher overhead ratio finite."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = fleet_demo.main(["--distill"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    d = res["distill"]
    cfg = fleet_demo.fleet_config(len(res["history"]), entity_policy=True, randomize_pool=True,
                                  fused_scorer=True)
    want = fleet_demo_launches(cfg)
    want.update(quantize=len(d["qstudent"]["qlayers"]),
                flat_trunk=64 + 1 + fleet_demo.READOUT_CALLS)
    check(launches == want, f"fleet demo --distill: launches {launches}, expected {want}")
    hist = d["history"]
    check(len(hist) == fleet_demo.DISTILL.iterations
          and all(math.isfinite(h["loss"]) for h in hist), f"fleet demo --distill: {hist}")
    ratio = d["overhead"]["int8"] / d["overhead"]["teacher"]
    check(math.isfinite(ratio), f"fleet demo --distill: overheads {d['overhead']}")
    rounds = "; ".join(f"round {h['iteration']}: {h['states']} states, loss {h['loss']:.4f}, "
                       f"agreement {h['agreement']:.3f}" for h in hist)
    fwd = ", ".join(f"{k} {v:.1f} us" for k, v in d["forward_us"].items())
    print(f"fleet demo --distill: {len(res['history'])} teacher iterations in "
          f"{res['seconds']:.1f} s, distillation in {d['seconds']:.1f} s ({wall:.1f} s in all), "
          f"launches {launches} as expected; {rounds}; int8 overhead {d['overhead']['int8']:.4f} "
          f"against the teacher's {d['overhead']['teacher']:.4f} (ratio {ratio:.3f}); "
          f"parameters {d['params']}; batch-1 forward (best of {fleet_demo.READOUT_CALLS}): "
          f"{fwd}", flush=True)
    return launches, res


def phase_fleet_llm(dev, fleet_demo, build_mod):
    """``fleet_demo --llm`` at the example's settings: the mixed CNN +
    LLM-decode fleet trained through the scorer kernels, exactly the
    launches its iterations make, every reward and overhead finite; prints
    each UE's split and the context-length shift."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = fleet_demo.main(["--llm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    cfg = fleet_demo.fleet_config(len(res["history"]), entity_policy=True, fused_scorer=True)
    want = fleet_demo_launches(cfg)
    check(launches == want, f"fleet demo --llm: launches {launches}, expected {want}")
    hist, env = res["history"], res["env"]
    check(len(hist) == 15 and all(math.isfinite(r["reward_mean"]) for r in hist),
          f"fleet demo --llm: rewards {[r['reward_mean'] for r in hist]}")
    beta = env.params.beta
    ovh = res["mahppo"]["t_task"] + beta * res["mahppo"]["e_task"]
    values = [ovh, res["greedy"]["overhead"], res["nearest"]["overhead"],
              res["loadbal"]["overhead"]]
    check(all(math.isfinite(v) for v in values), f"fleet demo --llm: overheads {values}")
    local = env.n_actions_b - 1
    splits = ", ".join(f"ue{i} b={b}{' (local)' if b == local else ''}"
                       for i, b in enumerate(res["splits"].tolist()))
    print(f"fleet demo --llm: {len(hist)} iterations in {res['seconds']:.1f} s ({wall:.1f} s in "
          f"all), launches {launches} as expected; reward {hist[0]['reward_mean']:.4f} -> "
          f"{hist[-1]['reward_mean']:.4f}; overhead MAHPPO {ovh:.4f}, greedy {values[1]:.4f}, "
          f"nearest {values[2]:.4f}, load-balanced {values[3]:.4f}; splits {splits}; "
          f"context-length shift {'YES' if res['llm_shift'] else 'not yet at this budget'}",
          flush=True)
    return launches, res


def stream_report_ok(name, rep, core):
    """A well-formed report of a drained stream."""
    led = core.ledger()
    check(set(rep) == STREAM_REPORT_KEYS, f"streaming {name}: report keys {sorted(rep)}")
    check(led["queued"] == led["in_flight"] == 0
          and led["arrivals"] == led["completed"] + led["dropped"] == rep["tasks"]
          == rep["arrivals"] > 0, f"streaming {name}: ledger {led}, report {rep}")
    check(0.0 <= rep["miss_rate"] <= 1.0 and 0.0 <= rep["drop_rate"] <= 1.0
          and math.isfinite(rep["throughput"]), f"streaming {name}: {rep}")


def dispatch_wall_ms(disp, core, calls=20):
    """Median wall time of one dispatch decision on ``core``'s state."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        disp(core, 0)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_streaming(dev, streaming_serve, distill, adapter, dispatcher, events, build_mod):
    """The streaming runtime, a main path: the ``streaming_serve`` twin at
    its defaults (8 UEs, 2 servers, MAHPPO 30 iterations, the fine-tune 14,
    then 10 s of Poisson arrivals at 8 tasks/s a UE through the asyncio
    daemon for the tuned entity policy, its zero-shot form, nearest-server
    and full-local), then the oracle on the same arrivals, then the tuned
    teacher distilled on the static pool and quantized (3 ``quantize``
    launches), and the same arrivals through ``TrunkDispatcher(int8)``:
    exactly one ``flat_trunk`` launch a dispatch and no other kernel. Every
    ledger balanced and every report well formed; the daemon and the event
    heap give identical records on the card for the full-local and greedy
    dispatchers. Prints each report, the seconds of each part, dispatches a
    second, host syncs a dispatch, and one profiled dispatch of the entity,
    oracle and int8 trunk dispatchers (device time and idle share)."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = streaming_serve.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    check(not launches, f"streaming serve: kernels launched {launches}, expected none")
    env, sp, seed = res["env"], res["sp"], 0
    tune = res["tune_history"]
    check(len(res["history"]) == 30 and len(tune) == 14
          and all(math.isfinite(h["reward_mean"]) for h in res["history"] + tune),
          f"streaming serve: {len(res['history'])} MAHPPO and {len(tune)} tune iterations")
    reports, cores, secs = dict(res["reports"]), dict(res["cores"]), dict(res["seconds"])
    oracle = adapter.StreamOracleDispatcher(env)
    t1 = time.perf_counter()
    reports["oracle"], cores["oracle"] = dispatcher.run_daemon(env, oracle, sp, seed=seed)
    secs["oracle"] = time.perf_counter() - t1
    print(f"streaming serve: MAHPPO {secs['train']:.1f} s, fine-tune {secs['tune']:.1f} s "
          f"({wall:.1f} s with the four streams); fine-tune reward "
          f"{tune[0]['reward_mean']:.3f} -> {tune[-1]['reward_mean']:.3f}, miss "
          f"{tune[0]['miss_rate']:.3f} -> {tune[-1]['miss_rate']:.3f}", flush=True)

    # the reference's own cross-runtime check, on the card
    for mk in (adapter.LocalDispatcher, adapter.GreedyDispatcher):
        sim = events.StreamSim(env, mk(env), sp, seed=seed)
        rep = sim.run()
        rep_d, core = dispatcher.run_daemon(env, mk(env), sp, seed=seed)
        stream_report_ok(mk.__name__, rep, sim)
        key = lambda recs: sorted((r.tid, r.ue, r.cls, r.t_arrive, r.t_start, r.t_done,
                                   r.dropped, r.b, r.channel, r.server, r.rate, r.energy)
                                  for r in recs)
        check(key(sim.monitor.records) == key(core.monitor.records) and rep == rep_d,
              f"streaming: the daemon and the event heap differ under {mk.__name__}")
    print("streaming: the daemon and the event heap give identical records for "
          "LocalDispatcher and GreedyDispatcher on the card", flush=True)

    t1 = time.perf_counter()
    student, hist = distill.distill_entity_policy(env, res["tuned"],
                                                  distill.DistillConfig(**STREAM_DISTILL), seed=0)
    secs["distill"] = time.perf_counter() - t1
    build_mod.reset_launches()
    q = distill.quantize_flat_trunk(student)
    torch.cuda.synchronize()
    launches["quantize"] = build_mod.LAUNCHES["quantize"]
    check(dict((k, v) for k, v in build_mod.LAUNCHES.items() if v) == {"quantize": 3},
          f"streaming: quantizing the trunk launched {dict(build_mod.LAUNCHES)}")
    print(f"streaming: distilled the tuned teacher in {secs['distill']:.1f} s: "
          + "; ".join(f"round {h['iteration']}: {h['states']} states, loss {h['loss']:.4f}, "
                      f"agreement {h['agreement']:.3f}" for h in hist), flush=True)
    trunk = adapter.TrunkDispatcher(env, q, seed=seed)
    build_mod.reset_launches()
    t1 = time.perf_counter()
    reports["int8 trunk"], cores["int8 trunk"] = dispatcher.run_daemon(env, trunk, sp, seed=seed)
    torch.cuda.synchronize()
    secs["int8 trunk"] = time.perf_counter() - t1
    got = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    dispatches = reports["int8 trunk"]["completed"]
    check(got == {"flat_trunk": dispatches},
          f"streaming: the trunk stream launched {got}, expected flat_trunk {dispatches}")
    launches["flat_trunk"] = dispatches
    policies = {"entity (tuned)", "entity zero-shot", "int8 trunk"}
    for name, rep in reports.items():
        core = cores[name]
        stream_report_ok(name, rep, core)
        n = rep["completed"]             # every started task completes: one dispatch each
        syncs = core.phys.rate_calls / max(n, 1) + (1 if name in policies else 0)
        print(f"streaming: {name:16s} throughput={rep['throughput']:6.1f}/s "
              f"miss={rep['miss_rate']:6.1%} drop={rep['drop_rate']:6.1%} sojourn "
              f"p50={rep['sojourn_p50']:.3f}s p95={rep['sojourn_p95']:.3f}s "
              f"p99={rep['sojourn_p99']:.3f}s; {n} dispatches in {secs[name]:.2f} s "
              f"({n / secs[name]:.0f} dispatches/s), {syncs:.2f} host syncs a dispatch",
              flush=True)
    print(f"streaming: server task counts of the tuned policy {res['per_server']}", flush=True)
    for name, disp in (("entity", adapter.EntityDispatcher(env, res["tuned"],
                                                            deterministic=False,
                                                            live_channel=True)),
                       ("oracle", oracle), ("int8 trunk", trunk)):
        core = cores[name if name != "entity" else "entity (tuned)"]
        profile_device(f"stream dispatch {name}", lambda: disp(core, 0),
                       dispatch_wall_ms(disp, core), "dispatch")
    return launches, res


def pretrain_cnn(dev, cnn_lib, optim, synthetic, cfg):
    """ResNet18 of ``cfg``'s width on its synthetic images, pre-trained as
    benchmarks/bench_compression.py does: AdamW at ``cfg["lr"]``, no weight
    decay, ``cfg["pretrain"]`` steps of ``cfg["batch"]`` images, the model
    from a seeded CPU generator and the images from a card one."""
    model = cnn_lib.make_resnet18(cfg["classes"], width=cfg["width"])
    params = cnn_lib.trainable_copy(model.init(torch.Generator().manual_seed(0), device=dev))
    leaves = cnn_lib.param_leaves(params)
    opt = optim.adamw_init(leaves)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []
    for _ in range(cfg["pretrain"]):
        x, y = synthetic.synthetic_image_batch(gen, cfg["batch"], cfg["img"], cfg["classes"])
        logits = cnn_lib.forward(model, params, x)
        loss = torch.mean(torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None])[:, 0])
        opt = optim.adamw_update(torch.autograd.grad(loss, leaves), opt, leaves, cfg["lr"],
                                 weight_decay=0.0)[1]
        losses.append(loss.detach())
    for t in leaves:
        t.requires_grad_(False)
    return model, params, torch.stack(losses).tolist()


def compression_sweep(dev, label, cfg, cnn_lib, compressor, jalad, optim, synthetic):
    """Pre-train, measure the base accuracy (4 batches of 64), run the
    Fig. 4 sweep and JALAD's entropy rate at each point (16 images), and
    check: every loss and accuracy finite, the base accuracy at least
    COMPRESS_BASE_ACC, each row's rate Eq. 3 of its (ch, ch', bits), and
    each row the highest qualifying ratio or the ch' = ch fallback, from
    the accuracies the sweep measured."""
    model, params, losses = pretrain_cnn(dev, cnn_lib, optim, synthetic, cfg)
    img, ncls = cfg["img"], cfg["classes"]
    check(all(math.isfinite(v) for v in losses), f"{label}: pre-training losses {losses}")

    def batch(seed, n):
        return synthetic.synthetic_image_batch(torch.Generator(device=dev).manual_seed(seed), n,
                                               img, ncls)

    def stream(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        while True:
            yield synthetic.synthetic_image_batch(gen, cfg["batch"], img, ncls)

    with torch.no_grad():
        accs = []
        for s in range(cfg["acc_batches"]):
            x, y = batch(10_000 + s, 64)
            accs.append(torch.mean((torch.argmax(cnn_lib.forward(model, params, x), -1) == y)
                                   .to(torch.float32)))
        base_acc = float(torch.stack(accs).mean())
    check(COMPRESS_BASE_ACC <= base_acc <= 1.0,
          f"{label}: base accuracy {base_acc:.4f} after {cfg['pretrain']} steps (at least "
          f"{COMPRESS_BASE_ACC} needed for the 2 % rule to mean anything)")
    trials, logs = [], []
    train, accuracy = compressor.train_autoencoder, compressor.accuracy_with_ae

    def train_logged(*args, **kw):
        out = train(*args, **kw)
        logs.append(out[2])
        return out

    def accuracy_logged(*args, **kw):
        out = accuracy(*args, **kw)
        trials.append(float(out))
        return out

    compressor.train_autoencoder, compressor.accuracy_with_ae = train_logged, accuracy_logged
    try:
        rows = compressor.measure_rate_distortion(
            model, params, lambda pi: stream(500 + pi),
            lambda pi: batch(20_000 + pi, cfg["eval_batch"]), ratios=cfg["ratios"],
            bits=cfg["bits"], steps=cfg["steps"], lr=cfg["lr"], acc_drop=cfg["acc_drop"],
            base_acc=base_acc)
    finally:
        compressor.train_autoencoder, compressor.accuracy_with_ae = train, accuracy
    ratios, bits = cfg["ratios"], cfg["bits"]
    check(len(rows) == 4 and len(trials) == len(logs) == 4 * len(ratios),
          f"{label}: {len(rows)} rows, {len(trials)} accuracies, {len(logs)} trainings")
    check(all(math.isfinite(r[k]) for log in logs for r in log for k in ("loss", "l2", "ce"))
          and all(math.isfinite(a) for a in trials), f"{label}: a sweep loss or accuracy "
          f"is not finite")
    for pi, row in enumerate(rows):
        ch, chp = row["channels"], row["ch_prime"]
        check(row["rate"] == ch * 32.0 / (chp * bits),
              f"{label}: point {pi + 1}: rate {row['rate']} is not Eq. 3 of ({ch}, {chp}, {bits})")
        tried = list(zip([max(1, ch // rc) for rc in ratios],
                         trials[pi * len(ratios):(pi + 1) * len(ratios)]))
        passing = [(c, a) for c, a in tried if a >= base_acc - cfg["acc_drop"]]
        want = min(passing) if passing else (ch, base_acc)
        check((chp, row["acc"]) == want, f"{label}: point {pi + 1} took ch' {chp} (acc "
              f"{row['acc']}), the rule gives {want} from {tried}")
        with torch.no_grad():
            x, _ = batch(30_000 + pi, 16)
            feat = cnn_lib.forward(model, params, x, upto=model.split_after[pi] + 1)
            row["jalad_rate"] = float(jalad.jalad_compress_size_bits(feat, bits)[1])
        row["tried"] = tried
    return model, params, rows, losses


def two_stage_ae(dev, model, params, ch, cfg, cnn_lib, compressor, synthetic):
    """COMPRESS_FINETUNE at point 2 from a random init: every loss finite,
    and stage 1's last five losses below its first five."""
    ft = COMPRESS_FINETUNE
    k = model.split_after[1]

    def stream():
        g = torch.Generator(device=dev).manual_seed(900)
        while True:
            yield synthetic.synthetic_image_batch(g, cfg["batch"], cfg["img"], cfg["classes"])

    t0 = time.perf_counter()
    ae, bb, logs = compressor.train_autoencoder(
        torch.Generator(device=dev).manual_seed(700), model, params, k, stream(), ch=ch,
        ch_prime=ch // ft["ratio"], steps=ft["steps"], lr=cfg["lr"],
        finetune_steps=ft["finetune_steps"], ft_lr=ft["ft_lr"], pca_init=False)
    x, y = synthetic.synthetic_image_batch(torch.Generator(device=dev).manual_seed(40_000),
                                           cfg["eval_batch"], cfg["img"], cfg["classes"])
    acc = float(compressor.accuracy_with_ae(model, bb, ae, k, x, y, bits=cfg["bits"]))
    torch.cuda.synchronize()
    s1 = [r["loss"] for r in logs if r["stage"] == 1]
    s2 = [r["loss"] for r in logs if r["stage"] == 2]
    check(len(s1) == ft["steps"] and len(s2) == ft["finetune_steps"]
          and all(math.isfinite(v) for v in s1 + s2 + [acc]),
          f"compressor: two-stage losses {s1} {s2}, accuracy {acc}")
    first, last = statistics.mean(s1[:5]), statistics.mean(s1[-5:])
    check(last < first, f"compressor: stage 1 did not lower the loss ({first} -> {last})")
    print(f"compressor: two-stage AE at point 2, {ch} -> {ch // ft['ratio']} ch from a random "
          f"init: stage 1 loss {first:.4f} -> {last:.4f} (means of the first and last 5 of "
          f"{ft['steps']}), stage 2 {s2[0]:.4f} -> {s2[-1]:.4f} ({ft['finetune_steps']} steps "
          f"at {ft['ft_lr']}), accuracy at 8 bits {acc:.4f}; {time.perf_counter() - t0:.1f} s",
          flush=True)


def huffman_roundtrip(dev, model, params, cfg, cnn_lib, compressor, huffman, jalad, synthetic):
    """One image's feature at point 2: JALAD's size is its entropy times its
    symbols, the Huffman codec decodes its codes back, and the coded size
    lies within HUFFMAN_GAP of the entropy estimate."""
    with torch.no_grad():
        x, _ = synthetic.synthetic_image_batch(torch.Generator(device=dev).manual_seed(30_001),
                                               1, cfg["img"], cfg["classes"])
        feat = cnn_lib.forward(model, params, x, upto=model.split_after[1] + 1)
        size, rate = jalad.jalad_compress_size_bits(feat, 8)
        codes = compressor.quantize(feat, 8)[0].reshape(-1)
        est = float(jalad.byte_entropy_bits(codes, 8)) * codes.numel()
    sym = codes.cpu().numpy().astype("int64")
    t0 = time.perf_counter()
    stream, table, n = huffman.encode(sym)
    back = huffman.decode(stream, table, n)
    coded = huffman.coded_size_bits(sym)
    check(bool((back == sym).all()) and n == sym.size,
          "compressor: the Huffman round trip changed the codes")
    check(abs(float(size) - est) <= 1e-6 * est,
          f"compressor: JALAD size {float(size)} against entropy x symbols {est}")
    gap = abs(coded - est) / est
    check(gap <= HUFFMAN_GAP, f"compressor: Huffman {coded} bits against the entropy estimate "
          f"{est:.0f} ({gap:.2%}, {HUFFMAN_GAP:.0%} allowed)")
    print(f"compressor: one image's feature at point 2 {tuple(feat.shape[1:])}: JALAD "
          f"{float(size):.0f} bits, rate {float(rate):.3f}; Huffman {coded} bits in "
          f"{len(stream)} bytes, {gap:.2%} from the entropy estimate, decoded equal "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)


def phase_compressor(dev, cnn_lib, compressor, huffman, jalad, optim, synthetic, build_mod):
    """The trained compressor on the card: the sweep at full width and
    224 px (COMPRESS), one two-stage AE, JALAD's size and a Huffman round
    trip, then the sweep at bench_compression's size (COMPRESS_BENCH). No
    kernel of the port's is on this path (the reference's is plain XLA
    too), so none may launch. cuDNN's default convolution algorithms sum in
    no fixed order, which moved the bench size's base accuracy by 0.11
    between two runs; the phase asks for its deterministic ones so that a
    run repeats."""
    build_mod.reset_launches()
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for label, cfg in (("compressor", COMPRESS), ("compressor (bench size)", COMPRESS_BENCH)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, params, rows, losses = compression_sweep(dev, label, cfg, cnn_lib, compressor,
                                                            jalad, optim, synthetic)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            base = rows[0]["base_acc"]
            print(f"{label}: ResNet18 width {cfg['width']}, {cfg['classes']} classes, "
                  f"{cfg['img']} px: pre-trained {cfg['pretrain']} steps (loss {losses[0]:.4f} "
                  f"-> {losses[-1]:.4f}), base accuracy {base:.4f} (chance "
                  f"{1 / cfg['classes']:.4f}); pre-training and sweep {seconds:.1f} s, peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
            for r in rows:
                print(f"{label}: point {r['point']} (module {r['module']}, {r['channels']} ch): "
                      f"ch' {r['ch_prime']}, rate {r['rate']:.1f}, acc {r['acc']:.4f} (ratios "
                      f"tried, ch' and acc: {[(c, round(a, 4)) for c, a in r['tried']]}); JALAD "
                      f"rate {r['jalad_rate']:.3f}", flush=True)
            out[label] = dict(rows=rows, seconds=seconds, base_acc=base)
            if cfg is COMPRESS:
                two_stage_ae(dev, model, params, rows[1]["channels"], cfg, cnn_lib, compressor,
                             synthetic)
                huffman_roundtrip(dev, model, params, cfg, cnn_lib, compressor, huffman, jalad,
                                  synthetic)
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    check(not launches, f"compressor: the path launched kernels: {launches}")
    return out


# ------------------------------------------------------------- KV-cache decode
def decode_inputs(dev, g, b, s, hkv, grp, d, kv_dtype=torch.float32, q_dtype=torch.float32,
                  empty=True):
    """Decode attention's inputs: with ``empty``, the reference's slots with
    pos % 5 == 2 empty (tests/test_kernels.py:58), else every slot filled."""
    q = torch.randn((b, hkv * grp, d), generator=g, device=dev).to(q_dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(kv_dtype) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).clone()
    if empty:
        pos[pos % 5 == 2] = -1
    return q, k, v, pos


def phase_decode_kernel(dev, kda, kref, serve_shape):
    """Hold decode_attention to its plain twin: |kernel - plain| <= tol +
    tol |plain| elementwise, tol 2e-5 in f32 (tests/test_kernels.py:72) and
    5e-2 with a bf16 cache, the reference's bounds; and every case also
    within 2e-5 + 2e-5 |plain|, since kernel and twin read the same cache
    values and compute in f32 (a bf16 cache leaves only the order of the
    sums between them). Returns the max abs error."""
    g = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0

    def hold(label, args, idx, tol, **kw):
        nonlocal worst
        got = kda.decode_attention(*args, idx, **kw)
        want = kda.decode_attention_plain(*args, idx, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"decode_attention {label}: non-finite output")
        for lim in sorted({tol, 2e-5}):
            excess = float(((got - want).abs() - lim * want.abs()).max())
            check(excess <= lim, f"decode_attention {label}: |kernel - plain| exceeds "
                  f"{lim} + {lim}|plain| by {excess - lim:.3e}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        return err

    for kv_dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
        name = str(kv_dtype)[6:]
        errs = [hold(f"S={s} (hkv,g)=({hkv},{grp}) {name}",
                     decode_inputs(dev, g, 2, s, hkv, grp, 64, kv_dtype), s - 10, tol)
                for s in (64, 257, 1024) for hkv, grp in ((2, 4), (1, 8), (4, 1))]
        print(f"kernels: decode_attention reference grid (S 64, 257, 1024 x (hkv,g) (2,4), "
              f"(1,8), (4,1); b 2, d 64) {name} cache: max abs err {max(errs):.3e}, allowed "
              f"{tol} + {tol}|plain| and 2e-05 + 2e-05|plain|", flush=True)
        for s in (600, 1088):
            err = hold(f"ragged S={s} {name}", decode_inputs(dev, g, 2, s, 2, 2, 128, kv_dtype),
                       s - 10, tol)
            print(f"kernels: decode_attention ragged S={s} {name} cache: max abs err {err:.3e}",
                  flush=True)
        args = decode_inputs(dev, g, 4, 2048, 2, 8, 128, kv_dtype)
        err = hold(f"bench shape {name}", args, 2047, tol)
        print(f"kernels: decode_attention bench shape q (4,16,128), k/v (4,2048,2,128) {name}: "
              f"max abs err {err:.3e}", flush=True)
    # the split planner's edges, with the last split of the last row empty
    tile = kda.TILE
    edges = [(2, 1, 2, 4, 64), (2, tile - 1, 2, 2, 128), (2, tile, 2, 2, 128),
             (2, tile + 1, 2, 2, 128), (2, 8 * tile + 1, 2, 2, 64), (5, 700, 7, 1, 64),
             (2, 300, 2, 8, 32), (40, 100, 8, 2, 64)]
    errs = []
    for kv_dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
        for b, s, hkv, grp, d in edges:
            q, k, v, pos = decode_inputs(dev, g, b, s, hkv, grp, d, kv_dtype)
            n, per = kda.plan_splits(b * hkv, s, kda.resident_blocks(dev, kv_dtype, grp, d))
            pos[-1, (n - 1) * per:] = -1
            errs.append(hold(f"planner edge (b,S,hkv,g,d)={(b, s, hkv, grp, d)} "
                             f"{str(kv_dtype)[6:]}", (q, k, v, pos), s - 1, tol))
    print(f"kernels: decode_attention at the split planner's edges (S 1, {tile - 1}, {tile}, "
          f"{tile + 1}, {8 * tile + 1}; B Hkv 35 and 320; G 8 with D 32; an empty split), f32 "
          f"and bf16 caches (D 32, 64, 128): max abs err {max(errs):.3e}", flush=True)
    # a row with no valid slot gives the mean of v, as the reference
    q, k, v, pos = decode_inputs(dev, g, 2, 300, 2, 4, 64)
    pos[0] = -1
    hold("all-empty row", (q, k, v, pos), 290, 2e-5)
    mean_err = float((kda.decode_attention(q, k, v, pos, 290)[0]
                      - v[0].mean(0).repeat_interleave(4, dim=0)).abs().max())
    check(mean_err <= 2e-5, f"decode_attention: an all-empty row is {mean_err:.3e} from mean(v)")
    print(f"kernels: decode_attention all-empty row: {mean_err:.3e} from the mean of v", flush=True)
    # the serving shape in bf16, and against the same function in float64
    b, s, hkv, grp, d = serve_shape
    args = decode_inputs(dev, g, b, s, hkv, grp, d, torch.bfloat16, torch.bfloat16, empty=False)
    err = hold(f"serving shape {serve_shape} bf16", args, s - 1, 5e-2)
    exact = kref.decode_attention_ref(*(a.double() for a in args[:3]), args[3], s - 1)
    k64 = float((kda.decode_attention(*args, s - 1).double() - exact).abs().max())
    p64 = float((kda.decode_attention_plain(*args, s - 1).double() - exact).abs().max())
    check(k64 <= 1e-5, f"decode_attention serving bf16: {k64:.3e} from float64 > 1e-5")
    print(f"kernels: decode_attention serving shape q ({b},{hkv * grp},{d}) bf16, k/v "
          f"({b},{s},{hkv},{d}) bf16: max abs err {err:.3e} against the twin; against "
          f"float64: kernel {k64:.3e}, plain {p64:.3e} (allowed 1e-5)", flush=True)
    return max(worst, phase_decode_zoo_kernel(dev, kda, kref, g, hold))


def zoo_decode_inputs(dev, g, b, s, hkv, grp, d, kv_dtype, q_dtype=torch.float32, empty=True):
    """Decode attention's inputs over a ring of S slots that has wrapped
    (idx = 3 S + 5, slot j holding the last position = j mod S), with
    ``empty`` the slots with pos % 5 == 2 empty; an int8 cache of random
    codes comes with per-(slot, kv head) scales in [0.01, 0.05). Returns
    (q, k, v, pos), idx and the scales as keyword arguments."""
    q = torch.randn((b, hkv * grp, d), generator=g, device=dev).to(q_dtype)
    scales = {}
    if kv_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=dev)
                .to(torch.int8) for _ in range(2))
        scales = {n: 0.01 + 0.04 * torch.rand((b, s, hkv), generator=g, device=dev)
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(kv_dtype)
                for _ in range(2))
    idx = 3 * s + 5
    p = torch.arange(idx - s + 1, idx + 1, device=dev)
    pos = torch.empty((b, s), dtype=torch.int32, device=dev)
    pos[:, p % s] = p.to(torch.int32)
    if empty:
        pos[pos % 5 == 2] = -1
    return (q, k, v, pos), idx, scales


def zoo_decode_shape(cfg, run):
    """decode_attention's (b, S, Hkv, G, D, cache, window) on ``cfg``'s
    decode serve ``run``: a local-attention layer's ring holds its window,
    a dense layer's the prompt and the generated tokens."""
    local = "lattn" in cfg.block_types()
    s = cfg.window if local else run["prompt_len"] + run["gen"]
    kv_dtype = torch.int8 if cfg.kv_quant_bits else getattr(torch, cfg.compute_dtype)
    return (run["batch"], s, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
            kv_dtype, cfg.window if local else 0)


def phase_decode_zoo_kernel(dev, kda, kref, g, hold):
    """decode_attention at the zoo's G and D: G 3, 7 and 16 at D 256 (f32
    and bf16 caches, the reference's bounds, and 2e-5 + 2e-5 |plain|
    whatever the cache), each zoo arch's serving shape (ZOO_DECODE_SHAPES:
    bf16 caches at G 1 / D 64, G 3 and G 7 at D 128, an int8 cache with its
    scales at qwen2-7b-kv8's, recurrentgemma-9b's local attention with its
    2048 window on a wrapped ring), a 1000 window that masks half that
    ring, an f32 cache at D 256 (one stage a consumer warp), each serving
    shape also against float64 (1e-5 + 1e-5 |exact|)."""
    errs = []
    for kv_dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
        for grp in (3, 7, 16):
            for window in (0, 64):
                args, idx, _ = zoo_decode_inputs(dev, g, 2, 300, 2, grp, 256, kv_dtype)
                errs.append(hold(f"G {grp} D 256 window {window} {str(kv_dtype)[6:]}", args,
                                 idx, tol, window=window))
    print(f"kernels: decode_attention G 3, 7, 16 at D 256 (b 2, S 300, hkv 2, wrapped ring, "
          f"window 0 and 64), f32 and bf16 caches: max abs err {max(errs):.3e}", flush=True)
    worst = max(errs)
    cases = [(f"{name} {str(shape[5])[6:]}", shape, 2e-5 if shape[5] == torch.int8 else 5e-2)
             for name, shape in ZOO_DECODE_SHAPES.items()]
    cases += [("recurrentgemma-9b window 1000 bf16",
              ZOO_DECODE_SHAPES["recurrentgemma-9b"][:6] + (1000,), 5e-2),
             ("f32 cache at D 256", ZOO_DECODE_SHAPES["recurrentgemma-9b"][:5]
              + (torch.float32, 2048), 2e-5)]
    for label, (b, s, hkv, grp, d, kv_dtype, window), tol in cases:
        q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
        args, idx, scales = zoo_decode_inputs(dev, g, b, s, hkv, grp, d, kv_dtype, q_dtype,
                                              empty=False)
        err = hold(f"{label} {(b, s, hkv, grp, d)}", args, idx, tol, window=window, **scales)
        wide = [a.double() for a in args[:3]]
        exact = kref.decode_attention_ref(*wide, args[3], idx, window=window,
                                          **{n: t.double() for n, t in scales.items()})
        got = kda.decode_attention(*args, idx, window=window, **scales).double()
        plain = kda.decode_attention_plain(*args, idx, window=window, **scales).double()
        k64 = float((got - exact).abs().max())
        excess = float(((got - exact).abs() - 1e-5 * exact.abs()).max())
        check(excess <= 1e-5, f"decode_attention {label}: {k64:.3e} from float64 exceeds "
              f"1e-5 + 1e-5|exact|")
        worst = max(worst, err)
        print(f"kernels: decode_attention {label} q ({b},{hkv * grp},{d}) k/v ({b},{s},{hkv},"
              f"{d}) window {window}: max abs err {err:.3e} against the twin (allowed {tol} + "
              f"{tol}|plain| and 2e-05 + 2e-05|plain|); against float64: kernel {k64:.3e}, "
              f"plain {float((plain - exact).abs().max()):.3e} (allowed 1e-5 + 1e-5|exact|)",
              flush=True)
    return worst


def phase_decode_timing(dev, kda, serve_shape):
    """Kernel, plain and SDPA times at the serving shape, beside the bound:
    q, k, v, pos read once and the f32 output written once, over the HBM
    rate (the 4 B Hq S D flops are far below it)."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, hkv, grp, d = serve_shape
    q, k, v, pos = decode_inputs(dev, g, b, s, hkv, grp, d, torch.bfloat16, torch.bfloat16,
                                 empty=False)
    idx = s - 1
    # the yardstick: one PyTorch call over the same inputs, transposed to
    # (B, H, S, D) outside the timed region (its -inf masking and bf16
    # output differ from the reference: its time is kept, not its result)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = ((pos >= 0) & (pos <= idx))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, pos)) + 4 * b * hkv * grp * d
    bound_ms, bound_by = bound(n_bytes, 4 * b * hkv * grp * s * d)
    ms = device_ms(lambda: kda.decode_attention(q, k, v, pos, idx))
    plain_ms = device_ms(lambda: kda.decode_attention_plain(q, k, v, pos, idx))
    library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    resident = kda.resident_blocks(dev, k.dtype, grp, d)
    plan = kda.plan_splits(b * hkv, s, resident)
    print(f"timing: decode_attention grid {b * hkv} x {plan[0]} blocks in clusters of "
          f"{plan[0]}; the card holds {resident[plan[0] - 1]} such blocks at once (clusters "
          f"of 1..{kda.MAX_SPLIT}: {resident})", flush=True)
    print(f"timing: decode_attention q ({b},{hkv * grp},{d}) k/v ({b},{s},{hkv},{d}) bf16: kernel "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, library (SDPA) {library_ms:.5f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}, {n_bytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}% "
          f"of bound; planner (n_split, slots) {plan}", flush=True)
    # a short cache, so the planner's choice for small S is on record
    # (informative: no check rests on it)
    s_short = 520
    q2, k2, v2, pos2 = decode_inputs(dev, g, b, s_short, hkv, grp, d, torch.bfloat16,
                                     torch.bfloat16, empty=False)
    kt2, vt2 = k2.transpose(1, 2).contiguous(), v2.transpose(1, 2).contiguous()
    mask2 = ((pos2 >= 0) & (pos2 <= s_short - 1))[:, None, None, :]
    short_ms = device_ms(lambda: kda.decode_attention(q2, k2, v2, pos2, s_short - 1))
    short_lib = device_ms(lambda: sdpa(q2[:, :, None], kt2, vt2, attn_mask=mask2,
                                       enable_gqa=True))
    short_bytes = sum(t.numel() * t.element_size() for t in (q2, k2, v2, pos2)) \
        + 4 * b * hkv * grp * d
    print(f"timing: decode_attention short cache k/v ({b},{s_short},{hkv},{d}) bf16: kernel "
          f"{short_ms:.5f} ms, library (SDPA) {short_lib:.5f} ms, bound "
          f"{bound(short_bytes, 0)[0]:.5f} ms; planner (n_split, slots) "
          f"{kda.plan_splits(b * hkv, s_short, resident)}", flush=True)
    if hasattr(kda, "block_rows"):             # a parent tree's kernel may not take them
        for name, shape in ZOO_DECODE_SHAPES.items():
            time_zoo_decode(dev, kda, g, name, shape)
    return {"decode_attention": dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)}


def time_zoo_decode(dev, kda, g, name, shape):
    """Kernel, plain and library times at a zoo arch's serving shape beside
    the bound: q (bf16), k, v, pos (and an int8 cache's two scales) read
    once and the f32 output written once, over the HBM rate. The library
    time is SDPA over the cache transposed to (B, H, S, D) outside the timed
    region, with the window in its mask; no one PyTorch call computes the
    int8 cache's function (its scales enter the scores and the
    probabilities), so there it is none."""
    b, s, hkv, grp, d, kv_dtype, window = shape
    args, idx, scales = zoo_decode_inputs(dev, g, b, s, hkv, grp, d, kv_dtype, torch.bfloat16,
                                          empty=False)
    q, k, v, pos = args
    n_bytes = sum(t.numel() * t.element_size() for t in args + tuple(scales.values())) \
        + 4 * b * hkv * grp * d
    bound_ms, bound_by = bound(n_bytes, 4 * b * hkv * grp * s * d)
    ms = device_ms(lambda: kda.decode_attention(q, k, v, pos, idx, window=window, **scales))
    plain_ms = device_ms(lambda: kda.decode_attention_plain(q, k, v, pos, idx, window=window,
                                                            **scales))
    library_ms = None
    if kv_dtype != torch.int8:
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        valid = (pos >= 0) & (pos <= idx)
        if window:
            valid = valid & (pos > idx - window)
        mask = valid[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = device_ms(lambda: sdpa(q[:, :, None], kt, vt, attn_mask=mask,
                                            enable_gqa=True))
    rows, groups = kda.block_rows(grp, d)
    resident = kda.resident_blocks(dev, kv_dtype, grp, d)
    plan = kda.plan_splits(b * hkv * groups, s, resident)
    lib = "none (no one call computes it)" if library_ms is None else f"{library_ms:.5f} ms"
    print(f"timing: decode_attention {name} q ({b},{hkv * grp},{d}) bf16 k/v ({b},{s},{hkv},{d}) "
          f"{str(kv_dtype)[6:]} window {window}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"library (SDPA) {lib}, bound {bound_ms:.5f} ms ({bound_by}, {n_bytes / 1e6:.2f} MB), "
          f"{100 * bound_ms / ms:.1f}% of bound; {rows} rows a block in {groups} row group(s), "
          f"grid {b * hkv * groups} x {plan[0]} blocks, planner (n_split, slots) {plan}, "
          f"resident blocks {resident}", flush=True)


def attention_layers(cfg):
    """The layers whose decode runs decode_attention: dense, local, MoE and
    the encoder-decoder's decoder layers (their self-attention); an image
    layer's cross-attention over its cached context launches none."""
    return sum(bt in ("dense", "lattn", "moe", "decx") for bt in cfg.block_types())


def phase_small_decode(dev, cfg, init_params, model_lib, build_mod, prompt=80, steps=8):
    """Prefill + greedy decode at a small f32 config, card against CPU. Both
    take the CPU's tokens, so each step compares the same inputs: logits
    within 1e-4 + 1e-4 |cpu| (the slice's f32 parity bound), and the card's
    token equal to the CPU's wherever the CPU's top-2 margin exceeds the
    step's logit error. An encoder-decoder or VLM config is prefilled with
    aux_embeds drawn from N(0, 1), its cross-attention gates drawn from
    N(0, 1) too (zero gates and a zero context would test nothing)."""
    cpu = torch.device("cpu")
    models = {cpu: init_params(cfg, torch.Generator().manual_seed(3), cpu)}
    aux, gates = None, 0
    if cfg.n_aux_tokens:
        g = torch.Generator().manual_seed(5)
        aux = torch.randn((2, cfg.n_aux_tokens, cfg.d_model), generator=g)
        with torch.no_grad():
            for name, p in models[cpu].named_parameters():
                if name.endswith(".gate"):
                    p.copy_(torch.randn((), generator=g))
                    gates += 1
    models[dev] = copy.deepcopy(models[cpu]).to(dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt), generator=torch.Generator().manual_seed(4))
    build_mod.reset_launches()
    worst, least_margin, equal = 0.0, float("inf"), 0
    with torch.inference_mode():
        out = {d: model_lib.prefill(m, tokens.to(d), attn_len=prompt + steps,
                                    aux_embeds=None if aux is None else aux.to(d))
               for d, m in models.items()}
        for i in range(steps + 1):
            (lc, cache_c), (ld, cache_d) = out[cpu], out[dev]
            ld = ld.cpu()
            err = float((ld - lc).abs().max())
            excess = float(((ld - lc).abs() - 1e-4 * lc.abs()).max())
            check(excess <= 1e-4, f"small decode {cfg.name} step {i}: logits differ by {err:.3e}")
            worst = max(worst, err)
            top = torch.topk(lc, 2, dim=-1).values
            margin = top[:, 0] - top[:, 1]
            tok = lc.argmax(-1)
            sure = margin > err
            check(torch.equal(ld.argmax(-1)[sure], tok[sure]),
                  f"small decode {cfg.name} step {i}: tokens differ where the margin exceeds the error")
            equal += int((ld.argmax(-1) == tok).sum())
            least_margin = min(least_margin, float(margin.min()))
            if i == steps:
                break
            out = {cpu: model_lib.decode_step(models[cpu], cache_c, tok[:, None], prompt + i),
                   dev: model_lib.decode_step(models[dev], cache_d, tok[:, None].to(dev), prompt + i)}
    torch.cuda.synchronize()
    n_attn = attention_layers(cfg)
    check(build_mod.LAUNCHES["decode_attention"] == n_attn * steps,
          f"small decode {cfg.name}: decode_attention launched "
          f"{build_mod.LAUNCHES['decode_attention']} times, expected {n_attn * steps}")
    context = ("" if aux is None else f", {cfg.n_aux_tokens} drawn aux tokens, {gates} drawn "
               f"gates")
    print(f"small decode ({cfg.name}, {cfg.n_layers}L d={cfg.d_model}, prompt {prompt}, {steps} "
          f"steps{context}): card vs CPU logits max abs diff {worst:.3e} (bound 1e-4 + 1e-4|cpu|), "
          f"{equal}/{2 * (steps + 1)} tokens equal (least top-2 margin {least_margin:.3e}), "
          f"decode_attention launches {n_attn * steps}", flush=True)


def phase_decode_serve(dev, sv, cfg, build_mod, cache_lib):
    """The KV-cache serving main path at full width; returns (launches, result)."""
    run = DECODE_SERVE[cfg.name]
    torch.cuda.reset_peak_memory_stats()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = sv.serve(cfg, device=dev, log=lambda m: print(f"decode serve: {m}", flush=True), **run)
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    wall = time.perf_counter() - t0
    steps, n = run["gen"] - 1, run["requests"]
    n_attn = attention_layers(cfg)
    n_ssd = sum(bt == "mamba2" for bt in cfg.block_types())
    want = {name: 0 for name in ROUTES}
    want.update(decode_attention=n_attn * steps * n, ssd_intra=n_ssd * n)
    for name in ROUTES:
        check(launches.get(name, 0) == want[name], f"decode serve {cfg.name}: {name} launched "
              f"{launches.get(name, 0)} times, expected {want[name]}")
    attn_len = run["prompt_len"] + run["gen"]
    want_bytes = sum(cache_lib.entry_payload_bits(cfg, bt, run["batch"], attn_len)
                     for bt in cfg.block_types()) // 8
    for st in res.stats:
        check(st["logits_finite"], f"decode serve {cfg.name}: non-finite logits")
        check(tuple(st["tokens"].shape) == (run["batch"], run["gen"]),
              f"decode serve {cfg.name}: tokens {tuple(st['tokens'].shape)}")
        check(st["cache_bytes"] == want_bytes,
              f"decode serve {cfg.name}: cache {st['cache_bytes']} bytes, expected {want_bytes}")
    med = lambda key: statistics.median(st[key] for st in res.stats)
    drops = ""
    if cfg.moe is not None:
        drops = (f"; MoE assignments dropped {100 * med('moe_dropped_prefill'):.3f}% at prefill "
                 f"(capacity {moe_capacity(cfg, run['batch'] * run['prompt_len'])}), "
                 f"{100 * med('moe_dropped_decode'):.3f}% at decode (capacity "
                 f"{moe_capacity(cfg, run['batch'])})")
    print(f"decode serve: {cfg.name} ({cfg.n_layers} layers, {cfg.param_dtype}), {n} requests of "
          f"a ({run['batch']}, {run['prompt_len']}) prefill + {steps} decode steps in {wall:.1f} s "
          f"(weights built in {res.build_s:.2f} s, included): prefill {med('prefill_ms'):.2f} ms, "
          f"cache {want_bytes / 1e6:.2f} MB, decode {med('decode_ms_per_token'):.3f} ms/token, "
          f"{med('tokens_per_s'):.1f} tokens/s (medians){drops}; launches {launches} as expected; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, res


def moe_capacity(cfg, tokens):
    """An MoE layer's slots an expert for a call of ``tokens`` tokens."""
    from repro_torch.models.moe import capacity
    return capacity(tokens, cfg.moe)


def phase_decode_consistency(dev, model, model_lib, prompt=256):
    """At full width: decoding token s from the cache against position s of
    the full forward, within 5e-2 x max|logit| (bf16: the prefill's
    attention rounds q * scale and the probabilities to bf16, the decode
    kernel keeps them f32). With a prompt longer than a local-attention
    window, the decode reads a ring that has wrapped."""
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, model.cfg.vocab_size, (2, prompt + 1), generator=g).to(dev)
    with torch.inference_mode():
        full = model_lib.apply_model(model, toks)[:, prompt].float()
        _, cache = model_lib.prefill(model, toks[:, :prompt], attn_len=prompt + 1)
        dec, _ = model_lib.decode_step(model, cache, toks[:, prompt:], prompt)
    err = float((dec.float() - full).abs().max())
    scale = float(full.abs().max())
    check(err <= 5e-2 * scale, f"{model.cfg.name}: decode differs from the full forward by "
          f"{err:.3e} > 5e-2 x {scale:.3e}")
    print(f"decode serve: {model.cfg.name} decode of token {prompt} against the full forward: max "
          f"abs diff {err:.3e}, max |logit| {scale:.3e} (bound 5e-2 x max|logit|), argmax equal "
          f"{int((dec.argmax(-1) == full.argmax(-1)).sum())}/2", flush=True)


def phase_decode_profile(model_lib, res):
    """One decode step of the served model, at the cache's last free slot."""
    tok = res.stats[-1]["tokens"][:, -1:]

    def step():
        with torch.inference_mode():
            model_lib.decode_step(res.model, res.cache, tok, res.attn_len - 1)
    wall = statistics.median(st["decode_ms_per_token"] for st in res.stats)
    profile_device(f"{res.model.cfg.name} decode", step, wall, "decode step")


def routing_flips(calls_cpu, calls_dev, label):
    """Hold one step's routing, layer by layer, card against CPU: wherever
    a token's k-th and (k+1)-th probability (on the CPU) differ by more
    than ROUTE_GAP its top-k set must be equal, and where no token's set
    differs the kept masks must be equal. Returns (near-tied tokens,
    tokens whose set differs)."""
    check(len(calls_cpu) == len(calls_dev), f"{label}: {len(calls_cpu)} MoE calls on the CPU, "
          f"{len(calls_dev)} on the card")
    ties = flips = 0
    for layer, (rc, rd) in enumerate(zip(calls_cpu, calls_dev)):
        k = rc.top_e.shape[1]
        top = torch.topk(rc.probs, k + 1, dim=-1).values
        sure = (top[:, k - 1] - top[:, k]) > ROUTE_GAP
        same = (rc.top_e.sort(-1).values == rd.top_e.cpu().sort(-1).values).all(-1)
        check(bool(same[sure].all()), f"{label} layer {layer}: the card routes a token with a "
              f"gap above {ROUTE_GAP} to other experts than the CPU")
        ties += int((~sure).sum())
        flips += int((~same).sum())
        if bool(same.all()):
            check(torch.equal(rc.kept, rd.kept.cpu()) and torch.equal(rc.rank, rd.rank.cpu()),
                  f"{label} layer {layer}: kept masks or ranks differ on the same routing")
    return ties, flips


def phase_small_moe_decode(dev, cfg, init_params, model_lib, moe_lib, build_mod, batch=4,
                           prompt=80, steps=8):
    """Prefill + greedy decode of a small f32 MoE config, card against CPU,
    both on the CPU's tokens. The routing first (``routing_flips``); then
    the logits within 1e-4 + 1e-4 |cpu| at every step before the first
    flipped token (a flipped token moves a whole expert's contribution, and
    its k / v stay in the cache); the flips and near-ties are counted."""
    cpu = torch.device("cpu")
    models = {cpu: init_params(cfg, torch.Generator().manual_seed(3), cpu),
              dev: init_params(cfg, torch.Generator().manual_seed(3), cpu).to(dev)}
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=torch.Generator().manual_seed(4))

    def both(fn):
        outs, calls = {}, {}
        for d in (cpu, dev):
            with moe_lib.routing_log() as log:
                outs[d] = fn(d)
            calls[d] = log.calls
        return outs, calls

    build_mod.reset_launches()
    worst, ties, flips, held, dropped = 0.0, 0, 0, 0, [0, 0]
    with torch.inference_mode():
        out, calls = both(lambda d: model_lib.prefill(models[d], tokens.to(d),
                                                       attn_len=prompt + steps))
        for i in range(steps + 1):
            t, f = routing_flips(calls[cpu], calls[dev], f"small MoE decode {cfg.name} step {i}")
            ties, flips = ties + t, flips + f
            dropped[i > 0] += sum(int((~r.kept).sum()) for r in calls[cpu])
            (lc, cache_c), (ld, cache_d) = out[cpu], out[dev]
            if flips == 0:
                ld = ld.cpu()
                err = float((ld - lc).abs().max())
                excess = float(((ld - lc).abs() - 1e-4 * lc.abs()).max())
                check(excess <= 1e-4, f"small MoE decode {cfg.name} step {i}: logits differ by "
                      f"{err:.3e}")
                worst, held = max(worst, err), held + 1
            if i == steps:
                break
            tok = lc.argmax(-1)[:, None]
            caches = {cpu: cache_c, dev: cache_d}
            out, calls = both(lambda d: model_lib.decode_step(models[d], caches[d], tok.to(d),
                                                              prompt + i))
    torch.cuda.synchronize()
    n_attn = attention_layers(cfg)
    check(build_mod.LAUNCHES["decode_attention"] == n_attn * steps,
          f"small MoE decode {cfg.name}: decode_attention launched "
          f"{build_mod.LAUNCHES['decode_attention']} times, expected {n_attn * steps}")
    m = cfg.moe
    assigned = (batch * prompt * m.top_k * cfg.n_layers, batch * m.top_k * cfg.n_layers * steps)
    print(f"small MoE decode ({cfg.name}, {cfg.n_layers}L d={cfg.d_model}, {m.n_experts} experts "
          f"top-{m.top_k}, {m.n_shared_experts} shared, capacity factor {m.capacity_factor}, batch "
          f"{batch}, prompt {prompt}, {steps} steps): routing equal wherever the gap exceeds "
          f"{ROUTE_GAP} ({ties} near-tied tokens, {flips} flipped); dropped "
          f"{dropped[0]}/{assigned[0]} assignments at prefill, {dropped[1]}/{assigned[1]} at "
          f"decode; card vs CPU logits max abs diff {worst:.3e} over {held}/{steps + 1} steps "
          f"(bound 1e-4 + 1e-4|cpu|); decode_attention launches {n_attn * steps}", flush=True)


def phase_small_kv8_decode(dev, cfg, init_params, model_lib, build_mod, prompt=80, steps=8):
    """Prefill + greedy decode over the int8 KV cache at a small f32 config,
    card against CPU, through ``models/attention.py``'s ``quantize_kv``
    path, both on the CPU's tokens: at every step each layer's codes within
    one step and equal at 99.9 % or more (a value half a code from a level
    may round either way), positions equal, and the logits within 5e-2 x
    max|logit| (the zoo's bf16 bound: a code one step off moves them by
    more than the float cache's 1e-4)."""
    cpu = torch.device("cpu")
    models = {cpu: init_params(cfg, torch.Generator().manual_seed(3), cpu),
              dev: init_params(cfg, torch.Generator().manual_seed(3), cpu).to(dev)}
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt), generator=torch.Generator().manual_seed(4))
    build_mod.reset_launches()
    worst, code_max, unequal, codes, scale_rel = 0.0, 0, 0, 0, 0.0
    with torch.inference_mode():
        out = {d: model_lib.prefill(m, tokens.to(d), attn_len=prompt + steps)
               for d, m in models.items()}
        for i in range(steps + 1):
            (lc, cache_c), (ld, cache_d) = out[cpu], out[dev]
            for layer, (ec, ed) in enumerate(zip(cache_c, cache_d)):
                check(ed["k"].dtype == torch.int8 and sorted(ec) == sorted(ed),
                      f"small kv8 decode step {i} layer {layer}: not an int8 cache")
                check(torch.equal(ec["pos"], ed["pos"].cpu()),
                      f"small kv8 decode step {i} layer {layer}: positions differ")
                for name in ("k", "v"):
                    diff = (ed[name].cpu().to(torch.int32) - ec[name].to(torch.int32)).abs()
                    code_max = max(code_max, int(diff.max()))
                    unequal += int((diff > 0).sum())
                    codes += diff.numel()
                    check(int(diff.max()) <= 1, f"small kv8 decode step {i} layer {layer}: {name} "
                          f"codes differ by {int(diff.max())}")
                    sc = ec[f"{name}_scale"]
                    scale_rel = max(scale_rel, float(((ed[f"{name}_scale"].cpu() - sc).abs()
                                                      / sc).max()))
            ld = ld.cpu()
            err = float((ld - lc).abs().max())
            bound_ = 5e-2 * float(lc.abs().max())
            check(err <= bound_, f"small kv8 decode step {i}: logits differ by {err:.3e} > "
                  f"{bound_:.3e}")
            worst = max(worst, err / float(lc.abs().max()))
            if i == steps:
                break
            tok = lc.argmax(-1)[:, None]
            out = {cpu: model_lib.decode_step(models[cpu], cache_c, tok, prompt + i),
                   dev: model_lib.decode_step(models[dev], cache_d, tok.to(dev), prompt + i)}
    torch.cuda.synchronize()
    check(unequal <= 1e-3 * codes, f"small kv8 decode: {unequal} of {codes} codes differ")
    n_attn = attention_layers(cfg)
    check(build_mod.LAUNCHES["decode_attention"] == n_attn * steps,
          f"small kv8 decode: decode_attention launched {build_mod.LAUNCHES['decode_attention']} "
          f"times, expected {n_attn * steps}")
    print(f"small kv8 decode ({cfg.name}, {cfg.n_layers}L d={cfg.d_model}, G "
          f"{cfg.n_heads // cfg.n_kv_heads}, int8 cache, prompt {prompt}, {steps} steps): card vs "
          f"CPU codes max diff {code_max} ({unequal} of {codes} differ, allowed 0.1 %), scales "
          f"max rel diff {scale_rel:.3e} (informative), logits max abs diff {worst:.3e} x "
          f"max|logit| (bound 5e-2); decode_attention launches {n_attn * steps}", flush=True)


def phase_moe(dev, cs, sv, model_lib, build_mod, cache_lib, kref, get_config):
    """The MoE stack's main paths at full width: qwen3-moe-30b-a3b split
    served (exactly one bottleneck_encode and one dequantize, codes within
    one of the oracle), then KV-cache served at its full depth (exactly 48
    x 31 decode_attention launches) with one profiled decode step, then
    kimi-k2-1t-a32b KV-cache served at its cut depth (31 launches). Each
    model is freed before the next. Returns the launch counts."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    qwen = get_config("qwen3-moe-30b-a3b")
    counts, res = phase_serve(dev, cs, qwen, build_mod, kref)
    launches.update(counts)
    del res
    torch.cuda.empty_cache()
    for name in MOE:
        cfg = get_config(name)
        cfg = cfg.replace(n_layers=MOE_LAYERS.get(name, cfg.n_layers))
        counts, res = phase_decode_serve(dev, sv, cfg, build_mod, cache_lib)
        launches.update(counts)
        if name == qwen.name:
            phase_decode_profile(model_lib, res)
        del res
        torch.cuda.empty_cache()
    cuts = ", ".join(f"{n} cut to {k} of {get_config(n).n_layers} layers"
                     for n, k in MOE_LAYERS.items())
    print(f"moe: split and KV-cache serve of {', '.join(MOE)} ({cuts}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase_encdec(dev, sv, model_lib, build_mod, cache_lib, get_config):
    """The encoder-decoder and VLM stacks' KV-cache serving at full width:
    seamless-m4t-large-v2 at its full depth and llama-3.2-vision-90b at its
    cut depth (ENCDEC_LAYERS), one request each (exactly 24 x 31
    decode_attention launches each: the decx and dense layers' self-
    attention; the xattn layers launch none), with one profiled decode
    step; each model freed before the next. Returns the launch counts."""
    t0 = time.perf_counter()
    launches = collections.Counter()
    for name in ENCDEC:
        cfg = get_config(name)
        cfg = cfg.replace(n_layers=ENCDEC_LAYERS.get(name, cfg.n_layers))
        counts, res = phase_decode_serve(dev, sv, cfg, build_mod, cache_lib)
        launches.update(counts)
        phase_decode_profile(model_lib, res)
        del res
        torch.cuda.empty_cache()
    cuts = ", ".join(f"{n} cut to {k} of {get_config(n).n_layers} layers"
                     for n, k in ENCDEC_LAYERS.items())
    print(f"encdec: KV-cache serve of {', '.join(ENCDEC)} ({cuts}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def phase_launcher(dev, train_lib, build_mod, arch_ids):
    """A main path: the --arch training launcher (``launch.train``) at
    ``--reduce`` for every arch of ARCH_IDS, LAUNCHER's steps into a
    temporary --out: every step's loss finite, the final checkpoint
    written, and exactly the launches the path makes (mamba2-1.3b's 4
    layers one ssd_intra and one ssd_intra_backward each a step, no other
    kernel anywhere). Returns the launches."""
    import tempfile

    t0 = time.perf_counter()
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as out:
        for arch in arch_ids:
            build_mod.reset_launches()
            t1 = time.perf_counter()
            model, _, losses = train_lib.train(arch, reduce=True, out=out, log=lambda *_: None,
                                               **LAUNCHER)
            torch.cuda.synchronize()
            got = {n: v for n, v in build_mod.LAUNCHES.items() if v}
            n_ssd = LAUNCHER["steps"] * sum(bt == "mamba2" for bt in model.cfg.block_types())
            want = {"ssd_intra": n_ssd, "ssd_intra_backward": n_ssd} if n_ssd else {}
            check(got == want, f"launcher {arch}: launches {got}, expected {want}")
            launches.update(got)
            losses = [float(v) for v in losses]
            check(len(losses) == LAUNCHER["steps"] and all(math.isfinite(v) for v in losses),
                  f"launcher {arch}: losses {losses}")
            check(Path(out, f"{arch}_final.npz").exists(), f"launcher {arch}: no checkpoint")
            print(f"launcher: {arch} --reduce ({model.cfg.n_layers}L d={model.cfg.d_model}, "
                  f"{model.cfg.optimizer}), {LAUNCHER['steps']} steps of ({LAUNCHER['batch']}, "
                  f"{LAUNCHER['seq']}) in {time.perf_counter() - t1:.1f} s: losses "
                  f"{', '.join(f'{v:.4f}' for v in losses)}; launches {got}", flush=True)
            del model
    torch.cuda.empty_cache()
    print(f"launcher: every arch of ARCH_IDS trained at --reduce in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ------------------------------------------------------------- training
def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_train(dev, quickstart, build_mod):
    """The quickstart twin at its defaults on the card, the way a user runs
    it; no kernel may launch, every reward must be finite and MAHPPO must
    beat full-local on t + beta e."""
    build_mod.reset_launches()
    t0 = time.perf_counter()
    res = quickstart.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    check(not launches, f"train: the training path launched kernels: {launches}")
    hist = res["history"]
    check(len(hist) == 30 and all(math.isfinite(r["reward_mean"]) for r in hist),
          f"train: rewards {[r['reward_mean'] for r in hist]}")
    ev, lo, beta = res["mahppo"], res["local"], res["beta"]
    ovh, lovh = ev["t_task"] + beta * ev["e_task"], lo["t_task"] + beta * lo["e_task"]
    check(all(math.isfinite(v) for v in (ovh, lovh)), f"train: overheads {ovh}, {lovh}")
    check(ovh < lovh, f"train: MAHPPO's overhead {ovh} is not below full-local's {lovh}")
    print(f"train: quickstart twin in {wall:.1f} s (30 iterations, eval and baseline "
          f"included), no kernel launched; reward {hist[0]['reward_mean']:.4f} -> "
          f"{hist[-1]['reward_mean']:.4f}; MAHPPO t {ev['t_task']:.6f} s e "
          f"{ev['e_task']:.6f} J overhead {ovh:.6f} against local t {lo['t_task']:.6f} "
          f"e {lo['e_task']:.6f} overhead {lovh:.6f} (beta {beta:.6f})", flush=True)


def phase_train_timing(dev, quickstart, mahppo, optim, build_mod):
    """Where an iteration's time goes: synchronized rollout and update
    seconds and profiled device time. Then one update on the card against
    the same update on the CPU, from the same agent, batch and indices:
    held at the configuration of the CPU test (tests/test_torch_train.py:
    horizon 64, 2 envs, batch 32, a fresh agent) to its bound, each
    parameter's change within 1e-3 of its leaf's largest change; and
    reported, beside a float64 CPU update, at the quickstart's
    configuration, where float32 rounding alone moves a leaf by more than
    that (an element whose gradient sits at rounding noise takes AdamW
    steps of up to lr either way)."""
    build_mod.reset_launches()
    _, env = quickstart.quickstart_env(device=dev)
    cfg = mahppo.MAHPPOConfig(iterations=TRAIN_TIMED, horizon=1024, n_envs=8)
    fns = mahppo.make_train_fns(env, cfg)
    agent = mahppo.init_agent(torch.Generator().manual_seed(0), env)
    opt = optim.adamw_init(mahppo.agent_parameters(agent))
    states = mahppo.init_states(env, cfg, torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    rollout, update = [], []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, traj, last_v = fns.collect(agent, gen, states)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fns.update(agent, opt, gen, traj, last_v)
        torch.cuda.synchronize()
        rollout.append(1e3 * (t1 - t0))
        update.append(1e3 * (time.perf_counter() - t1))
    print("train: ms an iteration (rollout + update, synchronized): "
          + ", ".join(f"{r:.1f} + {u:.1f}" for r, u in zip(rollout, update)), flush=True)
    wall_r, wall_u = statistics.median(rollout), statistics.median(update)
    box = {"states": states}

    def one_iteration():
        box["states"] = fns.iteration(agent, opt, gen, box["states"])[2]

    def one_rollout():
        box["traj"] = fns.collect(agent, gen, box["states"])

    profile_device("train iteration", one_iteration, wall_r + wall_u, "iteration")
    profile_device("train rollout", one_rollout, wall_r, "rollout")
    _, traj, last_v = box["traj"]
    profile_device("train update", lambda: fns.update(agent, opt, gen, traj, last_v), wall_u,
                   "update")

    # one update on the card and on the CPU, same agent, batch and indices:
    # checked at the CPU test's configuration, reported at the quickstart's
    _, env_cpu = quickstart.quickstart_env(device="cpu")
    small = mahppo.MAHPPOConfig(horizon=64, n_envs=2, batch=32)
    agent0 = mahppo.init_agent(torch.Generator().manual_seed(3), env)
    states0 = mahppo.init_states(env, small, torch.Generator(device=dev).manual_seed(4))
    _, traj0, last_v0 = mahppo.make_train_fns(env, small).collect(agent0, gen, states0)
    worst = {}
    for label, c, a, tr, lv in (("test", small, agent0, traj0, last_v0),
                                ("quickstart", cfg, agent, traj, last_v)):
        n_updates = c.reuse * max(c.horizon // c.batch, 1)
        keys = torch.rand((n_updates, c.horizon), generator=gen, device=dev)
        idx = torch.argsort(keys, dim=-1)[:, :c.batch]
        moved = {run: update_moves(mahppo, optim, mahppo.make_train_fns(e, c), a, tr, lv, idx, d,
                                   dt)
                 for run, e, d, dt in (("card", env, dev, torch.float32),
                                       ("cpu", env_cpu, torch.device("cpu"), torch.float32),
                                       ("cpu64", env_cpu, torch.device("cpu"), torch.float64))}
        worst[label] = {pair: max(float((x - y).abs().max() / y.abs().max())
                                  for x, y in zip(moved[pair[0]], moved[pair[1]]))
                        for pair in (("card", "cpu"), ("card", "cpu64"), ("cpu", "cpu64"))}
        print(f"train: one update at the {label} configuration (horizon {c.horizon}, "
              f"{c.n_envs} envs, batch {c.batch}, {n_updates} AdamW steps), the largest "
              f"difference of a leaf's change over that leaf's largest: "
              + ", ".join(f"{x} against {y} {r:.2e}" for (x, y), r in worst[label].items())
              + " (cpu64: float64 forward and backward)", flush=True)
    check(worst["test"][("card", "cpu")] <= 1e-3,
          f"train: the card's update is {worst['test'][('card', 'cpu')]:.2e} of a leaf's "
          f"largest change from the CPU's (1e-3 allowed)")
    launches = {k: v for k, v in build_mod.LAUNCHES.items() if v}
    check(not launches, f"train: the timed iterations launched kernels: {launches}")


def update_moves(mahppo, optim, fns, agent, traj, last_v, idx, device, dtype):
    """Each parameter's change under one ``fns.update`` of a copy of
    ``agent`` on ``device`` in ``dtype``, with the minibatch indices
    ``idx``."""
    conv = lambda x: x.to(device, dtype) if x.is_floating_point() else x.to(device)
    a = {k: copy.deepcopy(m).to(device, dtype) for k, m in agent.items()}
    params = mahppo.agent_parameters(a)
    before = [p.detach().clone() for p in params]
    fns.update(a, optim.adamw_init(params), None, _tree(conv, traj), conv(last_v),
               indices=[i.to(device) for i in idx])
    return [(p.detach() - b).double().cpu() for p, b in zip(params, before)]


# ------------------------------------------- the dry-run and batched evaluation
def phase_dryrun(dryrun, arch_ids, input_shapes):
    """15g: ``dryrun.run_one`` for each arch at its ``DRYRUN_SHAPES`` shape
    on both production meshes, on meta: one line a combination with the
    per-device bytes against the card's 80 GB and the step's counts; the
    phase's seconds."""
    check(set(DRYRUN_SHAPES) == set(arch_ids), "DRYRUN_SHAPES must name every arch once")
    check(set(DRYRUN_SHAPES.values()) == set(input_shapes),
          "DRYRUN_SHAPES must take every input shape")
    t0 = time.perf_counter()
    n = 0
    for arch in arch_ids:
        shape = DRYRUN_SHAPES[arch]
        for multi_pod in (False, True):
            rec = dryrun.run_one(arch, shape, multi_pod=multi_pod)
            held = "opt" if "opt_bytes_per_device" in rec else "cache"
            figures = {"params": rec["param_bytes_per_device"],
                       held: rec[f"{held}_bytes_per_device"]}
            figures["together"] = sum(figures.values())
            counts = [rec[k] for k in ("flops", "dot_flops", "bytes_accessed")]
            check(all(v > 0 and math.isfinite(v) for v in list(figures.values()) + counts),
                  f"dryrun {arch} {shape} {rec['mesh']}: {rec}")
            check(rec["collectives"] is None and rec["memory_analysis"] is None,
                  f"dryrun {arch} {shape}: collectives and memory analysis must be null")
            fits = ", ".join(f"{k} {v} B {'fits' if v <= CARD_BYTES else 'does not fit'}"
                             for k, v in figures.items())
            print(f"dryrun: {arch} {shape} {rec['mesh']} ({rec['n_devices']} devices): {fits} "
                  f"in 80 GB ({CARD_BYTES} B) a device; flops {rec['flops']:.6e}, dot_flops "
                  f"{rec['dot_flops']:.6e}, bytes_accessed {rec['bytes_accessed']:.6e}, "
                  f"counted in {rec['count_s']} s", flush=True)
            n += 1
    print(f"dryrun: {n} combinations ({len(arch_ids)} archs, one shape each, both meshes) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)


def storage_bytes(tensors):
    """Bytes the card holds for ``tensors``: each distinct storage once."""
    seen = {}
    for t in tensors:
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def phase_bytes_on_card(dev, cfg, init_params, sharding, mesh_lib, cache_lib):
    """15h: at a 1 x 1 mesh every spec is unsharded, so each rule's bytes
    must equal what the card holds, to the byte: ``cfg``'s parameters as
    the serving entry builds them (``init_params`` on the card) and the
    ``make_cache(cfg, 4, 2080)`` cache its KV-cache serve allocates."""
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    held = storage_bytes(model.parameters())
    params = sharding.reference_params(model)
    rule = sharding.bytes_per_device(params, sharding.params_pspecs(mesh, params, cfg), mesh)
    check(rule == held, f"bytes on the card: {cfg.name}'s params hold {held} B, the rules "
          f"at 1 x 1 give {rule}")
    run = DECODE_SERVE[cfg.name]
    b, s = run["batch"], run["prompt_len"] + run["gen"]
    cache = cache_lib.make_cache(cfg, b, s, device=dev)
    torch.cuda.synchronize()
    held_c = storage_bytes(t for entry in cache for t in entry.values())
    tree = sharding.reference_cache(cfg, cache)
    rule_c = sharding.bytes_per_device(tree, sharding.cache_pspecs(mesh, tree, cfg), mesh)
    check(rule_c == held_c, f"bytes on the card: {cfg.name}'s ({b}, {s}) cache holds "
          f"{held_c} B, the rules at 1 x 1 give {rule_c}")
    print(f"bytes on the card: {cfg.name} at a 1 x 1 mesh: params {rule} B by the rules, "
          f"{held} B held on the card; the ({b}, {s}) cache {rule_c} B by the rules, {held_c} B "
          f"held (equal, to the byte)", flush=True)
    del model, cache
    torch.cuda.empty_cache()


def phase_count_on_card(dev, cnn_lib, split_lib):
    """15i: ``measured_cnn_module_costs`` of ResNet18 (101 classes) at 224
    px on meta and on the card (real tensors, TF32 off): identical flops,
    dot_flops and bytes_accessed for every module; then the measured
    table's t_local, f_bits and feasibility."""
    model = cnn_lib.make_resnet18(CNN_COUNT["classes"])
    t0 = time.perf_counter()
    meta = split_lib.measured_cnn_module_costs(model, CNN_COUNT["img"])
    t_meta = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = split_lib.measured_cnn_module_costs(model, CNN_COUNT["img"], device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    for i, (m, c) in enumerate(zip(meta, card)):
        check(m == c, f"count on the card: resnet18 module {i}: meta {m}, card {c}")
        print(f"count on the card: resnet18 module {i}: flops {c['flops']:.0f}, dot_flops "
              f"{c['dot_flops']:.0f}, bytes_accessed {c['bytes_accessed']:.0f} on the card and "
              f"on meta", flush=True)
    check(len(meta) == len(card) == model.n_modules, "count on the card: a module is missing")
    plan = split_lib.measured_cnn_split_table(model, CNN_COUNT["img"], module_costs=card)
    print(f"count on the card: counted in {t_meta:.1f} s on meta and {t_card:.1f} s on the "
          f"card; measured table t_local {plan.t_local.tolist()}, f_bits "
          f"{plan.f_bits.tolist()}, feasible {plan.feasible.tolist()}", flush=True)


def timed_eval(evaluate, frames):
    """``(summary, ms a frame)`` of one ``evaluate()``, the work ended by a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = evaluate()
    torch.cuda.synchronize()
    return st, 1e3 * (time.perf_counter() - t0) / frames


def phase_batched_dispatch(dev, ds, mahppo, quantize_flat_trunk, build_mod):
    """15j: batched evaluation, a main path: the dispatch fleet's entity
    agent (through the fused scorer) and int8 trunk, each evaluated by
    ``mahppo.evaluate_policy`` with ``BATCHED_ENVS`` eval episodes a frame;
    exactly one pair_scorer and one flat_trunk launch a frame (64 each)
    and the trunk's 3 quantize, counted from the trunk's quantization on.
    An eval episode draws nothing, so every env runs the single-env
    episode: the summary must equal a single-env run's within 1e-5
    relative. ms a frame of both (the batched run after a 2-frame warm-up,
    its shapes' first calls)."""
    n, e, frames, seed, bits = (DISPATCH[k] for k in ("n_ue", "n_servers", "frames", "seed",
                                                      "bits"))
    env = ds.dispatch_env(n, e, dev)
    actor, trunk = ds.init_agents(env, seed)

    def agents():
        return {"entity": ({"entity_actor": actor}, True),
                f"int{bits} trunk": ({"flat_trunk": quantize_flat_trunk(trunk, bits)}, False)}

    single = {}
    for name, (agent, fused) in agents().items():
        mahppo.evaluate_policy(env, agent, frames=2, seed=seed, fused_scorer=fused,
                               n_envs=BATCHED_ENVS)
        single[name] = timed_eval(lambda: mahppo.evaluate_policy(
            env, agent, frames=frames, seed=seed, fused_scorer=fused), frames)
    torch.cuda.synchronize()
    build_mod.reset_launches()
    t0 = time.perf_counter()
    batched = {name: timed_eval(lambda: mahppo.evaluate_policy(
        env, agent, frames=frames, seed=seed, fused_scorer=fused, n_envs=BATCHED_ENVS), frames)
        for name, (agent, fused) in agents().items()}
    torch.cuda.synchronize()
    launches = dict(build_mod.LAUNCHES)
    wall = time.perf_counter() - t0
    want = {name: 0 for name in ROUTES}
    want.update(pair_scorer=frames, flat_trunk=frames, quantize=len(TRUNK_DIMS) - 1)
    for name in ROUTES:
        check(launches.get(name, 0) == want[name], f"batched dispatch: {name} launched "
              f"{launches.get(name, 0)} times, expected {want[name]}")
    for name, (st, ms) in batched.items():
        one, ms_one = single[name]
        check(all(math.isfinite(v) for v in st.values()), f"batched dispatch {name}: {st}")
        check(st["n_active"] == n and st["done"] == 0.0,
              f"batched dispatch {name}: {st['n_active']} active, done {st['done']}")
        check(st["t_task"] > 0 and st["e_task"] > 0, f"batched dispatch {name}: {st}")
        for k, v in one.items():
            check(abs(st[k] - v) <= 1e-5 * abs(v), f"batched dispatch {name}: {k} {st[k]} at "
                  f"{BATCHED_ENVS} envs, {v} at one env")
        print(f"batched dispatch ({name}, {BATCHED_ENVS} envs): {ms:.3f} ms a frame (one env "
              f"{ms_one:.3f} ms in the same run), summary within 1e-5 relative of one env's: "
              f"{st}", flush=True)
    print(f"batched dispatch: {n} UEs x {BATCHED_ENVS} envs x {frames} frames, both agents, "
          f"in {wall:.1f} s, launches {launches} as expected", flush=True)
    return launches


def batched_scorer_args(dev, ds, mahppo, kps):
    """The inputs that batched evaluation's first frame gives pair_scorer
    at (8, 1024, 3) with every env's queues and distances drawn
    (``draw_on_host``), so that each env's inputs and logits differ."""
    env = ds.dispatch_env(DISPATCH["n_ue"], DISPATCH["n_servers"], dev)
    draw_on_host(env, seed=10)
    actor, _ = ds.init_agents(env, DISPATCH["seed"])
    seen, real = [], kps.pair_scorer
    kps.pair_scorer = lambda *a: seen.append(a) or real(*a)
    try:
        mahppo.evaluate_policy(env, {"entity_actor": actor}, frames=1, fused_scorer=True,
                               n_envs=BATCHED_ENVS)
    finally:
        kps.pair_scorer = real
    check(len(seen) == 1, f"batched evaluation made {len(seen)} pair_scorer calls in a frame")
    return [a.detach().clone() for a in seen[0]]   # plain tensors, out of inference mode


def phase_batched_scorer_timing(dev, kps, ds, mahppo):
    """15j: pair_scorer at batched evaluation's (8, 1024, 3), on the inputs
    its first frame gives the kernel with every env drawn apart: held to
    its plain twin (which scores env by env) within 1e-5 + 1e-5|plain|,
    then timed as the serving shape is (phase 7), beside its bound.
    Returns the largest error."""
    args = batched_scorer_args(dev, ds, mahppo, kps)
    b, n, _ = args[0].shape
    e = args[4].shape[1]
    check((b, n, e) == (BATCHED_ENVS, DISPATCH["n_ue"], DISPATCH["n_servers"]),
          f"pair_scorer's batched inputs are {(b, n, e)}")
    (lk, sk), (lp, sp) = kps.pair_scorer(*args), kps.pair_scorer_plain(*args)
    torch.cuda.synchronize()
    for got, want, what in ((lk, lp, "logits"), (sk, sp, "server embeddings")):
        excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
        check(excess <= 1e-5, f"pair_scorer (B,N,E)=({b},{n},{e}) {what}: |kernel - plain| "
              f"exceeds 1e-5 + 1e-5|plain| by {excess - 1e-5:.3e}")
    check(all(not torch.equal(lp[0], lp[i]) for i in range(1, b)),
          "pair_scorer: two batched envs have the same logits")
    worst = max(float((lk - lp).abs().max()), float((sk - sp).abs().max()))
    print(f"kernels: pair_scorer (B,N,E)=({b},{n},{e}), batched evaluation's inputs, every env "
          f"drawn apart: max abs err {worst:.3e}, logits in [{float(lp.min()):.4e}, "
          f"{float(lp.max()):.4e}], allowed 1e-5 + 1e-5|plain| elementwise", flush=True)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    ms = device_ms(lambda: kps.pair_scorer(*args))
    plain_ms = device_ms(lambda: kps.pair_scorer_plain(*args))
    prof_ms, prof_names = profiled_ms(lambda: kps.pair_scorer(*args))
    bound_ms, bound_by = bound(*scorer_work(n, e, b=b))
    prof = "not measured" if prof_ms is None else f"{prof_ms:.5f} ms ({prof_names})"
    print(f"timing: pair_scorer (B,N,E)=({b},{n},{e}): kernel {ms:.5f} ms, {ms - floor_ms:.5f} "
          f"ms above the launch floor ({floor_ms:.5f} ms), profiler {prof} a call, plain "
          f"{plain_ms:.5f} ms, library none, bound {bound_ms:.7f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.2f}% of bound", flush=True)
    return worst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", type=Path, default=Path(__file__).resolve().parent / "src",
                        help="the directory that holds repro_torch (default: src beside "
                             "this script); another tree's src times that tree's kernels")
    parser.add_argument("--timing-only", action="store_true",
                        help="build and time the kernels (phases 1-2 and the timings of "
                             "3, 7 and 10), check nothing else and print no result")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    global HBM_BYTES_PER_S
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch import full_precision_matmuls
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.core import cnn as cnn_lib
    from repro_torch.core import compressor, huffman, jalad
    from repro_torch.core.compressor import pca_init_autoencoder
    from repro_torch.data import synthetic
    from repro_torch.kernels import (_build, bottleneck, decode_attn, flat_trunk, pair_scorer,
                                     quant, ssd_intra)
    from repro_torch.kernels import ref as kref
    from repro_torch import optim
    from repro_torch.launch import collab_serve, dispatch_serve, fleet_demo, quickstart
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import init_params, ssm
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.rl import mahppo
    from repro_torch.rl.distill import quantize_flat_trunk
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.core import split as split_lib
    from repro_torch.models import sharding

    full_precision_matmuls()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    mamba = get_config("mamba2-1.3b")
    _, n_heads, head_dim, d_state, _ = ssm.dims(mamba)
    serve = SERVE[mamba.name]
    ssd_shape = (serve["batch"], serve["seq"] // mamba.ssm.chunk, mamba.ssm.chunk, n_heads,
                 head_dim, d_state)
    calib_shape = (CALIB_BATCH,) + ssd_shape[1:]
    qwen = get_config("qwen3-1.7b")
    run = DECODE_SERVE[qwen.name]
    decode_shape = (run["batch"], run["prompt_len"] + run["gen"], qwen.n_kv_heads,
                    qwen.n_heads // qwen.n_kv_heads, qwen.head_dim)
    for name in ZOO_DECODE_SHAPES:
        want = zoo_decode_shape(get_config(name), DECODE_SERVE[name])
        check(ZOO_DECODE_SHAPES[name] == want, f"ZOO_DECODE_SHAPES[{name!r}] is "
              f"{ZOO_DECODE_SHAPES[name]}, its decode serve runs {want}")
    if args.timing_only:
        phase_timing(dev, quant, bottleneck, ssd_intra, ssd_shape, calib_shape)
        phase_dispatch_timing(dev, pair_scorer, flat_trunk, quant)
        if hasattr(pair_scorer, "pair_scorer_backward"):      # a parent tree may lack it
            phase_scorer_timing(dev, pair_scorer)
        if hasattr(ssd_intra, "ssd_intra_backward"):
            phase_ssd_backward_timing(dev, ssd_intra, ssd_shape, calib_shape)
        phase_decode_timing(dev, decode_attn, decode_shape)
        return 0
    from repro_torch.launch import steps as steps_lib   # not in a parent tree's --timing-only
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.launch import streaming_serve, train_lm
    from repro_torch.launch import train as train_lib
    from repro_torch.rl import distill
    from repro_torch.stream import adapter as stream_adapter
    from repro_torch.stream import dispatcher as stream_dispatcher
    from repro_torch.stream import events as stream_events
    err = phase_kernels(dev, quant, bottleneck, kref)
    err["ssd_intra"] = phase_ssd_kernel(dev, ssd_intra, kref, ssd_shape, calib_shape)
    err["ssd_intra_backward"] = phase_ssd_backward(dev, ssd_intra, _build, ssd_shape,
                                                   calib_shape)
    times = phase_timing(dev, quant, bottleneck, ssd_intra, ssd_shape, calib_shape)
    times.update(phase_ssd_backward_timing(dev, ssd_intra, ssd_shape, calib_shape))
    err.update(phase_dispatch_kernels(dev, pair_scorer, flat_trunk, quant))
    times.update(phase_dispatch_timing(dev, pair_scorer, flat_trunk, quant))
    err["pair_scorer_backward"], fwd_err = phase_scorer_backward(dev, pair_scorer, _build)
    err["pair_scorer"] = max(err["pair_scorer"], fwd_err)
    times.update(phase_scorer_timing(dev, pair_scorer))
    err["decode_attention"] = phase_decode_kernel(dev, decode_attn, kref, decode_shape)
    times.update(phase_decode_timing(dev, decode_attn, decode_shape))
    qwen_small = reduced(qwen, n_layers=4).replace(n_heads=4, n_kv_heads=2, d_head=64)
    phase_small_split(dev, collab_serve, qwen_small, 80, init_params, pca_init_autoencoder)
    # seq 40 with chunk 16 leaves a ragged last chunk
    phase_small_split(dev, collab_serve, reduced(mamba, n_layers=4), 40, init_params,
                      pca_init_autoencoder)
    phase_small_dispatch(dev, dispatch_serve, mahppo, quantize_flat_trunk)
    # the zoo's decode paths: recurrentgemma (a tail, a 64-slot window
    # wrapped by the 80-token prompt) and qwen2-7b (G 7, QKV bias); the
    # int8 cache is held to its twin above (card and CPU may round a code
    # of the same k apart, which moves logits past this phase's 1e-4)
    rg_small = reduced(get_config("recurrentgemma-9b"), n_layers=5)
    q2_small = reduced(get_config("qwen2-7b"), n_layers=3).replace(
        n_heads=7, n_kv_heads=1, d_head=32)
    for cfg in (qwen_small, reduced(mamba, n_layers=4), rg_small, q2_small):
        phase_small_decode(dev, cfg, init_params, model_lib, _build)
    # the int8 KV cache at model level: reduced qwen2-7b-kv8 with its G 7
    phase_small_kv8_decode(dev, reduced(get_config("qwen2-7b-kv8"), n_layers=3).replace(
        n_heads=7, n_kv_heads=1, d_head=32), init_params, model_lib, _build)
    # the MoE decodes: reduced qwen3-moe with its G 8 and the capacity factor
    # set back to 1.25 (decode drops at batch 4), and reduced kimi with its
    # shared expert
    qmoe = reduced(get_config("qwen3-moe-30b-a3b"), n_layers=3)
    qmoe = qmoe.replace(n_heads=8, n_kv_heads=1, d_head=32,
                        moe=dataclasses.replace(qmoe.moe, capacity_factor=1.25))
    for cfg in (qmoe, reduced(get_config("kimi-k2-1t-a32b"), n_layers=3)):
        phase_small_moe_decode(dev, cfg, init_params, model_lib, moe_lib, _build)
    # the encoder-decoder and VLM decodes: reduced seamless (2 encoder and 3
    # decx layers, MHA) and reduced llama-vision (one 5-layer group: 4 dense,
    # one xattn; G 8 by a head override), drawn gates and aux_embeds
    for cfg in (reduced(get_config("seamless-m4t-large-v2"), n_layers=3),
                reduced(get_config("llama-3.2-vision-90b")).replace(n_heads=8, n_kv_heads=1,
                                                                    d_head=32)):
        phase_small_decode(dev, cfg, init_params, model_lib, _build)

    launches = collections.Counter()
    for cfg in (qwen, mamba):
        counts, res = phase_serve(dev, collab_serve, cfg, _build, kref)
        launches.update(counts)
        phase_profile(collab_serve, res)
        del res
        torch.cuda.empty_cache()
    counts, res = phase_dispatch_serve(dev, dispatch_serve, _build)
    launches.update(counts)
    phase_dispatch_profile(mahppo, res)
    del res
    for cfg in (qwen, mamba):
        counts, res = phase_decode_serve(dev, serve_lib, cfg, _build, cache_lib)
        launches.update(counts)
        if cfg.name == qwen.name:
            phase_decode_consistency(dev, res.model, model_lib)
            phase_decode_profile(model_lib, res)
        del res
        torch.cuda.empty_cache()
    t_zoo = time.perf_counter()
    for name in ZOO_SPLIT:
        counts, res = phase_serve(dev, collab_serve, get_config(name), _build, kref)
        launches.update(counts)
        del res
        torch.cuda.empty_cache()
    for name in ZOO:
        counts, res = phase_decode_serve(dev, serve_lib, get_config(name), _build, cache_lib)
        launches.update(counts)
        if name == "recurrentgemma-9b":
            phase_decode_consistency(dev, res.model, model_lib, prompt=RG_CONSISTENCY_PROMPT)
            phase_decode_profile(model_lib, res)
        del res
        torch.cuda.empty_cache()
    print(f"zoo: split serve of {', '.join(ZOO_SPLIT)} and KV-cache serve of {', '.join(ZOO)} "
          f"in {time.perf_counter() - t_zoo:.1f} s", flush=True)
    launches.update(phase_moe(dev, collab_serve, serve_lib, model_lib, _build, cache_lib, kref,
                              get_config))
    launches.update(phase_encdec(dev, serve_lib, model_lib, _build, cache_lib, get_config))
    launches.update(phase_loss_grad(dev, model_lib, init_params, mamba, _build))
    torch.cuda.empty_cache()
    launches.update(phase_train_step(dev, steps_lib, model_lib, init_params, mamba, _build))
    phase_train_step_timing(dev, steps_lib, model_lib, init_params, qwen, _build)
    t_train = time.perf_counter()
    launches.update(phase_launcher(dev, train_lib, _build, ARCH_IDS))
    for name in ENCDEC:
        cfg = get_config(name)
        cfg = cfg.replace(n_layers=ENCDEC_TRAIN_LAYERS.get(name, cfg.n_layers))
        phase_train_step_timing(dev, steps_lib, model_lib, init_params, cfg, _build,
                                shape=ENCDEC_TRAIN_BATCH)
    print(f"encdec: the launcher over ARCH_IDS and the full-width train steps of "
          f"{', '.join(ENCDEC)} in {time.perf_counter() - t_train:.1f} s", flush=True)
    phase_train_check(dev, steps_lib, init_params, mamba, _build, ssd_intra)
    launches.update(phase_pretrain(dev, collab_serve, _build))
    phase_train_lm(dev, train_lm)
    phase_train(dev, quickstart, _build)
    phase_train_timing(dev, quickstart, mahppo, optim, _build)
    counts, res = phase_fleet_demo(dev, fleet_demo, _build)
    launches.update(counts)
    phase_fleet_timing(dev, fleet_demo, mahppo, optim, _build, res)
    del res
    counts, _ = phase_fleet_churn(dev, fleet_demo, _build)
    launches.update(counts)
    counts, _ = phase_fleet_distill(dev, fleet_demo, _build)
    launches.update(counts)
    counts, _ = phase_fleet_llm(dev, fleet_demo, _build)
    launches.update(counts)
    counts, _ = phase_streaming(dev, streaming_serve, distill, stream_adapter, stream_dispatcher,
                                stream_events, _build)
    launches.update(counts)
    phase_compressor(dev, cnn_lib, compressor, huffman, jalad, optim, synthetic, _build)
    torch.cuda.empty_cache()
    phase_dryrun(dryrun, ARCH_IDS, INPUT_SHAPES)
    phase_bytes_on_card(dev, qwen, init_params, sharding, mesh_lib, cache_lib)
    phase_count_on_card(dev, cnn_lib, split_lib)
    launches.update(phase_batched_dispatch(dev, dispatch_serve, mahppo, quantize_flat_trunk,
                                           _build))
    err["pair_scorer"] = max(err["pair_scorer"], phase_batched_scorer_timing(
        dev, pair_scorer, dispatch_serve, mahppo))
    phase_small_dispatch(dev, dispatch_serve, mahppo, quantize_flat_trunk,
                         n_envs=SMALL_BATCHED_ENVS)

    kernels = []
    for name, (source, replaces) in ROUTES.items():
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches.get(name, 0), max_abs_err=err[name],
                            **times[name]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
