#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once) and holds each against its plain
PyTorch version on the card: the K-NN reduction (NaN, ±inf and views off
the 16-byte grid among its cases; its times beside a launch floor, its
eager call's host time step by step), both flash-attention routes
(bfloat16 on the tensor cores, float32 on the CUDA cores; every head_dim
up to 256, some zero-padded, bf16 above 128 on the CUDA-core kernel, head
dims 320 and 512 on its wide form, and layouts TMA cannot load, staged)
and the WKV6 recurrence.  Then it drives the port's main paths:

* the DSDPS control loop: the K-NN beam and a short loop on the card
  against the CPU, then ``repro_torch.launch.drl_control.run`` on
  ``cq_large`` (100 executors × 10 machines) with a fleet of 8 DDPG lanes,
  checking that every select and every update went through the K-NN
  kernel;
* LM serving: both smoke configs in float32 on the card against the CPU,
  then llama3-8b and rwkv6-7b at full width and depth in bfloat16 (random
  weights from a seeded generator): ``prefill_forward`` on 4 prompts of
  2048 tokens and ``Engine.generate`` on 4 prompts of 64 tokens with 32
  new greedy tokens, checking that every attention layer went through the
  bfloat16 flash-attention kernel (wgmma + TMA) and every RWKV6 layer, in
  prefill and in every
  decode step, through the WKV6 kernel; then 64 decode steps are timed,
  the two prefills are held to each other in float32, and each bf16
  path's drift from the float32 answer to that of a control run with the
  kernels' plain versions;
* the paper's baselines and scenario fleets: round-robin, DQN and the
  model-based scheduler [25] under a mixed scenario fleet on the card
  against the CPU, then each through ``drl_control.run`` at ``cq_large``
  with 8 lanes, each lane slowing its own machine (the model-based lanes
  fit their own cluster), and DDPG at the main path's budget under a mixed
  fleet, every select and update through the K-NN kernel;
* control serving: ``repro_torch.launch.serve_control`` at ``cq_large``
  with placement, rate_control and auto_tune planes of 8 slots for 16
  perturbed clusters and 256 requests, the card's decisions held to the
  CPU's, every placement step through one K-NN launch and every plane step
  waiting on the device once.
* the replay-free streaming agents (Stream Q(λ), Stream AC(λ)) and the
  graph policy: card against CPU on the same draws, then each through
  ``drl_control.run`` at ``cq_large`` with 8 lanes under
  ``one_slow_machine`` (the graph policy on the topology's static
  2,475-edge graph), profiled;
* structural fleets: the graph policy under ``dag_shapes`` (a DAG per
  lane) card against CPU and lane against single run, each padded
  topology's latency against its plain env, then an envelope over the
  paper's three applications (N=100, E=2475) with 6 lanes, profiled;
* the expert-placement env (Jamba-1.5-large's 16 experts on 16 devices):
  DDPG, DQN, round-robin, Stream Q(λ) and Stream AC(λ) card against CPU on
  the same draws under a mixed fleet, then each through
  ``drl_control.run`` with 8 lanes under ``mixed`` and ``one_slow_device``,
  profiled, DDPG's selects and updates through the K-NN kernel at m = 16;
* fleet checkpoints: ``drl_control.run`` at ``cq_large`` with 8 DDPG lanes
  for 30 epochs saving every 10, and killed after 20 then resumed in fresh
  objects, held to uninterrupted runs (moves and final assignments exact,
  floats within the gap between two uninterrupted card runs), the K-NN
  kernel launched 160 times across the kill; the card's checkpoint
  restored into CPU templates; the saves timed, and the loop beside each
  part of a write; then every agent killed and resumed at a small size;
* the elastic lane lifecycle and the runtime guards: an elastic run card
  against CPU on the same draws, its surviving lanes against the card's
  fixed-grid run; then ``drl_control.run`` with ``early_stop`` at
  ``cq_large`` with 8 DDPG lanes, two of them forced to stop at epoch 16
  and under the default plateau rule, beside a fixed-grid run (lane-epochs
  executed, wall s, K-NN launches); the forced-stop run killed at epoch 24
  and resumed from its compacted checkpoint, held bit for bit to the
  uninterrupted one; the synchronizing calls of a steady-state epoch,
  by site, for every agent the port runs (sync debug mode); and a
  successive-halving scenario search over 8 candidates;
* LM serving beyond llama3-8b: the dense yi-34b (full depth),
  command-r-plus-104b and qwen1.5-110b (16 layers each: their bf16
  weights do not fit one card) and the MoE granite-moe-3b-a800m and
  qwen2-moe-a2.7b (full depth) in bfloat16: ``prefill_forward`` on 4
  prompts of 2048 tokens (one bf16 wgmma flash launch a layer, none
  padded or staged) and ``Engine.generate``, the decode step timed beside
  its byte bound, the flash kernel timed against SDPA at each config's
  prefill shape, and for the MoE two card runs held to the same tokens
  and the bf16 drift to a plain-version control's;
* continuous batching: ``ContinuousBatcher`` on the float32 smoke
  configs card against CPU (the reference tests' scenarios and a recycled
  slot), then llama3-8b and rwkv6-7b at full size in bf16 serving 32
  requests through 8 slots, the first wave held to ``Engine.generate``
  token for token, every RWKV step through 32 WKV launches;
* the last three LM families: their float32 smoke configs card against
  CPU (prefill, generate, the batcher), the flash kernel at seamless's
  encoder (4096 frames, non-causal) and cross-attention (2048 queries
  against a 4096-row memory, its key length of its own) shapes in bf16
  and float32, then in bf16 phi-3-vision-4.2b (576 seeded patch
  embeddings and 1472 tokens) and seamless-m4t-medium (over 4096 seeded
  frames) at full size, and jamba-1.5-large-398b at one period-8 block
  with 12 of its 16 experts (its float32 control at 4): prefill_forward,
  Engine.generate, the decode step beside its byte bound, the Mamba
  layers' share of jamba's prefill, and the two prefills held to each
  other (seamless's at Skv = 4096);
* the paper's evaluation (``repro_torch.figures``): its pieces at a tiny
  budget on cq_small card against CPU (the model-based fit and search,
  the DQN and actor-critic fleets and their deploys, Fig 12's shifted run
  and refit); the reward curves at the committed artifact's budget held
  to its seed band; ``compare_all`` on cq_large at ``Budget.quick`` (Fig
  6's large row: the four latencies, both improvements, the wall seconds
  of each part) and Fig 12's run, every DDPG select and update through
  the K-NN kernel (1,150 and 1,399 launches);
* the single-run entry and the examples' twins
  (``repro_torch.examples``): ``run_online_agent`` card against CPU, then
  the quickstart, expert-placement (with its straggler mitigation),
  scenario-fleet and serve-LM twins at their reference scripts' budgets,
  every DDPG select and update through the K-NN kernel, counted at the
  single run's shapes;
* LM training (``repro_torch.train``, ``launch/train.py``): one float32
  train step card against CPU for a smoke config of each family, the
  kernels' ``autograd.Function``s' gradients against their plain versions
  and plain autograd (the flash backward through its own kernels, one
  launch a backward, both routes), llama3-8b at every width cut to 4 of
  its 32 layers in bf16 (8 x 2048 in 4 microbatches, steps timed and one
  profiled, every attention forward and rematerialized recompute through
  the bf16 flash kernel, counted by shape, and every attention backward
  through the backward kernels, counted by call; the backward timed alone
  beside SDPA's), and the ``train_lm`` twin at its reference shapes for
  100 of its 300 steps, killed and resumed at step 50;
* LM training over a mesh (``sharding/policy.py``, ``sharding/ctx.py``,
  ``trainer.shard_train_state``, ``make_train_step(..., mesh=)``):
  ``launch.mesh.make_production_mesh`` over a world of one on NCCL, a
  float32 smoke step with int8 error feedback on it against the same step
  on the CPU, then phase 28's llama3-8b (4 of 32 layers at every width,
  bf16) sharded by the policy, 2 steps on the mesh against 2 unmeshed
  steps from the same seed and batches (loss, gradient norm and every
  leaf of the parameters and moments bit for bit), each step's ms, the
  peak GiB and the flash launches by shape;
* the dry-run (``repro_torch.launch.dryrun``): phase 28's step traced on
  ``meta`` tensors in a fake process group of one rank, then run on the
  card (NCCL, a world of one): argument bytes equal, flash calls by shape
  and backward calls by call equal to the launches, FLOPs (the kernels'
  at ``ops.flops`` and ``ops.flops_bwd``) within 1% and the predicted
  peak within 10% of ``max_memory_allocated``; then the dry-run's command
  on four cells of the reference's grid at full depth on a fake world of 256
  ranks (llama3-8b ``train_4k``, ``prefill_32k``, ``decode_32k`` and
  rwkv6-7b ``long_500k``), each cell's FLOPs a rank beside 6·N·D / 256,
  its predicted peak beside the card's 80 GiB and its wire bytes;
* tensor-parallel compute on the ``model`` axis (the meshed step's blocks
  on DTensor activations): phase 30's and 31's meshed steps run it on a
  (1, 1) mesh, still bit for bit the unmeshed step; then one rank of a
  16-way model axis: phase 28's step traced by the dry-run on a fake world
  of 16 and run for real on the card as rank 0 of a fake process group of
  16 (real tensors and kernel launches at the rank's local shapes,
  collectives that return at once without data): argument bytes equal,
  flash launches by call (2 local q heads against one kv head) equal to
  the predicted calls, FLOPs within 1% and the peak within 10%; its ms a
  step, peak GiB and device busy share, and the flash kernel timed at that
  local shape;
* the tensor-parallel decode (``lm.serve_step`` on DTensor parameters and a
  cache cut over the model axis, ``trainer.cache_model_shards``): on the
  (1, 1) NCCL mesh llama3-8b and rwkv6-7b (4 of 32 layers at every width,
  bf16, a cache of 2048 positions) take 16 steps bit for bit the unmeshed
  steps (logits and every cache leaf); then one rank of a 16-way model
  axis at ``decode_32k``'s local shapes (8 rows, 32768 positions, full
  depth) in a fake process group of 16, traced by the dry-run first:
  argument bytes equal, WKV6 launches by call (4 of 64 heads, carried
  state) equal to the predicted calls, the collectives by kind and count
  equal, FLOPs within 0.01%, peak within 2%; its ms a step and busy
  share, and WKV6 timed at that shape;
* expert parallelism and the tensor-parallel Mamba (the MoE FFN cut by
  experts or by each expert's d_ff, the Mamba mixer by d_inner): on the
  (1, 1) NCCL mesh granite-moe-3b at full size decodes 16 steps and jamba
  (one period-8 block, 4 of its 16 experts a MoE layer) as many, bit for
  bit the unmeshed steps (logits and every cache leaf), and granite-moe at
  4 of 32 layers takes one train step of 2 x 2048 bit for bit (loss, grad
  norm, every leaf); then one rank of a 16-way model axis decoding at
  ``decode_32k``'s local shapes (granite-moe and qwen2-moe at full depth,
  jamba at one of 9 blocks with all 16 experts, each rank's shards drawn
  alone) and one rank of a qwen2-moe train step (4 of 24 layers, 2 x
  2048), each held to its dry-run (argument bytes equal, collectives by
  kind and count equal; a decode's FLOPs within 0.01% and peak within 2%,
  a train step's within 1% and 10% and its flash launches by call equal),
  its ms a step and busy share, and the flash kernel timed at the rank's
  local heads;
* per-block parameter gathering (the placed tree handed to the model, each
  block's data-sharded leaves gathered just before the block runs and, in
  training, again in its recompute): phases 30-34 run it, then rank 0 of
  a fake process group of 256 on the single (16, 16) mesh, the first with
  a data axis larger than 1: jamba-1.5-large-398b's ``decode_32k`` at full
  depth (9 blocks, all 16 experts, 8 rows a rank) held to its dry-run
  (argument bytes exact, FLOPs within 0.01%, peak within 2%, collectives
  by kind and count, one block gather a block) and timed, and a
  llama3-8b train step at 4 of 32 layers (64 x 2048 in 4 microbatches, one
  row a rank a microbatch) held as phase 32 is, its block gathers two a
  block and microbatch, the flash kernel timed at its local shape.

Any failure raises; the last line of a passing run is
``{"ok": true, "device": {...}}``, after the ``kernels`` line and the
card's name and power limit.  Without a CUDA device it exits non-zero
before printing any result.  TF32 is turned off for matmuls and cuDNN,
so float32 products run in full float32."""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))         # torch_lm_cases

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12      # H100 SXM bf16 dense tensor cores
KERNELS = ("knn_topk", "flash_attention", "rwkv6_scan")

# the main path: the paper's large-scale setup, a fleet of 8 lanes
MAIN = dict(app="cq_large", fleet=8, k=16, offline=1000, offline_updates=100,
            epochs=50)
U = 1                           # the launcher's updates per online epoch
# the baselines at the same width (no offline pretraining: DDPG alone has it)
BASELINES = dict(app="cq_large", fleet=8, epochs=50)

# the LM serving paths: prefill_forward on 4 x 2048 tokens, and
# Engine.generate on 4 prompts of 64 tokens with 32 new greedy tokens
LM = dict(batch=4, prefill_len=2048, prompt_len=64, new_tokens=32, max_seq=128)
# decode throughput: serve_step timed over 2 windows of 32 steps (4 of 64
# until the script neared its time limit)
DECODE = dict(windows=2, steps=32)
# the LM configs beyond llama3-8b and rwkv6-7b, with the layers each runs:
# command-r-plus-104b (~208 GB in bf16) and qwen1.5-110b (~220 GB) cut to
# 16 layers to fit one 80 GB card; the others at full depth
LM_MORE = (("yi-34b", None), ("command-r-plus-104b", 16), ("qwen1.5-110b", 16),
           ("granite-moe-3b-a800m", None), ("qwen2-moe-a2.7b", None))
# the last three LM families (phase 25): phi-3-vision-4.2b and
# seamless-m4t-medium at full size; jamba-1.5-large-398b cut to one period-8
# block (8 of its 72 layers) and 12 of its 16 experts a MoE layer, 66.3 GiB
# of bf16 weights: one block with all 16 is 84.3 GiB, past the card's 79.6.
# jamba's float32 drift control runs on the same weights cut further, to
# JAMBA_F32_EXPERTS experts a MoE layer (~16.2 B parameters, 64.8 GB in
# float32), turned to float32 in place.  seamless's encoder reads
# ENCDEC_MEMORY_LEN frames, the reference's memory for its decode cells
LM_NEW = (("phi-3-vision-4.2b", None), ("seamless-m4t-medium", None),
          ("jamba-1.5-large-398b", dict(num_layers=8, num_experts=12)))
JAMBA_F32_EXPERTS = 4
ENCDEC_MEMORY_LEN = 4096
# the continuous batcher: 8 slots, a 2048-position shared cache, 32 seeded
# requests, the first 8 of 64 prompt and 32 new tokens, then 24 of 16-128
# prompt and 16-64 new tokens; greedy, no EOS.  With every request run to
# its budget, the seeded traffic takes 491 steps of the shared length
BATCHER = dict(slots=8, max_seq=2048, requests=32, first=8, first_prompt=64,
               first_new=32, prompt=(16, 128), new=(16, 64), seed=24, steps=491)
# the control-serving path: three decision kinds, 8 slots a plane, 16
# perturbed clusters, 256 requests, at the paper's large-scale setup
SERVE = dict(app="cq_large", clusters=16, requests=256, slots=8, seed=0)
# the streaming agents at the paper's large-scale setup, each lane slowing
# its own machine; structural fleets over the paper's three applications,
# two lanes a DAG
STREAMING = dict(app="cq_large", fleet=8, epochs=50, scenario="one_slow_machine")
STREAMING_AGENTS = ("stream_q", "stream_ac", "graph_policy")
STRUCTURAL = dict(apps=("cq_large", "log_stream", "word_count"), fleet=6, epochs=50)
# the expert-placement env at the reference's full size (16 experts on 16
# devices), 8 lanes, DDPG at the main path's budget
PLACEMENT = dict(app="placement", fleet=8, epochs=50, offline=1000,
                 offline_updates=100)
PLACEMENT_AGENTS = ("ddpg", "dqn", "round_robin", "stream_q", "stream_ac")
PLACEMENT_RUN_SCENARIOS = ("mixed", "one_slow_device")
# fleet checkpoints: the main path's DDPG fleet for 30 epochs saved every 10,
# killed after 20 and resumed; then every agent the port runs at a small
# size (F=2, T=4, saved every 2, killed after 2)
CHECKPOINT = dict(epochs=30, every=10, killed_at=20)
CHECKPOINT_SMALL = dict(fleet=2, epochs=4, every=2, killed_at=2)
CHECKPOINT_AGENTS = (
    *[("cq_small", a, "one_slow_machine") for a in
      ("ddpg", "dqn", "graph_policy", "model_based", "round_robin", "stream_ac",
       "stream_q")],
    ("structural", "graph_policy", "dag_shapes"),
    *[("placement", a, "mixed") for a in PLACEMENT_AGENTS])
# the elastic lane lifecycle: the main path's DDPG fleet with lanes 1 and 5
# stopped at epoch 16, the stop test every 8 epochs; killed at 24 (saved
# every 8) and resumed; the syncs of a steady-state epoch counted over 4
# epochs for every agent at its phase's width; a successive-halving search
# over 8 candidates
ELASTIC = dict(stop_at=16, stopped=(1, 5), killed_at=24, every=8, sync_epochs=4)
SYNC_AGENTS = (
    *[("cq_large", a, "one_slow_machine") for a in
      ("ddpg", "dqn", "round_robin", "model_based", *STREAMING_AGENTS)],
    ("structural", "graph_policy", "dag_shapes"),
    *[("placement", a, "mixed") for a in PLACEMENT_AGENTS])
SEARCH = dict(app="cq_large", fleet=8, rungs=(16, 16, 32), scenario="mixed")
# the paper's evaluation (phase 26): the CPU tests' tiny budget card against
# CPU on cq_small; the committed reward artifact's budget (Budget.quick at
# 60 online epochs, seed 0) held to its band; Fig 6's cq_large row and
# Fig 12 at Budget.quick
FIG_TINY = dict(offline_samples=60, offline_updates=10, online_epochs=6,
                updates_per_epoch=2, mb_samples=60, k_nn=4, n_seeds=2)
FIG_APP = "cq_large"
REWARD_ARTIFACT = os.path.join(ROOT, "artifacts", "paper", "reward_cq_small.json")
# the single-run entry and the examples' twins (phase 27), each twin at its
# reference script's budget (its run()'s defaults): the K-NN rows of a single
# run's select [N, M] and update [32·N, M] on cq_small (20 executors on 10
# machines) and on the placement env (16 experts on 16 devices), and of the
# scenario-fleet example's 8 lanes
SINGLE_SHAPES = ((20, 10), (640, 10), (16, 16), (512, 16), (160, 10), (5120, 10))
SINGLE_CHECK = dict(T=5, seed=27)
# LM training (phase 28): one float32 step card against CPU for a smoke
# config of each family; the kernels' Functions' backward at llama3-8b's
# prefill shape, seamless's cross-attention shape, a ragged S and in
# float32 on the CUDA cores; llama3-8b at every
# width cut to 4 of its 32 layers (1.92 B parameters: weights, float32
# moments and accumulator ~31 GB), bf16, batch 8 x 2048 in 4 microbatches
# (2 warm-up steps, 5 timed); the train_lm twin at its reference budget cut
# from 300 steps to TWIN_STEPS (killed and resumed half way)
TRAIN_FAMILIES = ("llama3-8b", "granite-moe-3b-a800m", "rwkv6-7b",
                  "jamba-1.5-large-398b", "phi-3-vision-4.2b", "seamless-m4t-medium")
TRAIN = dict(arch="llama3-8b", layers=4, batch=8, seq=2048, micro=4, warmup=2,
             timed=5, lr=3e-5, seed=28)    # at a 3e-4 peak the loss climbs
TWIN_STEPS = 100
# the fleet across slots and processes (phase 29): the main path's DDPG
# fleet under one_slow_machine on a 2-slot mesh on the card against the
# unmeshed run; the multi-host drill: 2 workers x 1 slot on the card,
# worker 1 killed once epoch 20 is published, 40 epochs saved every 10, at
# a small offline budget
MESH = dict(fleet=8, epochs=50, slots=2, scenario="one_slow_machine")
# LM training over a mesh (phase 30): phase 28c's llama3-8b, 2 steps
# sharded on make_production_mesh (a world of one on NCCL) and 2 unmeshed
MESH_TRAIN = dict(steps=2)
# the dry-run (phase 31): phase 28c's step traced on a fake world of one
# and held to the same step on the card; then the dry-run's command on four
# cells of the reference's grid at full depth, a fake world of 256 ranks
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"),
                ("llama3-8b", "decode_32k"), ("rwkv6-7b", "long_500k"))
DRYRUN_TIMEOUT_S = 300
# one rank of a 16-way model axis (phase 32): phase 28c's llama3-8b step on
# a fake process group of 16 (mesh (1, 16)), rank 0 on the card; a counted
# step held to the dry-run's prediction, then TP_RANK_STEPS timed and as
# many profiled
TP_RANK = dict(world=16, steps=2)
# phase 31b: llama3-8b train_4k's FLOPs a rank at 256 ranks, at most this
# multiple of 6·N·D / 256 (21.5x while the model axis repeated the work;
# the recompute and the float32 attention backward left ~1.35x, the
# recompute and the backward kernels' flops_bwd 1.27x)
TP_TRAIN_RATIO = 1.6
CARD_GIB = 80
# the tensor-parallel decode (phase 33): 33a llama3-8b and rwkv6-7b, 4 of 32
# layers at every width, bf16, batch 4, a cache of 2048 positions (llama's
# filled by prefill_forward over its first 2032, rwkv's states by a 64-token
# prompt through the unmeshed step), 16 steps meshed on a (1, 1) NCCL mesh
# and unmeshed; 33b one rank of a 16-way model axis at decode_32k's local
# shapes (8 rows, 32768 positions), full depth, in a fake process group of
# 16, its first step held to the dry-run, then ``timed`` steps timed and as
# many profiled
TP_DECODE = dict(layers=4, batch=4, max_seq=2048, steps=16, rwkv_prompt=64, world=16,
                 rows=8, seq=32768, timed=3)
# phase 31b: llama3-8b decode_32k at 256 ranks, FLOP and peak a rank at most
# these (2.5751e11 and 66.06 GiB while the decode gathered the cache and the
# tree whole: 1.25/16 of the first, and the card's tenth of the second)
TP_DECODE_CELL = dict(flops=2.01e10, peak_gib=8)
# expert parallelism and the tensor-parallel Mamba (phase 34): 34a on a (1, 1)
# NCCL mesh against unmeshed, bit for bit, granite-moe at full size decoding
# as 33a, jamba at one period-8 block with 4 of its 16 experts a MoE layer
# (30.3 GiB: the placed and gathered copies of the mesh of one sit beside
# the unmeshed weights, and phase 25's 12 experts, 66.3 GiB, leave no room
# for them) decoding as many steps, and granite-moe at 4 of 32 layers taking
# one train step of 2 x 2048; 34b one rank of 16 decoding as 33b (granite
# and qwen2-moe at full depth, jamba at 1 of 9 blocks with all 16 experts);
# 34c one rank of 16 of a qwen2-moe train step, 4 of 24 layers, 2 x 2048
# (both train steps cut to train_layers)
EP = dict(jamba_experts=4, train_layers=4, train_rows=2, train_seq=2048)
# per-block parameter gathering (phase 35): rank 0 of a fake process group
# of 256 on the single (16, 16) mesh, the first card phase whose data axis
# is larger than 1.  35a jamba-1.5-large-398b decode_32k at full depth (9
# blocks, all 16 experts, 8 rows of a 32768-position cache a rank), held
# to its dry-run as 33b and 34b are (argument bytes exact, FLOPs within
# 0.01%, peak within 2%, collectives by kind and count), then
# TP_DECODE["timed"] steps timed and as many profiled; 35b llama3-8b at 4
# of 32 layers, one train
# step of 64 x 2048 in 4 microbatches (one row a rank a microbatch), held
# as phase 32 is, its block gathers two a block and microbatch
BLOCKS = dict(mesh=(16, 16), decode_arch="jamba-1.5-large-398b", train_layers=4,
              train_rows=64, train_micro=4)
DRILL = dict(fleet=8, epochs=40, every=10, kill_at=20, offline=200,
             offline_updates=20)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call of ``fn`` called back to back from Python, host
    dispatch included (CUDA events around the whole loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 100, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    dispatch sits between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def regret_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| where want is finite; raises unless NaN and ±inf
    stand at the same places in both."""
    special = ~torch.isfinite(want)
    if not (torch.equal(special, ~torch.isfinite(got)) and torch.equal(
            got[special].nan_to_num(), want[special].nan_to_num())):
        raise AssertionError("kernel regret has NaN or inf where the plain "
                             "version has not")
    return float(torch.where(special, 0.0, got - want).abs().max())


def host_breakdown(proto, calls: int = 3000) -> dict:
    """Host µs per call of each step of an eager K-NN call at ``proto``'s
    shape (``time.perf_counter`` around ``calls`` calls of the step alone),
    of the whole wrapper, and of the steps the wrapper does not take in
    their place: three allocations, a device context on every call, the
    stream as a ``torch.cuda.Stream``, the library looked up each call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn_topk import ops

    *lead, m = proto.shape
    out = torch.empty((3, *lead), dtype=torch.int32, device=proto.device)
    rows = out[0].numel()
    entry = getattr(_build.load(ops.NAME, ops.SIGNATURES), ops.ENTRY)
    stream = torch.cuda.current_stream().cuda_stream
    index = proto.get_device()

    def outputs():
        out = proto.new_empty((3, *lead), dtype=torch.int32)
        return out[0], out[1], out[2].view(torch.float32)

    def device_context():
        with torch.cuda.device(proto.device):
            pass

    steps = {
        "checks": lambda: (proto.dtype != torch.float32, proto.dim() < 1,
                           proto.shape[-1] < 2, proto.is_contiguous(),
                           proto.is_cuda),
        "outputs: one [3, rows] new_empty, 3 views": outputs,
        "device check (get_device == current_device)":
            lambda: index == torch.cuda.current_device(),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "ctypes call (the launch)":
            lambda: entry(proto.data_ptr(), out.data_ptr(), rows, m, stream),
        "whole wrapper": lambda: ops.row_top2_regret(proto),
        "not taken: three torch.empty": lambda: [
            torch.empty(lead, dtype=dt, device=proto.device)
            for dt in (torch.int32, torch.int32, torch.float32)],
        "not taken: a torch.cuda.device context": device_context,
        "not taken: current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(proto.device).cuda_stream,
        "not taken: _build.load": lambda: _build.load(ops.NAME, ops.SIGNATURES),
    }
    us = {}
    for name, fn in steps.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return us


def knn_timing(proto, floor: float) -> dict:
    """The K-NN kernel, its plain version and the library call on ``proto
    [rows, m]``: device ms per call in a CUDA graph and eager, beside the
    bound (each input read once, each output written once, two compares an
    element)."""
    from repro_torch.kernels.knn_topk import row_top2_regret, row_top2_regret_ref

    def library(p=proto):
        v = torch.topk(p, 2).values
        return 2.0 * (v[:, 0] - v[:, 1])

    kernel = lambda p=proto: row_top2_regret(p)             # noqa: E731
    plain = lambda p=proto: row_top2_regret_ref(p)          # noqa: E731
    t = dict(ms=graph_ms(kernel), plain_ms=graph_ms(plain),
             library_ms=graph_ms(library), eager_ms=eager_ms(kernel),
             eager_plain_ms=eager_ms(plain),
             eager_library_ms=eager_ms(library), floor_ms=floor)
    rows, m = proto.shape
    bytes_moved = rows * m * 4 + rows * 12
    ops = rows * 2 * m                      # two compares per element
    t["bound_ms"] = max(bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    t["bound_by"] = ("bytes" if bytes_moved / HBM_BYTES_PER_S
                     >= ops / F32_OPS_PER_S else "operations")
    return t


def check_kernel(dev) -> dict:
    """Phase 3: the K-NN kernel against its plain version at every shape,
    on edge rows and on views off the 16-byte grid; its times beside the
    launch floor; the eager call's host time, step by step."""
    from repro_torch.kernels.knn_topk import row_top2_regret, row_top2_regret_ref
    from repro_torch.kernels.knn_topk.ref import edge_rows

    gen = torch.Generator(device=dev).manual_seed(0)
    # the cq_large update and select shapes, then DDPG's on the placement
    # env at F = 8: select [128, 16] and the update's target rows
    # [8, 32, 16, 16]
    placement_shapes = [(128, 16), (8, 32, 16, 16)]
    # a compacted cq_large fleet of 1-7 live lanes (phase 22): select
    # [F·100, 10] and update [F·32·100, 10]
    compacted = [(f * rows, 10) for f in range(1, 8) for rows in (100, 3200)]
    shapes = [(800, 10), (25600, 10), (7, 3), (1, 2), (513, 16),
              (300, 33)] + compacted + placement_shapes + list(SINGLE_SHAPES)
    cases = [(str(s), torch.rand(s, generator=gen, device=dev)) for s in shapes]
    # quantized rows: ties everywhere, incl. a best value held by several
    # columns and rows that are constant
    tied = torch.round(torch.rand(1000, 10, generator=gen, device=dev) * 3) / 3
    tied[:50] = 0.5
    cases.append(("tied", tied))
    # a batched [F, B, N, M] proto, noise added as exploration does
    cases.append(("[2,16,25,10]",
                  torch.rand(2, 16, 25, 10, generator=gen, device=dev) * 2))
    # NaN (first, middle, last, twice, beside +-inf), +-inf, all -inf, below
    # and tied with -1e30, -0.0, ties: every 16th of 300 rows
    for m in (2, 3, 10, 16, 33):
        names, rows = edge_rows(m)
        p = torch.rand(300, m, generator=gen, device=dev)
        p[::16][:len(names)] = rows.to(dev)
        cases.append((f"edge rows m={m}", p))
    # contiguous views 1-3 floats off the 16-byte grid, edge rows in them
    for off in (1, 2, 3):
        for n, m in ((25600, 10), (513, 16), (300, 33), (7, 3)):
            flat = torch.rand(off + n * m, generator=gen, device=dev)
            p = flat[off:].view(n, m)
            names, rows = edge_rows(m)
            k = min(n, len(names))
            p[-k:] = rows[:k].to(dev)
            cases.append((f"[{n},{m}] at offset {off}", p))
    max_err = placement_err = single_err = 0.0
    for what, proto in cases:
        b, s, r = row_top2_regret(proto)
        rb, rs, rr = row_top2_regret_ref(proto)
        torch.cuda.synchronize()
        if not (torch.equal(b, rb) and torch.equal(s, rs)):
            raise AssertionError(f"kernel indices differ at {what}")
        err = regret_err(r, rr)
        if err > 1e-6:
            raise AssertionError(f"kernel regret off by {err} at {what}")
        max_err = max(max_err, err)
        if what in map(str, placement_shapes):
            placement_err = max(placement_err, err)
        if what in map(str, SINGLE_SHAPES):
            single_err = max(single_err, err)
    log(f"phase 3 kernel vs plain version: {len(cases)} cases agree, edge rows "
        f"and offsets 1-3 among them (indices exact, NaN and inf at the same "
        f"places, max |regret err| {max_err}; at the placement shapes "
        f"{placement_shapes} {placement_err}; at the single-run shapes "
        f"{list(SINGLE_SHAPES)} {single_err}; the compacted cq_large shapes "
        f"{compacted} among them)")

    one = torch.zeros(1, device=dev)
    floor = graph_ms(lambda: one.fill_(1.0))
    log(f"  launch floor: a 1-element fill_ in the same CUDA graph harness "
        f"{floor:.6f} ms per call; eager {eager_ms(lambda: one.fill_(1.0)):.6f}")
    timings = {}
    # the cq_large update and select shapes, the placement select shape
    # (8 lanes x 16 experts, m = 16 devices), and a single run's update on
    # cq_small (32 samples x 20 executors, phase 27)
    for rows, width in ((25600, 10), (800, 10), (128, 16), (640, 10)):
        proto = torch.rand(rows, width, generator=gen, device=dev)
        m = proto.shape[1]
        t = timings[rows] = knn_timing(proto, floor)
        log(f"  [{rows},{m}] device ms per call (CUDA graph): kernel "
            f"{t['ms']:.6f} = floor + {(t['ms'] - floor) * 1e3:.3f} us  plain "
            f"{t['plain_ms']:.6f}  library (torch.topk + sub) "
            f"{t['library_ms']:.6f}  bound {t['bound_ms']:.6f} ({t['bound_by']})")
        log(f"  [{rows},{m}] eager ms per call (host dispatch included): "
            f"kernel {t['eager_ms']:.6f}  plain {t['eager_plain_ms']:.6f}  "
            f"library {t['eager_library_ms']:.6f}")
    # rows read from shared memory as float2 (m 10) or float4 (m 16) at
    # offset 0, as floats (2-way and 16-way bank conflicts) at offset 1
    for m in (10, 16):
        flat = torch.rand(1 + 25600 * m, generator=gen, device=dev)
        at = {off: graph_ms(lambda p=flat[off:off + 25600 * m].view(25600, m):
                            row_top2_regret(p)) for off in (0, 1)}
        log(f"  [25600,{m}] device ms per call at offset 0 (vector row reads) "
            f"{at[0]:.6f}, at offset 1 (scalar row reads, scalar head) {at[1]:.6f}")
    us = host_breakdown(torch.rand(25600, 10, generator=gen, device=dev))
    log("  eager host us per call at [25600,10] (perf_counter, 3000 calls a "
        "step): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    return dict(max_abs_err=max_err, placement_max_abs_err=placement_err,
                single_max_abs_err=single_err, timings=timings, host_us=us)


def check_beam(dev) -> None:
    """Phase 4: the K-NN beam on the card equals the beam on the CPU."""
    from repro_torch.core.knn_projection import knn_actions

    rng = np.random.default_rng(4)
    for shape, k, quant in [((8, 100, 10), 16, None), ((8, 32, 100, 10), 16, None),
                            ((2, 20, 10), 12, 4), ((3, 7, 3), 4, 2)]:
        p = rng.uniform(size=shape).astype(np.float32)
        if quant:
            p = np.round(p * quant) / quant
        gpu = knn_actions(torch.as_tensor(p, device=dev), k).cpu()
        cpu = knn_actions(torch.as_tensor(p), k)
        if not torch.equal(gpu, cpu):
            raise AssertionError(f"beam on the card differs from the CPU at {shape}")
    log("phase 4 K-NN beam: card == CPU, bit for bit, on 4 shapes")


def numpy_draws(rng, F: int, T: int, env, batch: int, updates: int = U,
                size0: int = 0, cap: int | None = None) -> list:
    """``T`` epochs of draws for ``F`` lanes from a numpy generator, for a
    run on the card and on the CPU alike: ``updates`` replay draws an
    epoch, epoch t's below ``size0 + t + 1`` (the rows stored by then),
    and below the buffer's capacity ``cap`` when given."""
    from repro_torch.core import EpochDraws

    # a DSDPS env measures 5 readings and walks S spout rates; the
    # placement env one step time and E expert loads
    dsdps = env.family == "scheduling"
    N, M = env.N, env.M
    S = env.workload.num_spouts if dsdps else env.N
    meas = (F, 5) if dsdps else (F,)
    draws = [dict(
        explore_add=torch.as_tensor(rng.uniform(size=F) < 0.7),
        explore_noise=torch.as_tensor(rng.uniform(size=(F, N, M)).astype(np.float32)),
        meas_z=torch.as_tensor(rng.normal(size=meas).astype(np.float32)),
        rate_z=torch.as_tensor(rng.normal(size=(F, S)).astype(np.float32)),
        replay_idx=torch.as_tensor(rng.integers(
            0, min(size0 + t + 1, cap or size0 + t + 1), (F, updates, batch))),
        explore_move=torch.as_tensor(rng.integers(0, N * M, F)),
    ) for t in range(T)]
    # the Gumbel draws (Stream AC(λ), graph_policy) after all the others
    return [EpochDraws(**d, explore_gumbel=torch.as_tensor(
        rng.gumbel(size=(F, N, M)).astype(np.float32))) for d in draws]


def check_loop_vs_cpu(dev) -> None:
    """Phase 5: cq_small, F=2, T=5 with the same draws on the card and CPU."""
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.core.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload

    F, T = 2, 5
    topo = apps.continuous_queries("small")
    histories, init = {}, None
    for where in ("cpu", dev):
        env = SchedulingEnv(topo, default_workload(topo), device=where)
        agent = make_agent("ddpg", env, k_nn=12)
        cfg = agent.cfg
        if init is None:
            init = ddpg_state_to_numpy(
                agent.init_fleet(torch.Generator().manual_seed(5), F, "cpu"))
        states = ddpg_state_from_numpy(init, where)
        draws = [d.to(where) for d in numpy_draws(
            np.random.default_rng(6), F, T, env, cfg.batch)]
        _, histories[str(where)] = run_online_fleet(
            0, env, agent, states, T, updates_per_epoch=U, draws=draws)
    cpu, gpu = histories["cpu"], histories[str(dev)]
    np.testing.assert_array_equal(gpu.moved, cpu.moved)
    np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
    np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=1e-4)
    log(f"phase 5 cq_small F={F} T={T}: card == CPU (moved exact, latencies "
        f"max rel diff {np.abs(gpu.latencies / cpu.latencies - 1).max():.3g})")


def run_main_path(dev):
    """Phase 6: the launcher's ``run`` at cq_large, fleet 8, on the card."""
    from repro_torch.kernels.knn_topk import ops
    from repro_torch.launch import drl_control

    ops.LAUNCHES = 0
    res = drl_control.run(device=dev, **MAIN)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES

    hist, env = res["history"], res["env"]
    F, T = MAIN["fleet"], MAIN["epochs"]
    if not (np.isfinite(hist.rewards).all() and np.isfinite(hist.latencies).all()):
        raise AssertionError("non-finite rewards or latencies on the main path")
    if hist.rewards.shape != (F, T) or (hist.latencies <= 0).any():
        raise AssertionError(f"bad traces: shape {hist.rewards.shape}")
    X = hist.final_assignment
    if X.shape != (F, env.N, env.M) or not np.array_equal(X.sum(-1), np.ones((F, env.N))):
        raise AssertionError("final assignments are not one-hot per executor")
    if not (np.isfinite(res["finals"]).all() and (res["finals"] > 0).all()):
        raise AssertionError("non-finite final latencies")
    want = MAIN["offline_updates"] + T * (1 + U)
    if launches != want:
        raise AssertionError(f"row_top2_regret launched {launches} times on the "
                             f"main path, expected {want}")
    finals, rrs, s = res["finals"], res["rrs"], res["seconds"]
    log(f"phase 6 main path {MAIN['app']} N={env.N} M={env.M} fleet={F}: "
        f"{launches} kernel launches (= {MAIN['offline_updates']} offline "
        f"updates + {T} epochs x (1 select + {U} update))")
    log(f"  wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in s.items()))
    log(f"  online {res['lane_epochs_per_s']:.1f} lane-epochs/s")
    log(f"  final latency {finals.mean():.4f} ± {finals.std():.4f} ms vs "
        f"round-robin {rrs.mean():.4f} ms (improvement "
        f"{1 - finals.mean() / rrs.mean():.2%} mean, "
        f"{1 - finals[res['best']] / rrs[res['best']]:.2%} best lane)")
    return launches, res


def check_baselines_vs_cpu(dev) -> None:
    """Phase 14: round-robin, DQN and model-based lanes, cq_small, F=2, T=5,
    under a mixed scenario fleet, on the card and on the CPU from the same
    states (made on the CPU), scenarios and draws."""
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.core.convert import dqn_state_from_numpy, dqn_state_to_numpy
    from repro_torch.dsdps import EnvParams, SchedulingEnv, apps, scenarios
    from repro_torch.dsdps.apps import default_workload

    F, T = 2, 5
    topo = apps.continuous_queries("small")
    cpu_env = SchedulingEnv(topo, default_workload(topo), device="cpu")
    params = scenarios.build("mixed", cpu_env, F, broadcast_invariant=True)
    rng = np.random.default_rng(14)
    for name in ("round_robin", "dqn", "model_based"):
        agent = make_agent(name, cpu_env)
        init = agent.init_fleet(torch.Generator().manual_seed(14), F, "cpu",
                                env_params=params)
        if name == "dqn":
            init = dqn_state_to_numpy(init)
        draws = numpy_draws(rng, F, T, cpu_env, getattr(agent.cfg, "batch", 1))
        hists = {}
        for where in ("cpu", dev):
            env = SchedulingEnv(topo, default_workload(topo), device=where)
            ag = make_agent(name, env)
            states = (dqn_state_from_numpy(init, where) if name == "dqn"
                      else init.clone().to(where))
            _, hists[str(where)] = run_online_fleet(
                0, env, ag, states, T, updates_per_epoch=U,
                env_params=EnvParams(*(x.to(where) for x in params)),
                draws=[d.to(where) for d in draws])
        cpu, gpu = hists["cpu"], hists[str(dev)]
        np.testing.assert_array_equal(gpu.moved, cpu.moved)
        np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
        # DQN learns over the 5 epochs (1e-4, as phase 5's DDPG); the
        # other two only read the simulator and the fitted model
        rtol = 1e-4 if name == "dqn" else 1e-5
        np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=rtol)
        np.testing.assert_allclose(gpu.rewards, cpu.rewards, rtol=rtol)
        log(f"phase 14 {name} cq_small F={F} T={T} under mixed: card == CPU "
            f"(moved {cpu.moved.sum()} in all, exact; final assignments exact; "
            f"latencies max rel diff "
            f"{np.abs(gpu.latencies / cpu.latencies - 1).max():.3g}, tol {rtol})")


def run_baselines(dev, card: str) -> dict:
    """Phase 15: the launcher's ``run`` at cq_large, fleet 8, under
    one_slow_machine, for round-robin, model-based (its fit in ``init``)
    and DQN; then the model-based select's peak memory and the greedy
    local search's wall time on the fitted lanes."""
    from repro_torch.core import model_based as mb
    from repro_torch.dsdps import lane_params
    from repro_torch.launch import drl_control

    out = {}
    for agent in ("round_robin", "model_based", "dqn"):
        res = drl_control.run(device=dev, agent=agent, scenario="one_slow_machine",
                              **BASELINES)
        torch.cuda.synchronize()
        hist, env, params = res["history"], res["env"], res["env_params"]
        F, T = BASELINES["fleet"], BASELINES["epochs"]
        if not (np.isfinite(hist.rewards).all() and np.isfinite(hist.latencies).all()
                and hist.rewards.shape == (F, T) and (hist.latencies > 0).all()):
            raise AssertionError(f"{agent}: bad traces at cq_large")
        X = hist.final_assignment
        if X.shape != (F, env.N, env.M) or not np.array_equal(X.sum(-1), np.ones((F, env.N))):
            raise AssertionError(f"{agent}: final assignments are not one-hot")
        rr = env.round_robin_assignment()
        for f in range(F):
            lane_p = lane_params(params, env.default_params(), f)
            own = float(env.evaluate(rr, lane_p.base_rates, params=lane_p))
            if not abs(res["rrs"][f] / own - 1) <= 1e-6:
                raise AssertionError(f"{agent}: lane {f}'s round-robin score "
                                     f"{res['rrs'][f]} is not its own {own}")
        if len(set(res["rrs"])) == 1:
            raise AssertionError(f"{agent}: the lanes' scenarios do not differ")
        finals, rrs, s = res["finals"], res["rrs"], res["seconds"]
        if agent == "round_robin" and not np.allclose(finals, rrs, rtol=1e-6):
            raise AssertionError("round_robin lanes left round-robin")
        log(f"phase 15 {agent} {BASELINES['app']} N={env.N} M={env.M} fleet={F} "
            f"T={T} under one_slow_machine ({card}): wall s "
            + ", ".join(f"{k} {v:.3f}" for k, v in s.items())
            + f"; online {res['lane_epochs_per_s']:.1f} lane-epochs/s; final "
            f"latency {finals.mean():.4f} ± {finals.std():.4f} ms (lanes "
            f"{finals.min():.4f}-{finals.max():.4f}) vs each lane's "
            f"round-robin {rrs.mean():.4f} ms (improvement "
            f"{1 - finals.mean() / rrs.mean():.2%} mean, "
            f"{1 - finals[res['best']] / rrs[res['best']]:.2%} best lane)")
        out[agent] = res
        if agent == "model_based":
            ag, thetas = res["agent"], res["states"]
            state = env.reset(F, params)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ag.select_fn(ag.cfg, thetas, None, state, params, True, None, None)
            torch.cuda.synchronize()
            t_select = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            t0 = time.perf_counter()
            mb.sweep_schedule_fleet(state.X, state.w, thetas, env, params, 3)
            torch.cuda.synchronize()
            t_sweep = time.perf_counter() - t0
            log(f"  model_based select over {F} x {env.N * env.M} moves: peak "
                f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held, "
                f"{t_select * 1e3:.3f} ms; sweep_schedule_fleet ({env.N} x 3 "
                f"steps of {env.M} candidates, eager) {t_sweep:.3f} s")
            res["select_peak_bytes"], res["sweep_s"] = peak, t_sweep
    return out


def run_ddpg_mixed(dev, card: str):
    """Phase 16: the launcher's DDPG at the main path's budget under a mixed
    scenario fleet; every select and update through the K-NN kernel."""
    from repro_torch.kernels.knn_topk import ops
    from repro_torch.launch import drl_control

    ops.LAUNCHES = 0
    res = drl_control.run(device=dev, scenario="mixed", **MAIN)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES
    hist, env = res["history"], res["env"]
    F, T = MAIN["fleet"], MAIN["epochs"]
    if not (np.isfinite(hist.rewards).all() and np.isfinite(res["finals"]).all()
            and hist.rewards.shape == (F, T)):
        raise AssertionError("non-finite traces on the DDPG mixed path")
    if not np.array_equal(hist.final_assignment.sum(-1), np.ones((F, env.N))):
        raise AssertionError("final assignments are not one-hot per executor")
    want = MAIN["offline_updates"] + T * (1 + U)
    if launches != want:
        raise AssertionError(f"row_top2_regret launched {launches} times on the "
                             f"mixed DDPG path, expected {want}")
    finals, rrs, s = res["finals"], res["rrs"], res["seconds"]
    log(f"phase 16 ddpg {MAIN['app']} fleet={F} under mixed ({card}): {launches} "
        f"kernel launches (= {MAIN['offline_updates']} offline updates + {T} "
        f"epochs x (1 select + {U} update)); wall s "
        + ", ".join(f"{k} {v:.3f}" for k, v in s.items())
        + f"; online {res['lane_epochs_per_s']:.1f} lane-epochs/s; final latency "
        f"{finals.mean():.4f} ± {finals.std():.4f} ms vs each lane's round-robin "
        f"{rrs.mean():.4f} ms")
    return launches


def run_serving(dev, card: str) -> int:
    """Phase 17: ``launch/serve_control`` at cq_large — placement (DDPG,
    K = 8), rate_control and auto_tune planes of 8 slots, 16 clusters from
    ``sample_perturbed``, 256 requests — on the card and on the CPU with
    the same weights, clusters and requests.  The card's decisions must be
    the CPU's; the placement plane must launch the K-NN kernel once a step;
    one plane step must wait on the device once (the actions' pull).
    Returns the K-NN launches of the card's run."""
    import warnings

    from repro_torch.core import spaces
    from repro_torch.kernels.knn_topk import ops
    from repro_torch.launch import serve_control as sc
    from repro_torch.launch.drl_control import build_env

    runs = {}
    for where in ("cpu", dev):
        env = build_env(SERVE["app"], where)
        svc = sc.build_service(env, n_slots=SERVE["slots"], seed=SERVE["seed"])
        sc.register_perturbed(svc, env, SERVE["clusters"], seed=SERVE["seed"])
        reqs = sc.synthetic_requests(env, svc, SERVE["requests"], seed=SERVE["seed"])
        if where == dev:
            ops.LAUNCHES = 0
        runs[str(where)] = (env, svc, sc.serve(svc, reqs))
        if where == dev:
            torch.cuda.synchronize()
            launches = ops.LAUNCHES
    cpu_env, cpu_svc, cpu = runs["cpu"]
    env, svc, res = runs[str(dev)]
    steps = {where: {k: p.steps for k, p in s.planes.items()}
             for where, (_, s, _) in runs.items()}
    placement_steps = steps[str(dev)]["placement"]
    if launches != placement_steps or launches == 0:
        raise AssertionError(f"the placement plane took {placement_steps} steps and "
                             f"launched the K-NN kernel {launches} times")
    if len(res["served"]) != SERVE["requests"]:
        raise AssertionError(f"served {len(res['served'])} of {SERVE['requests']}")
    # card == CPU, request by request; auto_tune and placement may differ
    # only where the CPU's own scores of the two choices tie to 1e-5
    want = {r.rid: r for r in cpu["served"]}
    exact = near = 0
    for r in res["served"]:
        w = want[r.rid]
        if (r.action.shape != spaces.action_space(r.kind).shape_fn(env)
                or not np.isfinite(r.action).all()):
            raise AssertionError(f"request {r.rid}: bad action shape {r.action.shape}")
        if np.array_equal(r.action, w.action):
            exact += 1
            continue
        near_tie(cpu_env, cpu_svc, r, w)
        near += 1
    # one more request a plane, under the sync debug mode: a plane step's
    # only wait on the device is the pull of its actions
    extra = sc.synthetic_requests(env, svc, len(svc.kinds), seed=SERVE["seed"] + 1)
    for r in extra:
        r.rid += SERVE["requests"]
        svc.submit(r)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            svc.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    if syncs != len(svc.kinds):
        raise AssertionError(f"{syncs} synchronizing calls in one step of "
                             f"{len(svc.kinds)} planes, expected one a plane: "
                             + "; ".join(str(w.message)[:120] for w in caught))
    log(f"phase 17 serve_control {SERVE['app']} N={env.N} M={env.M}: "
        f"{len(svc.kinds)} kinds x {SERVE['slots']} slots, {SERVE['clusters']} "
        f"clusters, {SERVE['requests']} requests ({card}); card == CPU on "
        f"{exact} decisions exactly, {near} near-ties; K-NN launches "
        f"{launches} over {placement_steps} placement steps "
        f"({launches / placement_steps:.0f} a step, [{SERVE['slots']}x{env.N}, "
        f"{env.M}] rows); {syncs} waits on the device in one service step "
        f"({len(svc.kinds)} planes)")
    for name, where in (("card", str(dev)), ("cpu", "cpu")):
        e, s, r = runs[where]
        log(f"  {name}: {r['decisions_per_s']:.1f} decisions/s after warm-up "
            f"({len(r['served']) - len(r['warm'])} in {r['wall_s']:.4f} s; plane "
            f"steps {steps[where]}); " + "; ".join(
                f"{k} n={st['n']} p50 {st['p50_ms']:.4f} ms p99 {st['p99_ms']:.4f} ms"
                for k, st in r["stats"].items()))
        for kind, t in time_plane_steps(s, e, on_card=name == "card").items():
            log(f"    {kind} plane step ({SERVE['slots']} slots): median "
                f"{t['ms']:.4f} ms wall" + (
                    f", device busy {t['busy_ms']:.4f} ms in {t['kernels']:.0f} "
                    f"kernels ({t['busy_ms'] / t['ms']:.1%})" if "busy_ms" in t
                    else ""))
    return launches


def streaming_io(name: str):
    """(state to numpy, numpy to state) of a streaming agent or the graph
    policy: a fleet made once is carried to the card and to the CPU."""
    from repro_torch.core import convert

    return {"stream_q": (convert.stream_q_state_to_numpy,
                         convert.stream_q_state_from_numpy),
            "stream_ac": (convert.stream_ac_state_to_numpy,
                          convert.stream_ac_state_from_numpy),
            "graph_policy": (convert.graph_policy_state_to_numpy,
                             convert.graph_policy_state_from_numpy)}[name]


def profile_fleet(env, agent, states, params, epochs: int = 5,
                  updates: int = 1) -> dict:
    """Wall ms per online epoch (``updates`` updates each) without and with
    ``torch.profiler`` (after two warm epochs), and from the trace the
    device's busy ms, kernels per epoch and the six kernels that take the
    most device time (phases 7, 18, 19, 27)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import run_online_fleet

    gen = torch.Generator(device=env.device).manual_seed(3)
    run_online_fleet(gen, env, agent, states, 2, updates_per_epoch=updates,
                     env_params=params)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_online_fleet(gen, env, agent, states, epochs, updates_per_epoch=updates,
                     env_params=params)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / epochs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_online_fleet(gen, env, agent, states, epochs, updates_per_epoch=updates,
                         env_params=params)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) / epochs
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / epochs
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return dict(wall_ms=wall * 1e3, wall_prof_ms=wall_prof * 1e3,
                busy_ms=busy_us / 1e3, kernels=len(kernels) / epochs,
                busy_share=busy_us / (wall * 1e6),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])


def log_fleet_run(what: str, res: dict, prof: dict) -> None:
    finals, rrs = res["finals"], res["rrs"]
    log(f"  {what}: wall s " + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
        + f"; online {res['lane_epochs_per_s']:.1f} lane-epochs/s; epoch "
        f"{prof['wall_ms']:.3f} ms unprofiled ({prof['wall_prof_ms']:.3f} profiled), "
        f"{prof['kernels']:.0f} kernels/epoch, device busy {prof['busy_ms']:.3f} "
        f"ms/epoch = {prof['busy_share']:.1%}")
    log(f"    final latency {finals.mean():.4f} ± {finals.std():.4f} ms vs each "
        f"lane's round-robin {rrs.mean():.4f} ms (improvement "
        f"{1 - finals.mean() / rrs.mean():.2%} mean, "
        f"{1 - finals[res['best']] / rrs[res['best']]:.2%} best lane); per lane "
        "final/round-robin ms: " + ", ".join(f"{a:.4f}/{b:.4f}"
                                             for a, b in zip(finals, rrs)))


def check_fleet_result(what: str, res: dict, F: int, T: int) -> None:
    """Finite traces of the expected shape, one-hot final assignments on the
    real executors, every lane scored under its own params."""
    from repro_torch.dsdps import lane_params
    from repro_torch.launch.drl_control import nominal_load

    hist, env, params = res["history"], res["env"], res["env_params"]
    if not (np.isfinite(hist.rewards).all() and np.isfinite(hist.latencies).all()
            and hist.rewards.shape == (F, T) and (hist.latencies > 0).all()):
        raise AssertionError(f"{what}: bad traces")
    if not (np.isfinite(res["finals"]).all() and (res["finals"] > 0).all()):
        raise AssertionError(f"{what}: non-finite final latencies")
    rr = env.round_robin_assignment()
    for f in range(F):
        lane_p = lane_params(params, env.default_params(), f)
        rows = hist.final_assignment[f].sum(-1)
        want = lane_p.node_mask.cpu().numpy() if env.structural else np.ones(env.N)
        if not np.array_equal(rows, want):
            raise AssertionError(f"{what}: lane {f}'s final assignment is not "
                                 "one-hot on its real executors")
        own = float(env.evaluate(rr, nominal_load(env, lane_p), params=lane_p))
        if not abs(res["rrs"][f] / own - 1) <= 1e-6:
            raise AssertionError(f"{what}: lane {f}'s round-robin score "
                                 f"{res['rrs'][f]} is not its own {own}")


def check_streaming_vs_cpu(dev) -> None:
    """Phase 18, first part: Stream Q(λ), Stream AC(λ) and the graph policy
    at cq_small, F=2, T=5, on the card and on the CPU from the same states
    (made on the CPU) and the same numpy draws: moves exact, latencies
    within 1e-5."""
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload

    F, T = 2, 5
    topo = apps.continuous_queries("small")
    cpu_env = SchedulingEnv(topo, default_workload(topo), device="cpu")
    rng = np.random.default_rng(18)
    for name in STREAMING_AGENTS:
        dump, load = streaming_io(name)
        init = dump(make_agent(name, cpu_env).init_fleet(
            torch.Generator().manual_seed(18), F, "cpu"))
        draws = numpy_draws(rng, F, T, cpu_env, 1)
        hists = {}
        for where in ("cpu", dev):
            env = SchedulingEnv(topo, default_workload(topo), device=where)
            _, hists[str(where)] = run_online_fleet(
                0, env, make_agent(name, env), load(init, where), T,
                draws=[d.to(where) for d in draws])
        cpu, gpu = hists["cpu"], hists[str(dev)]
        np.testing.assert_array_equal(gpu.moved, cpu.moved)
        np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
        np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=1e-5)
        np.testing.assert_allclose(gpu.rewards, cpu.rewards, rtol=1e-5)
        log(f"phase 18 {name} cq_small F={F} T={T}: card == CPU (moved "
            f"{cpu.moved.sum()} in all, exact; final assignments exact; latencies "
            f"max rel diff {np.abs(gpu.latencies / cpu.latencies - 1).max():.3g}, "
            "tol 1e-5)")


def run_streaming(dev, card: str) -> dict:
    """Phase 18: the launcher's ``run`` at cq_large, fleet 8, 50 epochs,
    under one_slow_machine, for each streaming agent and the graph policy
    (on the topology's static graph); then 5 more epochs under the
    profiler.  No kernel of the port lies on these paths."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import drl_control

    out = {}
    F, T = STREAMING["fleet"], STREAMING["epochs"]
    for agent in STREAMING_AGENTS:
        knn_ops.LAUNCHES = fa_ops.LAUNCHES = wkv_ops.LAUNCHES = 0
        res = drl_control.run(device=dev, agent=agent, **STREAMING)
        torch.cuda.synchronize()
        env = res["env"]
        check_fleet_result(f"phase 18 {agent}", res, F, T)
        if knn_ops.LAUNCHES or fa_ops.LAUNCHES or wkv_ops.LAUNCHES:
            raise AssertionError(f"{agent}: a kernel of the port ran on its path")
        edges = ""
        if agent == "graph_policy":
            n_edges = len(res["agent"].cfg.static_edge_src)
            if n_edges != 2475:
                raise AssertionError(f"graph_policy's static graph has {n_edges} edges")
            edges = f", static graph of {n_edges} edges"
        log(f"phase 18 {agent} {STREAMING['app']} N={env.N} M={env.M} fleet={F} "
            f"T={T} under {STREAMING['scenario']} ({card}{edges})")
        prof = profile_fleet(env, res["agent"], res["states"], res["env_params"])
        log_fleet_run(agent, res, prof)
        out[agent] = dict(lane_epochs_per_s=res["lane_epochs_per_s"], **prof)
    return out


def check_structural_vs_cpu(dev) -> None:
    """Phase 19, first part: the graph policy under dag_shapes on the
    default envelope (cq_small, diamond, wide_fanout; F=3, T=5).  Card ==
    CPU on moves; on the card lane f equals a fleet of one under its own
    DAG (moves exact, latencies within 1e-5); each padded topology's
    round-robin latency within 1e-5 of its plain env's."""
    from repro_torch.core import EpochDraws, convert, make_agent, run_online_fleet
    from repro_torch.dsdps import (SchedulingEnv, StructuralSchedulingEnv, apps,
                                   lane_params, scenarios)
    from repro_torch.dsdps.apps import default_workload

    F, T = 3, 5
    dump, load = streaming_io("graph_policy")
    cpu_env = StructuralSchedulingEnv(apps.structural_topologies(), device="cpu")
    init = dump(make_agent("graph_policy", cpu_env).init_fleet(
        torch.Generator().manual_seed(19), F, "cpu"))
    draws = numpy_draws(np.random.default_rng(19), F, T, cpu_env, 1)
    hists, envs = {}, {}
    for where in ("cpu", dev):
        env = envs[str(where)] = StructuralSchedulingEnv(apps.structural_topologies(),
                                                         device=where)
        params = scenarios.build("dag_shapes", env, F)
        _, hists[str(where)] = run_online_fleet(
            0, env, make_agent("graph_policy", env), load(init, where), T,
            env_params=params, draws=[d.to(where) for d in draws])
    cpu, gpu = hists["cpu"], hists[str(dev)]
    np.testing.assert_array_equal(gpu.moved, cpu.moved)
    np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
    np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=1e-5)
    env = envs[str(dev)]
    params = scenarios.build("dag_shapes", env, F)
    lane_diff = 0.0
    for f in range(F):
        lane_p = lane_params(params, env.default_params(), f)
        _, one = run_online_fleet(
            0, env, make_agent("graph_policy", env),
            load(convert.lane_arrays(init, f), dev), T, env_params=lane_p,
            draws=[EpochDraws(*(x[f:f + 1].to(dev) for x in d)) for d in draws])
        np.testing.assert_array_equal(one.moved[0], gpu.moved[f])
        np.testing.assert_array_equal(one.final_assignment[0], gpu.final_assignment[f])
        np.testing.assert_allclose(one.latencies[0], gpu.latencies[f], rtol=1e-5)
        lane_diff = max(lane_diff, float(np.abs(one.latencies[0] / gpu.latencies[f]
                                                - 1).max()))
    rr_diff = 0.0
    for t in env.topologies:
        plain = SchedulingEnv(t, default_workload(t), device=dev)
        p = env.params_for(t)
        got = float(env.evaluate(env.round_robin_assignment(), p.base_rates, params=p))
        want = float(plain.evaluate(plain.round_robin_assignment(),
                                    plain.default_params().base_rates))
        if not abs(got / want - 1) <= 1e-5:
            raise AssertionError(f"{t.name}: padded round-robin {got} ms, plain {want}")
        rr_diff = max(rr_diff, abs(got / want - 1))
    log(f"phase 19 graph_policy dag_shapes {[t.name for t in env.topologies]} "
        f"(N={env.N}, E={env.envelope.max_edges}) F={F} T={T}: card == CPU (moved "
        f"{cpu.moved.sum()} in all, exact; latencies max rel diff "
        f"{np.abs(gpu.latencies / cpu.latencies - 1).max():.3g}); on the card lane "
        f"== single run (moves exact, latencies max rel diff {lane_diff:.3g}); padded "
        f"round-robin vs plain env max rel diff {rr_diff:.3g}")


def run_structural(dev, card: str) -> dict:
    """Phase 19: the envelope over the paper's three applications
    (cq_large, log_stream, word_count: N=100, E=2475, S=10, C=6), the graph
    policy under dag_shapes with 6 lanes (two a DAG) for 50 epochs through
    the launcher's ``run``; then 5 epochs under the profiler."""
    from repro_torch.dsdps import StructuralSchedulingEnv, apps
    from repro_torch.launch import drl_control

    F, T = STRUCTURAL["fleet"], STRUCTURAL["epochs"]
    env = StructuralSchedulingEnv([apps.ALL_APPS[a]() for a in STRUCTURAL["apps"]],
                                  device=dev)
    e = env.envelope
    if (e.max_execs, e.max_edges, e.max_spouts, e.max_components) != (100, 2475, 10, 6):
        raise AssertionError(f"unexpected envelope {e}")
    res = drl_control.run(app="structural", env=env, agent="graph_policy", fleet=F,
                          epochs=T, scenario="dag_shapes", device=dev)
    torch.cuda.synchronize()
    check_fleet_result("phase 19", res, F, T)
    log(f"phase 19 graph_policy dag_shapes over {list(STRUCTURAL['apps'])} "
        f"(N={e.max_execs}, E={e.max_edges}, S={e.max_spouts}, C={e.max_components}) "
        f"fleet={F} T={T} ({card})")
    prof = profile_fleet(env, res["agent"], res["states"], res["env_params"])
    log_fleet_run("graph_policy", res, prof)
    return dict(lane_epochs_per_s=res["lane_epochs_per_s"], **prof)


def agent_io(name: str):
    """(state to numpy, numpy to state) of any agent the placement env
    runs: a fleet made once is carried to the card and to the CPU."""
    from repro_torch.core import convert

    if name == "round_robin":                 # its state is a bare [F] tensor
        return (lambda st: st.clone(), lambda x, where: x.clone().to(where))
    if name == "ddpg":
        return convert.ddpg_state_to_numpy, convert.ddpg_state_from_numpy
    if name == "dqn":
        return convert.dqn_state_to_numpy, convert.dqn_state_from_numpy
    return streaming_io(name)


def check_placement_vs_cpu(dev) -> None:
    """Phase 20, first part: the five agents on the expert-placement env at
    the reference's full size (16 experts, 16 devices), F=2, T=8, under a
    mixed fleet, on the card and on the CPU from the same states (made on
    the CPU), skew draws and epoch draws: moves exact, step times within
    1e-5."""
    from repro_torch.core import jamba_placement_env, make_agent, run_online_fleet
    from repro_torch.dsdps import scenarios

    F, T = 2, 8
    cpu_env = jamba_placement_env(device="cpu")
    rng = np.random.default_rng(20)
    skew_z = torch.as_tensor(rng.normal(size=(F, cpu_env.N)).astype(np.float32))
    for name in PLACEMENT_AGENTS:
        dump, load = agent_io(name)
        agent = make_agent(name, cpu_env)
        init = dump(agent.init_fleet(torch.Generator().manual_seed(20), F, "cpu"))
        draws = numpy_draws(rng, F, T, cpu_env, getattr(agent.cfg, "batch", 1))
        hists = {}
        for where in ("cpu", dev):
            env = jamba_placement_env(device=where)
            params = scenarios.build_for(env, "mixed", F, skew_z=skew_z.to(where))
            _, hists[str(where)] = run_online_fleet(
                0, env, make_agent(name, env), load(init, where), T,
                updates_per_epoch=U, env_params=params,
                draws=[d.to(where) for d in draws])
        cpu, gpu = hists["cpu"], hists[str(dev)]
        np.testing.assert_array_equal(gpu.moved, cpu.moved)
        np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
        np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=1e-5)
        np.testing.assert_allclose(gpu.rewards, cpu.rewards, rtol=1e-5)
        log(f"phase 20 {name} placement E={cpu_env.N} D={cpu_env.M} F={F} T={T} "
            f"under mixed: card == CPU (moved {cpu.moved.sum()} in all, exact; "
            f"final assignments exact; step times max rel diff "
            f"{np.abs(gpu.latencies / cpu.latencies - 1).max():.3g}, tol 1e-5)")


def run_placement(dev, card: str) -> dict:
    """Phase 20: the launcher's ``run`` on the expert-placement env, fleet
    8, 50 epochs, for each of the five agents under mixed and
    one_slow_device (DDPG pretrained at the main path's budget, its selects
    and updates through the K-NN kernel at m = 16); then 5 more epochs
    under the profiler.  Returns the K-NN launches of DDPG's mixed run and
    each run's numbers."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import drl_control

    F, T = PLACEMENT["fleet"], PLACEMENT["epochs"]
    out, knn = {}, None
    for scenario in PLACEMENT_RUN_SCENARIOS:
        for agent in PLACEMENT_AGENTS:
            knn_ops.LAUNCHES = fa_ops.LAUNCHES = wkv_ops.LAUNCHES = 0
            res = drl_control.run(device=dev, agent=agent, scenario=scenario,
                                  **PLACEMENT)
            torch.cuda.synchronize()
            launches = knn_ops.LAUNCHES
            env = res["env"]
            check_fleet_result(f"phase 20 {agent} {scenario}", res, F, T)
            if fa_ops.LAUNCHES or wkv_ops.LAUNCHES:
                raise AssertionError(f"{agent}: an LM kernel ran on the placement path")
            want = PLACEMENT["offline_updates"] + T * (1 + U) if agent == "ddpg" else 0
            if launches != want:
                raise AssertionError(f"{agent} {scenario}: row_top2_regret launched "
                                     f"{launches} times, expected {want}")
            if agent == "ddpg" and scenario == "mixed":
                knn = launches
            log(f"phase 20 {agent} placement E={env.N} D={env.M} fleet={F} T={T} "
                f"under {scenario} ({card}): {launches} K-NN launches at m = {env.M}")
            prof = profile_fleet(env, res["agent"], res["states"], res["env_params"])
            log_fleet_run(agent, res, prof)
            out[(agent, scenario)] = dict(lane_epochs_per_s=res["lane_epochs_per_s"],
                                          launches=launches, **prof)
    return dict(knn_launches=knn, runs=out)


def run_gap(a: dict, b: dict, skip_a: int = 0) -> dict:
    """How far two runs of the launcher (or ``run_online_fleet``) differ:
    the first epoch whose moves differ (None when none do), whether the
    final assignments are equal, and the largest absolute difference of
    the rewards, the latencies and any agent-state leaf.  ``skip_a`` drops
    ``a``'s first epochs (a resumed ``b`` holds only the later ones)."""
    from repro_torch.checkpoint import named_leaves

    ha, hb = a["history"], b["history"]
    diff = np.flatnonzero((ha.moved[:, skip_a:] != hb.moved).any(axis=0))
    la, lb = named_leaves(a["states"]), named_leaves(b["states"])
    if [n for n, _ in la] != [n for n, _ in lb]:
        raise AssertionError("the two runs' states hold other leaves")
    states = max(float((x.detach().double() - y.detach().double()).abs().max())
                 for (_, x), (_, y) in zip(la, lb) if x.numel())
    return dict(first_move_diff=None if diff.size == 0 else int(diff[0]) + skip_a,
                final_equal=bool(np.array_equal(ha.final_assignment, hb.final_assignment)),
                rewards=float(np.abs(ha.rewards[:, skip_a:] - hb.rewards).max()),
                latencies=float(np.abs(ha.latencies[:, skip_a:] - hb.latencies).max()),
                states=states)


def check_within(what: str, gap: dict, bar: dict) -> None:
    """Moves and final assignments exact; rewards, latencies and state
    leaves within the bar that two uninterrupted card runs set."""
    if gap["first_move_diff"] is not None or not gap["final_equal"]:
        raise AssertionError(f"{what}: moves differ from epoch "
                             f"{gap['first_move_diff']} (final assignments equal: "
                             f"{gap['final_equal']})")
    for key in ("rewards", "latencies", "states"):
        if not gap[key] <= bar[key]:
            raise AssertionError(f"{what}: {key} differ by {gap[key]!r}, beyond the "
                                 f"card-to-card bar {bar[key]!r}")


@contextlib.contextmanager
def timed_saves():
    """Times every ``FleetCheckpoint.save`` on the caller's thread (ms),
    into the list it yields."""
    from repro_torch.checkpoint import FleetCheckpoint

    save, out = FleetCheckpoint.save, []

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        save(self, *args, **kwargs)
        out.append((time.perf_counter() - t0) * 1e3)

    FleetCheckpoint.save = timed
    try:
        yield out
    finally:
        FleetCheckpoint.save = save


def time_saves(res: dict, root: str, n: int = 3) -> dict:
    """Bytes of one DDPG checkpoint at the main path's size, and ms per save
    on the caller's thread written synchronously and asynchronously (each
    asynchronous save into an empty queue), and ms from its return until
    the worker's write is on disk."""
    from repro_torch.checkpoint import FleetCheckpoint

    env, states = res["env"], res["states"]
    env_state = env.reset(MAIN["fleet"])
    gen = torch.Generator(device=env.device).manual_seed(0)
    sync_ck = FleetCheckpoint(os.path.join(root, "sync"), use_async=False)
    sync_ms = []
    for epoch in range(1, n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_ck.save(epoch, states, env_state, gen)
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    step = os.path.join(root, "sync", f"step_{n:08d}")
    nbytes = sum(os.path.getsize(os.path.join(step, f)) for f in os.listdir(step))
    async_ck = FleetCheckpoint(os.path.join(root, "async"))
    caller_ms, write_ms = [], []
    try:
        for epoch in range(1, n + 1):
            async_ck.wait()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            async_ck.save(epoch, states, env_state, gen)
            t1 = time.perf_counter()
            async_ck.wait()
            t2 = time.perf_counter()
            caller_ms.append((t1 - t0) * 1e3)
            write_ms.append((t2 - t1) * 1e3)
    finally:
        async_ck.close()
    return dict(bytes=nbytes, sync_ms=sync_ms, async_caller_ms=caller_ms,
                async_write_ms=write_ms)


def probe_write_contention(res: dict, root: str, epochs: int = 10) -> dict:
    """Ms per online epoch of the main path alone, then beside a background
    thread that repeats one part of an asynchronous write of its
    checkpoint without pause: the copies of the leaves into pinned memory on
    a side stream, their crc32, their ``np.save``, the whole write (crc,
    files, manifest), and a pure-Python loop (which holds the interpreter
    lock).  Says which part of a write slows the thread that dispatches the
    epochs."""
    import threading
    import zlib

    from repro_torch.checkpoint import Checkpointer, named_leaves
    from repro_torch.core import run_online_fleet

    env, agent, states = res["env"], res["agent"], res["states"]
    gen = torch.Generator(device=env.device).manual_seed(4)
    leaves = [x.detach() for _, x in named_leaves(states)]
    pinned = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in leaves]
    side = torch.cuda.Stream(env.device)
    names = [str(i) for i in range(len(leaves))]
    writer = Checkpointer(os.path.join(root, "probe"), keep=1)

    def d2h():
        with torch.cuda.stream(side):
            for buf, x in zip(pinned, leaves):
                buf.copy_(x, non_blocking=True)
        side.synchronize()

    def busy_python():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.05:
            sum(range(1000))

    parts = {"d2h": d2h,
             "crc32": lambda: [zlib.crc32(b.numpy()) for b in pinned],
             "np.save": lambda: [np.save(os.path.join(root, f"probe_{i}.npy"), b.numpy(),
                                         allow_pickle=False) for i, b in enumerate(pinned)],
             "write": lambda: writer._write(1, names, pinned),
             "python": busy_python}

    def epoch_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_online_fleet(gen, env, agent, states, epochs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / epochs * 1e3

    out = {"alone": epoch_ms()}
    for name, fn in parts.items():
        stop = threading.Event()

        def repeat(fn=fn, stop=stop):
            while not stop.is_set():
                fn()

        th = threading.Thread(target=repeat)
        th.start()
        try:
            out[name] = epoch_ms()
        finally:
            stop.set()
            th.join()
    out["alone again"] = epoch_ms()
    return out


def check_card_to_cpu_restore(res: dict, directory: str) -> int:
    """Restores the card's last checkpoint into CPU agent and env templates
    (the generator into a CUDA one: a CPU generator is refused) and holds
    every agent-state leaf to the card's, bit for bit.  Returns the number
    of leaves."""
    from repro_torch.checkpoint import FleetCheckpoint, named_leaves
    from repro_torch.core import make_agent
    from repro_torch.launch import drl_control

    cpu_env = drl_control.build_env(MAIN["app"], "cpu")
    template = make_agent("ddpg", cpu_env, k_nn=MAIN["k"]).init_fleet(
        torch.Generator().manual_seed(1), MAIN["fleet"], "cpu")
    ck = FleetCheckpoint(directory, use_async=False)
    try:
        ck.restore(template, cpu_env.reset(MAIN["fleet"]), torch.Generator())
    except ValueError as e:
        if "same device type" not in str(e):
            raise
    else:
        raise AssertionError("a CUDA generator's state restored into a CPU generator")
    epoch, states, _, _ = ck.restore(template, cpu_env.reset(MAIN["fleet"]),
                                     torch.Generator(device="cuda"))
    if epoch != CHECKPOINT["epochs"]:
        raise AssertionError(f"the newest checkpoint is epoch {epoch}")
    got, want = named_leaves(states), named_leaves(res["states"])
    for (name, a), (_, b) in zip(got, want):
        if a.device.type != "cpu" or not torch.equal(a, b.detach().cpu()):
            raise AssertionError(f"card -> CPU restore: leaf {name} differs")
    return len(got)


@contextlib.contextmanager
def fixed_order_sums():
    """PyTorch's deterministic algorithms on, warnings only (the GEMMs of
    one shape on one stream repeat without cuBLAS's workspace setting), no
    fill of uninitialized memory: ``index_add`` on the card then sums in a
    fixed order instead of by atomics."""
    from torch.utils import deterministic

    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    fill = deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        deterministic.fill_uninitialized_memory = fill


def check_small_resumes(dev, root: str) -> None:
    """Every agent the port runs, at F=2, T=4 from the generator's draws on
    the card: killed after 2 epochs (saved every 2) and resumed into fresh
    templates, against three uninterrupted runs: the resumed run must be as
    close to one of the uninterrupted runs as they come to each other, its
    moves and final assignments equal to all of theirs.  The graph policy
    sums messages with ``index_add``, atomic on the card and in no fixed
    order, so its float leaves would differ from run to run by a few ulps
    and the bar would be a draw; the runs here sum in a fixed order
    (``fixed_order_sums``), so every bar is what two runs of one program
    give, 0 where nothing else varies."""
    import copy
    import itertools

    from repro_torch.checkpoint import FleetCheckpoint
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.dsdps import scenarios
    from repro_torch.launch import drl_control

    F, T, every, kill = (CHECKPOINT_SMALL[k] for k in ("fleet", "epochs", "every",
                                                       "killed_at"))
    for i, (app, name, scenario) in enumerate(CHECKPOINT_AGENTS):
        env = drl_control.build_env(app, dev)
        params = scenarios.build_for(env, scenario, F)
        agent = make_agent(name, env, **({"k_nn": 4, "batch": 8} if name == "ddpg" else {}))
        init = agent.init_fleet(torch.Generator(device=dev).manual_seed(0), F, dev,
                                env_params=params)

        def run(states, n, gen=None, **kw):
            gen = torch.Generator(device=dev).manual_seed(1) if gen is None else gen
            st, hist = run_online_fleet(gen, env, agent, states, n, env_params=params,
                                        **kw)
            return dict(states=st, history=hist)

        with fixed_order_sums():
            uninterrupted = [run(copy.deepcopy(init), T) for _ in range(3)]
            directory = os.path.join(root, f"small_{i}")
            ck = FleetCheckpoint(directory, every=every)
            run(copy.deepcopy(init), kill, checkpoint=ck)
            ck.close()
            epoch, states, env_state, gen = FleetCheckpoint(directory).restore(
                copy.deepcopy(init), env.reset(F, params), torch.Generator(device=dev))
            resumed = run(states, T - epoch, gen=gen, env_state=env_state,
                          start_epoch=epoch)
        pairs = [run_gap(a, b) for a, b in itertools.combinations(uninterrupted, 2)]
        bar = {k: max(g[k] for g in pairs) for k in ("rewards", "latencies", "states")}
        gaps = [run_gap(u, resumed, skip_a=epoch) for u in uninterrupted]
        for g in pairs + gaps:
            check_within(f"phase 21 {name} on {app}: moves", g,
                         dict(rewards=np.inf, latencies=np.inf, states=np.inf))
        near = {k: min(g[k] for g in gaps) for k in ("rewards", "latencies", "states")}
        check_within(f"phase 21 {name} on {app}", dict(near, first_move_diff=None,
                                                       final_equal=True), bar)
        log(f"phase 21 {name} on {app} under {scenario}, F={F} T={T} killed at "
            f"{epoch}: resumed == uninterrupted (moves exact, "
            f"{int(uninterrupted[0]['history'].moved.sum())} in all); three "
            f"uninterrupted runs differ by up to rewards {bar['rewards']!r}, latencies "
            f"{bar['latencies']!r}, states {bar['states']!r}; the resumed from the "
            f"nearest by {near['rewards']!r}, {near['latencies']!r}, {near['states']!r}")


def run_checkpoints(dev, card: str) -> dict:
    """Phase 21: fleet checkpoints on the main path.  ``drl_control.run`` at
    the main path's budget for 30 epochs: twice uninterrupted (how far two
    card runs differ sets the bar), once saving every 10 (run A), and once
    killed after 20 (run B) then resumed in fresh objects (run C).  Moves
    and final assignments must match exactly, floats within the bar; the
    K-NN kernel launches 160 times in A and in B and C together.  Then the
    card's checkpoint restores into CPU templates, every agent resumes at a
    small size, and the saves are timed."""
    import shutil
    import tempfile

    from repro_torch.kernels.knn_topk import ops
    from repro_torch.launch import drl_control

    T, every, kill = CHECKPOINT["epochs"], CHECKPOINT["every"], CHECKPOINT["killed_at"]
    main = {**MAIN, "epochs": T}
    F = main["fleet"]
    root = tempfile.mkdtemp(prefix="chip_smoke_checkpoints_")
    try:
        runs, launches = {}, {}
        for what, kw in (("U1", {}),
                         ("A", dict(checkpoint_dir=os.path.join(root, "A"),
                                    checkpoint_every=every)),
                         ("U2", {}),
                         ("A2", dict(checkpoint_dir=os.path.join(root, "A2"),
                                     checkpoint_every=every)),
                         ("B", dict(checkpoint_dir=os.path.join(root, "B"),
                                    checkpoint_every=every, epochs=kill)),
                         ("C", dict(checkpoint_dir=os.path.join(root, "B"),
                                    checkpoint_every=every, resume=True))):
            ops.LAUNCHES = 0
            with timed_saves() as save_ms:
                runs[what] = drl_control.run(device=dev, **{**main, **kw})
            torch.cuda.synchronize()
            launches[what] = ops.LAUNCHES
            runs[what]["save_ms"] = save_ms
        want = dict(U1=main["offline_updates"] + T * (1 + U),
                    B=main["offline_updates"] + kill * (1 + U), C=(T - kill) * (1 + U))
        want.update(A=want["U1"], U2=want["U1"], A2=want["U1"])
        if launches != want:
            raise AssertionError(f"row_top2_regret launches {launches}, expected {want}")
        if runs["C"]["start_epoch"] != kill or runs["C"]["history"].rewards.shape != (F, T - kill):
            raise AssertionError("run C did not resume from epoch "
                                 f"{kill}: {runs['C']['start_epoch']}")
        for what, res in runs.items():
            h, env = res["history"], res["env"]
            if not (np.isfinite(h.rewards).all() and np.isfinite(h.latencies).all()
                    and np.isfinite(res["finals"]).all()
                    and np.array_equal(h.final_assignment.sum(-1), np.ones((F, env.N)))):
                raise AssertionError(f"phase 21 run {what}: non-finite traces or "
                                     "assignments that are not one-hot")
        bar = run_gap(runs["U1"], runs["U2"])
        chunked = run_gap(runs["U1"], runs["A"])
        if run_gap(runs["A"], runs["A2"]) != chunked:
            raise AssertionError("the second run saving every 10 differs from the first")
        resumed = run_gap(runs["A"], runs["C"], skip_a=kill)
        log(f"phase 21 checkpoints {main['app']} fleet={F} T={T} ({card}): two "
            f"uninterrupted runs differ by moves from epoch {bar['first_move_diff']}, "
            f"final assignments equal {bar['final_equal']}, rewards {bar['rewards']!r}, "
            f"latencies {bar['latencies']!r}, state leaves {bar['states']!r}")
        check_within("phase 21 saving every 10 vs uninterrupted", chunked, bar)
        check_within("phase 21 killed at 20 and resumed vs run A", resumed, bar)
        log(f"  saving every {every} == uninterrupted (rewards {chunked['rewards']!r}, "
            f"latencies {chunked['latencies']!r}, states {chunked['states']!r}); killed "
            f"at {kill} and resumed == run A (moves of epochs {kill}-{T - 1} and final "
            f"assignments exact; rewards {resumed['rewards']!r}, latencies "
            f"{resumed['latencies']!r}, states {resumed['states']!r})")
        log(f"  row_top2_regret launches: A {launches['A']} = "
            f"{main['offline_updates']} offline updates + {T} x (1 select + {U} update); "
            f"B {launches['B']} + C {launches['C']} = {launches['B'] + launches['C']}")
        leaves = check_card_to_cpu_restore(runs["A"], os.path.join(root, "A"))
        log(f"  card -> CPU restore of epoch {T}: {leaves} agent-state leaves exact")
        saves = time_saves(runs["A"], root)
        epoch_ms = {w: runs[w]["seconds"]["online"] / (T - r["start_epoch"] if w == "C"
                                                       else kill if w == "B" else T) * 1e3
                    for w, r in runs.items()}
        block = max(saves["async_write_ms"]) / min(epoch_ms["U1"], epoch_ms["U2"])
        log(f"  one DDPG checkpoint at {main['app']} F={F} ({card}): {saves['bytes']} "
            f"bytes; ms per save on the caller's thread, synchronous "
            + ", ".join(f"{x:.3f}" for x in saves["sync_ms"]) + "; asynchronous "
            + ", ".join(f"{x:.3f}" for x in saves["async_caller_ms"])
            + "; its write in the worker " + ", ".join(f"{x:.3f}" for x in saves["async_write_ms"]))
        log(f"  online lane-epochs/s ({card}): " + ", ".join(
            f"{w} {r['lane_epochs_per_s']:.1f} ({epoch_ms[w]:.3f} ms an epoch"
            + (f"; saves on the caller's thread " + ", ".join(f"{x:.3f}" for x in r["save_ms"])
               + f" ms, the last write's flush {r['seconds']['flush'] * 1e3:.3f} ms"
               if r["save_ms"] else "") + ")"
            for w, r in runs.items())
            + f"; U1, U2 uninterrupted, A the process's first run saving every {every} "
            f"(it allocates the pinned buffers), A2 the second, B killed at {kill}, C "
            f"resumed; a write spans {block:.1f} epochs, so from a cadence of "
            f"{int(np.ceil(block))} epochs the double-buffered queue never blocks")
        probe = probe_write_contention(runs["U2"], root)
        log(f"  ms an epoch ({card}) alone, then beside a thread repeating one part of a "
            "write: " + ", ".join(f"{k} {v:.3f}" for k, v in probe.items()))
        check_small_resumes(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(launches=launches, saves=saves,
                lane_epochs_per_s={w: r["lane_epochs_per_s"] for w, r in runs.items()})


def forced_stop(start: int = 0):
    """Phase 22's ``stop_fn``: lanes 1 and 5 stop at absolute epoch 16 (the
    call starts at ``start``; the live fleet is still whole there)."""
    def stop(rewards, t):
        done = np.zeros(rewards.shape[0], bool)
        if start + t == ELASTIC["stop_at"]:
            done[list(ELASTIC["stopped"])] = True
        return done
    return stop


def check_elastic_vs_cpu(dev) -> None:
    """Phase 22, first part: DDPG at cq_small, F=3, T=12, lane 1 stopped at
    epoch 4 (checked every 4), on the same numpy draws on the card and the
    CPU: moves, lane accounting and final assignments exact, traces at
    1e-4; on the card the surviving lanes equal a fixed-grid run on the
    same draws bit for bit (traces and states), the stopped lane up to its
    stop."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.core.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload
    from repro_torch.fleet import StopRule, run_online_fleet_elastic, take_lanes

    F, T, stop = 3, 12, 4
    topo = apps.continuous_queries("small")

    def stop_lane1(rewards, t):
        return (np.arange(rewards.shape[0]) == 1) & (t == stop)

    out, init, draws = {}, None, None
    for where in ("cpu", dev):
        env = SchedulingEnv(topo, default_workload(topo), device=where)
        agent = make_agent("ddpg", env, k_nn=12)
        if init is None:
            init = ddpg_state_to_numpy(
                agent.init_fleet(torch.Generator().manual_seed(22), F, "cpu"))
            draws = numpy_draws(np.random.default_rng(22), F, T, env, agent.cfg.batch)
        on = [d.to(where) for d in draws]
        out[str(where)] = run_online_fleet_elastic(
            0, env, agent, ddpg_state_from_numpy(init, where), T,
            rule=StopRule(check_every=stop), draws=on, stop_fn=stop_lane1)
    fixed_states, fixed = run_online_fleet(0, env, agent, ddpg_state_from_numpy(init, dev),
                                           T, draws=on)
    cpu, gpu = out["cpu"], out[str(dev)]
    if not (gpu.epochs_run.tolist() == cpu.epochs_run.tolist() == [T, stop, T]
            and gpu.executed_lane_epochs == cpu.executed_lane_epochs == 2 * T + stop):
        raise AssertionError(f"phase 22: epochs run {gpu.epochs_run} (card), "
                             f"{cpu.epochs_run} (CPU)")
    np.testing.assert_array_equal(gpu.history.moved, cpu.history.moved)
    np.testing.assert_array_equal(gpu.history.final_assignment,
                                  cpu.history.final_assignment)
    np.testing.assert_allclose(gpu.history.latencies, cpu.history.latencies, rtol=1e-4)
    np.testing.assert_allclose(gpu.history.rewards, cpu.history.rewards, rtol=1e-4)
    for field in ("rewards", "latencies", "moved", "final_assignment"):
        got, want = getattr(gpu.history, field), getattr(fixed, field)
        np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
        if field != "final_assignment":
            np.testing.assert_array_equal(got[1, :stop], want[1, :stop])
    for (name, a), (_, b) in zip(named_leaves(take_lanes(gpu.states, [0, 2])),
                                 named_leaves(take_lanes(fixed_states, [0, 2]))):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 22: survivor leaf {name} differs from the "
                                 "fixed-grid run")
    log(f"phase 22 elastic cq_small F={F} T={T}, lane 1 stopped at {stop}: card == "
        f"CPU (epochs run {gpu.epochs_run.tolist()}, {gpu.executed_lane_epochs} "
        f"lane-epochs; moves exact, {int(cpu.history.moved.sum())} in all; latencies "
        f"max rel diff {np.abs(gpu.history.latencies / cpu.history.latencies - 1).max():.3g}"
        f"); on the card lanes 0 and 2 == the fixed-grid run bit for bit (traces "
        f"and states), lane 1 up to epoch {stop}")


def sync_counts(dev, card: str) -> dict:
    """Phase 22: the synchronizing calls of an epoch, by site, for every
    agent the port runs at its phase's width, under
    ``guards(transfer="log")``: first through ``drl_control.run`` over 4
    epochs from a fresh fleet (DDPG after its offline pretraining at the
    main path's budget), whose first epoch builds the per-device caches,
    then over 4 more epochs of the same fleet, the steady state."""
    from repro_torch.core import run_online_fleet
    from repro_torch.diagnostics import guards
    from repro_torch.dsdps import StructuralSchedulingEnv, apps
    from repro_torch.launch import drl_control

    out = {}
    n = ELASTIC["sync_epochs"]
    for app, agent, scenario in SYNC_AGENTS:
        kw = dict(device=dev, app=app, agent=agent, scenario=scenario, epochs=n,
                  guards=True, offline=0, fleet=MAIN["fleet"])
        if agent == "ddpg":
            kw.update(offline=MAIN["offline"], offline_updates=MAIN["offline_updates"],
                      **({"k": MAIN["k"]} if app == MAIN["app"] else {}))
        if app == "structural":
            kw.update(fleet=STRUCTURAL["fleet"], env=StructuralSchedulingEnv(
                [apps.ALL_APPS[a]() for a in STRUCTURAL["apps"]], device=dev))
        res = drl_control.run(**kw)
        first = res["guards"]
        with guards(transfer="log") as steady:
            run_online_fleet(torch.Generator(device=dev).manual_seed(22), res["env"],
                             res["agent"], res["states"], n,
                             env_params=res["env_params"])
        for g in (first, steady):
            if g.steady_steps != n or g.nonfinite:
                raise AssertionError(f"phase 22 {agent} on {app}: {g}")
        out[(app, agent)] = dict(first=first.n_syncs / n, steady=steady.n_syncs / n,
                                 sites=dict(first.syncs + steady.syncs))
        log(f"phase 22 syncs {agent} on {app} under {scenario}, fleet {kw['fleet']} "
            f"({card}): from a fresh fleet {first.sync_report(per='epoch')}; then "
            f"{steady.sync_report(per='epoch')}; no non-finite carries")
    return out


def run_elastic(dev, card: str) -> dict:
    """Phase 22: the elastic lane lifecycle on the main path.
    ``drl_control.run`` at the main budget: a fixed-grid run (U), the
    forced stop of lanes 1 and 5 at epoch 16 (F), the default StopRule (D),
    the forced-stop run killed at epoch 24 saving every 8 (K) and resumed
    in fresh objects (R).  F's first 16 epochs equal U's; R equals F's
    surviving lanes bit for bit; the K-NN kernel launches 100 offline + 2
    an epoch the fleet runs.  Then the syncs of a steady-state epoch for
    every agent, and the scenario search."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import named_leaves
    from repro_torch.fleet import StopRule, take_lanes
    from repro_torch.kernels.knn_topk import ops
    from repro_torch.launch import drl_control

    F, T, kill = MAIN["fleet"], MAIN["epochs"], ELASTIC["killed_at"]
    rule = StopRule()                 # the launcher's: the stop test every 8 epochs
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        runs, launches = {}, {}
        ck = dict(checkpoint_dir=root, checkpoint_every=ELASTIC["every"])
        for what, kw in (("U", {}),
                         ("F", dict(early_stop=True, stop_fn=forced_stop())),
                         ("D", dict(early_stop=True)),
                         ("K", dict(early_stop=True, epochs=kill,
                                    stop_fn=forced_stop(), **ck)),
                         ("R", dict(early_stop=True, resume=True,
                                    stop_fn=forced_stop(kill), **ck))):
            ops.LAUNCHES = 0
            runs[what] = drl_control.run(device=dev, **{**MAIN, **kw})
            torch.cuda.synchronize()
            launches[what] = ops.LAUNCHES
        for what, res in runs.items():
            h = res["history"]
            if not (np.isfinite(h.rewards).all() and np.isfinite(res["finals"]).all()):
                raise AssertionError(f"phase 22 run {what}: non-finite traces")
            e = res["elastic"]
            ran = T - res["start_epoch"] if e is None else int(e.epochs_run.max())
            offline = 0 if what == "R" else MAIN["offline_updates"]
            want = offline + ran * (1 + U)
            if launches[what] != want:
                raise AssertionError(f"phase 22 run {what}: {launches[what]} K-NN "
                                     f"launches, expected {want}")
        fo, u = runs["F"]["elastic"], runs["U"]["history"]
        stopped = list(ELASTIC["stopped"])
        survivors = [f for f in range(F) if f not in stopped]
        want_run = [ELASTIC["stop_at"] if f in stopped else T for f in range(F)]
        if fo.epochs_run.tolist() != want_run or fo.executed_lane_epochs != sum(want_run):
            raise AssertionError(f"phase 22 forced stop: epochs run {fo.epochs_run}, "
                                 f"{fo.executed_lane_epochs} lane-epochs")
        s = ELASTIC["stop_at"]
        prefix = run_gap(dict(history=u, states=runs["U"]["states"]),
                         dict(history=fo.history, states=runs["U"]["states"]))
        if not (np.array_equal(fo.history.moved[:, :s], u.moved[:, :s])
                and np.array_equal(fo.history.rewards[:, :s], u.rewards[:, :s])):
            raise AssertionError("phase 22: the forced-stop run's first 16 epochs "
                                 "differ from the fixed-grid run's")
        r = runs["R"]
        if r["lane_ids"].tolist() != survivors or r["start_epoch"] != kill:
            raise AssertionError(f"phase 22: resumed lanes {r['lane_ids']} at "
                                 f"{r['start_epoch']}")
        for field in ("rewards", "latencies", "moved", "final_assignment"):
            got = getattr(r["history"], field)
            want = getattr(fo.history, field)[survivors]
            if field != "final_assignment":
                want = want[:, kill:]
            if not np.array_equal(got, want):
                raise AssertionError(f"phase 22: resumed {field} differ from the "
                                     "uninterrupted elastic run")
        for (name, a), (_, b) in zip(named_leaves(r["states"]),
                                     named_leaves(take_lanes(fo.states, survivors))):
            if not torch.equal(a, b):
                raise AssertionError(f"phase 22: resumed state leaf {name} differs")
        log(f"phase 22 elastic {MAIN['app']} fleet={F} T={T} ({card}): "
            f"forced stop of lanes {stopped} at epoch {s} (checked every "
            f"{rule.check_every}): first {s} epochs == the fixed grid's (moves and "
            f"rewards exact; later rewards differ by up to {prefix['rewards']!r}: "
            f"the compacted fleet draws other numbers); killed at {kill} and "
            f"resumed == uninterrupted bit for bit (lanes {survivors}, traces, "
            f"final assignments and {len(named_leaves(r['states']))} state leaves)")
        for what in ("U", "F", "D"):
            res = runs[what]
            e = res["elastic"]
            acct = ("fixed grid" if e is None else
                    f"epochs run {e.epochs_run.tolist()}, {e.executed_lane_epochs} "
                    f"lane-epochs executed of {e.fixed_grid_lane_epochs} "
                    f"({e.savings:.1%} saved)")
            log(f"  {what}: {acct}; online wall {res['seconds']['online']:.3f} s "
                f"({res['seconds']['online'] / T * 1e3:.3f} ms a grid epoch), "
                f"{res['lane_epochs_per_s']:.1f} lane-epochs/s executed; offline "
                f"{res['seconds']['offline']:.3f} s; {launches[what]} K-NN launches")
        log(f"  K + R: {launches['K']} + {launches['R']} = "
            f"{launches['K'] + launches['R']} K-NN launches; online wall "
            f"{runs['K']['seconds']['online']:.3f} + {runs['R']['seconds']['online']:.3f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    syncs = sync_counts(dev, card)
    ops.LAUNCHES = 0
    res = drl_control.run(device=dev, agent="ddpg", k=MAIN["k"], seed=0,
                          scenario_search=True, search_rungs=SEARCH["rungs"],
                          **{k: SEARCH[k] for k in ("app", "fleet", "scenario")})
    torch.cuda.synchronize()
    lb = res["leaderboard"]
    rungs = SEARCH["rungs"]
    if (lb.total_lane_epochs != SEARCH["fleet"] * sum(rungs)
            or ops.LAUNCHES != sum(rungs) * (1 + U)
            or not np.isfinite([e.score for e in lb.entries]).all()):
        raise AssertionError(f"phase 22 search: {lb.to_json()}; {ops.LAUNCHES} launches")
    best = lb.entries[0]
    log(f"phase 22 search_scenarios ddpg {SEARCH['app']} fleet {SEARCH['fleet']} rungs "
        f"{rungs} under {SEARCH['scenario']} ({card}): {len(lb.entries)} candidates, "
        f"{lb.total_lane_epochs} lane-epochs, wall {res['seconds']['search']:.3f} s, "
        f"{ops.LAUNCHES} K-NN launches; best candidate {best.cand} (rung {best.rung}, "
        f"{best.epochs} epochs) score {best.score:.4f}")
    return dict(launches=launches, syncs=syncs,
                lane_epochs_per_s={w: r["lane_epochs_per_s"] for w, r in runs.items()})


def time_plane_steps(svc, env, on_card: bool, steps: int = 7) -> dict:
    """Phase 17: each plane's full step (every slot busy) timed alone, the
    median of ``steps``; on the card also the device's busy time and
    kernels per step from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve_control as sc

    out = {}
    for kind, plane in svc.planes.items():
        def fill(plane=plane, kind=kind):
            for r in sc.synthetic_requests(env, svc, plane.n_slots * len(svc.kinds),
                                           seed=SERVE["seed"] + 2):
                if r.kind == kind:
                    plane.submit(r)

        walls = []
        for _ in range(steps):
            fill()
            t0 = time.perf_counter()
            plane.step()
            walls.append(time.perf_counter() - t0)
        out[kind] = dict(ms=float(np.median(walls)) * 1e3)
        if on_card:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    fill()
                    plane.step()
            kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
            out[kind].update(
                busy_ms=sum(e.time_range.elapsed_us() for e in kernels) / steps / 1e3,
                kernels=len(kernels) / steps)
    return out


def near_tie(cpu_env, cpu_svc, card_req, cpu_req) -> None:
    """A card decision that is not the CPU's must tie with it under the
    CPU's own scores to 1e-5: auto_tune's latencies, or the DDPG critic's
    Q values."""
    from repro_torch.core import networks as nets
    from repro_torch.serve.control import single_select

    plane = cpu_svc.planes[card_req.kind]
    params = plane._params_list[plane._clusters[card_req.cluster]]
    s = torch.as_tensor(card_req.s_vec)[None, None]
    if card_req.kind == "auto_tune":
        _, lats = plane.agent.select_fn(plane.agent.cfg, plane.state, s, None,
                                        params, False, None, None)
        a, b = (float(lats[0, 0, int(np.argmax(x))])
                for x in (card_req.action, cpu_req.action))
    elif card_req.kind == "placement":
        if not np.array_equal(cpu_req.action,
                              single_select(plane.agent, plane.state,
                                            card_req.s_vec, params).numpy()):
            raise AssertionError(f"request {card_req.rid}: the CPU's batched and "
                                 "single selects differ")
        a, b = (float(nets.apply_critic(plane.state.critic, s[0],
                                        torch.as_tensor(x).reshape(1, 1, -1))[0, 0])
                for x in (card_req.action, cpu_req.action))
    else:
        raise AssertionError(f"request {card_req.rid} ({card_req.kind}): card and "
                             "CPU decisions differ")
    if abs(a - b) > 1e-5 * max(abs(a), abs(b)):
        raise AssertionError(f"request {card_req.rid} ({card_req.kind}): card and "
                             f"CPU decisions differ, scores {a} vs {b}")


def profile_online(res, epochs: int = 5) -> None:
    """Phase 7: where an online epoch's time goes, on the trained fleet:
    the device's busy share of the wall time, launches per epoch, and the
    top kernels, from ``epochs`` more epochs (``profile_fleet``)."""
    from repro_torch.core import make_agent

    env = res["env"]
    p = profile_fleet(env, make_agent("ddpg", env, k_nn=MAIN["k"]), res["states"],
                      None, epochs)
    log(f"phase 7 online epoch, {MAIN['app']} fleet={MAIN['fleet']}: wall "
        f"{p['wall_ms']:.3f} ms unprofiled, {p['wall_prof_ms']:.3f} ms profiled; "
        f"device busy {p['busy_ms']:.3f} ms/epoch in {p['kernels']:.0f} "
        f"kernels/epoch = {p['busy_share']:.1%} of unprofiled wall")
    for name, us in p["top"]:
        log(f"  {us / epochs:9.1f} us/epoch  {name[:90]}")


def time_critic_head(res) -> None:
    """Phase 8: the critic's 32→1 output layer as ``FleetMLP`` runs it (a
    product and a sum, so that a lane never depends on its batch) against
    one ``bmm``, at the main path's row counts, on the trained weights."""
    from repro_torch.core import ddpg, networks

    critic = res["states"].critic
    w, b = critic.weights[-1].detach(), critic.biases[-1].detach()
    head = networks.FleetMLP([w], [b])
    F, din = w.shape[0], w.shape[1]
    gen = torch.Generator(device=w.device).manual_seed(8)
    B, K = ddpg.DDPGConfig.batch, MAIN["k"]
    for what, rows in (("select", K), ("update", B), ("target", B * K)):
        h = torch.rand(F, rows, din, generator=gen, device=w.device)

        @torch.no_grad()
        def ours(h=h):
            return head(h)

        @torch.no_grad()
        def gemm(h=h):
            return torch.bmm(h, w) + b[:, None, :]

        t_ours, t_gemm = graph_ms(ours), graph_ms(gemm)
        err = float((ours() - gemm()).abs().max())
        log(f"phase 8 critic head [{F},{rows},{din}]x[{F},{din},1] ({what}): "
            f"product+sum {t_ours:.6f} ms, bmm {t_gemm:.6f} ms per call "
            f"(device, CUDA graph); max |diff| {err:.3g}")


def sdpa(q, k, v, causal: bool = True):
    """The library call for the flash kernel's work: GQA attention on
    ``[B, S, H, hd]`` q and ``[B, Skv, Hkv, hd]`` k, v."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=True)


def check_flash(dev) -> dict:
    """Phase 9: both flash-attention routes against their plain version on
    tests/test_kernels.py's cases, every head dim, ragged S, a strided view
    and the llama3-8b prefill shape; then, at that shape, the float32
    route's time, and the bfloat16 kernel's against plain, SDPA and bound."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops

    # (rtol, atol) of |got - want| <= rtol * |want| + atol.  float32: both
    # sides compute in float32 and differ in summation order and exp only.
    # bfloat16: both round a float32 result to bfloat16, so they differ by
    # at most one bfloat16 step, 2^-7 = 0.0078 of |want|; rtol 1e-2 holds
    # that, and atol 2e-3 the outputs near 0.  The kernel carries P into P.V
    # as two bfloat16 parts, ~2^-17 of p (tests/test_torch_flash_numerics.py)
    tols = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 2e-3)}
    B, S, H, Hkv, hd = LM["batch"], LM["prefill_len"], 32, 8, 128
    cases = [(2, 128, 4, 4, 64, True, torch.float32),
             (2, 128, 4, 2, 64, True, torch.float32),
             (2, 256, 8, 2, 32, True, torch.float32),
             (2, 128, 4, 1, 64, True, torch.float32),
             (2, 128, 4, 2, 64, False, torch.float32),
             (2, 128, 4, 2, 64, True, torch.bfloat16),
             (2, 200, 4, 2, 32, True, torch.float32),
             (3, 37, 4, 2, 16, True, torch.float32),
             # the bfloat16 route at every head dim, both maskings, ragged S
             (2, 256, 4, 2, 16, True, torch.bfloat16),
             (2, 256, 8, 2, 32, False, torch.bfloat16),
             (2, 384, 4, 1, 64, False, torch.bfloat16),
             (2, 384, 8, 2, 128, False, torch.bfloat16),
             (2, 200, 4, 2, 128, True, torch.bfloat16),
             (3, 37, 4, 2, 32, True, torch.bfloat16),
             # hd 96 native on both routes; hd 8 and 40 zero-padded to 16, 64
             (2, 256, 8, 2, 96, True, torch.float32),
             (2, 200, 4, 2, 8, True, torch.float32),
             (2, 128, 4, 1, 40, False, torch.float32),
             (2, 256, 8, 2, 96, True, torch.bfloat16),
             (2, 200, 4, 1, 96, False, torch.bfloat16),
             (2, 200, 4, 2, 8, True, torch.bfloat16),
             (2, 128, 4, 2, 40, False, torch.bfloat16),
             # hd 192, 256 native on the CUDA-core kernel, 160 padded to
             # 192; bf16 above 128 runs there too (bf16 in and out)
             (2, 200, 4, 2, 160, True, torch.float32),
             (2, 256, 8, 2, 192, False, torch.float32),
             (2, 256, 4, 1, 256, True, torch.float32),
             (3, 37, 4, 2, 256, False, torch.float32),
             (2, 200, 4, 2, 160, False, torch.bfloat16),
             (2, 256, 8, 2, 192, True, torch.bfloat16),
             (2, 256, 4, 1, 256, False, torch.bfloat16),
             (3, 37, 4, 2, 256, True, torch.bfloat16),
             # above 256: the CUDA-core kernel's wide form, both dtypes,
             # both maskings, ragged S
             (2, 256, 4, 2, 320, True, torch.float32),
             (2, 200, 4, 1, 320, False, torch.float32),
             (2, 256, 4, 2, 512, False, torch.float32),
             (3, 37, 4, 2, 512, True, torch.float32),
             (2, 256, 4, 2, 320, False, torch.bfloat16),
             (2, 200, 4, 1, 320, True, torch.bfloat16),
             (2, 256, 4, 2, 512, True, torch.bfloat16),
             (3, 37, 4, 2, 512, False, torch.bfloat16),
             (B, S, H, Hkv, hd, True, torch.bfloat16)]
    gen = torch.Generator(device=dev).manual_seed(9)

    def check(q, k, v, causal, what):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        rtol, atol = tols[q.dtype]
        if bool((diff > rtol * want.float().abs() + atol).any()) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"flash kernel off by {float(diff.max())} at {what}")
        return float(diff.max())

    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    inputs = None
    cores, wide_before = ops.LAUNCHES_BF16_CUDA_CORES, ops.LAUNCHES_WIDE
    for b, s, h, hkv, d, causal, dtype in cases:
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev).to(dtype)
                   for n in (h, hkv, hkv))
        err = check(q, k, v, causal, f"{(b, s, h, hkv, d)} causal={causal} {dtype}")
        max_err[dtype] = max(max_err[dtype], err)
        inputs = (q, k, v)
    wide_bf16 = sum(1 for c in cases if c[4] > 128 and c[6] == torch.bfloat16)
    if ops.LAUNCHES_BF16_CUDA_CORES - cores != wide_bf16:
        raise AssertionError(f"{ops.LAUNCHES_BF16_CUDA_CORES - cores} bf16 launches on "
                             f"the CUDA-core kernel, expected {wide_bf16} (hd > 128)")
    wide_cases = sum(1 for c in cases if c[4] > ops.HEAD_DIMS[-1])
    if ops.LAUNCHES_WIDE - wide_before != wide_cases:
        raise AssertionError(f"{ops.LAUNCHES_WIDE - wide_before} launches of the wide "
                             f"form, expected {wide_cases} (hd > 256)")
    # q, k, v as slices of one fused bf16 projection [B, S, H + 2 Hkv, hd]
    qkv = torch.randn(2, 256, 8, 128, generator=gen, device=dev).bfloat16()
    before = ops.LAUNCHES_BF16
    err = check(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:], True, "a strided view")
    if ops.LAUNCHES_BF16 != before + 1:
        raise AssertionError("the strided bf16 view did not go through the bf16 kernel")
    max_err[torch.bfloat16] = max(max_err[torch.bfloat16], err)
    # a layout TMA cannot load (k's base 2 bytes off the grid, v's h stride
    # 40 bytes): staged into fresh allocations, then the bf16 kernel
    flat = torch.randn(1 + 2 * 256 * 4 * 64, generator=gen, device=dev).bfloat16()
    wide = torch.randn(2, 256, 2, 20, generator=gen, device=dev).bfloat16()
    q = torch.randn(2, 256, 4, 16, generator=gen, device=dev).bfloat16()
    before = (ops.LAUNCHES_BF16, ops.STAGED_COPIES)
    err = check(q, flat[1:].view(2, 256, 4, 64)[:, :, :2, :16], wide[..., 4:], True,
                "a staged layout")
    if (ops.LAUNCHES_BF16, ops.STAGED_COPIES) != (before[0] + 1, before[1] + 2):
        raise AssertionError("the misaligned bf16 layout was not staged once per "
                             "tensor and run by the bf16 kernel")
    max_err[torch.bfloat16] = max(max_err[torch.bfloat16], err)
    # non-causal k/v of their own length (cross-attention over a memory):
    # a memory longer and shorter than q, on the bf16 wgmma route, the
    # float32 route, bf16 above 128 and the wide form in both dtypes
    cross = [(2, 64, 256, 4, 4, 64, torch.bfloat16), (2, 200, 37, 4, 2, 128, torch.bfloat16),
             (2, 64, 256, 4, 4, 64, torch.float32), (1, 37, 300, 4, 2, 96, torch.float32),
             (2, 100, 70, 4, 2, 192, torch.bfloat16), (2, 100, 70, 4, 2, 320, torch.float32),
             (1, 37, 130, 2, 1, 512, torch.bfloat16)]
    cross_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, s, skv, h, hkv, d, dtype in cross:
        q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        before = (ops.LAUNCHES, ops.LAUNCHES_WIDE)
        err = check(q, k, v, False, f"{(b, s, h, hkv, d)} against {skv} keys {dtype}")
        if (ops.LAUNCHES, ops.LAUNCHES_WIDE) != (before[0] + 1, before[1] + (d > 256)):
            raise AssertionError(f"flash at {skv} keys against {s} rows: launches "
                                 f"{before} -> {(ops.LAUNCHES, ops.LAUNCHES_WIDE)}")
        cross_err[dtype] = max(cross_err[dtype], err)
    log(f"phase 9 flash kernels vs plain version: {len(cases) + 2} cases agree "
        f"(max |err| float32 route {max_err[torch.float32]:.3g}, bfloat16 route "
        f"{max_err[torch.bfloat16]:.3g}; |err| <= 2e-5 |x| + 2e-5 f32, "
        f"1e-2 |x| + 2e-3 bf16), and {len(cross)} at a key length of their own "
        f"(max |err| float32 {cross_err[torch.float32]:.3g}, bfloat16 "
        f"{cross_err[torch.bfloat16]:.3g})")

    q, k, v = inputs
    flops = ops.flops(B, S, S, H, hd, causal=True)
    q32, k32, v32 = q.float(), k.float(), v.float()
    f32 = dict(ms=eager_ms(lambda: ops.flash_attention(q32, k32, v32, causal=True),
                           iters=5, warmup=1),
               plain_ms=eager_ms(lambda: flash_attention_ref(q32, k32, v32), iters=5,
                                 warmup=1),
               library_ms=eager_ms(lambda: sdpa(q32, k32, v32), iters=5, warmup=1),
               bound_ms=max(flops / F32_OPS_PER_S, ops.bytes_moved(
                   B, S, S, H, Hkv, hd, torch.float32) / HBM_BYTES_PER_S) * 1e3)
    log(f"  [{B},{S},{H},{hd}] q x [{B},{S},{Hkv},{hd}] k/v float32 causal, float32 "
        f"route (flash_attention.cu), ms per call: kernel {f32['ms']:.6f}  plain "
        f"{f32['plain_ms']:.6f}  library (SDPA, float32) {f32['library_ms']:.6f}  "
        f"bound {f32['bound_ms']:.6f} (operations: {flops / 1e9:.1f} GFLOP at 67 "
        f"TFLOP/s); {flops / f32['ms'] / 1e9:.1f} TFLOP/s")
    del q32, k32, v32
    kernel = lambda: ops.flash_attention(q, k, v, causal=True)          # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v, causal=True)           # noqa: E731
    library = lambda: sdpa(q, k, v)                                     # noqa: E731
    lib_err = float((library().transpose(1, 2).float() - kernel().float()).abs().max())
    t = dict(ms=eager_ms(kernel, iters=20, warmup=3),
             plain_ms=eager_ms(plain, iters=5, warmup=1),
             library_ms=eager_ms(library, iters=20, warmup=3))
    bytes_moved = ops.bytes_moved(B, S, S, H, Hkv, hd, torch.bfloat16)
    t_ops, t_bytes = flops / BF16_TC_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    t["bound_ms"] = max(t_ops, t_bytes) * 1e3
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  [{B},{S},{H},{hd}] q x [{B},{S},{Hkv},{hd}] k/v bf16 causal, bfloat16 "
        f"route (flash_attention_sm90.cu), ms per call: kernel {t['ms']:.6f}  plain "
        f"{t['plain_ms']:.6f}  library (SDPA) {t['library_ms']:.6f}  bound "
        f"{t['bound_ms']:.6f} ({t['bound_by']}: {flops / 1e9:.1f} GFLOP, "
        f"{bytes_moved / 1e6:.1f} MB); {flops / t['ms'] / 1e9:.1f} TFLOP/s; "
        f"|kernel - SDPA| max {lib_err:.3g}")
    del q, k, v, inputs
    # phi-3-vision's head dim (96, native: it has its own instantiation)
    phi3 = time_flash_shape(dev, gen, "phi-3-vision heads", 32, 32, 96)
    wide = time_wide_heads(dev, gen)
    f32["bound_by"] = "operations"
    return dict(max_abs_err=max_err[torch.bfloat16], timings=t,
                f32=dict(max_abs_err=max_err[torch.float32], timings=f32),
                phi3=phi3, wide=wide)


def time_flash_shape(dev, gen, what: str, H: int, Hkv: int, hd: int,
                     S: int | None = None, Skv: int | None = None,
                     causal: bool = True, f32: bool = False,
                     B: int | None = None) -> dict:
    """The bf16 route on a prefill shape, q [B, S, H, hd] and k/v [B, Skv,
    Hkv, hd] (B = 4 and S = Skv = 2048 unless given; causal unless told
    not): held to its plain version, one native wgmma launch (not padded,
    staged or on the CUDA cores), and timed beside plain, SDPA and the
    bound.  With ``f32``, the float32 route at the same shape too
    (``t["f32"]``)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops

    B = B or LM["batch"]
    S = S or LM["prefill_len"]
    Skv = Skv or S
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, Skv, Hkv, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    counts = lambda: (ops.LAUNCHES_BF16, ops.LAUNCHES_PADDED,  # noqa: E731
                      ops.STAGED_COPIES, ops.LAUNCHES_BF16_CUDA_CORES)
    before = counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    if counts() != (before[0] + 1, *before[1:]):
        raise AssertionError(f"{what}: flash counts {before} -> {counts()}, expected "
                             "one native bf16 launch")
    want = flash_attention_ref(q, k, v, causal=causal)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if bool((diff > 1e-2 * want.float().abs() + 2e-3).any()):
        raise AssertionError(f"{what}: flash off its plain version by {err}")
    lib_err = float((sdpa(q, k, v, causal).transpose(1, 2).float() - got.float())
                    .abs().max())
    del got, want, diff
    flops = ops.flops(B, S, Skv, H, hd, causal)
    bytes_moved = ops.bytes_moved(B, S, Skv, H, Hkv, hd, torch.bfloat16)
    t = dict(ms=eager_ms(lambda: ops.flash_attention(q, k, v, causal=causal), iters=20,
                         warmup=3),
             plain_ms=eager_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                               iters=3, warmup=1),
             library_ms=eager_ms(lambda: sdpa(q, k, v, causal), iters=20, warmup=3),
             max_abs_err=err)
    t_ops, t_bytes = flops / BF16_TC_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    t["bound_ms"] = max(t_ops, t_bytes) * 1e3
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    mask = "causal" if causal else "non-causal"
    log(f"  {what}: q [{B},{S},{H},{hd}] x k/v [{B},{Skv},{Hkv},{hd}] bf16 {mask}, "
        f"bfloat16 route, ms per call: kernel {t['ms']:.6f}  plain {t['plain_ms']:.6f}  "
        f"library (SDPA) {t['library_ms']:.6f}  bound {t['bound_ms']:.6f} "
        f"({t['bound_by']}: {flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB); "
        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s; |kernel - plain| max {err:.3g}, "
        f"|kernel - SDPA| max {lib_err:.3g}")
    if f32:
        q, k, v = q.float(), k.float(), v.float()
        before = ops.LAUNCHES_F32
        got = ops.flash_attention(q, k, v, causal=causal)
        if ops.LAUNCHES_F32 != before + 1:
            raise AssertionError(f"{what}: the float32 inputs missed the float32 route")
        want = flash_attention_ref(q, k, v, causal=causal)
        diff = (got - want).abs()
        err32 = float(diff.max())
        if bool((diff > 2e-5 * want.abs() + 2e-5).any()):
            raise AssertionError(f"{what}: float32 flash off its plain version by {err32}")
        del got, want, diff
        t32 = dict(ms=eager_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                               iters=5, warmup=1),
                   plain_ms=eager_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                                     iters=3, warmup=1),
                   library_ms=eager_ms(lambda: sdpa(q, k, v, causal), iters=5, warmup=1),
                   max_abs_err=err32)
        t_ops = flops / F32_OPS_PER_S
        t_bytes = ops.bytes_moved(B, S, Skv, H, Hkv, hd, torch.float32) / HBM_BYTES_PER_S
        t32["bound_ms"] = max(t_ops, t_bytes) * 1e3
        t32["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"  {what}, float32 route (flash_attention.cu), ms per call: kernel "
            f"{t32['ms']:.6f}  plain {t32['plain_ms']:.6f}  library (SDPA, float32) "
            f"{t32['library_ms']:.6f}  bound {t32['bound_ms']:.6f} ({t32['bound_by']} "
            f"at 67 TFLOP/s, 3.35 TB/s); {flops / t32['ms'] / 1e9:.1f} TFLOP/s; "
            f"|kernel - plain| max {err32:.3g} (<= 2e-5 |x| + 2e-5)")
        t["f32"] = t32
    del q, k, v
    torch.cuda.empty_cache()
    return t


def time_wide_heads(dev, gen) -> dict:
    """Phase 9, last part: head dims 256 (the CUDA-core kernel's widest
    instantiation) and 512 (its wide form) at q, k, v [4, 2048, 32, hd],
    causal, in float32 and in bf16: kernel, plain, SDPA and bound (float32
    at the CUDA cores' 67 TFLOP/s; bf16 at the tensor cores' 989, what the
    card could do for the same bf16 work)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref, ops

    B, S, H = LM["batch"], LM["prefill_len"], 32
    out = {}
    for hd in (256, 512):
        flops = ops.flops(B, S, S, H, hd, causal=True)
        wide = hd > ops.HEAD_DIMS[-1]
        for dtype, peak in ((torch.float32, F32_OPS_PER_S),
                            (torch.bfloat16, BF16_TC_OPS_PER_S)):
            q, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            counts = lambda: (ops.LAUNCHES_PADDED, ops.STAGED_COPIES,  # noqa: E731
                              ops.LAUNCHES_BF16_CUDA_CORES, ops.LAUNCHES_WIDE)
            before = counts()
            err = float((ops.flash_attention(q, k, v).float()
                         - flash_attention_ref(q, k, v).float()).abs().max())
            want = (before[0], before[1], before[2] + (dtype == torch.bfloat16),
                    before[3] + wide)
            if counts() != want:
                raise AssertionError(f"hd {hd} {dtype}: padded/staged/CUDA-core/wide "
                                     f"counts {before} -> {counts()}, expected {want}")
            qkv = (q, k, v)
            t = dict(ms=eager_ms(lambda a=qkv: ops.flash_attention(*a), iters=5,
                                 warmup=1),
                     plain_ms=eager_ms(lambda a=qkv: flash_attention_ref(*a), iters=3,
                                       warmup=1),
                     library_ms=eager_ms(lambda a=qkv: sdpa(*a), iters=5, warmup=1))
            bytes_moved = ops.bytes_moved(B, S, S, H, H, hd, dtype)
            t_ops, t_bytes = flops / peak, bytes_moved / HBM_BYTES_PER_S
            t["bound_ms"] = max(t_ops, t_bytes) * 1e3
            t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            t["max_abs_err"] = err
            form = "wide form" if wide else "kernel"
            log(f"  [{B},{S},{H},{hd}] q, k, v {dtype} causal, CUDA-core {form} "
                f"(flash_attention.cu), ms per call: kernel {t['ms']:.6f}  plain "
                f"{t['plain_ms']:.6f}  library (SDPA) {t['library_ms']:.6f}  bound "
                f"{t['bound_ms']:.6f} ({t['bound_by']}: {flops / 1e9:.1f} GFLOP at "
                f"{peak / 1e12:.0f} TFLOP/s, {bytes_moved / 1e6:.1f} MB); "
                f"{flops / t['ms'] / 1e9:.1f} TFLOP/s; |kernel - plain| max {err:.3g}")
            out[(hd, str(dtype).removeprefix("torch."))] = t
            del q, k, v, qkv
            torch.cuda.empty_cache()
    return out


def check_wkv(dev) -> dict:
    """Phase 10: the WKV6 kernel against its plain version at T=1 and
    T=2048, from a zero and a non-zero state, at the continuous batcher's
    step and at the smoke head sizes; then kernel, plain and bound at the
    rwkv6-7b decode, prefill and batcher shapes.  The batcher's row in the
    kernels line takes its error from its own case."""
    from repro_torch.kernels.rwkv6_scan import ops, wkv6_ref

    B, H, hd = LM["batch"], 64, 64
    gen = torch.Generator(device=dev).manual_seed(10)

    def make(b, T, h, d, dtype, carry):
        return wkv_inputs(gen, dev, b, T, h, d, dtype, carry)

    batcher = (BATCHER["slots"], 1, H, hd, torch.bfloat16, True)
    cases = [(B, 1, H, hd, torch.bfloat16, False), (B, 1, H, hd, torch.bfloat16, True),
             (B, 2048, H, hd, torch.bfloat16, False), (B, 2048, H, hd, torch.bfloat16, True),
             batcher,
             (2, 96, 2, 8, torch.float32, True), (2, 64, 4, 16, torch.float32, False),
             (1, 40, 2, 128, torch.float32, True)]
    max_rel = max_abs = batcher_abs = 0.0
    for case in cases:
        b, T, h, d, dtype, carry = case
        args = make(b, T, h, d, dtype, carry)
        out, S_T = ops.wkv6(*args)
        want, want_S = wkv6_ref(*args)
        torch.cuda.synchronize()
        for got_, want_ in ((out, want), (S_T, want_S)):
            # float32 on both sides, summed in another order over up to 2048
            # steps: the error scales with the terms summed (|S| grows to
            # ~1e1, |out| to ~1e2), not with an output that cancels to ~0,
            # so it is held relative to the tensor's largest value
            err = float((got_ - want_).abs().max())
            rel = err / (1 + float(want_.abs().max()))
            if not rel <= 1e-5:
                raise AssertionError(f"wkv kernel off by {err} ({rel} of the "
                                     f"largest value) at {(b, T, h, d)} {dtype} "
                                     f"carry={carry}")
            max_rel, max_abs = max(max_rel, rel), max(max_abs, err)
            if case == batcher:
                batcher_abs = max(batcher_abs, err)
    log(f"phase 10 wkv kernel vs plain version: {len(cases)} cases agree "
        f"(max |err| {max_abs:.3g}; max |err|/(1+max|x|) {max_rel:.3g}, tol 1e-5; "
        f"at the batcher's step {list(batcher[:4])}: max |err| {batcher_abs:.3g})")

    timings = {name: wkv_timing(name, make(b, T, H, hd, torch.bfloat16, carry))
               for name, b, T, carry in (("decode", B, 1, True),
                                         ("prefill", B, LM["prefill_len"], False),
                                         ("batcher", BATCHER["slots"], 1, True))}
    return dict(max_abs_err=max_abs, batcher_max_abs_err=batcher_abs, timings=timings)


def wkv_inputs(gen, dev, b: int, T: int, h: int, d: int, dtype, carry: bool) -> tuple:
    """Seeded WKV6 inputs ``[b, T, h, d]``: the model's decays (exp(-exp(-6 +
    small)), close to 1), r, k, v in ``dtype``, u, and a carried state
    where ``carry``."""
    shape = (b, T, h, d)
    w = torch.exp(-torch.exp(-6 + 0.5 * torch.randn(shape, generator=gen, device=dev)))
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
    u = torch.randn(h, d, generator=gen, device=dev) * 0.5
    S0 = torch.randn(b, h, d, d, generator=gen, device=dev) if carry else None
    return w, r, k, v, u, S0


def wkv_timing(name: str, args: tuple) -> dict:
    """The WKV6 kernel and its plain version on ``args`` (``wkv_inputs``), ms
    a call (in a CUDA graph at T = 1, eager otherwise), beside the bound."""
    from repro_torch.kernels.rwkv6_scan import ops, wkv6_ref

    b, T, H, hd = args[1].shape
    dtype, carry = args[1].dtype, args[5] is not None
    kernel = lambda: ops.wkv6(*args)                 # noqa: E731
    plain = lambda: wkv6_ref(*args)                  # noqa: E731
    if T == 1:
        t = dict(ms=graph_ms(kernel), plain_ms=graph_ms(plain))
    else:
        t = dict(ms=eager_ms(kernel, iters=20, warmup=3),
                 plain_ms=eager_ms(plain, iters=2, warmup=1))
    bytes_moved = ops.bytes_moved(b, T, H, hd, dtype, carry)
    ops_count = ops.flops(b, T, H, hd)
    t_ops, t_bytes = ops_count / F32_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S
    t["bound_ms"] = max(t_ops, t_bytes) * 1e3
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  {name} [{b},{T},{H},{hd}] {str(dtype).removeprefix('torch.')} r/k/v, ms per call: "
        f"kernel {t['ms']:.6f}  plain {t['plain_ms']:.6f}  library none  bound "
        f"{t['bound_ms']:.6f} ({t['bound_by']}: {ops_count / 1e9:.3f} GFLOP, "
        f"{bytes_moved / 1e6:.2f} MB)")
    return t


LM_ARCHS = ("llama3-8b", "rwkv6-7b", "yi-34b", "command-r-plus-104b", "qwen1.5-110b",
            "granite-moe-3b-a800m", "qwen2-moe-a2.7b")


@contextlib.contextmanager
def recorded_routes(into: list, probs: bool = False):
    """Every MoE layer's routing (expert ids, keep mask, and with
    ``probs`` the router's probabilities) appended to ``into`` as it is
    computed, on the host."""
    from repro_torch.models import ffn

    route = ffn.moe_route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        into.append((r.expert.cpu(), r.keep.cpu(), *((r.probs.cpu(),) if probs else ())))
        return r
    ffn.moe_route = recording
    try:
        yield
    finally:
        ffn.moe_route = route


def check_lm_smoke(dev, archs=LM_ARCHS, phase: int = 11) -> None:
    """Phases 11 and 25: the smoke configs of ``archs`` in float32, card
    against CPU, on the same weights: prefill_forward logits,
    Engine.generate's greedy tokens, and every MoE layer's expert ids and
    keep mask.  A vlm's prefill takes its seeded patch embeddings; an
    encdec's prefill and generate read 48 seeded frames against the
    24-token prompt, so its cross-attention runs the float32 kernel at
    Skv = 48 against S = 24 (counted)."""
    from torch_lm_cases import frontend_inputs, smoke_lm

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm
    from repro_torch.serve import Engine

    worst, routed, cross, want_cross = 0.0, 0, 0, 0
    for arch in archs:
        cfg, cpu = smoke_lm(arch, 11)
        want_cross += cfg.num_layers if cfg.encoder_layers else 0
        card = _tree_map(lambda t: t.to(dev), cpu)
        toks = torch.randint(1, cfg.vocab_size, (2, 24),
                             generator=torch.Generator().manual_seed(13))
        more = {k: torch.from_numpy(v) for k, v in frontend_inputs(cfg, 2, 25, 48).items()}
        logits, gens, routes = {}, {}, {}
        for where, params in (("cpu", cpu), ("card", card)):
            d = "cpu" if where == "cpu" else dev
            routes[where] = []
            fa_ops.LAUNCHES_BY_SHAPE.clear()
            with recorded_routes(routes[where]):
                logits[where], _ = lm.prefill_forward(cfg)(
                    params, {"tokens": toks.to(d), **{k: v.to(d) for k, v in more.items()}})
                eng = Engine(cfg, params, max_seq=48, batch_size=2, device=d, enc_len=48)
                gens[where] = eng.generate(None, toks, 16, frames=more.get("frames")).cpu()
            if where == "card":
                cross += fa_ops.LAUNCHES_BY_SHAPE.get("24x48 full float32", 0)
        # float32 on both sides with TF32 off: the matmuls and the kernels sum
        # in another order than the CPU, ~1e-6 relative on logits of O(1)
        err = float((logits["card"].cpu() - logits["cpu"]).abs().max())
        worst = max(worst, err)
        if err > 1e-4:
            raise AssertionError(f"{arch} smoke: card logits off the CPU by {err}")
        if not torch.equal(gens["card"], gens["cpu"]):
            raise AssertionError(f"{arch} smoke: greedy tokens differ card vs CPU")
        if len(routes["card"]) != len(routes["cpu"]) or not all(
                torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(routes["card"], routes["cpu"])):
            raise AssertionError(f"{arch} smoke: MoE expert ids or keep masks differ "
                                 "card vs CPU")
        if cfg.num_experts and not routes["card"]:
            raise AssertionError(f"{arch} smoke: no MoE layer ran")
        routed += len(routes["card"])
    if cross != want_cross:
        raise AssertionError(f"phase {phase}: {cross} flash calls at Skv != S on the card, "
                             f"expected {want_cross} (the encdec cross-attention layers)")
    log(f"phase {phase} smoke configs ({', '.join(archs)}) float32: card == CPU "
        f"(prefill logits within 1e-4, max |err| {worst:.3g}; 16 greedy tokens "
        f"identical; {routed} MoE routings with expert ids and keep masks identical"
        + (f"; {cross} cross-attention launches at Skv 48 against S 24" if cross else "")
        + ")")


def busy_share(run, steps: int, what: str) -> dict:
    """``run()`` ``steps`` times unprofiled (host clock, synchronized), then
    ``steps`` times under ``torch.profiler`` recording the device's
    activity alone: the kernels' device time over the unprofiled wall (the
    host activity of a step of tens of thousands of ops took tens of
    seconds to process, and the share reads only the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / steps
    log(f"  {what} profile: wall {wall * 1e3:.3f} ms unprofiled, device busy "
        f"{busy_us / 1e3:.3f} ms in {len(kernels) / steps:.0f} kernels = "
        f"{busy_us / (wall * 1e6):.1%} of the wall")
    return dict(wall_ms=wall * 1e3, busy_ms=busy_us / 1e3, kernels=len(kernels) / steps,
                busy=busy_us / (wall * 1e6))


def run_lm_path(dev, arch: str, layers: int | None = None,
                batcher: bool = False, over: dict | None = None) -> dict:
    """Phases 12, 13, 23 and 25: ``arch`` at full width in bfloat16 (at
    ``layers`` of its layers where given, else at full depth; ``over``
    replaces further fields, as jamba's expert count), random weights from
    a seeded generator: prefill_forward (a vlm with its seeded patch
    embeddings in front of the tokens, an encdec over ENCDEC_MEMORY_LEN
    seeded frames), then Engine.generate (an encdec with the same frames),
    with the path's kernel launches counted; the decode step timed; then
    (phase 24, ``batcher``) the continuous batcher on the same weights."""
    import dataclasses

    from torch_lm_cases import frontend_inputs

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.models import lm
    from repro_torch.serve import Engine

    full = get_config(arch)
    cfg = dataclasses.replace(full, **({"num_layers": layers} if layers else {}),
                              **(over or {}))
    phase = {"llama3-8b": 12, "rwkv6-7b": 13}.get(
        arch, 25 if cfg.family in ("hybrid", "vlm", "encdec") else 23)
    attn = cfg.family != "ssm"
    B, S, P, N = LM["batch"], LM["prefill_len"], LM["prompt_len"], LM["new_tokens"]
    gen = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, dev)
    if cfg.family == "ssm":
        # rwkv6_init sets the bonus u to zeros; seeded values exercise it
        u = params["layers"]["pos0"]["mixer"]["u"]
        u.copy_(torch.randn(u.shape, generator=gen, device=dev) * 0.5)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    cuts = ", ".join(f"{k} {v} of {getattr(full, k)}" for k, v in (over or {}).items())
    log(f"phase {phase} {arch}: {cfg.num_layers} of {full.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else "")
        + f", d_model {cfg.d_model}, {cfg.num_heads} heads ({cfg.num_kv_heads} kv) of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}"
        + (f", {cfg.num_experts} experts top-{cfg.experts_per_token}"
           f" + {cfg.num_shared_experts} shared" if cfg.num_experts else "")
        + (f"; cut: {cuts}" if cuts else "")
        + f"; {n_params / 1e9:.3f} B params bf16 "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), "
        f"init {time.perf_counter() - t0:.2f} s"
        + ("; the bonus u filled with seeded values" if cfg.family == "ssm" else ""))
    mixers = [m for m, _ in cfg.block_program()]
    attn_layers = mixers.count("attn") * cfg.num_blocks
    # one launch a layer: WKV for rwkv; flash for each attention layer, and
    # an encdec's encoder layers and decoder cross-attentions
    want = cfg.num_layers if not attn else attn_layers + (
        cfg.encoder_layers + cfg.num_layers if cfg.encoder_layers else 0)
    count = fa_ops if attn else wkv_ops

    # a vlm's patch embeddings take the first positions of the 2048; an
    # encdec's frames are the encoder's input, beside 2048 decoder tokens
    more = {k: torch.from_numpy(v).to(dev).bfloat16() for k, v in
            frontend_inputs(cfg, B, 25, ENCDEC_MEMORY_LEN).items()}
    n_fe = cfg.frontend_positions if "frontend_embeds" in more else 0
    frames = more.get("frames")
    prefill = lm.prefill_forward(cfg)
    toks = torch.randint(1, cfg.vocab_size, (B, S - n_fe), generator=gen, device=dev)
    prefill(params, {"tokens": toks[:, :256], **more})  # warm the libraries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES = wkv_ops.LAUNCHES = knn_ops.LAUNCHES = 0
    fa_ops.LAUNCHES_BF16 = fa_ops.LAUNCHES_F32 = 0
    fa_ops.LAUNCHES_PADDED = fa_ops.STAGED_COPIES = 0
    fa_ops.LAUNCHES_BF16_CUDA_CORES = fa_ops.LAUNCHES_WIDE = 0
    fa_ops.LAUNCHES_BY_SHAPE.clear()
    t0 = time.perf_counter()
    logits, kv = prefill(params, {"tokens": toks, **more})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches_prefill = count.LAUNCHES
    if launches_prefill != want:
        raise AssertionError(f"{arch} prefill_forward launched its kernel "
                             f"{launches_prefill} times, expected {want}")
    if attn and (fa_ops.LAUNCHES_BF16, fa_ops.LAUNCHES_F32) != (want, 0):
        raise AssertionError(f"{arch} prefill_forward: {fa_ops.LAUNCHES_BF16} bf16 and "
                             f"{fa_ops.LAUNCHES_F32} float32 flash launches, expected "
                             f"{want} and 0")
    launches_f32, launches_wide = fa_ops.LAUNCHES_F32, fa_ops.LAUNCHES_WIDE
    by_shape = dict(fa_ops.LAUNCHES_BY_SHAPE)
    if attn:
        log(f"  prefill_forward flash: {fa_ops.LAUNCHES_BF16} bf16 (wgmma) and "
            f"{fa_ops.LAUNCHES_F32} float32 launches, {fa_ops.LAUNCHES_PADDED} padded, "
            f"{fa_ops.STAGED_COPIES} staged copies, {fa_ops.LAUNCHES_BF16_CUDA_CORES} "
            f"on the CUDA cores (head_dim {cfg.head_dim}); by shape {by_shape}")
        if fa_ops.LAUNCHES_PADDED or fa_ops.STAGED_COPIES:
            raise AssertionError(f"{arch} prefill padded or staged its flash inputs")
        if fa_ops.LAUNCHES_BF16_CUDA_CORES:
            raise AssertionError(f"{arch} prefill left the wgmma route "
                                 f"{fa_ops.LAUNCHES_BF16_CUDA_CORES} times")
    if logits.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill logits: shape {tuple(logits.shape)} "
                             "or non-finite values")
    for tap in kv.values():
        if tap["k"].shape != (cfg.num_blocks, B, S, cfg.num_kv_heads, cfg.head_dim):
            raise AssertionError(f"{arch} K/V tap shape {tuple(tap['k'].shape)}")
    del logits, kv
    log(f"  prefill_forward [{B},{S}]"
        + (f" ({n_fe} patch embeddings + {S - n_fe} tokens)" if n_fe else "")
        + (f" over {ENCDEC_MEMORY_LEN} frames" if frames is not None else "")
        + f": {t_prefill:.3f} s = {B * S / t_prefill:.1f} tokens/s; {launches_prefill} "
        f"{'bf16 flash' if attn else 'wkv'} launches (one per layer); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prefill_prof = None
    if phase == 25:
        prefill_prof = profile_prefill(prefill, params, {"tokens": toks, **more})

    eng = Engine(cfg, params, max_seq=LM["max_seq"], batch_size=B, device=dev,
                 enc_len=ENCDEC_MEMORY_LEN if frames is not None else 0)
    prompts = toks[:, :P]
    base = count.LAUNCHES
    fa_ops.LAUNCHES_BY_SHAPE.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(None, prompts, N, frames=frames)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches_gen = count.LAUNCHES - base
    for key, n in fa_ops.LAUNCHES_BY_SHAPE.items():
        by_shape[key] = by_shape.get(key, 0) + n
    steps = P + N                          # prompt steps + one per new token
    # the decode step attends by a plain masked softmax; an encdec's
    # prefill_encoder runs the encoder through the kernel
    want_gen = steps * cfg.num_layers if cfg.family == "ssm" else cfg.encoder_layers
    if launches_gen != want_gen:
        raise AssertionError(f"{arch} generate launched its kernel {launches_gen} "
                             f"times, expected {want_gen}")
    if out.shape != (B, N) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch} generate: bad tokens, shape {tuple(out.shape)}")
    if knn_ops.LAUNCHES:
        raise AssertionError("the K-NN kernel ran on the LM path")
    launches = launches_prefill + launches_gen     # not the Mamba profile's prefill
    if attn and sum(by_shape.values()) != launches:
        raise AssertionError(f"{arch}: flash launches by shape {by_shape} do not sum "
                             f"to the path's {launches}")
    log(f"  Engine.generate {B} x ({P} prompt + {N} new) tokens"
        + (f" over {ENCDEC_MEMORY_LEN} frames" if frames is not None else "")
        + f": {t_gen:.3f} s, {launches_gen} {'wkv' if cfg.family == 'ssm' else 'flash'} "
        f"launches ({steps} steps x {cfg.num_layers} layers"
        + (f"; the encoder's {cfg.encoder_layers} in prefill_encoder" if frames is not None
           else "") + ")"
        + (f"; the path's flash launches by shape {by_shape}" if attn else ""))
    if cfg.num_experts:
        # the dispatch writes kept rows by plain indexing and combines in a
        # fixed order: a second run gives the same tokens
        again = eng.generate(None, prompts, N, frames=frames)
        if not torch.equal(again, out):
            raise AssertionError(f"{arch}: two card runs of generate differ")
        log(f"  Engine.generate run twice: {N} x {B} tokens identical")

    drift = None
    agree = phase in (12, 13) or (phase == 25 and not cfg.num_experts)
    if agree:
        # the Engine's token-by-token prefill against prefill_forward on the
        # same 64-token prompts (an encdec's over the whole memory: the
        # kernel at Skv = ENCDEC_MEMORY_LEN against S = 64); the float32
        # pair on the same weights follows
        cache = eng.new_cache()
        if frames is not None:
            cache = lm.prefill_encoder(cfg, params, cache, frames)
        _, step_logits = eng.prefill(cache, prompts)
        full_logits, _ = prefill(params, {"tokens": prompts, **more_frames(frames)})
        del cache
    del eng
    decode = time_decode(cfg, params, out[:, -1:], frames=frames)
    if agree:
        drift = check_prefills_agree(cfg, params, prompts, step_logits, full_logits,
                                     frames=frames)
    elif phase == 25:
        # it cuts the experts and turns the weights to float32 in place:
        # nothing runs after it
        drift = check_hybrid_drift(cfg, params, torch.randint(
            1, cfg.vocab_size, (32, P), generator=gen, device=dev))
    elif cfg.num_experts:
        # it turns the weights to float32 in place: nothing runs after it
        drift = check_moe_drift(cfg, params, gen)
    res = dict(launches=launches, launches_f32=launches_f32,
               launches_wide=launches_wide, layers=cfg.num_layers,
               prefill_tok_s=B * S / t_prefill, decode=decode, drift=drift,
               by_shape=by_shape, prefill_profile=prefill_prof)
    if batcher:
        res["batcher"] = run_batcher(dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    return res


def seamless_launches(new: dict, shape: str) -> int:
    """seamless's bf16 flash launches at ``shape`` ("S x Skv causal|full")
    on its main path, prefill_forward and Engine.generate (phase 25), as
    the wrapper counts them where it launches."""
    return new["seamless-m4t-medium"]["by_shape"].get(f"{shape} bfloat16", 0)


def more_frames(frames) -> dict:
    return {} if frames is None else {"frames": frames}


def profile_prefill(prefill, params, batch) -> dict:
    """Phase 25: one more prefill_forward under ``torch.profiler``: the
    device's busy time (its kernels' and copies'), the kernels that take
    most of it, and, every ``ssm.mamba_forward`` call in a
    ``record_function`` range, the Mamba layers' share of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm

    forward = ssm.mamba_forward

    def ranged(*args, **kwargs):
        with record_function("mamba_forward"):
            return forward(*args, **kwargs)
    ssm.mamba_forward = ranged
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(params, batch)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ssm.mamba_forward = forward
    events = prof.events()
    by_name: dict = {}
    for e in events:
        if str(e.device_type).endswith("CUDA") and e.name != "mamba_forward":
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values()) or float("nan")
    mamba = [e for e in events
             if e.name == "mamba_forward" and not str(e.device_type).endswith("CUDA")]
    mamba_us = sum(getattr(e, "device_time_total", 0) for e in mamba)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"  prefill_forward profile: wall {wall_ms:.3f} ms profiled, device busy "
        f"{busy_us / 1e3:.3f} ms; most: "
        + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms ({us / busy_us:.1%})"
                    for name, us in top)
        + (f"; the {len(mamba)} Mamba layers' kernels {mamba_us / 1e3:.3f} ms = "
           f"{mamba_us / busy_us:.1%} of the busy time" if mamba else ""))
    return dict(busy_ms=busy_us / 1e3, wall_ms=wall_ms,
                mamba_ms=mamba_us / 1e3 if mamba else None,
                mamba_share=mamba_us / busy_us if mamba else None)


def decode_bytes(cfg, params, B: int, t: int, routed: dict | None = None,
                 enc_len: int = 0) -> int:
    """What one decode step at batch ``B`` and position ``t`` moves: every
    weight once (an untied embedding only its B rows; an encoder's weights
    and, with ``enc_len``, the cross-attention's ``wk``/``wv`` not at all:
    the step does not run the encoder, and prefill_encoder already turned
    the memory into ``ck``/``cv``), the K/V rows 0..t of each
    attention layer read and row t written, an encdec's ``enc_len`` rows of
    cross-attention K/V read in every decoder layer, the RWKV and Mamba
    states read and written.  An MoE's experts: with ``routed`` None, all
    of them, as this formulation reads them (capacity 1, ``bmm`` over every
    expert); else, for each MoE position, ``routed[pos]`` experts' weights,
    the distinct experts the step's layers at that position route to,
    summed over the blocks (at most B·K a layer): the function's bound."""
    total = 0
    for name, leaf in _named_leaves(params):
        if name[0].startswith("enc_") or (enc_len and name[-3:-1] in (
                ("cross", "wk"), ("cross", "wv"))):
            continue
        if name == ("embed", "table") and not cfg.tie_embeddings:
            total += B * leaf.shape[1] * leaf.element_size()
        elif routed is not None and name[-2] == "ffn" and name[-1] in ("gate", "up", "down"):
            # the stacked experts [num_blocks, E, ...]
            total += routed[name[-3]] * leaf[0, 0].numel() * leaf.element_size()
        else:
            total += leaf.numel() * leaf.element_size()
    if cfg.family == "ssm":
        state = cfg.rwkv_heads * cfg.rwkv_head_size ** 2 * 4 + 2 * cfg.d_model * 2
        return total + 2 * cfg.num_layers * B * state
    mixers = [m for m, _ in cfg.block_program()]
    row = 2 * cfg.num_kv_heads * cfg.head_dim * 2          # k and v, bf16
    total += mixers.count("attn") * cfg.num_blocks * B * row * (t + 2)
    total += cfg.num_layers * B * row * enc_len if cfg.encoder_layers else 0
    di = cfg.mamba_d_inner
    state = di * cfg.mamba_d_state * 4 + (cfg.mamba_d_conv - 1) * di * 2   # h, conv
    return total + 2 * mixers.count("mamba") * cfg.num_blocks * B * state


def time_decode(cfg, params, tok, frames=None) -> dict:
    """Decode throughput at batch ``B``: ``serve_step`` on a fresh cache
    (an encdec's holding the cross-attention K/V of ``frames``), timed over
    DECODE["windows"] back-to-back windows of DECODE["steps"] steps each
    (host time, synchronized at each window's end), so that the host's
    noise averages out; then the device's busy share, and the byte bound
    of a step at the windows' middle position."""
    from repro_torch.models import lm

    B, n, k = tok.shape[0], DECODE["steps"], DECODE["windows"]
    prof_steps = 4
    step = lm.serve_step(cfg)
    cache = lm.init_cache(cfg, batch=B, max_seq=3 + n * k + 2 * prof_steps,
                          device=tok.device)
    enc_len = 0
    if frames is not None:
        cache = lm.prefill_encoder(cfg, params, cache, frames)
        enc_len = frames.shape[1]
    step(params, cache, tok)                             # warm
    torch.cuda.synchronize()
    window_ms = []
    for _ in range(k):
        t0 = time.perf_counter()
        for _ in range(n):
            _, cache = step(params, cache, tok)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) / n * 1e3)
    step_ms = sum(window_ms) / k
    moved = decode_bytes(cfg, params, B, 1 + n * k // 2, enc_len=enc_len)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  decode step at batch {B}, {k} windows of {n} steps: {step_ms:.3f} ms "
        f"mean = {B / step_ms * 1e3:.1f} tokens/s (windows "
        f"{min(window_ms):.3f}-{max(window_ms):.3f} ms per step); byte bound "
        f"{bound_ms:.3f} ms ({moved / 1e9:.3f} GB at 3.35 TB/s)")
    res = dict(step_ms=step_ms, tok_s=B / step_ms * 1e3, window_ms=window_ms,
               bound_ms=bound_ms, bytes=moved)
    if cfg.num_experts:
        routes = []
        with recorded_routes(routes):
            step(params, cache, tok)
        # the step routes its MoE layers block by block, position by position
        moe_pos = [f"pos{p}" for _ in range(cfg.num_blocks)
                   for p, (_, f) in enumerate(cfg.block_program()) if f == "moe"]
        by_pos: dict = {}
        for pos, (e, keep) in zip(moe_pos, routes, strict=True):
            by_pos[pos] = by_pos.get(pos, 0) + len(set(e[keep].tolist()))
        routed = sum(by_pos.values())
        fn_moved = decode_bytes(cfg, params, B, 1 + n * k // 2, routed=by_pos,
                                enc_len=enc_len)
        res.update(fn_bound_ms=fn_moved / HBM_BYTES_PER_S * 1e3, routed=routed)
        log(f"  that byte bound is this formulation's (every expert read at "
            f"capacity 1); the function's, with the {routed} experts routed in "
            f"{len(routes)} layers (at most {min(B * cfg.experts_per_token, cfg.num_experts)}"
            f" of {cfg.num_experts} a layer): {res['fn_bound_ms']:.3f} ms "
            f"({fn_moved / 1e9:.3f} GB)")
    prof = busy_share(lambda: step(params, cache, tok), prof_steps, "decode step")
    res["busy"] = prof["busy"]
    return res


def check_moe_drift(cfg, params, gen) -> dict:
    """Phase 23, MoE: the bf16 prefill_forward's drift from the float32
    answer of the same weights, no larger than 1.5x that of a control with
    the kernels' plain versions.  With random weights the routers are
    close to uniform, and bf16 rounding moves some tokens to other experts
    in any run, the control's too, which makes a sequence's last logits
    jump: the distance is taken over 32 sequences of 64 tokens, where the
    jumps average out (tests/test_torch_lm_bf16.py).  The weights are
    turned to float32 in place, leaf by leaf (qwen2-moe's 28.6 GB in bf16
    and 57.2 GB in float32 do not fit one card together)."""
    import dataclasses

    from repro_torch.models import lm

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    prompts = torch.randint(1, cfg.vocab_size, (32, 64), generator=gen,
                            device=params["embed"]["table"].device)
    full16, _ = lm.prefill_forward(cfg)(params, {"tokens": prompts})
    with plain_kernels():
        plain16, _ = lm.prefill_forward(cfg)(params, {"tokens": prompts})

    to_f32_in_place(params)
    full32, _ = lm.prefill_forward(dataclasses.replace(cfg, dtype="float32"))(
        params, {"tokens": prompts})
    r = dict(full16=rel(full16, full32), control=rel(plain16, full32),
             kernel_vs_plain16=rel(full16, plain16))
    log(f"  MoE bf16 drift from the float32 answer over 32 x 64 tokens: "
        f"prefill_forward {r['full16']:.4f}, control with the plain versions "
        f"{r['control']:.4f} (tol 1.5x the control); kernels vs plain versions "
        f"in bf16 {r['kernel_vs_plain16']:.4f}")
    if not r["full16"] <= 1.5 * r["control"]:
        raise AssertionError(f"{cfg.name}: bf16 drift past 1.5x the control: {r}")
    return r


def to_f32_in_place(tree) -> None:
    """Every leaf of ``tree`` turned to float32 in place, leaf by leaf: the
    peak is the weights plus one float32 leaf."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            to_f32_in_place(leaf)
        else:
            tree[name] = leaf.float()
            del leaf
    torch.cuda.empty_cache()


def check_hybrid_drift(cfg, params, prompts) -> dict:
    """Phase 25, jamba: the prefill agreement and the bf16 drift control of
    check_prefills_agree, on the same weights cut to JAMBA_F32_EXPERTS of
    their experts a MoE layer (the first ones, and the router's columns for
    them), since a float32 copy of 12 experts a layer fits nowhere: the cut
    is ~16.2 B parameters, 64.8 GB in float32, turned in place.  The
    capacity factor is raised until no token drops (E / K), so the Engine's
    one token a step and prefill_forward's 64 compute one sum.  ``prompts``
    are 32 sequences of 64 tokens, over which the router's bf16 jumps
    average out (as in check_moe_drift)."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.serve import Engine

    E = JAMBA_F32_EXPERTS
    for pos, (_, fkind) in enumerate(cfg.block_program()):
        if fkind != "moe":
            continue
        ffn = params["layers"][f"pos{pos}"]["ffn"]
        ffn["router"]["w"] = ffn["router"]["w"][..., :E].contiguous()
        for name in ("gate", "up", "down"):
            ffn[name] = ffn[name][:, :E].contiguous()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_experts=E, capacity_factor=E / cfg.experts_per_token)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  drift control on the weights cut to {E} of {cfg.num_experts} experts a MoE "
        f"layer, capacity factor {cut.capacity_factor}: {n_params / 1e9:.3f} B params")
    eng = Engine(cut, params, max_seq=LM["max_seq"], batch_size=prompts.shape[0],
                 device=prompts.device)
    _, step16 = eng.prefill(eng.new_cache(), prompts)
    full16, _ = lm.prefill_forward(cut)(params, {"tokens": prompts})
    del eng
    r = check_prefills_agree(cut, params, prompts, step16, full16, in_place=True)
    return dict(r, experts=E, params=n_params)


@contextlib.contextmanager
def plain_kernels():
    """The model's flash and WKV calls swapped for the kernels' plain
    versions, on the card: a control for the bf16 drift below."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import wkv6_ref

    saved = fa_ops.flash_attention, wkv_ops.wkv6
    fa_ops.flash_attention, wkv_ops.wkv6 = flash_attention_ref, wkv6_ref
    try:
        yield
    finally:
        fa_ops.flash_attention, wkv_ops.wkv6 = saved


def check_prefills_agree(cfg, params, prompts, step16, full16, frames=None,
                         in_place: bool = False) -> dict:
    """The Engine's token-by-token prefill (through the decode step) and
    prefill_forward give the same last-token logits.

    The gate is float32, on the bf16 weights upcast: there the two paths
    are one computation summed in other orders, held to 1e-4 relative.  In
    bf16 each path rounds every layer's activations, at other points, and
    with random weights the logits drift from the float32 answer by an
    amount (~0.1 for rwkv6-7b) that no limit set in advance can follow;
    that the port rounds where the reference does is held against the
    reference on the CPU (tests/test_torch_lm.py, test_torch_lm_bf16.py).
    On the card a control witnesses the drift: the same bf16
    prefill_forward with the kernels swapped for their plain versions.
    Each bf16 path of the port must drift from the float32 answer no
    further than 1.5 times the control does, the bound that
    test_torch_lm_bf16.py puts on the port against the reference; the
    bf16 pair's distance and argmax agreement are readings.  An encdec's
    two paths read the memory of ``frames``.  With ``in_place`` the weights
    are turned to float32 in place (where a float32 copy would not fit
    beside them): nothing runs on them after.

    An MoE's float32 gate reads every sequence whose two float32 paths
    route every token to the same experts.  A sequence whose routings
    differ is shown instead to have met a near tie (router_flips): at the
    first MoE layer where they differ, the two paths' router probabilities
    agree within 1e-4 over the whole sequence, so the layer's inputs were
    the same and its sums broke a near tie apart; its gap is logged
    beside that layer, the tokens and their top-K margins."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.serve import Engine

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    batch = {"tokens": prompts, **more_frames(frames)}
    with plain_kernels():
        plain16, _ = lm.prefill_forward(cfg)(params, batch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if in_place:
        to_f32_in_place(params)
        p32 = params
    else:
        p32 = _tree_map(lambda t: t.float(), params)
    eng = Engine(cfg32, p32, max_seq=LM["max_seq"], batch_size=prompts.shape[0],
                 device=prompts.device)
    cache = eng.new_cache()
    if frames is not None:
        cache = lm.prefill_encoder(cfg32, p32, cache, frames)
    routes_step, routes_full = [], []
    with recorded_routes(routes_step, probs=True):
        _, step32 = eng.prefill(cache, prompts)
    with recorded_routes(routes_full, probs=True):
        full32, _ = lm.prefill_forward(cfg32)(p32, batch)
    del eng, p32, cache
    flips = router_flips(routes_step, routes_full, prompts.shape[1])
    seqs = prompts.shape[0]
    g = [b for b in range(seqs) if b not in flips]
    for b, f in flips.items():
        f["f32"] = rel(step32[b], full32[b])
        log(f"  float32 routing differs in sequence {b}: first at MoE layer {f['layer']}, "
            f"tokens {f['tokens']}, top-{f['k']} margins {f['margin_step']} (token by "
            f"token) and {f['margin_full']} (prefill_forward), the router "
            f"probabilities there within {f['probs_gap']:.3g} over the sequence (median "
            f"margin of the layer {f['median_margin']:.3g}); the sequence's float32 gap "
            f"{f['f32']:.3g}")
    if any(f["probs_gap"] > 1e-4 for f in flips.values()):
        raise AssertionError(f"{cfg.name}: float32 routings differ past a near tie: {flips}")
    r = dict(f32=rel(step32[g], full32[g]), control=rel(plain16, full32),
             full16=rel(full16, full32), step16=rel(step16, full32),
             pair16=rel(step16, full16), kernel_vs_plain16=rel(full16, plain16))
    agree = float((step16.argmax(-1) == full16.argmax(-1)).float().mean())
    log(f"  Engine prefill (token by token) vs prefill_forward, last-token "
        f"logits |diff|/|logits|: float32 {r['f32']:.3g} (tol 1e-4, over {len(g)} of "
        f"{seqs} sequences"
        + (f"; the other {len(flips)} met a router near tie" if flips else "")
        + f"); bf16 "
        f"drift from the float32 answer: prefill_forward {r['full16']:.4f}, "
        f"token by token {r['step16']:.4f}, control with the plain versions "
        f"{r['control']:.4f} (tol 1.5x the control); readings: bf16 pair "
        f"{r['pair16']:.4f}, kernels vs plain versions in bf16 "
        f"{r['kernel_vs_plain16']:.4f}, bf16 argmax agree {agree:.2f}")
    r.update(f32_sequences=len(g), flips=flips)
    if not (r["f32"] <= 1e-4 and r["full16"] <= 1.5 * r["control"]
            and r["step16"] <= 1.5 * r["control"]):
        raise AssertionError(f"{cfg.name}: the two prefills disagree: {r}")
    return r


def router_flips(step: list, full: list, S: int) -> dict:
    """The sequences whose float32 routings differ between the Engine's
    token-by-token prefill (``step``: S calls of the model's M MoE layers,
    one token each) and prefill_forward (``full``: the M layers once), as
    recorded_routes(probs=True) took them.  For each, at the first MoE
    layer where the chosen experts differ (as sets): the layer, the
    tokens, the router's top-K margin (the K-th probability less the
    next) at them in each path, the two paths' largest router-probability
    gap over the sequence at that layer, and the layer's median margin."""
    M = len(full)
    if len(step) != S * M:
        raise AssertionError(f"{len(step)} token-by-token routings, expected {S} x {M}")
    out: dict = {}
    for m in range(M):
        e_full, _, p_full = full[m]
        e_step = torch.cat([step[t * M + m][0] for t in range(S)], 1)
        p_step = torch.cat([step[t * M + m][2] for t in range(S)], 1)
        B, E = p_full.shape[0], p_full.shape[-1]
        K = e_full.shape[1] // S

        def margin(p):
            top = p.topk(min(K + 1, E), -1).values
            return top[..., K - 1] - top[..., K]
        differ = (e_full.view(B, S, K).sort(-1).values
                  != e_step.view(B, S, K).sort(-1).values).any(-1)
        for b in differ.any(-1).nonzero()[:, 0].tolist():
            if b in out:
                continue
            toks = differ[b].nonzero()[:, 0].tolist()
            out[b] = dict(layer=m, tokens=toks, k=K,
                          margin_step=[f"{x:.3g}" for x in margin(p_step[b, toks]).tolist()],
                          margin_full=[f"{x:.3g}" for x in margin(p_full[b, toks]).tolist()],
                          probs_gap=float((p_step[b] - p_full[b]).abs().max()),
                          median_margin=float(margin(p_full).median()))
    return out


def time_config_flash(dev) -> dict:
    """Phase 23: the bf16 flash kernel at each new config's prefill shape."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(23)
    log("phase 23 flash bf16 at each config's prefill shape")
    out = {}
    for arch, _ in LM_MORE:
        cfg = get_config(arch)
        out[arch] = time_flash_shape(dev, gen, arch, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.head_dim)
    return out


def serve_requests(cfg, params, n_slots, max_seq, reqs, device) -> list:
    """[(rid, out)] in finish order, served by a ContinuousBatcher."""
    from repro_torch.serve import ContinuousBatcher, Request

    cb = ContinuousBatcher(cfg, params, max_seq=max_seq, n_slots=n_slots, eos_id=-1,
                           device=device)
    for rid, (prompt, new) in enumerate(reqs):
        cb.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=new))
    return [(r.rid, list(r.out)) for r in cb.run(None, max_steps=200)]


def check_batcher_vs_cpu(dev, archs=("llama3-8b", "rwkv6-7b", "granite-moe-3b-a800m"),
                         phase: int = 24) -> None:
    """Phases 24 and 25, first part: the float32 smoke configs of ``archs``
    through the continuous batcher, card against CPU: outputs token for
    token and the finish order."""
    from torch_lm_cases import BATCHER_SCENARIOS, smoke_lm

    distinct = {}
    for arch in archs:
        cfg, cpu = smoke_lm(arch, 24)
        card = _tree_map(lambda t: t.to(dev), cpu)
        for name, (n_slots, max_seq, reqs) in BATCHER_SCENARIOS.items():
            got = serve_requests(cfg, card, n_slots, max_seq, reqs, dev)
            want = serve_requests(cfg, cpu, n_slots, max_seq, reqs, "cpu")
            if got != want:
                raise AssertionError(f"phase {phase} {arch} {name}: card {got} != CPU "
                                     f"{want}")
            if name == "recycled_slot":
                distinct[arch] = len({tuple(out) for _, out in got})
    log(f"phase {phase} ContinuousBatcher smoke configs ({', '.join(archs)}) float32, "
        "5 requests on 2 slots, 2 on 1, 3 equal prompts through 1 slot: card == CPU "
        f"(outputs and finish order); distinct outputs of the 3 equal prompts {distinct}")


def run_batcher(dev, cfg, params) -> dict:
    """Phase 24: 32 seeded requests through 8 slots of a 2048-position
    shared cache, greedy, no EOS, on ``cfg`` at full size: the first wave
    against Engine.generate on the same prompts at batch 8, every request
    finished with its budget, the traffic's steps, the kernel launches of
    the run, its tokens/s and requests/s, and a step's device busy
    share."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.serve import ContinuousBatcher, Engine, Request

    n_slots, max_seq = BATCHER["slots"], BATCHER["max_seq"]
    rng = np.random.default_rng(BATCHER["seed"])
    reqs = []
    for i in range(BATCHER["requests"]):
        if i < BATCHER["first"]:
            P, N = BATCHER["first_prompt"], BATCHER["first_new"]
        else:
            P = int(rng.integers(BATCHER["prompt"][0], BATCHER["prompt"][1] + 1))
            N = int(rng.integers(BATCHER["new"][0], BATCHER["new"][1] + 1))
        reqs.append((rng.integers(1, cfg.vocab_size, P).tolist(), N))

    first = torch.tensor([p for p, _ in reqs[:n_slots]], dtype=torch.int32, device=dev)
    eng = Engine(cfg, params, max_seq=max_seq, batch_size=n_slots, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = eng.generate(None, first, BATCHER["first_new"]).cpu().tolist()
    t_eng = time.perf_counter() - t0
    del eng
    torch.cuda.empty_cache()

    cb = ContinuousBatcher(cfg, params, max_seq=max_seq, n_slots=n_slots, eos_id=-1,
                           device=dev)
    for rid, (prompt, new) in enumerate(reqs):
        cb.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new))
    fa_ops.LAUNCHES = wkv_ops.LAUNCHES = 0
    steps = slot_steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while cb.queue or any(cb.slots):
        slot_steps += min(n_slots, cb.active + len(cb.queue))
        cb.step()
        steps += 1
    wall = time.perf_counter() - t0
    launches = dict(flash=fa_ops.LAUNCHES, wkv=wkv_ops.LAUNCHES)
    done = cb._finished
    if len(done) != len(reqs) or any(len(r.out) != reqs[r.rid][1] for r in done):
        raise AssertionError(f"phase 24 {cfg.name}: {len(done)} of {len(reqs)} requests "
                             "finished with their budget")
    if not cb.cache["len"] == steps == BATCHER["steps"] <= max_seq:
        raise AssertionError(f"phase 24 {cfg.name}: {steps} steps (cache len "
                             f"{cb.cache['len']}), expected {BATCHER['steps']} within "
                             f"max_seq {max_seq}")
    got = {r.rid: r.out for r in done}
    if [got[i] for i in range(n_slots)] != want:
        raise AssertionError(f"phase 24 {cfg.name}: the first wave's tokens differ "
                             "from Engine.generate's")
    want_launches = dict(flash=0, wkv=cfg.num_layers * steps if cfg.family == "ssm" else 0)
    if launches != want_launches:
        raise AssertionError(f"phase 24 {cfg.name}: launches {launches}, expected "
                             f"{want_launches}")
    new_tokens = sum(n for _, n in reqs)
    prompt_tokens = sum(len(p) for p, _ in reqs)
    res = dict(steps=steps, wall_s=wall, tok_s=new_tokens / wall,
               req_s=len(reqs) / wall, active=slot_steps / steps,
               step_ms=wall / steps * 1e3, launches=launches,
               engine_tok_s=n_slots * BATCHER["first_new"] / t_eng)
    log(f"phase 24 ContinuousBatcher {cfg.name} bf16, {n_slots} slots, max_seq "
        f"{max_seq}, {len(reqs)} requests ({prompt_tokens} prompt + {new_tokens} new "
        f"tokens): {steps} steps, {wall:.3f} s = "
        f"{res['tok_s']:.1f} generated tokens/s, {res['req_s']:.3f} requests/s, "
        f"{res['step_ms']:.3f} ms a step, {res['active']:.2f} slots active a step; "
        f"first wave == Engine.generate at batch {n_slots} token for token "
        f"(Engine: {res['engine_tok_s']:.1f} generated tokens/s); launches {launches}")

    # a step's device busy share: 8 more requests on the same batcher, past
    # their prompts' first steps
    for rid in range(n_slots):
        cb.submit(Request(rid=100 + rid, prompt=reqs[rid][0][:16], max_new_tokens=64))
    for _ in range(20):
        cb.step()
    res["profile"] = busy_share(cb.step, 4, "batcher step")
    del cb
    torch.cuda.empty_cache()
    return res


def time_new_flash(dev) -> dict:
    """Phase 25: the flash kernel at the new configs' shapes, bf16 route and
    (at seamless's encoder and cross-attention, the shapes the key length
    of its own opened) the float32 route, each against its plain version,
    SDPA and the bound."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(25)
    log("phase 25 flash at the new configs' shapes")
    sm = get_config("seamless-m4t-medium")
    jb = get_config("jamba-1.5-large-398b")
    heads = (sm.num_heads, sm.num_kv_heads, sm.head_dim)
    return dict(
        encoder=time_flash_shape(dev, gen, "seamless encoder", *heads,
                                 S=ENCDEC_MEMORY_LEN, causal=False, f32=True),
        cross=time_flash_shape(dev, gen, "seamless cross-attention", *heads,
                               Skv=ENCDEC_MEMORY_LEN, causal=False, f32=True),
        decoder=time_flash_shape(dev, gen, "seamless decoder", *heads),
        jamba=time_flash_shape(dev, gen, "jamba attention", jb.num_heads,
                               jb.num_kv_heads, jb.head_dim))


# --------------------------------------------------------------------------
# phase 26: the paper's evaluation (repro_torch.figures)
# --------------------------------------------------------------------------
def check_figures_vs_cpu(dev) -> None:
    """Phase 26a: the figures' pieces at the CPU tests' tiny budget on
    cq_small, card against CPU from the same states (made on the CPU) and
    numpy draws: the model-based fit and search, the DQN and actor-critic
    fleets with their deploys, Fig 12's shifted run and refit."""
    from repro_torch.core import OfflineDraws, make_agent
    from repro_torch.core.convert import (ddpg_state_from_numpy, ddpg_state_to_numpy,
                                          dqn_state_from_numpy, dqn_state_to_numpy)
    from repro_torch.figures import common, fig12

    budget = common.Budget(**FIG_TINY)
    F, T, n = budget.n_seeds, budget.online_epochs, budget.offline_samples
    cpu_env = common.make_env("cq_small", "cpu")
    N, M, S = cpu_env.N, cpu_env.M, cpu_env.workload.num_spouts
    gen = torch.Generator().manual_seed(26)
    dqn0 = dqn_state_to_numpy(make_agent("dqn", cpu_env).init_fleet(gen, F, "cpu"))
    ddpg = make_agent("ddpg", cpu_env, k_nn=budget.k_nn)
    ddpg0 = ddpg_state_to_numpy(ddpg.init_fleet(gen, F, "cpu"))
    B, upd = ddpg.cfg.batch, budget.updates_per_epoch      # DQN's batch is 32 too
    rng = np.random.default_rng(26)
    fit = (torch.as_tensor(rng.integers(0, M, (budget.mb_samples, N))),
           torch.as_tensor(rng.normal(size=(budget.mb_samples, 5)).astype(np.float32)))
    dqn_draws = numpy_draws(rng, F, T, cpu_env, B, upd)
    offline = OfflineDraws(
        torch.as_tensor(rng.integers(0, M, (F, n, N))),
        torch.as_tensor(rng.normal(size=(F, n, 5)).astype(np.float32)),
        torch.as_tensor(rng.normal(size=(F, n, S)).astype(np.float32)),
        torch.as_tensor(rng.integers(0, n, (F, budget.offline_updates, B))))
    ac_draws = numpy_draws(rng, F, T, cpu_env, B, upd, size0=n)
    T_shift = max(T // 3, 40)
    shift_draws = numpy_draws(rng, F, T_shift, cpu_env, B, upd, size0=n + T)
    out = {}
    for where in ("cpu", dev):
        env = common.make_env("cq_small", where)
        on = lambda ds: [d.to(where) for d in ds]           # noqa: E731
        A, Z = (x.to(where) for x in fit)
        mb = common.run_model_based(env, budget, 0, assignments=A, meas_z=Z)
        dqn = common.run_dqn(env, budget, 0, states=dqn_state_from_numpy(dqn0, where),
                             draws=on(dqn_draws))
        ac = common.run_actor_critic(
            env, budget, 0, states=ddpg_state_from_numpy(ddpg0, where),
            draws=on(ac_draws), offline_draws=OfflineDraws(*(x.to(where) for x in offline)))
        states, cfg = ac[2]
        shifted = fig12.run_shifted(env, cfg, states, budget, 0, draws=on(shift_draws))
        refit = fig12.refit_model_based(env, budget, 0, assignments=A, meas_z=Z)
        out[str(where)] = dict(mb=mb, dqn=dqn, ac=ac, shifted=shifted, refit=refit)
    cpu, gpu = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(gpu["mb"][1].cpu(), cpu["mb"][1])
    np.testing.assert_allclose(gpu["mb"][0], cpu["mb"][0], rtol=1e-4)
    np.testing.assert_allclose(gpu["refit"], cpu["refit"], rtol=1e-4)
    moved, rel = {}, [abs(gpu["mb"][0] / cpu["mb"][0] - 1),
                      abs(gpu["refit"] / cpu["refit"] - 1)]
    for name in ("dqn", "ac", "shifted"):
        (lats, hist), (lats_cpu, hist_cpu) = gpu[name][:2], cpu[name][:2]
        np.testing.assert_array_equal(hist.moved, hist_cpu.moved)
        np.testing.assert_array_equal(hist.final_assignment, hist_cpu.final_assignment)
        np.testing.assert_allclose(hist.latencies, hist_cpu.latencies, rtol=1e-4)
        np.testing.assert_allclose(lats, lats_cpu, rtol=1e-4)
        moved[name] = int(hist_cpu.moved.sum())
        rel += [np.abs(hist.latencies / hist_cpu.latencies - 1).max(),
                np.abs(np.asarray(lats) / np.asarray(lats_cpu) - 1).max()]
    log(f"phase 26a figures cq_small at the tiny budget (F={F}, T={T}, "
        f"{n} offline samples, Fig 12 shift {T_shift} epochs): card == CPU "
        f"(moves {moved} exact, final assignments exact, model-based schedule "
        f"exact; latencies, deployed and model-based latencies max rel diff "
        f"{max(rel):.3g}, tol 1e-4)")


def band_gap(got: dict, want: dict) -> dict:
    """For actor-critic and DQN, the largest |mean − mean_ref| − (std +
    std_ref) over the last fifth of epochs; the bands overlap where it is
    at most 0."""
    last = max(want["epochs"] // 5, 1)
    gaps = {}
    for name in ("ac", "dqn"):
        mean, std, mean_ref, std_ref = (
            np.asarray(d[f"{name}_smoothed_{k}"][-last:])
            for d in (got, want) for k in ("mean", "std"))
        gaps[name] = float((np.abs(mean - mean_ref) - (std + std_ref)).max())
    return gaps


def run_figures(dev, card: str) -> dict:
    """Phase 26b-d: the reward curves at the committed artifact's budget
    held to its band; ``compare_all`` on cq_large at Budget.quick (Fig 6's
    large row); Fig 12's run at Budget.quick.  Every DDPG select and update
    through the K-NN kernel: offline updates + epochs × (1 + U) a run."""
    import dataclasses

    from repro_torch.figures import common, fig12, reward
    from repro_torch.kernels.knn_topk import ops

    want = json.loads(open(REWARD_ARTIFACT).read())
    budget = dataclasses.replace(common.Budget.quick(), online_epochs=want["epochs"])
    t0 = time.perf_counter()
    got = reward.run(want["app"], budget, 0, device=dev)
    gaps = band_gap(got, want)
    if list(got) != list(want) or not all(g <= 0 for g in gaps.values()):
        raise AssertionError(f"reward bands do not overlap the artifact's: {gaps}")
    log(f"phase 26b reward {want['app']} at Budget.quick, {want['epochs']} epochs, "
        f"{budget.n_seeds} seeds ({card}): {time.perf_counter() - t0:.3f} s; final "
        f"smoothed reward AC {got['ac_final_avg']:.4f} (artifact "
        f"{want['ac_final_avg']:.4f}), DQN {got['dqn_final_avg']:.4f} "
        f"({want['dqn_final_avg']:.4f}); band gap over the last fifth "
        f"(<= 0 overlaps) AC {gaps['ac']:.4f}, DQN {gaps['dqn']:.4f}")

    quick = common.Budget.quick()
    per_run = quick.offline_updates + quick.online_epochs * (1 + quick.updates_per_epoch)
    common.SECONDS.clear()
    ops.LAUNCHES = 0
    out = common.compare_all(FIG_APP, quick, 0, verbose=False, device=dev)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES
    parts = dict(common.SECONDS)
    for name in ("_dqn_hist", "_ac_hist"):
        hist = out[name]
        if (hist.rewards.shape != (quick.n_seeds, quick.online_epochs)
                or not np.isfinite(hist.rewards).all()
                or not np.array_equal(hist.final_assignment.sum(-1),
                                      np.ones(hist.final_assignment.shape[:2]))):
            raise AssertionError(f"compare_all {name}: bad traces or assignments")
    lats = [out[k] for k in ("default", "model_based", "dqn", "actor_critic")]
    if not all(np.isfinite(x) and x > 0 for x in lats + out["dqn_seeds"]
               + out["actor_critic_seeds"]):
        raise AssertionError(f"compare_all: bad latencies {lats}")
    if launches != per_run:
        raise AssertionError(f"row_top2_regret launched {launches} times in "
                             f"compare_all, expected {per_run}")
    log(f"phase 26c compare_all {FIG_APP} at Budget.quick ({quick.n_seeds} seeds, "
        f"{card}): default {out['default']:.4f} ms, model-based "
        f"{out['model_based']:.4f} ms, DQN {out['dqn']:.4f} ± {out['dqn_std']:.4f} "
        f"ms, actor-critic {out['actor_critic']:.4f} ± {out['actor_critic_std']:.4f} "
        f"ms; improvement {out['imp_vs_default']:.2%} vs default, "
        f"{out['imp_vs_model_based']:.2%} vs model-based; {launches} K-NN launches "
        f"(= {quick.offline_updates} offline updates + {quick.online_epochs} epochs "
        f"x (1 select + {quick.updates_per_epoch} updates)); {out['seconds']} s")
    log("  wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    shift = fig12.run(FIG_APP, quick, 0, device=dev)
    torch.cuda.synchronize()
    shift_launches = ops.LAUNCHES
    want_shift = per_run + max(quick.online_epochs // 3, 40) * (1 + quick.updates_per_epoch)
    if shift_launches != want_shift:
        raise AssertionError(f"row_top2_regret launched {shift_launches} times in "
                             f"fig12.run, expected {want_shift}")
    if not all(np.isfinite(shift[k]) and shift[k] > 0 for k in
               ("ac_before", "mb_before", "ac_after_shift", "mb_after_shift")):
        raise AssertionError(f"fig12: bad latencies {shift}")
    log(f"phase 26d fig12 {FIG_APP} at Budget.quick ({card}): AC "
        f"{shift['ac_before']:.4f} ± {shift['ac_before_std']:.4f} -> "
        f"{shift['ac_after_shift']:.4f} ± {shift['ac_after_shift_std']:.4f} ms, "
        f"model-based {shift['mb_before']:.4f} -> {shift['mb_after_shift']:.4f} ms "
        f"after +{shift['shift_factor'] - 1:.0%}; {shift_launches} K-NN launches "
        f"(= {per_run} + {max(quick.online_epochs // 3, 40)} shifted epochs x "
        f"{1 + quick.updates_per_epoch}); {time.perf_counter() - t0:.3f} s "
        f"(shifted run {common.SECONDS['shifted']:.3f}, refit "
        f"{common.SECONDS['mb_refit']:.3f})")
    return dict(compare_all=out, fig12=shift, launches=launches,
                shift_launches=shift_launches)


# --------------------------------------------------------------------------
# phase 27: the single-run entry and the examples' twins (repro_torch.examples)
# --------------------------------------------------------------------------
def check_single_run_vs_cpu(dev) -> None:
    """Phase 27a: ``run_online_agent`` on cq_small, DDPG at T 5, card against
    CPU from one state (made on the CPU) and the same numpy draws."""
    from repro_torch.core import make_agent, run_online_agent
    from repro_torch.core.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload

    T, seed = SINGLE_CHECK["T"], SINGLE_CHECK["seed"]
    topo = apps.continuous_queries("small")
    histories, init = {}, None
    for where in ("cpu", dev):
        env = SchedulingEnv(topo, default_workload(topo), device=where)
        agent = make_agent("ddpg", env, k_nn=8)
        if init is None:
            init = ddpg_state_to_numpy(
                agent.init_fleet(torch.Generator().manual_seed(seed), 1, "cpu"))
        draws = [d.to(where) for d in numpy_draws(
            np.random.default_rng(seed), 1, T, env, agent.cfg.batch, updates=2)]
        _, histories[str(where)] = run_online_agent(
            0, env, agent, ddpg_state_from_numpy(init, where), T,
            updates_per_epoch=2, draws=draws)
    cpu, gpu = histories["cpu"], histories[str(dev)]
    if gpu.rewards.shape != (T,) or gpu.final_assignment.shape != (20, 10):
        raise AssertionError(f"run_online_agent: bad shapes {gpu.rewards.shape}, "
                             f"{gpu.final_assignment.shape}")
    np.testing.assert_array_equal(gpu.moved, cpu.moved)
    np.testing.assert_array_equal(gpu.final_assignment, cpu.final_assignment)
    np.testing.assert_allclose(gpu.latencies, cpu.latencies, rtol=1e-4)
    log(f"phase 27a run_online_agent cq_small DDPG T={T} U=2: card == CPU "
        f"(moved {int(cpu.moved.sum())} exact, final assignment exact, "
        f"latencies max rel diff {np.abs(gpu.latencies / cpu.latencies - 1).max():.3g}, "
        f"tol 1e-4)")


def _one_hot(X) -> bool:
    return bool(np.array_equal(np.asarray(X).sum(-1), np.ones(np.asarray(X).shape[:-1])))


def run_twins(dev, card: str) -> dict:
    """Phase 27b-e: the quickstart, expert-placement, scenario-fleet and
    serve-LM twins at their reference scripts' budgets on the card, each
    printing the reference's lines; every DDPG select and update through the
    K-NN kernel, counted at the single run's shapes (the straggler
    mitigation takes the host's exact k-best set: no launch), and no kernel
    launch in the LM example's decode-only serving."""
    from repro_torch.examples import expert_placement, quickstart, scenario_fleet, serve_lm
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.knn_topk import ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

    def single(N, M, epochs, U=1, offline=0, F=1, runs=1):
        """The launches a DDPG run makes at each shape: epochs selects of
        [F·N, M], offline + epochs·U updates of [F·32·N, M]."""
        return {(F * N, M): runs * epochs,
                (F * 32 * N, M): runs * epochs * U + offline}

    qb, eb, fb = quickstart, expert_placement, scenario_fleet
    q_want = single(20, 10, qb.EPOCHS, qb.UPDATES_PER_EPOCH, qb.OFFLINE_UPDATES)
    e_want = single(16, 16, eb.EPOCHS, eb.UPDATES_PER_EPOCH, eb.OFFLINE_UPDATES)
    f_want = single(20, 10, fb.EPOCHS, F=fb.FLEET, runs=2)
    twins = (("quickstart", quickstart.run, q_want),
             ("expert_placement", expert_placement.run, e_want),
             ("scenario_fleet", scenario_fleet.run, f_want))
    out, seconds = {}, {}
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_SHAPE.clear()
    for name, run, want in twins:
        before = dict(ops.LAUNCHES_BY_SHAPE)
        t0 = time.perf_counter()
        out[name] = run(device=dev)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        new = {k: v - before.get(k, 0) for k, v in ops.LAUNCHES_BY_SHAPE.items()
               if v != before.get(k, 0)}
        if new != want:
            raise AssertionError(f"{name}: K-NN launches by shape {new}, "
                                 f"expected {want}")
    launches = ops.LAUNCHES
    if launches != sum(ops.LAUNCHES_BY_SHAPE.values()):
        raise AssertionError(f"K-NN launch counts disagree: {launches} in all, "
                             f"{dict(ops.LAUNCHES_BY_SHAPE)} by shape")

    q = out["quickstart"]
    if not (q["history"].rewards.shape == (qb.EPOCHS,)
            and np.isfinite(q["history"].latencies).all()
            and _one_hot(q["history"].final_assignment)
            and np.isfinite([q["default"], q["learned"]]).all()):
        raise AssertionError(f"quickstart: bad result {q}")
    log(f"phase 27b quickstart cq_small ({card}): Storm default {q['default']:.4f} "
        f"ms, DRL-learned {q['learned']:.4f} ms, improvement {q['improvement']:.2%}; "
        f"{seconds['quickstart']:.3f} s wall ({qb.OFFLINE_SAMPLES} offline samples, "
        f"{qb.OFFLINE_UPDATES} updates, {qb.EPOCHS} epochs x "
        f"{qb.UPDATES_PER_EPOCH} updates); K-NN launches "
        f"{q_want}")
    e = out["expert_placement"]
    X = e["reassignment"].cpu().numpy()
    if not (e["stragglers"] == [eb.STRAGGLER] and _one_hot(X)
            and _one_hot(e["history"].final_assignment)
            and np.isfinite([e["round_robin"], e["learned"], e["before"],
                             e["after"]]).all()):
        raise AssertionError(f"expert_placement: bad result {e}")
    log(f"phase 27c expert placement 16 x 16 ({card}): round-robin "
        f"{e['round_robin']:.4f} ms/step, DRL {e['learned']:.4f} ms/step "
        f"({1 - e['learned'] / e['round_robin']:+.2%}); straggler "
        f"{e['stragglers']} at {eb.SLOWDOWN}x: re-assigned {e['moved']} experts, "
        f"{e['before']:.4f} -> {e['after']:.4f} ms (host k-best, no launch); "
        f"{seconds['expert_placement']:.3f} s wall; K-NN launches "
        f"{e_want}")
    f = out["scenario_fleet"]
    F, T = fb.FLEET, fb.EPOCHS
    for hist in (f["history"], f["shifted"]):
        if not (hist.latencies.shape == (F, T) and np.isfinite(hist.latencies).all()
                and _one_hot(hist.final_assignment)):
            raise AssertionError("scenario_fleet: bad traces")
    if not np.isfinite(f["finals"]).all():
        raise AssertionError(f"scenario_fleet: bad finals {f['finals']}")
    log(f"phase 27d scenario fleet cq_small F={F} x {T} epochs under "
        f"{fb.SCENARIO!r} ({card}): {f['seconds']['train']:.3f} s "
        f"({F * T / f['seconds']['train']:.1f} lane-epochs/s), mean latency "
        f"{f['history'].latencies.mean():.4f} ms, finals "
        f"{np.mean(f['finals']):.4f} ± {np.std(f['finals']):.4f} ms; +50% re-run "
        f"{f['seconds']['shifted']:.3f} s, mean latency "
        f"{f['shifted'].latencies.mean():.4f} ms; {seconds['scenario_fleet']:.3f} s "
        f"wall; K-NN launches {f_want}")

    before = (ops.LAUNCHES, fa_ops.LAUNCHES, wkv_ops.LAUNCHES)
    t0 = time.perf_counter()
    s = serve_lm.run(device=dev)
    torch.cuda.synchronize()
    seconds["serve_lm"] = time.perf_counter() - t0
    if (ops.LAUNCHES, fa_ops.LAUNCHES, wkv_ops.LAUNCHES) != before:
        raise AssertionError("serve_lm: a kernel launched in decode-only serving")
    if not (s["tokens"].shape == (4, 16) and sorted(r.rid for r in s["done"]) ==
            list(range(8)) and all(len(r.out) == 4 + r.rid % 3 for r in s["done"])):
        raise AssertionError("serve_lm: bad tokens or requests")
    log(f"phase 27e serve_lm llama3-8b smoke ({card}): {tuple(s['tokens'].shape)} "
        f"tokens in {s['seconds']:.3f} s, 8 requests through 3 slots served; "
        f"{seconds['serve_lm']:.3f} s wall; 0 flash, 0 WKV, 0 K-NN launches")

    # where a single run's wall goes: the quickstart's online epoch (one
    # lane, U updates) under the profiler
    from repro_torch.core import make_agent
    from repro_torch.dsdps import SchedulingEnv, apps
    from repro_torch.dsdps.apps import default_workload
    topo = apps.continuous_queries("small")
    env = SchedulingEnv(topo, default_workload(topo), device=dev)
    agent = make_agent("ddpg", env, k_nn=qb.K_NN)
    states = agent.init_fleet(torch.Generator(device=dev).manual_seed(0), 1, dev)
    epochs = 20
    p = profile_fleet(env, agent, states, None, epochs=epochs,
                      updates=qb.UPDATES_PER_EPOCH)
    log(f"phase 27f quickstart online epoch cq_small F=1 U={qb.UPDATES_PER_EPOCH} "
        f"({card}): {p['wall_ms']:.3f} ms unprofiled ({p['wall_prof_ms']:.3f} "
        f"profiled), {p['kernels']:.0f} kernels/epoch, device busy "
        f"{p['busy_ms']:.3f} ms/epoch = {p['busy_share']:.1%}; most: "
        + "; ".join(f"{n[:48]} {us / epochs / 1e3:.4f} ms" for n, us in p["top"][:3]))
    return dict(launches=launches, seconds=seconds, profile=p)


# --------------------------------------------------------------------------
# phase 28: LM training (repro_torch.train, launch/train.py, the train_lm twin)
# --------------------------------------------------------------------------
def check_train_vs_cpu(dev) -> int:
    """Phase 28a: one float32 ``make_train_step`` step (2 microbatches, TF32
    off) of each family's smoke config on the card against the CPU, from
    the same state, after two steps on the CPU (``warm_train_state``:
    from zero moments Adam's first update turns the rounding of near-zero
    gradients into whole steps of the learning rate: jamba's
    zero-initialized ``conv_b`` came off by 3.6e-3 of its scale),
    and the same batch: loss and gradient norm within 1e-4 relative, every
    updated parameter within 1e-4 of its leaf's scale."""
    from torch_lm_cases import on_device, warm_train_state

    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves

    from repro_torch.kernels.flash_attention import ops as fa_ops

    setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-4, warmup_steps=1,
                               total_steps=10)
    worst = [0.0, 0.0, 0.0]
    cuda_core_bwd = fa_ops.LAUNCHES_BWD - fa_ops.LAUNCHES_BWD_TC
    for arch in TRAIN_FAMILIES:
        cfg, state, batch = warm_train_state(arch, setup, 2, TRAIN["seed"])
        step = trainer.make_train_step(cfg, setup)
        res = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            new, m = step(on_device(state, d), on_device(batch, d))
            res[where] = new, {k: float(v) for k, v in m.items()}
        (cs, cm), (gs, gm) = res["cpu"], res["card"]
        errs = [abs(gm[k] - cm[k]) / abs(cm[k]) for k in ("loss", "grad_norm")]
        errs.append(max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(tree_leaves(gs.params), tree_leaves(cs.params))))
        if not (np.isfinite(errs).all() and max(errs) <= 1e-4):
            raise AssertionError(f"{arch}: a train step card vs CPU off by {errs} "
                                 "(loss, grad norm relative; parameters of leaf scale)")
        worst = [max(a, b) for a, b in zip(worst, errs)]
    cuda_core_bwd = fa_ops.LAUNCHES_BWD - fa_ops.LAUNCHES_BWD_TC - cuda_core_bwd
    if not cuda_core_bwd:
        raise AssertionError("phase 28a: no float32 flash backward launched on the card")
    log(f"phase 28a train step card == CPU, float32, 2 microbatches, from a state two "
        f"steps in, for {', '.join(TRAIN_FAMILIES)}: loss within {worst[0]:.3g}, grad "
        f"norm {worst[1]:.3g} relative, parameters {worst[2]:.3g} of their leaf's scale "
        f"(bound 1e-4 each); {cuda_core_bwd} flash backward launches on the CUDA cores")
    return cuda_core_bwd


def check_train_functions(dev) -> dict:
    """Phase 28b: the kernels' ``autograd.Function``s on the card.  Flash:
    each forward launches the forward kernel once and each backward the
    backward kernels once (``LAUNCHES_BWD``; the bf16 ones on the tensor
    cores, ``LAUNCHES_BWD_TC``), and neither calls the plain version
    (``flash_attention_ref``); the gradients are held to the backward's
    plain version (``flash_attention_bwd_ref`` from the saved log-sum-exp,
    float32 math) and to plain autograd of the plain forward in float32:
    in bf16 on the tensor cores within 1e-2·|x| + 2e-3 at llama3-8b's
    prefill shape (q [1,2048,32,128], 8 kv heads, causal), seamless's
    cross-attention (q [1,2048,16,64] against k/v [1,4096,16,64]) and a
    ragged S (q [2,1000,32,128], 8 kv heads, causal), and in float32 on
    the CUDA cores within 1e-5·(1 + max|x|) (q [2,1000,8,128], 2 kv heads,
    causal); WKV in float32 at [2,128,4,64] with a carried state, within
    1e-5·(1 + max|x|).  Every gradient nonzero."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"])
    out = {}
    plain_calls = []
    real_ref = fa_ops.flash_attention_ref

    def counted(*args, **kwargs):
        plain_calls.append(args[0].shape)
        return real_ref(*args, **kwargs)
    for what, (B, S, Skv, H, Hkv, hd, causal, dtype) in {
            "llama3-8b": (1, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
            "seamless_cross": (1, 2048, 4096, 16, 16, 64, False, torch.bfloat16),
            "ragged": (2, 1000, 1000, 32, 8, 128, True, torch.bfloat16),
            "float32": (2, 1000, 1000, 8, 2, 128, True, torch.float32)}.items():
        q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, Skv, Hkv, hd, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        go = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts = lambda: (fa_ops.LAUNCHES, fa_ops.LAUNCHES_BWD,  # noqa: E731
                          fa_ops.LAUNCHES_BWD_TC)
        before = counts()
        fa_ops.flash_attention_ref = counted
        try:
            o = fa_ops.flash_attention(*leaves, causal=causal)
            lse = o.grad_fn.saved_tensors[3]
            got = torch.autograd.grad(o, leaves, go)
            torch.cuda.synchronize()
        finally:
            fa_ops.flash_attention_ref = real_ref
        tc = dtype == torch.bfloat16
        want_counts = (before[0] + 1, before[1] + 1, before[2] + tc)
        if counts() != want_counts or plain_calls or o.grad_fn is None:
            raise AssertionError(f"{what}: the Function's launches {before} -> {counts()} "
                                 f"(forward, backward, backward on the tensor cores; "
                                 f"expected {want_counts}), plain calls {plain_calls}")
        plain = flash_attention_bwd_ref(q.float(), k.float(), v.float(), lse, go.float(),
                                        causal)
        exact_leaves = [t.float().requires_grad_() for t in (q, k, v)]
        exact = torch.autograd.grad(flash_attention_ref(*exact_leaves, causal=causal),
                                    exact_leaves, go.float())
        errs = {"plain": 0.0, "autograd": 0.0}
        for name, a, *wants in zip("qkv", got, plain, exact):
            if a.dtype != dtype or not float(a.abs().max()) > 0:
                raise AssertionError(f"{what}: d{name} {a.dtype}, zero or not finite")
            for against, w in zip(errs, wants):
                diff = (a.float() - w).abs()
                bad = (bool((diff > 1e-2 * w.abs() + 2e-3).any()) if tc else
                       float(diff.max()) > 1e-5 * (1 + float(w.abs().max())))
                if bad or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{what}: d{name} off the {against} by "
                                         f"{float(diff.max())}")
                errs[against] = max(errs[against], float(diff.max()))
        out[what] = errs
        del q, k, v, go, leaves, o, lse, got, plain, exact_leaves, exact
    B, T, H, hd = 2, 128, 4, 64
    w = torch.rand(B, T, H, hd, generator=gen, device=dev) * 0.5 + 0.45
    r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=dev) for _ in range(3))
    u = torch.randn(H, hd, generator=gen, device=dev)
    S0 = torch.randn(B, H, hd, hd, generator=gen, device=dev)
    go = torch.randn(B, T, H, hd, generator=gen, device=dev)
    gs = torch.randn(B, H, hd, hd, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (w, r, k, v, u, S0)]
    before = wkv_ops.LAUNCHES
    o, S_T = wkv_ops.wkv6(*leaves)
    got = torch.autograd.grad((o, S_T), leaves, (go, gs))
    torch.cuda.synchronize()
    if wkv_ops.LAUNCHES != before + 1 or o.grad_fn is None:
        raise AssertionError("wkv6: the Function did not launch the kernel once")
    plain = [t.clone().requires_grad_() for t in (w, r, k, v, u, S0)]
    want = torch.autograd.grad(wkv6_ref(*plain), plain, (go, gs))
    err = 0.0
    for name, a, b in zip(("w", "r", "k", "v", "u", "S0"), got, want):
        e = float((a - b).abs().max())
        if not (float(a.abs().max()) > 0 and e <= 1e-5 * (1 + float(b.abs().max()))):
            raise AssertionError(f"wkv6: d{name} off plain autograd by {e} or zero")
        err = max(err, e)
    out["wkv6"] = err
    flash = "; ".join(f"{what} {e['plain']:.3g} / {e['autograd']:.3g}" for what, e in out.items()
                      if what != "wkv6")
    log(f"phase 28b the Functions' gradients on the card: flash max |err| against the "
        f"backward's plain version / plain autograd: {flash} (llama3-8b [1,2048,32,128] kv 8 "
        "causal, seamless cross q 2048 x k/v 4096, ragged [2,1000,32,128] kv 8 causal, bf16 "
        "on the tensor cores, bound 1e-2|x| + 2e-3; float32 [2,1000,8,128] kv 2 causal on "
        f"the CUDA cores, bound 1e-5(1 + max|x|)); wkv6 float32 [2,128,4,64] with S0 "
        f"{out['wkv6']:.3g} (bound 1e-5(1 + max|x|)); one forward launch and one backward "
        "launch a call, no plain call, all nonzero")
    return out


def train_step_flops(cfg, tokens: int, seq: int) -> float:
    """The work of one rematerialized train step: the matmul weights' 2·N
    FLOP a token forward, 4·N backward and 2·N again for the recompute of
    each checkpointed block and cross-entropy chunk; causal attention's
    4·S·hd·H/2 a token, forward, recompute and twice backward."""
    d, h, hkv, hd, ff = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    layer = d * h * hd * 2 + d * hkv * hd * 2 + 3 * d * ff
    n_matmul = cfg.num_layers * layer + d * cfg.vocab_size
    attn = cfg.num_layers * 4 * (seq / 2) * hd * h
    return 8 * n_matmul * tokens + 4 * attn * tokens


def profile_train_step(step, state, batch) -> dict:
    """Phase 28c: one more step under ``torch.profiler``: the device's busy
    time, the kernels that take most of it, and the flash backward
    kernels' share by their own names (``flash_bwd_*``: the dQ and dK/dV
    kernels of each route)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        new, m = step(state, batch)
        float(m["loss"])
    wall_ms = (time.perf_counter() - t0) * 1e3
    del new
    events = prof.events()
    by_name: dict = {}
    for e in events:
        if str(e.device_type).endswith("CUDA"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values()) or float("nan")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    n_kernels = sum(1 for e in events if str(e.device_type).endswith("CUDA"))
    kern = {name: us for name, us in by_name.items() if "flash_bwd_" in name}
    kern_us = sum(kern.values())
    by_kind = {kind: sum(us for name, us in kern.items() if f"flash_bwd_{kind}" in name)
               for kind in ("dq_tc", "dkdv_tc", "dq_cc", "dkdv_cc")}
    log(f"  train step profile: wall {wall_ms:.3f} ms profiled, device busy "
        f"{busy_us / 1e3:.3f} ms = {busy_us / 1e3 / wall_ms:.1%}, {n_kernels} device "
        f"events; the flash backward kernels {kern_us / 1e3:.3f} ms = "
        f"{kern_us / busy_us:.1%} ("
        + ", ".join(f"{kind} {us / 1e3:.3f} ms" for kind, us in by_kind.items() if us)
        + "); most: "
        + "; ".join(f"{name[:56]} {us / 1e3:.3f} ms ({us / busy_us:.1%})"
                    for name, us in top))
    return dict(busy_ms=busy_us / 1e3, wall_ms=wall_ms, bwd_kernels_ms=kern_us / 1e3,
                bwd_kernels_share=kern_us / busy_us,
                bwd_by_kind_ms={kind: us / 1e3 for kind, us in by_kind.items()},
                kernels=n_kernels)


def time_flash_backward(dev, gen, what: str, B: int, S: int, H: int, Hkv: int, hd: int,
                        dtype=torch.bfloat16) -> dict:
    """The flash backward (``ops._backward``) alone at q [B, S, H, hd] and
    k/v [B, S, Hkv, hd], causal, from the forward kernel's log-sum-exp:
    one launch (on the tensor cores in bf16), held to its plain version
    (``flash_attention_bwd_ref``, float32 math; 1e-2·|x| + 2e-3 in bf16,
    1e-5·(1 + max|x|) in float32), and timed beside the plain version,
    SDPA's backward (the library call for the same gradient) and the
    bound: ``flops_bwd`` at the tensor cores' bf16 rate (the CUDA cores'
    float32 rate for float32) against ``bytes_moved_bwd`` at 3.35 TB/s."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops

    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype) for _ in range(2))
    do = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    _, lse = ops._forward(q, k, v, True, True)
    tc = dtype == torch.bfloat16
    before = (ops.LAUNCHES_BWD, ops.LAUNCHES_BWD_TC, ops.STAGED_COPIES)
    got = ops._backward(q, k, v, lse, do, True)
    torch.cuda.synchronize()
    if (ops.LAUNCHES_BWD, ops.LAUNCHES_BWD_TC, ops.STAGED_COPIES) != (
            before[0] + 1, before[1] + tc, before[2]):
        raise AssertionError(f"{what}: backward counts {before} -> {ops.LAUNCHES_BWD}, "
                             f"{ops.LAUNCHES_BWD_TC}, {ops.STAGED_COPIES}")
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), lse, do.float(), True)
    err = 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - w).abs()
        bad = (bool((diff > 1e-2 * w.abs() + 2e-3).any()) if tc else
               float(diff.max()) > 1e-5 * (1 + float(w.abs().max())))
        if bad:
            raise AssertionError(f"{what}: {name} off its plain version by {float(diff.max())}")
        err = max(err, float(diff.max()))
    del got, want
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True,
                                                               enable_gqa=True)
    do_t = do.transpose(1, 2)
    t = dict(ms=eager_ms(lambda: ops._backward(q, k, v, lse, do, True), iters=20 if tc else 3,
                         warmup=3 if tc else 1),
             plain_ms=eager_ms(lambda: flash_attention_bwd_ref(q, k, v, lse, do, True),
                               iters=3, warmup=1),
             library_ms=eager_ms(lambda: torch.autograd.grad(lib_out, leaves, do_t,
                                                             retain_graph=True),
                                 iters=20 if tc else 3, warmup=3 if tc else 1),
             max_abs_err=err)
    flops = ops.flops_bwd(B, S, S, H, hd, True)
    bytes_moved = ops.bytes_moved_bwd(B, S, S, H, Hkv, hd, dtype)
    t_ops = flops / (BF16_TC_OPS_PER_S if tc else F32_OPS_PER_S)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t["bound_ms"] = max(t_ops, t_bytes) * 1e3
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  {what}: flash backward q [{B},{S},{H},{hd}] x k/v [{B},{S},{Hkv},{hd}] "
        f"{str(dtype).removeprefix('torch.')} causal, {'tensor' if tc else 'CUDA'}-core "
        f"route, ms per call: kernels {t['ms']:.6f}  plain {t['plain_ms']:.6f}  library "
        f"(SDPA backward) {t['library_ms']:.6f}  bound {t['bound_ms']:.6f} ({t['bound_by']}: "
        f"{flops / 1e9:.1f} GFLOP, {bytes_moved / 1e6:.1f} MB); {flops / t['ms'] / 1e9:.1f} "
        f"TFLOP/s useful; |kernels - plain| max {err:.3g}")
    del q, k, v, do, lse, leaves, lib_out
    torch.cuda.empty_cache()
    return t


def run_train_full(dev, card: str) -> dict:
    """Phase 28c: llama3-8b at every width cut to 4 of its 32 layers, bf16,
    the pipeline's batches of 8 x 2048 in 4 microbatches, warmup-cosine:
    2 warm-up steps then 5 timed (ms a step, tokens/s, peak GiB, the flash
    launches of each step by shape: 4 layers x 4 microbatches x (forward +
    the rematerialized recompute) = 32, and the backward's by call, 16),
    the loss finite and falling; one more step profiled; the flash kernel
    at the microbatch's shape, its backward alone
    (``time_flash_backward``), and its Function's forward + backward beside
    SDPA's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.train import trainer

    T = TRAIN
    cfg = dataclasses.replace(get_config(T["arch"]), num_layers=T["layers"])
    steps = T["warmup"] + T["timed"]
    setup = trainer.TrainSetup(micro_batches=T["micro"], learning_rate=T["lr"],
                               warmup_steps=T["warmup"], total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_train_state(cfg, setup, torch.Generator(device=dev).manual_seed(
        T["seed"]), dev)
    n_params = sum(p.numel() for p in _leaves(state.params))
    step = trainer.make_train_step(cfg, setup)
    data = DataConfig(cfg.vocab_size, T["seq"], T["batch"], seed=T["seed"])
    tokens = T["batch"] * T["seq"]
    shape = f"{T['seq']}x{T['seq']} causal bfloat16"
    want = {shape: cfg.num_layers * T["micro"] * 2}
    B = T["batch"] // T["micro"]
    bwd_key = fa_ops.call_key(B, T["seq"], T["seq"], cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, True, torch.bfloat16)
    want_bwd = {bwd_key: cfg.num_layers * T["micro"]}
    losses, times, launches, bwd_launches = [], [], 0, 0
    for i in range(steps):
        batch = {k: v.to(dev) for k, v in batch_at(data, i).items()}
        fa_ops.LAUNCHES_BY_SHAPE.clear()
        fa_ops.LAUNCHES_BWD_BY_CALL.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        got, got_bwd = dict(fa_ops.LAUNCHES_BY_SHAPE), dict(fa_ops.LAUNCHES_BWD_BY_CALL)
        if got != want or got_bwd != want_bwd:
            raise AssertionError(f"train step {i}: flash launches {got}, expected {want}; "
                                 f"backward launches {got_bwd}, expected {want_bwd}")
        launches += got[shape]
        bwd_launches += got_bwd[bwd_key]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"llama3-8b training: losses {losses} not finite and falling "
                             f"(steps {times} s)")
    timed = times[T["warmup"]:]
    ms = 1e3 * float(np.mean(timed))
    flops = train_step_flops(cfg, tokens, T["seq"])
    bound_ms = flops / BF16_TC_OPS_PER_S * 1e3
    log(f"phase 28c llama3-8b training ({card}), {cfg.num_layers} of 32 layers at every "
        f"width ({n_params / 1e9:.3f} B parameters), bf16, batch {T['batch']} x "
        f"{T['seq']} in {T['micro']} microbatches: {ms:.3f} ms a step (timed steps "
        + ", ".join(f"{1e3 * t:.3f}" for t in timed)
        + f"; warm-up {', '.join(f'{1e3 * t:.3f}' for t in times[:T['warmup']])}), "
        f"{tokens / (ms / 1e3):.1f} tokens/s, peak {peak:.2f} GiB; bound "
        f"{bound_ms:.3f} ms ({flops / 1e12:.1f} TFLOP at {BF16_TC_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s, {bound_ms / ms:.1%} of the step); losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; flash launches a step by shape {want} ({launches} in the run), backward "
        f"launches a step {want_bwd} ({bwd_launches} in the run)")
    prof = profile_train_step(step, state,
                              {k: v.to(dev) for k, v in batch_at(data, steps).items()})
    del state, step
    torch.cuda.empty_cache()

    # the flash kernel at the microbatch's shape, its backward alone, and
    # its Function's forward + backward beside SDPA's
    gen = torch.Generator(device=dev).manual_seed(T["seed"])
    t = time_flash_shape(dev, gen, f"train microbatch (phase 28c, B {B})", cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim, S=T["seq"], B=B)
    bwd = time_flash_backward(dev, gen, f"train microbatch (phase 28c, B {B})", B, T["seq"],
                              cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    # the CUDA-core route (float32), at llama3-8b's head layout cut to 8
    # query heads
    bwd32 = time_flash_backward(dev, gen, "float32 (phase 28c)", 1, T["seq"], 8, 2,
                                cfg.head_dim, torch.float32)
    q = torch.randn(B, T["seq"], cfg.num_heads, cfg.head_dim, generator=gen,
                    device=dev).bfloat16().requires_grad_()
    k, v = (torch.randn(B, T["seq"], cfg.num_kv_heads, cfg.head_dim, generator=gen,
                        device=dev).bfloat16().requires_grad_() for _ in range(2))
    go = torch.randn_like(q)

    def fn_fwd_bwd():
        torch.autograd.grad(fa_ops.flash_attention(q, k, v, causal=True), (q, k, v), go)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(q, k, v, True).transpose(1, 2), (q, k, v), go)
    fwd_bwd_ms = eager_ms(fn_fwd_bwd, iters=10, warmup=2)
    sdpa_ms = eager_ms(sdpa_fwd_bwd, iters=10, warmup=2)
    log(f"  flash at the microbatch's shape: kernel forward {t['ms']:.6f} ms, backward "
        f"kernels {bwd['ms']:.6f} ms; the Function's forward + backward {fwd_bwd_ms:.6f} ms; "
        f"SDPA forward + backward {sdpa_ms:.6f} ms")
    return dict(ms=ms, tokens_per_s=tokens / (ms / 1e3), peak_gib=peak, losses=losses,
                launches=launches, bwd_launches=bwd_launches, bound_ms=bound_ms, flops=flops,
                timing=t, bwd_timing=bwd, bwd32_timing=bwd32, fwd_bwd_ms=fwd_bwd_ms,
                sdpa_fwd_bwd_ms=sdpa_ms,
                profile=prof, n_params=n_params)


def run_train_lm_twin(dev, card: str) -> dict:
    """Phase 28d: the train_lm twin at its reference script's shapes
    (demo-100m, batch 8 x 256 in 2 microbatches) for TWIN_STEPS steps (its
    reference budget is 300), killed and resumed half way (the twin
    restores that checkpoint into a fresh state and holds every leaf to
    the saved one bit for bit): the first and last loss, the wall s, and
    the flash launches (12 layers x 2 microbatches x (forward + recompute)
    x TWIN_STEPS); the flash kernel timed at its microbatch's shape."""
    from repro_torch.examples import train_lm
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg = train_lm.hundred_m_config(False)
    shape = f"{train_lm.SEQ}x{train_lm.SEQ} causal bfloat16"
    want = {shape: cfg.num_layers * train_lm.MICRO * 2 * TWIN_STEPS}
    fa_ops.LAUNCHES_BY_SHAPE.clear()
    t0 = time.perf_counter()
    out = train_lm.run(steps=TWIN_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(fa_ops.LAUNCHES_BY_SHAPE)
    if got != want:
        raise AssertionError(f"train_lm: flash launches {got}, expected {want}")
    first, second = out["first"], out["second"]
    losses = first["losses"] + second["losses"]
    if not (len(losses) == TWIN_STEPS and second["start_step"] == TWIN_STEPS // 2
            and np.isfinite(losses).all() and losses[-1] < losses[0]
            and out["restored_leaves"] > 0):
        raise AssertionError(f"train_lm: bad run ({len(losses)} losses, resumed at "
                             f"{second['start_step']}, {losses[0]} -> {losses[-1]})")
    gen = torch.Generator(device=dev).manual_seed(TRAIN["seed"] + 1)
    t = time_flash_shape(dev, gen, "train_lm microbatch (phase 28d)", cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim, S=train_lm.SEQ,
                         B=train_lm.BATCH // train_lm.MICRO)
    # where a step of the twin goes: one more step under the profiler
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train import trainer
    setup = trainer.TrainSetup(micro_batches=train_lm.MICRO, learning_rate=train_lm.LR,
                               warmup_steps=train_lm.WARMUP, total_steps=TWIN_STEPS)
    batch = {k: v.to(dev) for k, v in batch_at(
        DataConfig(cfg.vocab_size, train_lm.SEQ, train_lm.BATCH), 0).items()}
    prof = profile_train_step(trainer.make_train_step(cfg, setup),
                              trainer.init_train_state(cfg, setup, gen, dev), batch)
    log(f"phase 28d train_lm twin demo-100m ({card}): {TWIN_STEPS} steps at "
        f"{train_lm.BATCH} x {train_lm.SEQ} in {train_lm.MICRO} microbatches, killed and "
        f"resumed at {second['start_step']} ({out['restored_leaves']} leaves restored bit "
        f"for bit); loss {losses[0]:.4f} -> {losses[-1]:.4f}; {wall:.3f} s wall (first "
        f"run {first['total_s']:.3f} s, second {second['total_s']:.3f} s of steps); "
        f"flash launches {got}")
    return dict(launches=got[shape], wall_s=wall, timing=t, first=losses[0],
                last=losses[-1], profile=prof)

# --------------------------------------------------------------------------
# phase 29: the fleet across slots and processes (launch/mesh, sharding/fleet,
# run_online_fleet(mesh=), the multi-host checkpoint, launch/multihost)
# --------------------------------------------------------------------------
def run_meshed_fleet(dev, card: str, floor: float) -> dict:
    """Phase 29a: cq_large F=8 DDPG under one_slow_machine at phase 6's
    offline budget and T=50, from one pretrained state and on the same
    explicit draws, on a 2-slot mesh on the card and unmeshed: moves and
    final assignments equal, rewards and latencies within 1e-5; each run's
    lane-epochs/s; the K-NN launches counted by shape, and the kernel held
    to its plain version at the block shapes."""
    from repro_torch.core import make_agent, run_online_fleet
    from repro_torch.core import ddpg as ddpg_lib
    from repro_torch.dsdps import scenarios
    from repro_torch.fleet import take_lanes
    from repro_torch.kernels.knn_topk import ops, row_top2_regret, row_top2_regret_ref
    from repro_torch.launch import drl_control
    from repro_torch.launch.mesh import SLOTS_ENV, make_fleet_mesh

    F, T = MESH["fleet"], MESH["epochs"]
    env = drl_control.build_env(MAIN["app"], dev)
    agent = make_agent("ddpg", env, k_nn=MAIN["k"])
    params = scenarios.build_for(env, MESH["scenario"], F)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    states = ddpg_lib.offline_pretrain(
        agent.init_fleet(seeded(29), F, dev, env_params=params), agent.cfg, env,
        n_samples=MAIN["offline"], n_updates=MAIN["offline_updates"],
        env_params=params, gen=seeded(30))
    size0 = int(states.replay.size[0])
    draws = [d.to(dev) for d in numpy_draws(np.random.default_rng(29), F, T, env,
                                            agent.cfg.batch, size0=size0,
                                            cap=agent.cfg.buffer)]
    os.environ[SLOTS_ENV] = str(MESH["slots"])
    try:
        mesh = make_fleet_mesh(device=dev)
    finally:
        del os.environ[SLOTS_ENV]
    runs = {}
    for what, m in (("mesh", mesh), ("none", None)):
        ops.LAUNCHES_BY_SHAPE.clear()
        ops.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = run_online_fleet(0, env, agent, take_lanes(states, np.arange(F)), T,
                                   env_params=params, draws=draws, mesh=m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[what] = dict(hist=hist, wall=wall, by_shape=dict(ops.LAUNCHES_BY_SHAPE),
                          launches=ops.LAUNCHES)
        if sum(runs[what]["by_shape"].values()) != ops.LAUNCHES:
            raise AssertionError(f"phase 29a {what}: launches by shape "
                                 f"{runs[what]['by_shape']} != {ops.LAUNCHES}")
    a, b = runs["mesh"]["hist"], runs["none"]["hist"]
    if not (np.array_equal(a.moved, b.moved)
            and np.array_equal(a.final_assignment, b.final_assignment)):
        raise AssertionError("phase 29a: the 2-slot mesh's moves or assignments "
                             "differ from the unmeshed run's")
    np.testing.assert_allclose(a.rewards, b.rewards, rtol=1e-5)
    np.testing.assert_allclose(a.latencies, b.latencies, rtol=1e-5)
    gap = float(np.abs(a.latencies / b.latencies - 1).max())
    rows = F // MESH["slots"] * env.N
    select, update = (rows, env.M), (rows * agent.cfg.batch, env.M)
    want = {select: MESH["slots"] * T, update: MESH["slots"] * T}
    if runs["mesh"]["by_shape"] != want:
        raise AssertionError(f"phase 29a: mesh launches {runs['mesh']['by_shape']}, "
                             f"expected {want}")
    gen = torch.Generator(device=dev).manual_seed(31)
    err = 0.0
    for shape in (select, update):
        proto = torch.rand(shape, generator=gen, device=dev)
        proto[::7] = torch.round(proto[::7] * 3) / 3                  # ties
        got, ref = row_top2_regret(proto), row_top2_regret_ref(proto)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"phase 29a: kernel indices differ at {shape}")
        err = max(err, regret_err(got[2], ref[2]))
    if err != 0.0:
        raise AssertionError(f"phase 29a: kernel regret off by {err} at the block shapes")
    timing = knn_timing(torch.rand(update, generator=gen, device=dev), floor)
    rate = {k: F * T / r["wall"] for k, r in runs.items()}
    log(f"phase 29a {MAIN['app']} ddpg F={F} T={T} under {MESH['scenario']} ({card}): "
        f"{MESH['slots']}-slot mesh on {dev} == unmeshed on the same draws (moves and "
        f"final assignments exact, latencies max rel diff {gap:.3g}); lane-epochs/s "
        f"mesh {rate['mesh']:.1f} ({runs['mesh']['wall']:.3f} s), unmeshed "
        f"{rate['none']:.1f} ({runs['none']['wall']:.3f} s); K-NN launches by shape "
        f"mesh {runs['mesh']['by_shape']}, unmeshed {runs['none']['by_shape']}; the "
        f"kernel at {list(want)} max |regret err| {err}; [{update[0]},{update[1]}] "
        f"{timing['ms']:.6f} ms (plain {timing['plain_ms']:.6f}, library "
        f"{timing['library_ms']:.6f}, bound {timing['bound_ms']:.6f})")
    return dict(launches=runs["mesh"]["launches"], max_abs_err=err, timing=timing,
                rate=rate, by_shape=runs["mesh"]["by_shape"])


def _proc_bytes(step_dir) -> dict:
    import pathlib
    return {p.name: sum(f.stat().st_size for f in p.iterdir())
            for p in sorted(pathlib.Path(step_dir).glob("proc_*"))}


def run_multihost_drill(dev, card: str) -> dict:
    """Phase 29b: the kill-and-resume drill through ``python -m
    repro_torch.launch.multihost`` (2 workers x 1 slot, both on cuda:0 over
    gloo; worker 1 SIGKILLed once epoch 20 is published), an uninterrupted
    2-process job, and an uninterrupted 1-process run of the same seed: the
    healed job and the 2-process one end equal to the 1-process run (moves
    and final assignments exact, floats within 1e-5).  Logs each attempt's
    wall s, the resume epoch, the ms of each multi-host save (the barrier
    included) and the bytes of each proc_* directory."""
    import json as _json
    import pathlib
    import shutil
    import tempfile

    D = DRILL
    device = torch.device(dev).type
    worker = ["--app", MAIN["app"], "--fleet", str(D["fleet"]), "--epochs",
              str(D["epochs"]), "--checkpoint-every", str(D["every"]), "--k",
              str(MAIN["k"]), "--offline", str(D["offline"]), "--offline-updates",
              str(D["offline_updates"])]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    root = tempfile.mkdtemp(prefix="chip_smoke_mh_")

    def supervised(name: str, *extra: str) -> tuple[str, float]:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.multihost", "--procs", "2",
             "--devices-per-proc", "1", "--device", device, "--checkpoint-dir",
             os.path.join(root, name), "--timeout", "300", *extra, "--", *worker,
             "--save-history", os.path.join(root, f"{name}.npz")],
            env=env, capture_output=True, text=True, timeout=400)
        if out.returncode != 0:
            raise AssertionError(f"phase 29b {name}: the supervisor exited "
                                 f"{out.returncode}:\n{out.stdout[-6000:]}\n{out.stderr[-3000:]}")
        return out.stdout, time.perf_counter() - t0

    try:
        healed_out, healed_wall = supervised("healed", "--kill-proc", "1", "--kill-at-epoch",
                                         str(D["kill_at"]))
        if ("killing worker 1 (drill)" not in healed_out
                or "job complete on 1 process(es)" not in healed_out):
            raise AssertionError(f"phase 29b: no kill or no healed finish:\n{healed_out}")
        metas = {}
        for step in sorted(pathlib.Path(root, "healed").glob("step_*")):
            if (step / "meta.json").exists():
                metas[step.name] = dict(_json.loads((step / "meta.json").read_text()),
                                        bytes=_proc_bytes(step))
        if not any(m["process_count"] == 2 for m in metas.values()):
            raise AssertionError(f"phase 29b: no 2-process step published: {metas}")
        whole_out, whole_wall = supervised("two")
        t0 = time.perf_counter()
        one = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.drl_control", "--sharded",
             "--device", device, *worker, "--checkpoint-dir", os.path.join(root, "one"),
             "--save-history", os.path.join(root, "one.npz")],
            env=dict(env, REPRO_FLEET_SLOTS="1"), capture_output=True, text=True,
            timeout=400)
        one_wall = time.perf_counter() - t0
        if one.returncode != 0:
            raise AssertionError(f"phase 29b: the 1-process run exited {one.returncode}:"
                                 f"\n{one.stdout[-3000:]}\n{one.stderr[-3000:]}")
        ref = np.load(os.path.join(root, "one.npz"))
        starts = {}
        for name in ("healed", "two"):
            got = np.load(os.path.join(root, f"{name}.npz"))
            start = starts[name] = int(got["start_epoch"])
            if not (np.array_equal(got["moved"], ref["moved"][:, start:])
                    and np.array_equal(got["final_assignment"], ref["final_assignment"])):
                raise AssertionError(f"phase 29b {name}: moves or final assignments "
                                     f"differ from the 1-process run's")
            for f in ("rewards", "latencies"):
                np.testing.assert_allclose(got[f], ref[f][:, start:], rtol=1e-5)
            np.testing.assert_allclose(got["finals"], ref["finals"], rtol=1e-5)
        two_metas = {}
        for step in sorted(pathlib.Path(root, "two").glob("step_*")):
            if (step / "meta.json").exists():
                two_metas[step.name] = dict(_json.loads((step / "meta.json").read_text()),
                                            bytes=_proc_bytes(step))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    walls = re.findall(r"attempt (\d+) wall ([0-9.]+) s", healed_out)
    kill = re.search(r"checkpoint at epoch (\d+) published; killing", healed_out)
    saves = re.search(r"checkpoint saves: (\d+), ms each ([0-9., ]+)", whole_out)
    rates = re.findall(r"([0-9.]+) lane-epochs/s", whole_out + healed_out + one.stdout)
    save_ms = [1e3 * m["save_s"] for m in {**metas, **two_metas}.values()
               if m["process_count"] == 2]
    log(f"phase 29b drill ({card}): {MAIN['app']} F={D['fleet']} T={D['epochs']} "
        f"saving every {D['every']}, 2 workers x 1 slot on cuda:0 over gloo; worker 1 "
        f"killed once epoch {kill.group(1) if kill else '?'} was published, the job "
        f"healed on 1 process from epoch {starts['healed']} (epochs redone: those the "
        f"killed job ran past {starts['healed']}, at most {D['every']}; the killed "
        f"logs end mid-run); attempt walls s {walls}, the healed job "
        f"{healed_wall:.3f} s, the uninterrupted 2-process job {whole_wall:.3f} s, "
        f"the 1-process run {one_wall:.3f} s; healed and 2-process == 1-process "
        f"(moves, final assignments exact; floats within 1e-5)")
    log(f"  multi-host saves ms (process 0, barrier included, from meta.json): "
        + ", ".join(f"{x:.3f}" for x in save_ms)
        + (f"; the 2-process job's rank 0: {saves.group(2).strip()} ms over "
           f"{saves.group(1)} saves" if saves else ""))
    log(f"  bytes per proc_* directory: "
        + "; ".join(f"{k} {v['bytes']}" for k, v in {**metas, **two_metas}.items()
                    if v["process_count"] == 2))
    log(f"  lane-epochs/s printed by the workers (2-process job, healed attempt, "
        f"1-process run): {rates}")
    return dict(save_ms=save_ms, walls=walls, start=starts["healed"])


def run_elastic_twin(dev, card: str) -> dict:
    """Phase 29c: the elastic_restart twin at its reference budget (the
    smoke llama3-8b, 10 steps saved every 5, 16 of 512 workers lost, the
    multi-pod re-plan, 5 steps after the restore): its lines, and the flash
    launches of its steps counted by shape (each layer's forward and its
    rematerialized recompute, 2 microbatches, 15 steps)."""
    from repro_torch.examples import elastic_restart
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.knn_topk import ops

    fa_ops.LAUNCHES_BY_SHAPE.clear()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    out = elastic_restart.run(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(fa_ops.LAUNCHES_BY_SHAPE)
    steps = elastic_restart.STEPS + elastic_restart.RESUMED_STEPS
    from repro_torch.configs import get_config
    layers = get_config("llama3-8b", smoke=True).num_layers
    if (len(out["dead"]) != 16 or out["resumed"] != elastic_restart.STEPS
            or out["steps"] != [5, 10] or len(out["losses"]) != steps
            or not np.isfinite(out["losses"]).all()
            or sum(got.values()) != layers * 2 * 2 * steps or ops.LAUNCHES != 0):
        raise AssertionError(f"phase 29c: {out}, flash {got}, K-NN {ops.LAUNCHES}")
    log(f"phase 29c elastic_restart twin ({card}): {len(out['dead'])} dead of 512, "
        f"re-plan {out['plan'].shape} over {out['plan'].axes}, restored step "
        f"{out['resumed']}; loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; "
        f"{wall:.3f} s; flash launches by shape {got}; K-NN 0")
    return dict(flash=got, wall=wall)


def leaf_digest(x: torch.Tensor) -> tuple[int, int]:
    """Two int64 sums over a tensor's bits (its 16- or 32-bit words as
    integers, and their squares, both wrapping): equal for equal bits."""
    w = x.detach().reshape(-1)
    w = w.view(torch.int16 if w.element_size() == 2 else torch.int32).to(torch.int64)
    return int(w.sum()), int((w * w).sum())


def check_meshed_compressed_vs_cpu(dev, mesh) -> dict:
    """Phase 30a: one float32 step with int8 error feedback (2
    microbatches) of llama3-8b's smoke config on the mesh on the card
    against the unmeshed step on the CPU, from the same state two steps in
    and the same batch: loss and gradient norm within 1e-4 relative; every
    residual element within 1e-2 of its leaf's quantum (``max|g + r| /
    127``) or a whole quantum from the CPU's (an int8 rounding flipped by a
    float32 difference), at most 1 in 10^3 of them; every other parameter
    and moment element within 1e-4 of its leaf's scale."""
    from torch_lm_cases import on_device, warm_train_state

    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import tree_leaves

    setup = trainer.TrainSetup(micro_batches=2, learning_rate=1e-4, warmup_steps=1,
                               total_steps=10, compress_grads=True)
    cfg, state, batch = warm_train_state("llama3-8b", setup, 2, TRAIN["seed"])
    cpu_state, cm = trainer.make_train_step(cfg, setup)(state, batch)
    sharded = trainer.shard_train_state(on_device(state, dev), ShardingPolicy(mesh, cfg))
    card_state, gm = trainer.make_train_step(cfg, setup, mesh)(sharded, on_device(batch, dev))
    card = trainer.unshard_train_state(card_state)
    errs = [abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k]))
            for k in ("loss", "grad_norm")]
    flips = total = 0
    worst = noise = 0.0
    for j, (r_g, r_c) in enumerate(zip(tree_leaves(card.ef_residual),
                                       tree_leaves(cpu_state.ef_residual))):
        quantum = 2 * float(r_c.float().abs().max())
        dev_q = (r_g.cpu().float() - r_c.float()).abs() / max(quantum, 1e-30)
        flip = dev_q > 0.5
        if flip.any() and float((dev_q[flip] - 1).abs().max()) > 0.05:
            raise AssertionError(f"phase 30a: residual leaf {j} off by a part of a quantum")
        noise = max(noise, float(dev_q[~flip].max()) if (~flip).any() else 0.0)
        flips += int(flip.sum())
        total += flip.numel()
        for a, b in ((card.params, cpu_state.params), (card.opt.mu, cpu_state.opt.mu),
                     (card.opt.nu, cpu_state.opt.nu)):
            x, y = tree_leaves(a)[j].cpu(), tree_leaves(b)[j]
            d = (x - y).abs()[~flip]
            if d.numel():
                worst = max(worst, float(d.max()) / max(float(y.abs().max()), 1e-30))
    if not (max(errs) <= 1e-4 and worst <= 1e-4 and noise <= 1e-2 and flips <= total / 1000):
        raise AssertionError(f"phase 30a: meshed compressed step card vs CPU: loss, grad "
                             f"norm {errs}, leaves {worst}, residual noise {noise} of a "
                             f"quantum, {flips} int8 flips of {total}")
    log(f"phase 30a float32 llama3-8b smoke step with int8 EF on the mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (card) == unmeshed (CPU): loss "
        f"within {errs[0]:.3g}, grad norm {errs[1]:.3g} relative, parameters and moments "
        f"{worst:.3g} of their leaf's scale (bound 1e-4), residuals {noise:.3g} of a "
        f"quantum, {flips} int8 flips of {total} elements")
    return dict(flips=flips, worst=worst)


def run_meshed_train(dev, card: str, mesh) -> dict:
    """Phase 30b: phase 28c's llama3-8b (4 of 32 layers at every width,
    bf16, 8 x 2048 in 4 microbatches), ``MESH_TRAIN["steps"]`` steps
    (``train_on_mesh_of_one``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train import trainer

    T = TRAIN
    cfg = dataclasses.replace(get_config(T["arch"]), num_layers=T["layers"])
    setup = trainer.TrainSetup(micro_batches=T["micro"], learning_rate=T["lr"],
                               warmup_steps=T["warmup"], total_steps=T["warmup"] + T["timed"])
    return train_on_mesh_of_one(dev, card, mesh, "30b", cfg, setup, T["batch"], T["seq"],
                                MESH_TRAIN["steps"])


def train_on_mesh_of_one(dev, card: str, mesh, phase: str, cfg, setup, rows: int, seq: int,
                         steps: int) -> dict:
    """One case of phases 30b and 34a: ``cfg`` (bf16) from the seed
    ``TRAIN["seed"]``, ``steps`` steps of ``rows`` x ``seq`` token batches
    unmeshed then as many with the state sharded by the policy on the mesh,
    each run alone on the card (the first freed before the second is
    drawn), under ``fixed_order_sums()``: loss, gradient norm and every leaf
    of the parameters and both moments after each step equal bit for bit
    (leaves by ``leaf_digest``); each step's ms, each run's peak GiB, the
    flash launches of each step by shape (a forward and a recompute a layer
    and microbatch) and its backward launches (one a layer and
    microbatch)."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    data = DataConfig(cfg.vocab_size, seq, rows, seed=TRAIN["seed"])
    shape = f"{seq}x{seq} causal bfloat16"
    attn = sum(mixer == "attn" for mixer, _ in cfg.block_program()) * cfg.num_blocks
    want = {shape: attn * setup.micro_batches * 2}
    want_bwd = attn * setup.micro_batches
    runs = {}
    for meshed in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init_train_state(cfg, setup, torch.Generator(device=dev).manual_seed(
            TRAIN["seed"]), dev)
        if meshed:
            state = trainer.shard_train_state(state, ShardingPolicy(mesh, cfg))
        step = trainer.make_train_step(cfg, setup, mesh if meshed else None)
        out = []
        with fixed_order_sums():
            for i in range(steps):
                batch = {k: v.to(dev) for k, v in batch_at(data, i).items()}
                fa_ops.LAUNCHES_BY_SHAPE.clear()
                bwd_before = fa_ops.LAUNCHES_BWD
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                dt = time.perf_counter() - t0
                got = dict(fa_ops.LAUNCHES_BY_SHAPE)
                got_bwd = fa_ops.LAUNCHES_BWD - bwd_before
                if got != want or got_bwd != want_bwd:
                    raise AssertionError(f"phase {phase} step {i} (meshed {meshed}): flash "
                                         f"launches {got}, expected {want}; backward "
                                         f"launches {got_bwd}, expected {want_bwd}")
                local = (lambda x: x.to_local()) if meshed else (lambda x: x)  # noqa: E731
                digests = [leaf_digest(local(x)) for tree in (
                    state.params, state.opt.mu, state.opt.nu) for x in _leaves(tree)]
                out.append(dict(loss=loss, gnorm=gnorm, ms=1e3 * dt, digests=digests,
                                launches=got[shape], bwd_launches=got_bwd))
        runs[meshed] = dict(steps=out, peak=torch.cuda.max_memory_allocated() / 2**30)
        del state, step
    plain, sharded = runs[False], runs[True]
    for i, (a, b) in enumerate(zip(plain["steps"], sharded["steps"])):
        if not np.isfinite(a["loss"]):
            raise AssertionError(f"phase {phase}: step {i} loss {a['loss']}")
        if (a["loss"], a["gnorm"]) != (b["loss"], b["gnorm"]):
            raise AssertionError(f"phase {phase} step {i}: meshed loss, grad norm "
                                 f"{b['loss']}, {b['gnorm']} against {a['loss']}, "
                                 f"{a['gnorm']}")
        off = sum(x != y for x, y in zip(a["digests"], b["digests"]))
        if off:
            raise AssertionError(f"phase {phase} step {i}: {off} of {len(a['digests'])} "
                                 "leaves differ from the unmeshed step's bits")
    launches = sum(x["launches"] for x in sharded["steps"])
    bwd_launches = sum(x["bwd_launches"] for x in sharded["steps"])
    log(f"phase {phase} {cfg.name} training on the mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({dist.get_backend()}, world "
        f"{dist.get_world_size()}; {card}), {cfg.num_layers} of "
        f"{get_config_layers(cfg.name)} layers at every width, bf16, batch {rows} x {seq} in "
        f"{setup.micro_batches} microbatches, {steps} steps from seed {TRAIN['seed']}: "
        f"loss, grad norm and all {len(plain['steps'][0]['digests'])} leaves of params, "
        "mu and nu equal to the unmeshed steps bit for bit; ms a step unmeshed "
        + ", ".join(f"{x['ms']:.3f}" for x in plain["steps"])
        + ", meshed " + ", ".join(f"{x['ms']:.3f}" for x in sharded["steps"])
        + f"; peak {plain['peak']:.2f} GiB unmeshed, {sharded['peak']:.2f} GiB meshed; losses "
        + ", ".join(f"{x['loss']:.4f}" for x in sharded["steps"])
        + f"; flash launches a step by shape {want} ({launches} in the meshed run), "
        f"backward launches a step {want_bwd} ({bwd_launches} in the meshed run)")
    return dict(launches=launches, bwd_launches=bwd_launches, runs=runs)


def check_dryrun_vs_card(dev, card: str) -> dict:
    """Phase 31a: phase 28c's llama3-8b step (4 of 32 layers at every width,
    bf16, 8 x 2048 in 4 microbatches: the grid's ``train_4k`` cut) first
    traced by the dry-run on a fake world of one (``dryrun.trace`` on
    ``meta`` tensors), then run on the card on ``make_production_mesh()``
    (NCCL, a world of one) from a fresh state, after
    ``reset_peak_memory_stats``, under the dry-run's counter
    (``dryrun.StepCounter``: FLOPs of the local ops).  The argument
    bytes must be equal, the flash calls by shape equal to the card's
    launches by shape, the FLOPs (aten ops + kernel calls × ``ops.flops``
    on each side) within 1%, and the predicted peak within 10% of
    ``max_memory_allocated`` less what earlier phases left allocated
    before the state was drawn."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    T = TRAIN
    cfg = dataclasses.replace(get_config(T["arch"]), num_layers=T["layers"])
    setup = trainer.TrainSetup(micro_batches=T["micro"], learning_rate=T["lr"],
                               warmup_steps=T["warmup"], total_steps=T["warmup"] + T["timed"])
    shape = ShapeSpec("train_4k", T["seq"], T["batch"], "train")
    with dryrun.fake_world(1):
        pred = dryrun.trace(cfg, shape, make_production_mesh(device="cpu"), setup)

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    mesh = make_production_mesh()
    try:
        state = trainer.init_train_state(cfg, setup, torch.Generator(device=dev).manual_seed(
            T["seed"]), dev)
        state = trainer.shard_train_state(state, ShardingPolicy(mesh, cfg))
        data = DataConfig(cfg.vocab_size, T["seq"], T["batch"], seed=T["seed"])
        batch = {k: v.to(dev) for k, v in batch_at(data, 0).items()}
        args_bytes = dryrun.local_bytes(state) + dryrun.local_bytes(batch)
        step = trainer.make_train_step(cfg, setup, mesh)
        fa_ops.LAUNCHES_BY_SHAPE.clear()
        fa_ops.LAUNCHES_BWD_BY_CALL.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fc = dryrun.StepCounter()
        with fc:
            new, m = step(state, batch)
            loss = float(m["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        launches = dict(fa_ops.LAUNCHES_BY_SHAPE)
        bwd_launches = dict(fa_ops.LAUNCHES_BWD_BY_CALL)
        del new, m, state, step, batch
    finally:
        dist.destroy_process_group()
    B = T["batch"] // T["micro"]
    flash = fa_ops.flops(B, T["seq"], T["seq"], cfg.num_heads, cfg.head_dim, True)
    flash_bwd = fa_ops.flops_bwd(B, T["seq"], T["seq"], cfg.num_heads, cfg.head_dim, True)
    card_flops = (fc.flops + sum(launches.values()) * flash
                  + sum(bwd_launches.values()) * flash_bwd)
    calls = pred["kernels"].get("flash_attention", {}).get("by_shape", {})
    bwd_calls = pred["kernels"].get("flash_attention_bwd", {}).get("by_call", {})
    mem = pred["memory"]
    flop_off = abs(pred["flops_per_device"] - card_flops) / card_flops
    peak_off = abs(mem["peak_bytes_est"] - peak) / peak
    log(f"phase 31a the dry-run of phase 28c's step (llama3-8b, the grid's train_4k cut: "
        f"S 4096 -> {T['seq']}, batch 256 -> {T['batch']}, layers 32 -> {T['layers']}; "
        f"{T['micro']} microbatches, bf16) on a fake world of one, traced in "
        f"{pred['trace_s']:.1f} s, against the step on the card ({card}; NCCL world of "
        f"one, {ms:.3f} ms, loss {loss:.4f}): argument bytes {mem['argument_bytes']} "
        f"predicted, {args_bytes} held; flash calls {calls} predicted, launches "
        f"{launches}; backward calls {bwd_calls} predicted, launches {bwd_launches}; FLOPs {pred['flops_per_device']:.6e} predicted "
        f"({pred['flops_aten']:.6e} aten + {pred['flops_per_device'] - pred['flops_aten']:.6e} "
        f"kernel), {card_flops:.6e} measured ({fc.flops:.6e} aten + "
        f"{card_flops - fc.flops:.6e} kernel), off by {flop_off:.3%}; peak "
        f"{mem['peak_bytes_est'] / 2**30:.3f} GiB predicted, {peak / 2**30:.3f} GiB "
        f"max_memory_allocated less the {base / 2**30:.3f} GiB allocated before the "
        f"state, off by {peak_off:.2%}; output bytes {mem['output_bytes']} predicted")
    if mem["argument_bytes"] != args_bytes:
        raise AssertionError(f"phase 31a: argument bytes {mem['argument_bytes']} "
                             f"predicted, {args_bytes} on the card")
    if calls != launches or bwd_calls != bwd_launches or not bwd_launches:
        raise AssertionError(f"phase 31a: flash calls {calls} predicted, launches {launches}; "
                             f"backward calls {bwd_calls} predicted, launches {bwd_launches}")
    if flop_off > 0.01:
        raise AssertionError(f"phase 31a: FLOPs off by {flop_off:.3%} (bound 1%)")
    if peak_off > 0.10:
        raise AssertionError(f"phase 31a: the predicted peak is off by {peak_off:.2%} "
                             "(bound 10%)")
    return dict(launches=sum(launches.values()), bwd_launches=sum(bwd_launches.values()),
                pred=pred, peak=peak, flops=card_flops)


def run_tp_rank(dev, card: str) -> dict:
    """Phase 32: phase 28c's llama3-8b (4 of 32 layers at every width,
    bf16, 8 x 2048 in 4 microbatches) as one rank of a 16-way model axis
    (``train_rank_case``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train import trainer

    T = TRAIN
    cfg = dataclasses.replace(get_config(T["arch"]), num_layers=T["layers"])
    setup = trainer.TrainSetup(micro_batches=T["micro"], learning_rate=T["lr"],
                               warmup_steps=T["warmup"], total_steps=T["warmup"] + T["timed"])
    return train_rank_case(dev, card, "32", cfg, setup, T["batch"], T["seq"])


def train_rank_case(dev, card: str, phase: str, cfg, setup, rows: int, seq: int,
                    mesh_shape: tuple | None = None, steps: int | None = None) -> dict:
    """One case of phases 32, 34c and 35b: one rank of a (data, model) mesh
    of ``mesh_shape`` (default (1, 16): one rank of a 16-way model axis) on
    the card, training ``cfg`` (bf16) on ``rows`` x ``seq`` token batches.
    The step is first traced by the dry-run on ``meta`` tensors in a fake
    process group of the mesh's ranks; then the same rank runs for real on
    the card in a fake process group of as many (the dry-run's ``"fake"``
    backend) over a ``cuda`` mesh: its tensors and kernel launches are real,
    at the rank's local shapes (its rows of each microbatch, its shards),
    and its collectives return at once without data.  So this measures a
    rank's compute time and memory, not its values, and checks no loss.  A
    first step from a fresh state, after ``reset_peak_memory_stats``, under
    the dry-run's counter: argument bytes equal, flash launches by call
    equal to the predicted calls (all at the rank's q heads against one kv
    head), two block gathers a block and microbatch (the forward's and the
    recompute's), the collectives by kind as many as predicted, FLOPs
    within 1%, the predicted peak within 10% of ``max_memory_allocated``
    less what was allocated before the state; then ``steps`` (default
    ``TP_RANK["steps"]``; 0: none) steps timed and as many profiled (the
    device's busy share), and the flash kernel timed at the rank's local
    shape."""
    import math

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun
    from repro_torch.sharding import gather
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    mesh_shape = tuple(mesh_shape or (1, TP_RANK["world"]))
    world, n = math.prod(mesh_shape), mesh_shape[-1]
    steps = TP_RANK["steps"] if steps is None else steps
    shape = ShapeSpec("train_4k", seq, rows, "train")
    names = ("data", "model")
    with dryrun.fake_world(world):
        pred = dryrun.trace(cfg, shape, init_device_mesh("cpu", mesh_shape,
                                                         mesh_dim_names=names), setup)

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with dryrun.fake_world(world):
        mesh = init_device_mesh("cuda", mesh_shape, mesh_dim_names=names)
        state = trainer.init_train_state(cfg, setup, torch.Generator(device=dev).manual_seed(
            TRAIN["seed"]), dev)
        state = trainer.shard_train_state(state, ShardingPolicy(mesh, cfg))
        data = DataConfig(cfg.vocab_size, seq, rows, seed=TRAIN["seed"])
        batch = {k: v.to(dev) for k, v in batch_at(data, 0).items()}
        args_bytes = dryrun.local_bytes(state) + dryrun.local_bytes(
            {k: v[trainer._local_rows(ShardingPolicy(mesh, cfg), rows)[0]]
             for k, v in batch.items()})
        step = trainer.make_train_step(cfg, setup, mesh)
        fa_ops.LAUNCHES_BY_CALL.clear()
        fa_ops.LAUNCHES_BWD_BY_CALL.clear()
        gather.COUNTS["blocks"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter = dryrun.StepCounter()
        t0 = time.perf_counter()
        with counter:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        counted_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        launches = dict(fa_ops.LAUNCHES_BY_CALL)
        bwd_launches = dict(fa_ops.LAUNCHES_BWD_BY_CALL)
        blocks = gather.COUNTS["blocks"]
        del m

        def run():
            nonlocal state
            state, _ = step(state, batch)
        fa_ops.LAUNCHES_BY_CALL.clear()
        fa_ops.LAUNCHES_BWD_BY_CALL.clear()
        prof = busy_share(run, steps, f"phase {phase} rank step") if steps else None
        timed = dict(fa_ops.LAUNCHES_BY_CALL)
        timed_bwd = dict(fa_ops.LAUNCHES_BWD_BY_CALL)
        del state, step, batch
    torch.cuda.empty_cache()
    B = rows // setup.micro_batches // mesh_shape[0]
    heads = cfg.num_heads // n
    key = fa_ops.call_key(B, seq, seq, heads, 1, cfg.head_dim, True, torch.bfloat16)
    flash = fa_ops.flops(B, seq, seq, heads, cfg.head_dim, True)
    flash_bwd = fa_ops.flops_bwd(B, seq, seq, heads, cfg.head_dim, True)
    card_flops = (counter.flops + sum(launches.values()) * flash
                  + sum(bwd_launches.values()) * flash_bwd)
    calls = pred["kernels"].get("flash_attention", {}).get("by_call", {})
    bwd_calls = pred["kernels"].get("flash_attention_bwd", {}).get("by_call", {})
    mem = pred["memory"]
    flop_off = abs(pred["flops_per_device"] - card_flops) / card_flops
    peak_off = abs(mem["peak_bytes_est"] - peak) / peak
    coll = {k: v["count"] for k, v in counter.collectives.items()}
    pred_coll = {k: v["count"] for k, v in pred["collectives"].items()}
    want_blocks = 2 * cfg.num_blocks * setup.micro_batches
    timing = (f"{prof['wall_ms']:.3f} ms a step ({steps} steps; device busy "
              f"{prof['busy_ms']:.3f} ms in {prof['kernels']:.0f} kernels = "
              f"{prof['busy']:.1%} of the wall), " if prof else "")
    log(f"phase {phase} one rank of the mesh {mesh_shape} (data, model) training ({card}): "
        f"{cfg.name}, {cfg.num_layers} of {get_config_layers(cfg.name)} layers at every "
        f"width, bf16, batch {rows} x {seq} in {setup.micro_batches} microbatches "
        f"({B} row(s) a rank a microbatch), rank 0 of a fake process group of {world}: its "
        "tensors and kernel launches are real at the rank's local shapes, its collectives "
        "return at once without data, so this is a rank's compute time and memory, not its "
        f"values (no loss is checked); {timing}the counted first step {counted_ms:.3f} ms; "
        f"peak {peak / 2**30:.3f} GiB max_memory_allocated less the {base / 2**30:.3f} GiB "
        f"allocated before the state; {blocks} block gathers (2 a block and microbatch: "
        f"{want_blocks}); flash launches by call {launches} in the counted step, {timed} in "
        f"the {2 * steps} timed and profiled, backward launches {bwd_launches} and "
        f"{timed_bwd}.  The dry-run of the same rank, traced in "
        f"{pred['trace_s']:.1f} s: argument bytes {mem['argument_bytes']} predicted, "
        f"{args_bytes} held; flash calls {calls} predicted, backward calls {bwd_calls}; FLOPs "
        f"{pred['flops_per_device']:.6e} predicted, {card_flops:.6e} counted on the card "
        f"({counter.flops:.6e} aten + {card_flops - counter.flops:.6e} kernel), off by "
        f"{flop_off:.3%}; peak {mem['peak_bytes_est'] / 2**30:.3f} GiB predicted, off by "
        f"{peak_off:.2%}; collectives {coll} on the card, {pred_coll} predicted")
    if mem["argument_bytes"] != args_bytes:
        raise AssertionError(f"phase {phase}: argument bytes {mem['argument_bytes']} "
                             f"predicted, {args_bytes} on the card")
    if calls != launches or set(launches) != {key}:
        raise AssertionError(f"phase {phase}: flash calls {calls} predicted, launches "
                             f"{launches}, expected all at {key}")
    if bwd_calls != bwd_launches or set(bwd_launches) != {key}:
        raise AssertionError(f"phase {phase}: backward calls {bwd_calls} predicted, "
                             f"launches {bwd_launches}, expected all at {key}")
    if blocks != want_blocks:
        raise AssertionError(f"phase {phase}: {blocks} block gathers, not {want_blocks} "
                             "(the forward's and the recompute's of each block and microbatch)")
    if coll != pred_coll:
        raise AssertionError(f"phase {phase}: collectives {coll} on the card, {pred_coll} "
                             "predicted")
    if flop_off > 0.01:
        raise AssertionError(f"phase {phase}: FLOPs off by {flop_off:.3%} (bound 1%)")
    if peak_off > 0.10:
        raise AssertionError(f"phase {phase}: the predicted peak is off by {peak_off:.2%} "
                             "(bound 10%)")
    gen = torch.Generator(device=dev).manual_seed(int(phase[:2]))
    timing = time_flash_shape(dev, gen, f"phase {phase} flash at the rank's local shape",
                              heads, 1, cfg.head_dim, S=seq, B=B)
    bwd_timing = time_flash_backward(dev, gen, f"phase {phase} at the rank's local shape", B,
                                     seq, heads, 1, cfg.head_dim)
    return dict(launches=sum(launches.values()) + sum(timed.values()),
                bwd_launches=sum(bwd_launches.values()) + sum(timed_bwd.values()), timing=timing,
                bwd_timing=bwd_timing,
                ms=prof["wall_ms"] if prof else counted_ms, peak=peak,
                busy=prof["busy"] if prof else None, pred=pred, counted_ms=counted_ms)


def run_ep_train_rank(dev, card: str) -> dict:
    """Phase 34c: qwen2-moe at ``EP["train_layers"]`` of its 24 layers
    (every width; its 60 experts and shared experts cut by d_ff, its 16
    heads by heads: one a rank) as one rank of a 16-way model axis, a
    batch of ``EP["train_rows"]`` x ``EP["train_seq"]`` tokens in one
    microbatch (``train_rank_case``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train import trainer

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=EP["train_layers"])
    setup = trainer.TrainSetup(micro_batches=1, learning_rate=TRAIN["lr"],
                               warmup_steps=TRAIN["warmup"],
                               total_steps=TRAIN["warmup"] + TRAIN["timed"])
    return train_rank_case(dev, card, "34c", cfg, setup, EP["train_rows"], EP["train_seq"])


def decode_lm(dev, arch: str, layers: int, **over):
    """(config at ``layers`` of ``arch``'s layers at full width, bf16, with
    the overrides ``over``; its seeded parameters on the card, an RWKV
    config's bonus u seeded too)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch), **{"num_layers": layers, **over})
    gen = torch.Generator(device=dev).manual_seed(33)
    params = lm.init_params(cfg, gen, dev)
    if cfg.family == "ssm":
        u = params["layers"]["pos0"]["mixer"]["u"]
        u.copy_(torch.randn(u.shape, generator=gen, device=dev) * 0.5)
    return cfg, params


def decode_on_mesh_of_one(dev, card: str, mesh, phase: str, arch: str, layers: int,
                          over: dict | None = None) -> dict:
    """One case of phases 33a and 34a: ``arch`` at ``layers`` layers (full
    width, bf16, the config overrides ``over``), batch ``TP_DECODE["batch"]``,
    a cache of ``TP_DECODE["max_seq"]`` positions filled by
    ``prefill_forward`` over all but the last ``TP_DECODE["steps"]`` of them
    (an attention-only stack), else by a ``TP_DECODE["rwkv_prompt"]``-token
    prompt stepped through the unmeshed step (its RWKV or Mamba states).
    Then ``TP_DECODE["steps"]`` greedy steps from copies of that cache,
    unmeshed and on the (1, 1) ``mesh`` (the parameters placed by the
    policy, the unmeshed copy freed first, each block gathered as it runs;
    the cache placed and ``cache_model_shards``), under ``fixed_order_sums()``: the
    logits of every step and every cache leaf after the last bit for bit
    equal; the meshed run's WKV6 launches by call, one a layer and step for
    an RWKV stack, none otherwise."""
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    T = TP_DECODE
    B, S, N = T["batch"], T["max_seq"], T["steps"]
    torch.cuda.empty_cache()
    cfg, params = decode_lm(dev, arch, layers, **(over or {}))
    step = lm.serve_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(330)
    cache = lm.init_cache(cfg, B, S, dev)
    if any(mixer != "attn" for mixer, _ in cfg.block_program()):
        prompt = torch.randint(1, cfg.vocab_size, (B, T["rwkv_prompt"]), generator=gen,
                               device=dev, dtype=torch.int32)
        for t in range(prompt.shape[1]):
            logits, cache = step(params, cache, prompt[:, t:t + 1])
    else:
        P = S - N
        prompt = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device=dev,
                               dtype=torch.int32)
        logits, taps = lm.prefill_forward(cfg)(params, {"tokens": prompt})
        for name, kv in taps.items():
            for kk, rows in kv.items():
                cache[name][kk][:, :, :P].copy_(rows)
        cache["len"] = P
        del taps
    first = logits.argmax(-1, keepdim=True).to(torch.int32)
    policy = ShardingPolicy(mesh, cfg)
    copy = _tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, cache)
    start = copy["len"]
    runs = {}
    with fixed_order_sums():
        tok, got = first, []
        for _ in range(N):
            logits, cache = step(params, cache, tok)
            got.append(logits)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        runs[False] = got
        placed = policy.distribute(params, policy.params_sharding(params))
        del params                      # the card holds the placed copy alone
        torch.cuda.empty_cache()
        tp_cache = trainer.cache_model_shards(
            policy.distribute(copy, policy.cache_sharding(copy)), mesh)
        del copy
        wkv_ops.LAUNCHES_BY_CALL.clear()
        tok, got = first, []
        with ctx.use_mesh(mesh):
            for _ in range(N):
                logits, tp_cache = step(placed, tp_cache, tok)
                got.append(logits)
                tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        runs[True] = got
        launches = dict(wkv_ops.LAUNCHES_BY_CALL)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(runs[False], runs[True]))
    leaves = [(path, a, b) for (path, a), (_, b) in zip(_named_leaves(cache),
                                                        _named_leaves(tp_cache))]
    differ = [path for path, a, b in leaves if isinstance(a, torch.Tensor)
              and not torch.equal(a, b.to_local())]
    full = get_config_layers(arch)
    cut = f"{cfg.num_layers} of {full} layers" + (
        f", {cfg.num_experts} of its experts a MoE layer" if over and "num_experts" in over
        else "")
    log(f"phase {phase} {arch} ({card}): {cut}, bf16, batch {B}, a cache of {S} positions "
        f"from len {start}, {N} greedy steps unmeshed and on the (1, 1) mesh: logits "
        f"{'bit for bit' if same else 'DIFFER'}, {len(leaves) - len(differ)} of "
        f"{len(leaves)} cache leaves bit for bit, len {cache['len']} and {tp_cache['len']}; "
        f"WKV6 launches by call on the mesh {launches}")
    if not same or differ or cache["len"] != tp_cache["len"]:
        raise AssertionError(f"phase {phase} {arch}: the meshed decode differs from the "
                             f"unmeshed (logits equal: {same}; leaves {differ})")
    want = ({wkv_ops.call_key(B, 1, cfg.rwkv_heads, cfg.rwkv_head_size,
                              torch.bfloat16): N * cfg.num_layers}
            if cfg.family == "ssm" else {})
    if launches != want:
        raise AssertionError(f"phase {phase} {arch}: WKV6 launches {launches}, expected "
                             f"{want}")
    del cache, placed, tp_cache, runs
    torch.cuda.empty_cache()
    return dict(launches=sum(launches.values()))


def get_config_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).num_layers


def run_tp_decode_one(dev, card: str) -> dict:
    """Phase 33a: the tensor-parallel decode on ``make_production_mesh()``
    (NCCL, a world of one: a (1, 1) mesh), llama3-8b and rwkv6-7b at 4 of
    32 layers (``decode_on_mesh_of_one``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    try:
        return {arch: decode_on_mesh_of_one(dev, card, mesh, "33a", arch,
                                            TP_DECODE["layers"])
                for arch in ("llama3-8b", "rwkv6-7b")}
    finally:
        dist.destroy_process_group()


def rank_shards(dev, cfg, policy, seed: int) -> dict:
    """``cfg``'s parameters placed by ``policy`` with each rank's shard
    drawn at its local shape on the card (``randn`` at 0.02, seeded), the
    whole tree never made (a jamba block with all 16 experts would take
    84.3 GiB).  The values are not the init's; in a fake process group
    none is read back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm

    gen = torch.Generator(device=dev).manual_seed(seed)
    meta = lm.init_params(cfg, None, "meta")

    def draw(x):
        local = torch.randn(x.to_local().shape, generator=gen, device=dev).mul_(0.02)
        return DTensor.from_local(local.to(x.dtype), x.device_mesh, x.placements,
                                  run_check=False)
    return _tree_map(draw, policy.distribute(meta, policy.params_sharding(meta)))


def decode_rank_case(dev, card: str, phase: str, arch: str, over: dict | None = None,
                     mesh_shape: tuple | None = None) -> dict:
    """One case of phases 33b, 34b and 35a: one rank decoding at
    ``decode_32k``'s local shapes (``TP_DECODE["rows"]`` rows a data rank, a
    cache of ``TP_DECODE["seq"]`` positions), bf16, ``arch``'s config with
    the overrides ``over``, on a (data, model) mesh of ``mesh_shape``
    (default (1, 16): one rank of a 16-way model axis).  First traced by
    the dry-run on ``meta`` tensors in a fake process group of the mesh's
    ranks; then the same rank runs on the card as rank 0 of a fake process
    group of as many over a ``cuda`` mesh: real tensors and launches at the
    rank's shapes, collectives that return at once without data (so no
    value is checked).  Only the rank's shards of the parameters are drawn
    (``rank_shards``) and of the cache made, at their local shapes, and the
    step takes its rows of the tokens (``ctx.cut_batch``, as the dry-run
    cuts them).  A first step (the cache's rewrap and every block's gather
    included, as the dry-run traces it) from len 0, after
    ``reset_peak_memory_stats``, under the dry-run's counter: argument
    bytes equal, WKV6 launches by call equal to the predicted calls (none
    but an RWKV stack's), one block gather a block, the collectives by
    kind as many as predicted, FLOPs within 0.01%, the predicted peak
    within 2% of ``max_memory_allocated`` less what was allocated before;
    then ``TP_DECODE["timed"]`` steps on the rewrapped cache timed and as
    many profiled (the device's busy share)."""
    import dataclasses
    import math

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.sharding import ctx, gather
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.train import trainer

    T = TP_DECODE
    mesh_shape = tuple(mesh_shape or (1, T["world"]))
    world, n = math.prod(mesh_shape), mesh_shape[-1]
    names = ("data", "model")
    shape = ShapeSpec("decode_32k", T["seq"], T["rows"] * mesh_shape[0], "decode")
    cfg = dataclasses.replace(get_config(arch), **(over or {}))
    with dryrun.fake_world(world):
        pred = dryrun.trace(cfg, shape, init_device_mesh("cpu", mesh_shape,
                                                         mesh_dim_names=names))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with dryrun.fake_world(world):
        mesh = init_device_mesh("cuda", mesh_shape, mesh_dim_names=names)
        policy = ShardingPolicy(mesh, cfg)
        params = rank_shards(dev, cfg, policy, int(phase[:2]))
        meta = lm.init_cache(cfg, shape.global_batch, T["seq"], "meta")
        # the rank's shards made at their local shapes: the whole cache
        # (2 x 32 GB for llama3-8b) is not drawn
        cache = _tree_map(lambda x: DTensor.from_local(
            torch.zeros_like(x.to_local(), device=dev), mesh, x.placements,
            run_check=False) if isinstance(x, DTensor) else x,
            policy.distribute(meta, policy.cache_sharding(meta)))
        rows, cut = trainer._local_rows(policy, shape.global_batch)
        tokens = torch.randint(1, cfg.vocab_size, (shape.global_batch, 1), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(331),
                               dtype=torch.int32)[rows]
        args_bytes = dryrun.local_bytes((params, cache)) + dryrun.local_bytes(tokens)
        step = lm.serve_step(cfg)
        wkv_ops.LAUNCHES_BY_CALL.clear()
        gather.COUNTS["blocks"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter = dryrun.StepCounter()
        t0 = time.perf_counter()
        with counter, ctx.use_mesh(mesh), ctx.cut_batch(cut):
            logits, tp_cache = step(params, trainer.cache_model_shards(cache, mesh), tokens)
        torch.cuda.synchronize()
        counted_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        launches = dict(wkv_ops.LAUNCHES_BY_CALL)
        blocks = gather.COUNTS["blocks"]

        def run():
            nonlocal logits
            with ctx.use_mesh(mesh), ctx.cut_batch(cut):
                logits, _ = step(params, tp_cache, tokens)
        wkv_ops.LAUNCHES_BY_CALL.clear()
        prof = busy_share(run, T["timed"], f"phase {phase} {arch} rank step")
        timed = dict(wkv_ops.LAUNCHES_BY_CALL)
        if logits.shape != (T["rows"], cfg.vocab_size):
            raise AssertionError(f"phase {phase} {arch}: logits {tuple(logits.shape)}, not "
                                 "[rows, V] (their values are not the rank's: the fake "
                                 "group's collectives carry no data)")
        del params, cache, tp_cache, logits
    torch.cuda.empty_cache()
    flops = counter.flops + (sum(launches.values()) * wkv_ops.flops(
        T["rows"], 1, cfg.rwkv_heads // n, cfg.rwkv_head_size) if launches else 0)
    calls = pred["kernels"].get("wkv6", {}).get("by_call", {})
    mem = pred["memory"]
    flop_off = abs(pred["flops_per_device"] - flops) / flops
    peak_off = abs(mem["peak_bytes_est"] - peak) / peak
    coll = {k: v["count"] for k, v in counter.collectives.items()}
    pred_coll = {k: v["count"] for k, v in pred["collectives"].items()}
    if cfg.family == "ssm":
        cut_by = f"the cache cut by heads ({cfg.rwkv_heads // n} of {cfg.rwkv_heads} a rank)"
    elif cfg.num_kv_heads % n:
        cut_by = f"the cache cut by positions ({T['seq'] // n} a rank)"
    else:
        cut_by = f"the cache cut by kv heads ({cfg.num_kv_heads // n} a rank)"
    if cfg.num_experts:
        cut_by += (f", the experts cut by experts ({cfg.num_experts // n} of "
                   f"{cfg.num_experts} a rank)" if cfg.num_experts % n == 0 else
                   f", each of the {cfg.num_experts} experts cut by d_ff ({cfg.d_ff // n} of "
                   f"{cfg.d_ff} a rank)")
    if cfg.family == "hybrid":
        cut_by += (f", Mamba by d_inner ({cfg.mamba_d_inner // n} of {cfg.mamba_d_inner} "
                   "channels a rank)")
    log(f"phase {phase} one rank of the mesh {mesh_shape} (data, model) decoding ({card}): "
        f"{arch}, {cfg.num_layers} of {get_config_layers(arch)} layers at every width, bf16, "
        f"{T['rows']} rows of {shape.global_batch} against a cache of {T['seq']} positions, "
        f"{cut_by}, rank 0 of a fake process group of {world} (real tensors and launches at "
        f"the rank's shapes, collectives that return at once: no values); "
        f"{prof['wall_ms']:.3f} ms a step ({T['timed']} steps; device busy "
        f"{prof['busy_ms']:.3f} ms in {prof['kernels']:.0f} kernels = {prof['busy']:.1%} of "
        f"the wall), the counted first step (the cache's rewrap and {blocks} block gathers "
        f"included) {counted_ms:.3f} ms; peak {peak / 2**30:.3f} GiB max_memory_allocated "
        f"less the {base / 2**30:.3f} GiB allocated before; WKV6 launches by call {launches} "
        f"in the counted step, {timed} in the {2 * T['timed']} timed and profiled.  The "
        f"dry-run of the same rank, traced in {pred['trace_s']:.1f} s: argument bytes "
        f"{mem['argument_bytes']} predicted, {args_bytes} held; WKV6 calls {calls}; FLOPs "
        f"{pred['flops_per_device']:.6e} predicted, {flops:.6e} counted on the card "
        f"({counter.flops:.6e} aten), off by {flop_off:.4%}; peak "
        f"{mem['peak_bytes_est'] / 2**30:.3f} GiB predicted, off by {peak_off:.2%}; "
        f"collectives {coll} on the card, {pred_coll} predicted")
    if mem["argument_bytes"] != args_bytes:
        raise AssertionError(f"phase {phase} {arch}: argument bytes {mem['argument_bytes']} "
                             f"predicted, {args_bytes} on the card")
    if calls != launches:
        raise AssertionError(f"phase {phase} {arch}: WKV6 calls {calls} predicted, "
                             f"launches {launches}")
    if blocks != cfg.num_blocks:
        raise AssertionError(f"phase {phase} {arch}: {blocks} block gathers, not one a "
                             f"block ({cfg.num_blocks})")
    if coll != pred_coll:
        raise AssertionError(f"phase {phase} {arch}: collectives {coll} on the card, "
                             f"{pred_coll} predicted")
    if flop_off > 1e-4:
        raise AssertionError(f"phase {phase} {arch}: FLOPs off by {flop_off:.4%} "
                             "(bound 0.01%)")
    if peak_off > 0.02:
        raise AssertionError(f"phase {phase} {arch}: the predicted peak is off by "
                             f"{peak_off:.2%} (bound 2%)")
    return dict(launches=sum(launches.values()) + sum(timed.values()), ms=prof["wall_ms"],
                busy=prof["busy"], peak=peak, pred=pred, collectives=coll,
                counted_ms=counted_ms)


def run_tp_decode_rank(dev, card: str) -> dict:
    """Phase 33b: ``decode_rank_case`` for llama3-8b (its cache cut by
    positions, 2048 of 32768 a rank) and rwkv6-7b (by heads, 4 of 64) at
    full depth; then WKV6 held to its plain
    version and timed at the rank's decode shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan import wkv6_ref

    T, n = TP_DECODE, TP_DECODE["world"]
    out = {arch: decode_rank_case(dev, card, "33b", arch) for arch in ("llama3-8b", "rwkv6-7b")}
    gen = torch.Generator(device=dev).manual_seed(332)
    rwkv = get_config("rwkv6-7b")
    args = wkv_inputs(gen, dev, T["rows"], 1, rwkv.rwkv_heads // n, rwkv.rwkv_head_size,
                      torch.bfloat16, True)
    got, want = wkv_ops.wkv6(*args), wkv6_ref(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = 1 + max(float(b.abs().max()) for b in want)
    if not err / scale <= 1e-5:
        raise AssertionError(f"phase 33b: WKV6 at a rank's decode shape off its plain "
                             f"version by {err}")
    out["timing"] = wkv_timing("phase 33b WKV6 at a rank's decode shape (carried state)",
                               args)
    out["max_abs_err"] = err
    return out


def run_ep_one(dev, card: str) -> dict:
    """Phase 34a: expert parallelism and the tensor-parallel Mamba on
    ``make_production_mesh()`` (NCCL, a world of one: a (1, 1) mesh), bit
    for bit the unmeshed runs.  granite-moe-3b at full size decodes
    ``TP_DECODE["steps"]`` steps (``decode_on_mesh_of_one``); jamba at one
    period-8 block, every width kept, with ``EP["jamba_experts"]`` of its 16
    experts a MoE layer (the ``EP`` comment says why), decodes as many;
    granite-moe at 4 of 32 layers takes one train step of
    ``EP["train_rows"]`` x ``EP["train_seq"]`` unmeshed and one on the mesh
    (``train_on_mesh_of_one``)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import trainer

    mesh = make_production_mesh()
    try:
        out = {"granite-moe-3b-a800m": decode_on_mesh_of_one(
            dev, card, mesh, "34a", "granite-moe-3b-a800m",
            get_config_layers("granite-moe-3b-a800m"))}
        out["jamba-1.5-large-398b"] = decode_on_mesh_of_one(
            dev, card, mesh, "34a", "jamba-1.5-large-398b", 8,
            dict(num_experts=EP["jamba_experts"]))
        cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                  num_layers=EP["train_layers"])
        setup = trainer.TrainSetup(micro_batches=1, learning_rate=TRAIN["lr"],
                                   warmup_steps=TRAIN["warmup"],
                                   total_steps=TRAIN["warmup"] + TRAIN["timed"])
        out["train"] = train_on_mesh_of_one(dev, card, mesh, "34a", cfg, setup,
                                            EP["train_rows"], EP["train_seq"], 1)
    finally:
        dist.destroy_process_group()
    return out


def run_ep_decode_rank(dev, card: str) -> dict:
    """Phase 34b: ``decode_rank_case`` for granite-moe (40 experts, each cut
    by d_ff) and qwen2-moe (60, by d_ff; its shared experts column- and
    row-parallel) at full depth, and jamba at one of its 9 blocks with all
    16 experts (one a rank; Mamba by d_inner)."""
    return {arch: decode_rank_case(dev, card, "34b", arch, over)
            for arch, over in (("granite-moe-3b-a800m", None), ("qwen2-moe-a2.7b", None),
                               ("jamba-1.5-large-398b", dict(num_layers=8)))}


def run_block_gather(dev, card: str) -> dict:
    """Phase 35: per-block parameter gathering on the card, rank 0 of a
    fake process group of 256 on the single (16, 16) mesh (``BLOCKS``):
    35a one rank of jamba-1.5-large-398b's ``decode_32k`` at full depth
    (``decode_rank_case``), 35b one rank of a llama3-8b train step at
    ``BLOCKS["train_layers"]`` layers (``train_rank_case``, its flash
    launches at the rank's local shape timed there)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.train import trainer

    B = BLOCKS
    out = {"decode": decode_rank_case(dev, card, "35a", B["decode_arch"],
                                      mesh_shape=B["mesh"])}
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), num_layers=B["train_layers"])
    setup = trainer.TrainSetup(micro_batches=B["train_micro"], learning_rate=TRAIN["lr"],
                               warmup_steps=TRAIN["warmup"],
                               total_steps=TRAIN["warmup"] + TRAIN["timed"])
    out["train"] = train_rank_case(dev, card, "35b", cfg, setup, B["train_rows"], TRAIN["seq"],
                                   mesh_shape=B["mesh"], steps=0)
    return out


def run_dryrun_cells() -> dict:
    """Phase 31b: ``python -m repro_torch.launch.dryrun --mesh single
    --force`` on each of ``DRYRUN_CELLS`` at full depth, one process a
    cell, all at once (the dry-run runs on the CPU: it allocates nothing
    on the card).  For each cell: FLOPs a rank beside 6·N·D / 256 (2·N·D
    forward only; N the active parameters, D the tokens a step computes),
    the predicted peak beside the card's 80 GiB (a cell that does not fit
    is a result), the wire bytes and the trace seconds.  Any status other
    than ok fails, and so does llama3-8b ``train_4k`` above
    ``TP_TRAIN_RATIO`` × 6·N·D / 256."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
         cell[1], "--mesh", "single", "--force"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cell in DRYRUN_CELLS}
    out = {}
    try:
        for (arch, shape), p in procs.items():
            text, _ = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            path = dryrun.cell_path(arch, shape, "single")
            res = json.loads(path.read_text()) if path.exists() else {}
            if p.returncode != 0 or res.get("status") != "ok":
                raise AssertionError(f"phase 31b {arch} x {shape}: exit {p.returncode}, "
                                     f"status {res.get('status')}: "
                                     f"{res.get('error', text[-2000:])}")
            sh = SHAPES[shape]
            tokens = sh.global_batch * (1 if sh.kind == "decode" else sh.seq_len)
            n_flop = (6 if sh.kind == "train" else 2) * res["param_count_active"] * tokens
            peak = res["memory"]["peak_bytes_est"] / 2**30
            log(f"phase 31b {arch} x {shape} x single ({res['devices']} ranks "
                f"{res['mesh_shape']}, {res['kind']}): {res['flops_per_device']:.4e} FLOP a "
                f"rank against {'6' if sh.kind == 'train' else '2'}·N·D / {res['devices']} = "
                f"{n_flop / res['devices']:.4e} ({res['flops_per_device'] * res['devices'] / n_flop:.2f}x); "
                f"peak {peak:.2f} GiB a rank against the card's {CARD_GIB} "
                f"({'fits' if peak <= CARD_GIB else 'does not fit'}); arguments "
                f"{res['memory']['argument_bytes'] / 2**30:.3f} GiB; wire "
                f"{res['collective_wire_bytes_per_device']:.4e} B a rank "
                + str({k: v["count"] for k, v in res["collectives"].items()})
                + f"; kernel calls {({k: v['calls'] for k, v in res['kernels'].items()})}; "
                f"traced in {res['trace_s']} s on the host's CPU")
            out[(arch, shape)] = res
            ratio = res["flops_per_device"] * res["devices"] / n_flop
            if (arch, shape) == ("llama3-8b", "train_4k") and ratio > TP_TRAIN_RATIO:
                raise AssertionError(f"phase 31b llama3-8b x train_4k: {ratio:.2f}x 6·N·D / "
                                     f"{res['devices']} a rank, above {TP_TRAIN_RATIO}x: "
                                     "the model axis repeats the step's work")
            if (arch, shape) == ("llama3-8b", "decode_32k") and (
                    res["flops_per_device"] > TP_DECODE_CELL["flops"]
                    or peak >= TP_DECODE_CELL["peak_gib"]):
                raise AssertionError(f"phase 31b llama3-8b x decode_32k: "
                                     f"{res['flops_per_device']:.4e} FLOP and {peak:.2f} GiB a "
                                     f"rank, not within {TP_DECODE_CELL}: the decode is not "
                                     "tensor-parallel")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def log_instantiations(source: str, text: str) -> None:
    """Phase 2: registers and spill stores of every kernel instantiation in
    ``source``'s ``-Xptxas -v`` log, by demangled name."""
    found = []
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        found.append((name, int(regs.group(1)) if regs else -1,
                      int(spill.group(1)) if spill else 0))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _, _ in found),
                               capture_output=True, text=True, timeout=30,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [n for n, _, _ in found]
    for (_, regs, spill), name in zip(found, names):
        short = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", ""))
        short = short.removeprefix("void ")
        log(f"    {short}: {regs} registers, {spill} B spill stores")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, path + (k,))
    else:
        yield path, tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = nvidia_smi()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build_logs = _build.build_all(KERNELS, verbose=True)
    log(f"phase 2 build: " + ", ".join(_build.library_path(n).name for n in KERNELS)
        + f" in {time.perf_counter() - t0:.2f} s (one nvcc per source, all at once, "
        "then one link per kernel)")
    for source, text in build_logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
        if regs:
            log(f"  {source}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                f"{sum(1 for b in spills if b)} with spills (max {max(spills, default=0)} "
                "B stored)")
        for line in text.splitlines():
            if "warning" in line.lower():
                log(f"  {source}: {line.strip()}")
        if "flash_attention" in source or any(spills):
            log_instantiations(source, text)

    kernel = check_kernel(dev)
    check_beam(dev)
    check_loop_vs_cpu(dev)
    launches, res = run_main_path(dev)
    profile_online(res)
    time_critic_head(res)
    del res
    flash = check_flash(dev)
    wkv = check_wkv(dev)
    check_lm_smoke(dev)
    llama = run_lm_path(dev, "llama3-8b", batcher=True)
    rwkv = run_lm_path(dev, "rwkv6-7b", batcher=True)
    t0 = time.perf_counter()
    check_baselines_vs_cpu(dev)
    run_baselines(dev, card)
    run_ddpg_mixed(dev, card)
    log(f"phases 14-16 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_serving(dev, card)
    log(f"phase 17 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_streaming_vs_cpu(dev)
    run_streaming(dev, card)
    log(f"phase 18 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_structural_vs_cpu(dev)
    run_structural(dev, card)
    log(f"phase 19 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_placement_vs_cpu(dev)
    placement = run_placement(dev, card)
    log(f"phase 20 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_checkpoints(dev, card)
    log(f"phase 21 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_elastic_vs_cpu(dev)
    run_elastic(dev, card)
    log(f"phase 22 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    config_flash = time_config_flash(dev)
    more = {arch: run_lm_path(dev, arch, layers) for arch, layers in LM_MORE}
    log(f"phase 23 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_batcher_vs_cpu(dev)
    log(f"phase 24 smoke configs {time.perf_counter() - t0:.1f} s (the full-size "
        "batcher runs beside phases 12 and 13, on their weights)")
    t0 = time.perf_counter()
    new_archs = tuple(arch for arch, _ in LM_NEW)
    check_lm_smoke(dev, new_archs, phase=25)
    check_batcher_vs_cpu(dev, new_archs, phase=25)
    new_flash = time_new_flash(dev)
    new = {arch: run_lm_path(dev, arch, over=over) for arch, over in LM_NEW}
    log(f"phase 25 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_figures_vs_cpu(dev)
    run_figures(dev, card)
    log(f"phase 26 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_single_run_vs_cpu(dev)
    twins = run_twins(dev, card)
    log(f"phase 27 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f32_bwd_launches = check_train_vs_cpu(dev)
    check_train_functions(dev)
    train = run_train_full(dev, card)
    train_lm_twin = run_train_lm_twin(dev, card)
    log(f"phase 28 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    meshed = run_meshed_fleet(dev, card, kernel["timings"][25600]["floor_ms"])
    run_multihost_drill(dev, card)
    run_elastic_twin(dev, card)
    log(f"phase 29 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    lm_mesh = make_production_mesh()
    try:
        log(f"phase 30 mesh {dict(zip(lm_mesh.mesh_dim_names, lm_mesh.shape))} on "
            f"{dist.get_backend()}, world {dist.get_world_size()}")
        check_meshed_compressed_vs_cpu(dev, lm_mesh)
        meshed_train = run_meshed_train(dev, card, lm_mesh)
    finally:
        dist.destroy_process_group()
    log(f"phase 30 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = check_dryrun_vs_card(dev, card)
    run_dryrun_cells()
    log(f"phase 31 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_rank = run_tp_rank(dev, card)
    log(f"phase 32 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_one = run_tp_decode_one(dev, card)
    tp_decode = run_tp_decode_rank(dev, card)
    log(f"phase 33 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ep_one = run_ep_one(dev, card)
    run_ep_decode_rank(dev, card)
    ep_train = run_ep_train_rank(dev, card)
    log(f"phase 34 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    blocks = run_block_gather(dev, card)
    log(f"phase 35 {time.perf_counter() - t0:.1f} s")

    def row(name, source, replaces, launches, check, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": check["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}

    # launches: the K-NN kernel's on the training path (phase 6; phase 17
    # logs the serving path's) and on DDPG's placement path (phase 20, its
    # select shape [128, 16]), each flash route's in the llama3-8b prefill
    # (the wide form's: no path has hd > 256) and the bf16 route's in each
    # phase 23 config's prefill, at its own shape; WKV's in the rwkv6-7b
    # prefill and generate, and in the continuous batcher's run (phase 24,
    # checked and timed at its [8, 1, 64, 64] step)
    flash_sm90 = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu"
    flash_bwd = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
    flash_tpu = "src/repro/kernels/flash_attention/kernel.py:74"
    print(json.dumps({"kernels": [
        row("row_top2_regret", "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
            "src/repro/kernels/knn_topk/kernel.py:37", launches, kernel,
            kernel["timings"][25600]),
        row("row_top2_regret_placement",
            "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
            "src/repro/kernels/knn_topk/kernel.py:37", placement["knn_launches"],
            dict(max_abs_err=kernel["placement_max_abs_err"]),
            kernel["timings"][128]),
        # phase 27: the examples' twins (the quickstart's, the expert
        # placement's and the scenario fleet's launches), timed at the
        # quickstart's update shape [640, 10]
        row("row_top2_regret_single",
            "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
            "src/repro/kernels/knn_topk/kernel.py:37", twins["launches"],
            dict(max_abs_err=kernel["single_max_abs_err"]),
            kernel["timings"][640]),
        row("flash_attention",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention/kernel.py:74", llama["launches"],
            flash, flash["timings"]),
        row("flash_attention_f32",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:74", llama["launches_f32"],
            flash["f32"], flash["f32"]["timings"]),
        row("flash_attention_wide",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:74", llama["launches_wide"],
            flash["wide"][(512, "float32")], flash["wide"][(512, "float32")]),
        row("wkv6", "src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu",
            "src/repro/kernels/rwkv6_scan/kernel.py:49", rwkv["launches"], wkv,
            wkv["timings"]["prefill"]),
        *[row(f"flash_attention_{arch}", flash_sm90, flash_tpu, more[arch]["launches"],
              config_flash[arch], config_flash[arch]) for arch, _ in LM_MORE],
        row("wkv6_batcher", "src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu",
            "src/repro/kernels/rwkv6_scan/kernel.py:49",
            rwkv["batcher"]["launches"]["wkv"],
            dict(max_abs_err=wkv["batcher_max_abs_err"]), wkv["timings"]["batcher"]),
        # phase 25: phi-3-vision's 32 launches at phase 9's hd-96 shape;
        # seamless's decoder self-attention, its cross-attention at Skv =
        # 4096 and its encoder (prefill_forward's 12 and prefill_encoder's
        # 12 in Engine.generate), each counted by the wrapper at its shape;
        # the float32 route's cross-attention at the same shape, which the
        # bf16 main path launches no time; jamba's one attention layer
        row("flash_attention_phi-3-vision-4.2b", flash_sm90, flash_tpu,
            new["phi-3-vision-4.2b"]["launches"], flash["phi3"], flash["phi3"]),
        row("flash_attention_seamless_decoder", flash_sm90, flash_tpu,
            seamless_launches(new, "2048x2048 causal"), new_flash["decoder"],
            new_flash["decoder"]),
        row("flash_attention_seamless_cross", flash_sm90, flash_tpu,
            seamless_launches(new, "2048x4096 full"), new_flash["cross"],
            new_flash["cross"]),
        row("flash_attention_f32_seamless_cross",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu", flash_tpu,
            new["seamless-m4t-medium"]["launches_f32"], new_flash["cross"]["f32"],
            new_flash["cross"]["f32"]),
        row("flash_attention_seamless_encoder", flash_sm90, flash_tpu,
            seamless_launches(new, f"{ENCDEC_MEMORY_LEN}x{ENCDEC_MEMORY_LEN} full"),
            new_flash["encoder"], new_flash["encoder"]),
        row("flash_attention_jamba-1.5-large-398b", flash_sm90, flash_tpu,
            new["jamba-1.5-large-398b"]["launches"], new_flash["jamba"],
            new_flash["jamba"]),
        # phase 28: the training path's forward launches (forward and the
        # rematerialized recompute; the backward's rows are below),
        # llama3-8b's 4-layer run at its microbatch's
        # shape [2, 2048, 32, 128] and the train_lm twin's at [4, 256, 12, 64]
        row("flash_attention_train_llama3-8b", flash_sm90, flash_tpu, train["launches"],
            train["timing"], train["timing"]),
        row("flash_attention_train_lm", flash_sm90, flash_tpu, train_lm_twin["launches"],
            train_lm_twin["timing"], train_lm_twin["timing"]),
        # phase 29a: the 2-slot mesh's blocks, select [400, 10] and update
        # [12800, 10] (4 lanes a block), timed at the update's shape
        row("row_top2_regret_mesh", "src/repro_torch/kernels/knn_topk/csrc/knn_topk.cu",
            "src/repro/kernels/knn_topk/kernel.py:37", meshed["launches"], meshed,
            meshed["timing"]),
        # phase 30b: the meshed llama3-8b train steps' forward launches (the
        # microbatch's shape, timed in phase 28c)
        row("flash_attention_train_mesh", flash_sm90, flash_tpu, meshed_train["launches"],
            train["timing"], train["timing"]),
        # phase 31a: the step the dry-run's prediction is held to (phase
        # 28c's shape, timed there)
        row("flash_attention_dryrun_check", flash_sm90, flash_tpu, dry["launches"],
            train["timing"], train["timing"]),
        # phase 32: one rank of a 16-way model axis, its launches at the
        # rank's local heads (q [2, 2048, 2, 128] against one kv head),
        # timed there
        row("flash_attention_tp_rank", flash_sm90, flash_tpu, tp_rank["launches"],
            tp_rank["timing"], tp_rank["timing"]),
        # phase 33: the tensor-parallel decode's WKV6 launches on a rank's
        # heads with the cache's carried state (33a's meshed steps at
        # [4, 1, 64, 64] on a mesh of one, 33b's at [8, 1, 4, 64]), timed
        # and held to the plain version at 33b's shape
        row("wkv6_tp_decode", "src/repro_torch/kernels/rwkv6_scan/csrc/wkv6.cu",
            "src/repro/kernels/rwkv6_scan/kernel.py:49",
            tp_one["rwkv6-7b"]["launches"] + tp_decode["rwkv6-7b"]["launches"], tp_decode,
            tp_decode["timing"]),
        # phase 34: expert parallelism and the tensor-parallel Mamba: 34c's
        # rank of a qwen2-moe train step at its local heads (q [2, 2048, 1,
        # 128] against one kv head), timed there, and 34a's granite-moe
        # train steps on the (1, 1) mesh at [2, 2048, 24, 64] (8 kv heads);
        # the decodes (34a, 34b) attend through the plain decode attention
        row("flash_attention_tp_moe", flash_sm90, flash_tpu,
            ep_train["launches"] + ep_one["train"]["launches"], ep_train["timing"],
            ep_train["timing"]),
        # phase 35b: a rank of the (16, 16) mesh training llama3-8b with
        # each block gathered just before it runs (q [1, 2048, 2, 128]
        # against one kv head: one row a rank a microbatch), timed there
        row("flash_attention_block_gather", flash_sm90, flash_tpu,
            blocks["train"]["launches"], blocks["train"]["timing"],
            blocks["train"]["timing"]),
        # the flash backward (flash_attention_bwd.cu: a dQ kernel that also
        # sums D, then a dK/dV kernel; one launch a Function backward):
        # phase 28c's llama3-8b steps on the tensor cores, timed at the
        # microbatch's shape; the CUDA-core route's float32 launches in
        # phase 28a's smoke steps, timed at [1, 2048, 8, 128] against 2 kv
        # heads; the meshed steps of 30b and 31a at 28c's shape; the ranks
        # of phases 32, 34c and 35b at their local shapes, timed there.
        # The TPU kernel has no backward; this is the gradient of its
        # function
        row("flash_attention_bwd", flash_bwd, flash_tpu, train["bwd_launches"],
            train["bwd_timing"], train["bwd_timing"]),
        row("flash_attention_bwd_f32", flash_bwd, flash_tpu, f32_bwd_launches,
            train["bwd32_timing"], train["bwd32_timing"]),
        row("flash_attention_bwd_mesh", flash_bwd, flash_tpu,
            meshed_train["bwd_launches"] + ep_one["train"]["bwd_launches"],
            train["bwd_timing"], train["bwd_timing"]),
        row("flash_attention_bwd_dryrun_check", flash_bwd, flash_tpu, dry["bwd_launches"],
            train["bwd_timing"], train["bwd_timing"]),
        row("flash_attention_bwd_tp_rank", flash_bwd, flash_tpu, tp_rank["bwd_launches"],
            tp_rank["bwd_timing"], tp_rank["bwd_timing"]),
        row("flash_attention_bwd_tp_moe", flash_bwd, flash_tpu, ep_train["bwd_launches"],
            ep_train["bwd_timing"], ep_train["bwd_timing"]),
        row("flash_attention_bwd_block_gather", flash_bwd, flash_tpu,
            blocks["train"]["bwd_launches"], blocks["train"]["bwd_timing"],
            blocks["train"]["bwd_timing"]),
    ]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
