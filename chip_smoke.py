#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA H100: the DPM data plane,
one KN's planned DAC windows over it, the DPM pool with its planned merge,
the cluster over that pool by its host and compiled batch engines, the
paged LLM serving path, the dense, MoE and VLM families at head dim 128
with the dense-cache decode, the SSM family's prefill and recurrent
decode, the hybrid and encoder-decoder families, training with its
loop (data loader, checkpoints, resume, hot-row replica), the launch side,
and the multi-device paths over torch.distributed at world size 1.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It first runs the port's static analysis over the checkout
(repro_torch.analysis: its six AST passes, as ``python -m
repro_torch.analysis --strict`` runs them) and stops on any finding. Then
it builds the port's CUDA kernels (src/repro_torch/csrc/*.cu, nvcc for
sm_90a, into build/repro_torch/), holds every kernel against its plain
torch version on the card (kernels C and 4 also on the adversarial
inputs of tests/torch_cases.py), then serves the repo's own dataset -- 2^25
keys with 1 KB values (the paper's 32 GB dataset) in a device-resident
CLHT index, log segment and value heap:

  load       every key through log_append_merge, in batches of 2^20
  serve      YCSB read_only and write_heavy_update at zipf 0.99, reads
             through kvs_lookup, writes through log_append_merge, every
             read checked against a host shadow of the last acknowledged
             version of its key
  read-back  every key written while serving, through lookup (its
             pointer) and kvs_lookup (its value row)

and times each kernel at the shapes the serving path gives it (kernel D
also on the slow-path entries of one served write batch). Then one
KN serves the same pool from its DAC cache:

  kn_window  an ArrayDAC of 1 GiB (the paper's KN cache against its 32 GB
             dataset) warmed full, then 2^15 ops each (cut from 2^16 for
             the run's time) of YCSB write_heavy_update and
             read_mostly_update at zipf 0.99 over the 2^25 keys, in
             batches whose missing reads are probed on the card (kernel A)
             and whose writes go through log_append_merge (C and D). Each
             batch is cut into planning chunks of at most 512 ops;
             plan_dac_window plans a chunk or it is replayed op by op.
             Every planned window's gathered inputs run through
             cache_transition (kernel 4) on the card, held bit for bit
             against its plain version and against the plan, with every
             disagreement under a named cause; a window whose reads
             missed is also checked on its prefix before the first miss

and times kernel 4 on a 512-op window of that path. Then the port's DPM
pool (core/dpm_pool.py: host lists and index, as the reference's) runs on
the card at 2^21 keys of 1 KB values:

  dpm_pool   the keys loaded through the pool's batched writes and
             merge_all, then 8 rounds of YCSB write_heavy_update at zipf
             0.99 by three KNs: log_write_batch, merge_budget, and the
             round's reads through index_lookup_batch on the card (the
             pool's packed copy of its index, kernel A and the chain walk),
             each kernel-A launch held bit for bit to clht_probe_ref on
             its inputs, each read against the host index's walk and the
             last acknowledged write merged; every written key read back after
             merge_all, verify_integrity() empty; the same log merged into
             a slice-1 card table by merge_segment_planned (kernel D for
             its chain-growth tail) equal to the pool's index row for row

Then the cluster over such a pool (core/cluster.py), the reference's
dataplane cluster at 2^21 keys, by both batch engines:

  cluster    DinomoCluster (dinomo, 4 KNs, 1 KB values, segments of 512,
             each KN's cache 3 % of the dataset) loaded warm and copied;
             the host leg runs execute_batch with the host engine, the
             jit leg with engine="jit" (every KN's eligible window of an
             advance step in one launch of kernel E over the KNs' states,
             kept on the card across batches, only the changed slots
             moved; core/jit_engine.py). Both take YCSB write_heavy_update and
             read_mostly_update at zipf 0.99, 8 batches of 2^14 ops each,
             with the DPM merging between batches, a KN added and kn2
             failed between batches; every BatchResult equal between the
             legs and, after each mix and reconfiguration, their
             aggregate_stats() and snapshots; each batch's cache-miss
             reads probed on the card (index_lookup_batch, kernel A, once
             per KN), each launch held bit for bit to clht_probe_ref; the
             first kernel-E launch of each KN in each mix held bit for
             bit to fused_window_ref (each KN's job of a launch on its
             own); per mix the jit leg's upload and scatter-back seconds
             and bytes beside both legs' ops/s; one jit write-heavy batch
             profiled;
             every written key read back on both; verify_integrity()
             empty; no data moved; the same configuration at 2^16 keys
             held batch for batch to its per-op twin
             (reference_cache=True) by both engines on the card, every
             kernel-E launch there held to fused_window_ref
  cluster_variants
             the paper's baselines on the same configuration and streams,
             each taking a copy of the cluster phase's pool as loaded
             (kept pickled, out of the garbage collector's walks):
             dinomo-s (static shortcut-only caches, windows planned by
             plan_static_window) and clover (shared everything: every
             batch reads the index for every op through kernel A, then
             lands its index updates on the host, which the next batch's
             sync_index uploads as changed rows), then read_only batches,
             a join and a failure; every kernel-A launch held to
             clht_probe_ref and every batched read to the host index's
             walk; the read-back, verify_integrity(), RTs an op ordered
             dinomo < dinomo-s < clover on write_heavy_update; each
             baseline at 2^16 keys held batch for batch to its per-op
             oracle on the card

and times kernel E on the largest window held (a KN window over 2^21
slots), beside the host engine's time for that window, on a window that
consumes victims from both trees and on the four KNs' first windows in
one launch; then the gather, scatter and guard kernels that move a
resident state's changed slots. Then the planes around the cluster:

  timed      the paper's Fig. 6 timeline (benchmarks/fig6_elasticity.py:
             YCSB write_heavy_update at zipf 0.5, 8e6/7 ops/s offered,
             8e6 for t in [30, 230] of 300 simulated s, dt 2, 2,000
             sampled ops a step, the M-node's policy) through
             TimedSimulation on three copies of the cluster phase's pool
             as loaded: dinomo by the host engine, dinomo by engine="jit"
             in lockstep with it (their newest TimePoints, statistics and
             reconfiguration records equal after every step, their
             snapshots after every join and removal), dinomo-n (the
             figure's contrast); joins and removals clear the
             participants' caches, whose reads then miss through kernel A,
             and block them for their outage (blocked_kns on the jit
             path); every kernel-A launch held to clht_probe_ref, the
             first kernel-E launch of each KN after each membership change
             to fused_window_ref; the written keys read back equal between
             the dinomo legs and to the pool's host walk, integrity on all
             three; then the open-loop request plane on the host leg at
             0.9x (poisson, bursty) and 1.5x of the estimated capacity,
             with bench_latency.py's gates
  scenarios  the scenario harness: run_suite's and run_overload's smoke
             rows on the card and on the CPU, equal; the full profile's
             composed rows (dinomo, dinomo-n, clover), zombie and
             overload on dinomo on the card, every violation list empty
             but composed on dinomo's, which holds exactly the
             reference's own post-recovery fault; kernel A every Clover
             batch, each launch held to clht_probe_ref

Then it runs qwen1.5-0.5b at its published widths (24 layers, d_model 1024, 16
heads, vocab 151,936; random bf16 weights from a seeded generator):

  prefill      build_model(CONFIG).prefill of 4 prompts x 2048 tokens
               (flash_attention, 24 launches a call)
  serve        PagedServer(cfg=CONFIG): 2 requests of 256-token prompts
               sharing a 128-token prefix, a worker added after the
               first (logits unchanged), 64 greedy decode steps each
               (cut: 2 requests, not 8, for the run's time)
               (paged_decode_attention, one launch a layer over the
               page owners' stacked tables)
  equivalence  the server's logits for a 256-token prompt (token by token
               through paged_decode_attention) against prefill's
               (flash_attention)

and times both attention kernels at the main path's shapes. Then the
attention families at head dim 128 (random bf16 weights from a seeded
generator; each model freed before the next is made):

  prefill_llama       llama3.2-3b at its published widths (28 layers,
                      d_model 3072, 24 heads over 8 kv heads of 128, vocab
                      128,256): build_model(CONFIG).prefill of 4 x 2048
                      (flash_attention at D = 128, 28 launches a call, each
                      layer's held to mha_ref), kernel 5 timed at layer 0's
                      views beside scaled_dot_product_attention
  dense_decode_llama  launch.steps.serve_step's three dense-cache decodes
                      (v1, v2, v3) at batch 4 from a 256-token prefill_step,
                      32 steps each on v1's greedy tokens (cut from 64):
                      the three within
                      2e-2 of max |logit| at every step, each within 5e-2
                      of forward's logits; one profiled step each
  serve_llama         PagedServer(cfg=CONFIG): 2 requests of 128 tokens
                      sharing 64 (cut from 4), a worker added after the
                      first, 32 greedy steps each (paged_decode_attention at group 3,
                      one stacked launch a layer); the server against
                      prefill on a 128-token prompt; kernel 6 timed
  moe_olmoe           olmoe-1b-7b at its published widths (16 layers,
                      d_model 2048, 16 heads of 128, 64 experts top-8):
                      prefill 4 x 2048 (16 launches a call, each held),
                      each layer's expert loads and choices dropped at
                      capacity; serve_step v3 for 32 greedy steps at batch 4
                      (capacity 1 an expert, as the reference computes it)
  widths_d128         internlm2-20b, nemotron-4-15b, chameleon-34b and
                      granite-moe-1b-a400m at their published widths cut to
                      2 layers: one prefill of 1 x 2048 each, every kernel-5
                      launch held to mha_ref

Last, mamba2-2.7b at its published widths (64 layers, d_model 2560, 80 SSD
heads of 64, state 128, vocab 50,280, tied embeddings; random bf16
weights from a seeded generator):

  check_ssd    ssd_scan against its plain versions at the sweep shapes of
               tests/test_kernels.py
  ssm_prefill  launch.steps.prefill_step of 4 prompts x 2048 tokens
               (ssd_scan, 64 launches a call); the kernel held against
               the plain chunked scan on every layer of one call and
               against the recurrence on layer 0, and the bar shown to
               catch the output of a kernel that lost the chunk carry
  ssm_decode   a 256-token prompt teacher-forced through serve_step
               against forward's logits, then 32 greedy steps for a
               batch of 4, and a profile of one step
  time_ssd     ssd_scan at prefill's layer-0 inputs

Then the last two families at their published widths (random bf16
weights from a seeded generator):

  hybrid_zamba2    zamba2-1.2b (38 mamba layers, d_model 2048, 64 SSD
                   heads of 64, N 64; one shared attention block of 32
                   heads of 64 and d_ff 8192 after every 6 layers: 6 sites,
                   2 tail layers; vocab 32,000): launch.steps.prefill_step
                   of 4 x 2048 tokens (38 ssd_scan and 6 causal
                   flash_attention launches a call, each of one call held
                   to its plain version); a 128-token prompt teacher-forced
                   through serve_step against forward, each mamba layer
                   and shared-block site in bf16 and the model in f32;
                   32 greedy steps at batch 4 after a 128-token prompt, a
                   profile of one step; kernel 7 timed at layer 0's inputs
                   and kernel 5 at the first shared-block site's views
                   beside scaled_dot_product_attention
  encdec_seamless  seamless-m4t-medium (12 + 12 layers, d_model 1024, 16
                   heads of 64, vocab 256,206; random frame embeddings,
                   the frontend being a stub): prefill_step on 4 x 1,500
                   frames and 4 x 256 tokens (12 non-causal encoder, 12
                   causal self and 12 non-causal cross flash_attention
                   launches a call, the cross ones at Sq 256 against
                   Sk 1,500, each of one call held to mha_ref, and the
                   bar shown to see a dropped ragged key tail); encode and
                   prepare_cross, then the 256 tokens teacher-forced at
                   batch 1 against forward; 32 greedy steps at batch 4;
                   kernel 5 timed at the first cross-attention's and the
                   first encoder layer's views beside
                   scaled_dot_product_attention

Every timing of kernel 5 also prints a "redesigned" line: its time beside
the time of the design it replaced at that view (BEFORE_SLICE22_MS) and
SDPA's. (The greedy decodes' 32 steps are cut from 64 for the run's time). Last,
training at the published widths: launch.steps.train_step (remat "full",
loss_chunk 512, AdamW with warmup_steps 1) on one fixed batch of 4 x 2048
tokens (cut: the prefill cells' batch, not the reference's TRAIN_4K 256 x
4096), 4 steps, the first with every kernel launch held to its plain
version as it returns (attn_path_bar, ssd_path_err), 2 timed (cut from 4:
the loop below times the same step), the last
profiled; the loss must fall and stay finite with every parameter; then
the gradients of the same model cut to a few layers, in f32 on 1 x 256
tokens, held on the card to the CPU's within 1e-4 of each leaf's max |g|:

  train_qwen    qwen1.5-0.5b (0.62 B parameters; 2 layers for the
                gradient hold): 48 flash_attention launches a step, each
                block's forward and its checkpointed recompute
  train_zamba2  zamba2-1.2b (1.17 B; 7 layers for the hold, one group
                and a tail layer): 76 ssd_scan launches a step and 6
                flash_attention (the shared block is not checkpointed)

On the card kernels 5 and 7 run the forward; their backward is the plain
versions' under autograd, as the reference's train step differentiates
its plain paths. Then training's loop around that step, at qwen1.5-0.5b's
published widths:

  train_loop  launch.train.train (smoke=False) on 4 x 2048 tokens a step
              from SyntheticLM through the Prefetcher, checkpoints in a
              temporary directory under build/ (removed after; the phase
              first asks for twice a checkpoint's 6.2 GB free): 12 steps
              with a failure injected after step 11, so one sealed
              checkpoint, step 10, written by the asynchronous flush while
              steps 11 and 12 run; then 5 steps resumed from it. The first
              step's 48 kernel-5 launches held to the plain version, 48 a
              step over the 17; the state the resumed run restores equal
              bit for bit to the one saved (each leaf on the card,
              serialized as the store writes it, with its segment's CRC);
              every loss and parameter finite. Timed: the steps, the
              prefetch waits and uploads, the save (its host copy, the
              flush by stage, the steps it overlaps) and the restore
              (validation and its CRC passes, the load, the upload)
  hot_rows    the trained embedding table (151,936 x 1,024 bf16): the
              loop's token ids counted, the M-node's rule (3 sigma, at most
              256 rows), build_replica; lookup of the next batch bit for
              bit the gather, is_hot np.isin; one more train_step changes
              the table (the stale replica must differ), then
              refresh_after_update and the lookup equal again; lookup
              timed beside the plain gather

Then the launch side: the dry run and the long sequences.

  dryrun        launch.dryrun.run_cell of the two long_context cells, cut
                as below, on the card's (1, 1) mesh, on meta tensors in two
                worker processes: their status, FLOPs and predicted peak
                memory, which long_context reads (the production cells run
                in `python -m repro_torch.launch.dryrun --all` and
                tests/test_torch_dryrun.py; nothing here reads them)
  long_context  qwen1.5-0.5b at its published widths through the launch
                layer's bundles: build_prefill_step at 1 x 32,768 tokens
                (PREFILL_32K's length; batch cut from 32), 24 kernel-5
                launches a call, causal over 32,768 keys; then
                build_train_step at 2 x 4,096 (TRAIN_4K's length; batch
                cut from 256), 3 steps, the first with every kernel-5
                launch held to the plain version (blocked_mha above 2048
                keys, as the backward recomputes) and 2 timed. Layer 0's
                launch of the prefill held to blocked_mha too; tokens/s,
                peak memory beside the dry run's prediction, the train
                step's FLOPs over its time as a share of 989 TFLOP/s, and
                kernel 5 timed at both views

Last, the multi-device paths (launch/mesh.py's mesh of ranks,
distributed/collectives.py) on the one card: NCCL at world size 1, joined
through a file:// store in a temporary directory, the (1, 1) mesh of ranks
on cuda:0 (a world of more ranks needs more cards; their partitions are
held on the CPU by gloo ranks in tests/test_torch_multi_rank.py):

  multi_rank  each collective kind the port issues (all_gather,
              reduce_scatter, all_to_all, all_reduce) through NCCL on a
              bf16 CUDA tensor, equal to its input at one rank;
              moe_ff_sharded on one olmoe-1b-7b MoE layer at its published
              widths (d 2048, 64 experts top-8, ff 1024, bf16) over 4 x 2048
              tokens against moe_ff on the same inputs (the same ops; their
              index_add_ sums in an unfixed order, so within MOE_PATH_BAR
              of max |y|), its drops and the collectives' calls and bytes;
              qwen1.5-0.5b at its published widths through the mesh-of-ranks
              build_train_step, 2 steps of 4 x 2048 tokens, against
              train_step from the same parameters and batch: step 1's loss
              and grad_norm within 1e-5 relative, step 2's loss within 2e-2,
              every kernel-5 launch of step 1 held to its plain version

Every failure raises. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels, each
with its launches summed over every phase that ran it.
Without a card, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from repro_torch import analysis  # noqa: E402
from repro_torch.analysis.passes import ALL_PASSES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import collectives, sharding  # noqa: E402
from repro_torch.distributed.sharding import make_rules  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.core import clht, log  # noqa: E402
from repro_torch.core.cluster import (DINOMO, VARIANTS,  # noqa: E402
                                      DinomoCluster, KVSNode, _WritePlan,
                                      apply_window_plan, warm_load)
from repro_torch.core.dac import (SHORTCUT_BYTES,  # noqa: E402
                                  VALUE_OVERHEAD_BYTES)
from repro_torch.core.dpm_pool import DPMPool  # noqa: E402
from repro_torch.core import scenarios as scen  # noqa: E402
from repro_torch.core.mnode import PolicyConfig  # noqa: E402
from repro_torch.core.netmodel import (DEFAULT_MODEL,  # noqa: E402
                                       ArrivalProcess)
from repro_torch.core.requestplane import RequestPlaneConfig  # noqa: E402
from repro_torch.core.simulate import TimedSimulation  # noqa: E402
from repro_torch.core.transition import (ENGINE_WALL,  # noqa: E402
                                         MERGE_PLAN_STATS, PLAN_STATS,
                                         plan_dac_window,
                                         reset_engine_wall,
                                         reset_merge_plan_stats,
                                         reset_plan_stats)
from repro_torch.data import Prefetcher, SyntheticLM, Workload  # noqa: E402
from repro_torch import embedding  # noqa: E402
from repro_torch import state as state_mod  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_mod  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import batch_executor  # noqa: E402
from repro_torch.kernels import cache_transition as transition  # noqa: E402
from repro_torch.kernels import clht_probe as probe  # noqa: E402
from repro_torch.kernels.clht_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import log_merge as merge  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.kvcache import paged_store  # noqa: E402
from repro_torch.kvcache.paged_store import decode_over_owners  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import PagedServer  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import (encdec, layers, mamba2, moe,  # noqa: E402
                                ssm_lm, transformer, zamba2)
from repro_torch.models.model_zoo import build_model, make_batch  # noqa: E402,E501
from torch_cases import (MERGE_CASES, TRANSITION_CASES,  # noqa: E402
                         merge_case, transition_case, window_victims_case)
from torch_cluster_cases import (cache_contents,  # noqa: E402
                                 cluster_snapshot, loaded_like, pool_index)

KEYS_LOG2 = 25              # the paper's 32 GB of 1 KB values
WIDTH = 256                 # int32 lanes per value row = 1 KB
ZIPF = 0.99
BATCH = 1 << 20             # keys or ops per load / served batch
BATCHES = 8                 # served batches per mix
REPS = 20                   # timed runs per kernel
SEED = 0
HBM_BYTES_PER_S = mesh_mod.HBM_BW      # H100 SXM device memory rate
BF16_FLOPS = mesh_mod.PEAK_FLOPS_BF16  # H100 SXM dense bf16 tensor rate
F32_FLOPS = 67e12           # H100 SXM f32 rate outside the tensor cores
SPIN_CYCLES = 2_000_000     # about 1 ms of device spin before a timed call

DPM_KERNELS = ("clht_probe", "kvs_lookup_fused", "log_merge_sorted",
               "clht_insert")
# one KN's planned DAC windows over the DPM pool: the paper's 1 GB KN cache
# against its 32 GB dataset (benchmarks/bench_dataplane.py:65-67)
KN_CACHE = 1 << 30
KN_MIXES = ("write_heavy_update", "read_mostly_update")
KN_OPS = 1 << 15            # ops per mix (cut from 2^16 for the run's time)
KN_BATCH = 1 << 13          # ops whose reads are probed and writes merged
KN_WINDOW = 512             # ops per planning chunk, as _run_window_at
KN_SEGMENT = 2048           # the reference's segments (a segcache holds 4)
KN_WRITE_BATCH = 8          # writes per amortized log flush (one RT)
VALUE_BYTES = WIDTH * 4
# the DPM pool phase: the port's DPMPool (host lists and index, its
# batched reads on the card) at 2^21 keys, not the paper's 2^25: a pool
# of Python lists at 2^25 keys would take minutes and gigabytes on the
# host, and at 2^22 the phase took up to 121 s of the smoke's time
POOL_KEYS_LOG2 = 21
POOL_SEGMENT = 512          # benchmarks/bench_dataplane.py:86's segments
POOL_LOAD_BATCH = 1 << 16   # keys per batched load write
POOL_KNS = ("kn1", "kn2", "kn3")     # a key's owner: key % 3
POOL_ROUNDS = 8
POOL_ROUND_OPS = 1 << 18    # YCSB ops per round over the three KNs
# the cluster phase: the reference's own dataplane cluster
# (benchmarks/bench_dataplane.py:83-88: dinomo, 4 KNs, 1 KB values,
# segments of 512, the paper's 1 GB cache against its 32 GB dataset) at
# the DPM pool phase's 2^21 keys, through DinomoCluster.execute_batch
CLUSTER_KEYS_LOG2 = 21
CLUSTER_KNS = 4
CLUSTER_SEGMENT = 512
CACHE_FRAC = 0.03
CLUSTER_MIXES = ("write_heavy_update", "read_mostly_update")
CLUSTER_BATCH = 1 << 14     # ops per execute_batch
CLUSTER_BATCHES = 8         # timed batches per mix
CLUSTER_RECONFIG_BATCHES = 2    # batches after each reconfiguration
CLUSTER_TWIN_KEYS_LOG2 = 16     # the per-op twin's keys
CLUSTER_TWIN_BATCHES = 2        # the first batches of each mix
# the paper's baselines on the cluster phase's configuration (the
# variant changed, as benchmarks/fig5_scalability.py compares them): the
# cluster phase's streams, then read_only batches
BASELINES = ("dinomo-s", "clover")
BASELINE_READ_BATCHES = 2
# the timed phase: the paper's Fig. 6 timeline (benchmarks/
# fig6_elasticity.py:24-41: YCSB write_heavy_update at zipf 0.5, 8e6/7
# ops/s, 8e6 over t in [30, 230], 300 simulated s at dt 2, 2,000 sampled
# ops a step, the 32 GB dataset's reorganization, the M-node's policy)
# over the cluster phase's dataset (2^21 keys loaded warm, 4 KNs, caches
# CACHE_FRAC of the data, segments of 512), then the open-loop request
# plane at bench_latency.py's near- and past-saturation points
TIMED_DURATION = 300.0
TIMED_DT = 2.0
TIMED_SAMPLE_OPS = 2000
TIMED_DATASET_BYTES = 32e9
TIMED_LOW, TIMED_HIGH = 8e6 / 7, 8e6
TIMED_BURST = (30.0, TIMED_DURATION - 70.0)
TIMED_ZIPF = 0.5
TIMED_MIX = "write_heavy_update"
TIMED_POLICY = {"grace_period_s": 30.0, "epoch_s": 10.0, "max_kns": 8,
                "min_kns": 2}
TIMED_LEGS = (("host", "dinomo", None), ("jit", "dinomo", "jit"),
              ("dinomo-n", "dinomo-n", None))
OPEN_LOOP_S = 2.0
OPEN_LOOP_POINTS = ((0.9, "poisson"), (0.9, "bursty"), (1.5, "poisson"))
# the scenarios phase: the reference's full-profile rows run on the card
# (benchmarks/bench_scenarios.py without --smoke); composed on dinomo
# ends with the reference's own post-recovery fault (ROADMAP Queue 3)
FULL_ROWS = (("composed", "dinomo"), ("composed", "dinomo-n"),
             ("composed", "clover"), ("zombie", "dinomo"))
REFERENCE_FAULT = ("composed", "dinomo",
                   "post-recovery: index key 7326: dead value row ")
ARCH = "qwen1.5-0.5b"
PREFILL_B, PREFILL_S, PREFILL_REPS = 4, 2048, 3
# 2 requests, cut from 8 for the run's time: every request's shape, the
# worker join's place before the last admission, and the held and timed
# decode step (the last request's, 3 owners over 41 slots) are as before
SERVE_REQUESTS, PROMPT, SHARED, DECODE_STEPS = 2, 256, 128, 64
PAGE_SIZE, NUM_PAGES = 8, 4096
RECONFIG_AFTER = 1          # requests admitted before w2 joins
DECODE_B, DECODE_CTX = 64, 2048     # kernel 6 at a batched decode shape
# the attention families at head dim 128: llama3.2-3b (dense, 24 heads over
# 8 kv heads) and olmoe-1b-7b (MoE, 64 experts top-8) at their published
# widths, and four more configs cut to WIDTH_LAYERS layers
LLAMA = "llama3.2-3b"
OLMOE = "olmoe-1b-7b"
# the paged server at llama's widths: fewer and shorter requests than the
# qwen serve cell (it admits token by token, about 70 ms a token)
# (2 requests, cut from 4 as the qwen cell's from 8, w2 after the first)
LLAMA_REQUESTS, LLAMA_PROMPT, LLAMA_SHARED = 2, 128, 64
LLAMA_DECODE_STEPS, LLAMA_RECONFIG_AFTER, LLAMA_NUM_PAGES = 32, 1, 256
SERVE_CUT = ("requests cut (qwen's 8 to 2, llama's 4 to 2) for the run's "
             "time; each request's shape and the held decode step kept")
# the dense-cache decodes (steps.serve_step, optimized False / "v2" / "v3")
DENSE_B, DENSE_PROMPT, DENSE_STEPS = 4, 256, 32     # steps cut from 64
DENSE_IMPLS = (False, "v2", "v3")
# max |diff| / max |logit| between two decode implementations fed the same
# tokens: the reference's own bar (tests/test_perf_variants.py)
DECODE_IMPL_TOL = 2e-2
MOE_DECODE_STEPS = 32
WIDTH_ARCHS = ("internlm2-20b", "nemotron-4-15b", "chameleon-34b",
               "granite-moe-1b-a400m")
WIDTH_LAYERS, WIDTH_SEQ = 2, 2048
SSM_ARCH = "mamba2-2.7b"
SSM_B, SSM_S, SSM_REPS = 4, 2048, 3     # prefill prompts x tokens, calls
SSM_CHUNK = 64
TF_PROMPT = 256                         # teacher-forced decode tokens
GREEDY_B, GREEDY_STEPS = 4, 32        # steps cut from 64 for the time
STEPS_CUT = "decode steps cut from 64 to 32 for the run's time"
# the hybrid and encoder-decoder families at their published widths:
# zamba2-1.2b's prefill, its teacher-forced prompt (also the greedy
# batch's prompt); seamless-m4t-medium's 30 s of audio at 20 ms a frame
# and its decoder tokens
ZAMBA = "zamba2-1.2b"
HYBRID_B, HYBRID_S, HYBRID_REPS, HYBRID_TF = 4, 2048, 3, 128
# the long-sequence cells of qwen1.5-0.5b at its published widths, through
# the launch layer's bundles: PREFILL_32K's length at batch 1 (cut from
# 32), 2 timed calls after a warm-up; TRAIN_4K's length at batch 2 (cut
# from 256), one held step and 2 timed
LONG_PREFILL_B, LONG_PREFILL_S, LONG_PREFILL_REPS = 1, 32768, 2
LONG_TRAIN_B, LONG_TRAIN_S, LONG_TRAIN_STEPS = 2, 4096, 2
LONG_CUT = (f"prefill {LONG_PREFILL_B} x {LONG_PREFILL_S} (PREFILL_32K's "
            f"batch cut from 32), train {LONG_TRAIN_B} x {LONG_TRAIN_S} "
            "(TRAIN_4K's batch cut from 256), one fixed batch")
# the dry run's cells on the card's host: the two that long_context reads
# (the 40 production cells take 68-71 s over 8 processes on a CPU, and the
# CLI and tests/test_torch_dryrun.py run them)
DRYRUN_CUT = ("long_context's two cut cells on the (1, 1) mesh; the "
              "production cells left to the CLI and the CPU tests")
# the multi-device paths at world size 1 over NCCL: olmoe-1b-7b's MoE layer
# at its published widths on MULTI_B x MULTI_S tokens, and qwen1.5-0.5b's
# train step on the same count, MULTI_STEPS steps
MULTI_B, MULTI_S, MULTI_STEPS = 4, 2048, 2
# moe_ff_sharded against moe_ff, in max |diff| / max |y|: the same ops on
# the same inputs, but index_add_ adds each token's 8 bf16 contributions
# with atomics in an unfixed order (a few bf16 ulps of a partial sum)
MOE_PATH_BAR = 2.0 ** -6
# step 1's loss and grad_norm (relative), step 2's loss (absolute, the
# reference's sharded-step bar, tests/test_system.py:126)
STEP1_TOL, STEP2_TOL = 1e-5, 2e-2
# the rest of the multi-device paths on the (1, 1) mesh of ranks: the
# prefill bundles on MULTI_B x MULTI_S tokens and MULTI_DECODE steps of
# the decode bundles after them; the SSD carry over MULTI_PIECES pieces
# of mamba2's layer-0 sequence; qwen's decode with its cache cut into
# MULTI_PIECES owners, within OWNERS_TOL of max |logit| of the whole-cache
# step (DECODE_IMPL_TOL, the bar between two decode implementations)
MULTI_DECODE, MULTI_PIECES = 16, 4
OWNERS_TOL = DECODE_IMPL_TOL
SEAMLESS = "seamless-m4t-medium"
ENC_B, ENC_FRAMES, ENC_TOKENS, ENC_REPS = 4, 1500, 256, 3
# training: qwen1.5-0.5b and zamba2-1.2b at their published widths, steps
# of launch/steps.py:train_step (remat "full", loss_chunk 512, AdamW with
# warmup_steps 1) on one fixed batch of TRAIN_B x TRAIN_S tokens, the
# prefill cells' batch (cut from the reference's TRAIN_4K, 256 x 4096):
# one step held, TRAIN_STEPS timed (cut from 4: train_loop times the same
# step 15 more times) and one profiled
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 2
TRAIN_CUT = (f"batch {TRAIN_B} x {TRAIN_S} tokens, the prefill cells', not "
             f"TRAIN_4K's 256 x 4096; one fixed batch; {TRAIN_STEPS} timed "
             "steps, cut from 4")
# the gradients on the card held to the CPU's at a cut depth and full
# width, in f32 (TF32 off), on 1 x 256 tokens: qwen at 2 layers, zamba2 at
# 7 (one group of 6 with its shared-block site, and one tail layer); every
# leaf within TRAIN_GRAD_TOL of its max |g|, the loss within it too
TRAIN_HOLD_B, TRAIN_HOLD_S = 1, 256
TRAIN_HOLD_LAYERS = {ARCH: 2, ZAMBA: 7}
TRAIN_GRAD_TOL = 1e-4
# training's loop (launch/train.py): qwen1.5-0.5b at its published widths,
# the reference's test_system.py drive at TRAIN_B x TRAIN_S tokens: 12 steps
# with a failure injected after step 11 (one sealed checkpoint, step 10),
# then 5 steps resumed from it; a log line every 5 steps
LOOP_STEPS, LOOP_FAIL_AT, LOOP_RESUME_STEPS, LOOP_LOG_EVERY = 12, 11, 5, 5
LOOP_RESUME_AT = 10
LOOP_CUT = (f"batch {TRAIN_B} x {TRAIN_S} tokens, as the train cells; the "
            "reference test's 12 + 5 steps and its one checkpoint")
# the hot-row replica of the trained embedding table (the M-node's rule)
HOT_K_SIGMA, HOT_MAX_ROWS = 3.0, 256
# the two attention kernels' times in the design they replace (commit
# 6166d87: kernel 5 on mma.sync, kernel 6 one block per (row, kv head),
# one launch per page owner), measured by this script on the same seeded
# inputs on an NVIDIA H100 80GB HBM3 at 700 W; printed beside the new
# times
BEFORE = "commit 6166d87, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_MS = {"flash_attention": 0.45325759798288345,
             "paged_decode_attention": 0.017422399949282408,
             "paged_decode_attention_64x2048": 0.4994655936956406}
# kernel 5 at each main-path view in the design the warp-specialised one
# replaces (commit db81ff5: one producer warp, 64-key tiles, a block a query
# block, each product waited for at once), measured by tools/ab_attention.py
# against that commit (the baseline's mean of two runs of 20 CUDA-event
# timings, seeded random views of the same shapes) on an NVIDIA H100 80GB
# HBM3 at 700 W; printed beside the new times
BEFORE_SLICE22 = "commit db81ff5, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_SLICE22_MS = {"flash_attention": 0.10741840042173861,
                     "flash_attention_d128": 0.2799752004444599,
                     "flash_attention_cross": 0.03078400008380413,
                     "flash_attention_32k": 5.490009605884552,
                     "flash_attention_4k_train": 0.19935119934380052,
                     "flash_attention_encoder": 0.12043840046972036,
                     "flash_attention_zamba2": 0.2131800003349781}
# kernels 7 and D in the design they replace (commit 61d41b4: kernel 7 on
# the f32 CUDA cores, kernel D one thread over the batch), measured by this
# script at the same shapes on an NVIDIA H100 80GB HBM3 at 700 W
BEFORE_SLICE6 = "commit 61d41b4, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_SLICE6_MS = {"ssd_scan": 2.857639992237091,
                    "clht_insert": 11.547859191894531,
                    "clht_insert_write_batch": 6.395474}
# kernels C and 4 in the design they replace (commit 9bd28d4: kernel C one
# thread per bucket group, kernel 4 one thread reading each row and victim
# as its turn comes), measured by this script at the same shapes on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6)
BEFORE_SLICE7 = "commit 9bd28d4, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_SLICE7_MS = {"log_merge_sorted": 3.098, "cache_transition": 0.0792}
# kernel A in the design it replaces (commit ae9bb1d: one thread a key,
# the line as two 16-byte loads), measured by this script at the same
# shape on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6)
BEFORE_SLICE8 = "commit ae9bb1d, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_SLICE8_MS = {"clht_probe": 0.0291}
# kernel E in the design it replaces (commit 996280b: one KN a launch on one
# warp, each op's entry read and its tree paths repaired as it ran), on the
# cluster phase's kn2 first write-heavy window (3,073 ops over 2^21 slots,
# the same seeded window time_fused_window times), measured by this script
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6)
BEFORE_SLICE10 = "commit 996280b, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_SLICE10_MS = {"fused_window": 3.61, "fused_window_ops": 3073}
# the victim-consuming window time_fused_window times: ops over the
# cluster's 2^21 slots, from a cache of as many values (then 2^19
# shortcuts; tests/torch_cases.py:window_victims_case), so that its
# make-spaces demote every value and then evict shortcuts
VICTIM_WINDOW_OPS = 2048
VICTIM_WINDOW_VALUES = 32
# stated tolerances (atol = rtol), see tests/test_torch_cuda.py
TOL = {torch.float32: {"flash_attention": 3e-5,
                       "paged_decode_attention": 2e-5, "ssd_scan": 3e-4},
       torch.bfloat16: {"flash_attention": 2.5e-2,
                        "paged_decode_attention": 3e-2, "ssd_scan": 4e-2}}
# max |diff| / max |logit| between two paths of the model (server vs
# prefill, before vs after a worker joins), the bar of
# tests/test_serve_equivalence.py: where the two paths round one bf16
# attention element differently, 24 random layers carry the flip to
# about 1e-2 (the reconfig phase measures this witness in every run)
LOGIT_TOL = 5e-2
# kernel 7 against its plain version on the main path's bf16 inputs. Both
# compute y in f32 from the same inputs and round it to bf16 once, so they
# may part by one unit in y's last place: at most 2^-7 of |y|, or 2^-8 of
# a layer's max |y| where y is near 0. The sweep shapes' 4e-2 is too loose
# here: at prefill's shapes a layer's max |y| is about 1, and the state
# carried between chunks moves y by only 1.5e-2 to 4.9e-2 (lost_carry), so
# a kernel that dropped that term would pass 4e-2 on every layer
SSD_PATH_RTOL = 2 ** -7
SSD_PATH_ATOL_OF_MAX = 2 ** -8
# kernel 5 against mha_ref on the main path's bf16 views. mha_ref computes
# in f32 and rounds its output to bf16 once. The kernel rounds each p to
# bf16 for P.V (at most 2^-9 of each term p v, so at most 2^-9 of the
# softmax average of |v|, sum(p |v|) / l) and its output to bf16 once (one
# unit in the last place, at most 2^-7 of |out|). The bar is twice the
# first and the second: atol 2^-8 of the softmax average of |v|, rtol
# 2^-7. TOL's fixed 2.5e-2 is about the size of what it compares here: over
# 1,500 keys of unit-variance q, k and v each output is about N(0, 0.04),
# so a kernel that dropped the ragged last 28 keys (1,500 = 23 x 64 + 28)
# would pass it on most elements (tail_fault)
ATTN_PATH_RTOL = 2 ** -7
ATTN_PATH_ATOL_OF_ABS = 2 ** -8
# the same comparison for mamba2 in f32 (weights and activations), where
# the two paths differ only in the order of f32 sums (about 1e-5 of max
# |logit| on an H100): far below the bf16 floor, so a path that computed
# another function would show
F32_LOGIT_TOL = 1e-4


def decode_y(args, out) -> torch.Tensor:
    """mamba_decode's or attention_decode's output for one token, (d,), as
    recorded."""
    return out[0][0, 0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def redesigned(view: str, row: dict) -> None:
    """Kernel 5's time at one view beside its time in the design it
    replaces (BEFORE_SLICE22_MS) and SDPA's."""
    emit({"redesigned": "flash_attention", "view": view, "ms": row["ms"],
          "before_ms": BEFORE_SLICE22_MS[view],
          "sdpa_ms": row["library_ms"], "bound_ms": row["bound_ms"],
          "before": BEFORE_SLICE22})


def value_rows(keys: torch.Tensor, versions: torch.Tensor) -> torch.Tensor:
    """Value rows as a fixed integer hash of (key, version, lane), so any
    read can be checked by regenerating its row."""
    k = keys.to(torch.int64)[:, None]
    v = versions.to(torch.int64)[:, None]
    lane = torch.arange(WIDTH, dtype=torch.int64, device=keys.device)[None]
    h = (k * 0x9E3779B1) ^ (v * 0x85EBCA77) ^ (lane * 0xC2B2AE3D)
    return ((h ^ (h >> 15)) & 0x7FFFFFFF).to(torch.int32)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over matching integer outputs; raises on
    any difference of shape or value (the kernels must be exact)."""
    worst = 0
    for name, got, ref in pairs:
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        diff = (got.to(torch.int64) - ref.to(torch.int64)).abs()
        err = int(diff.max()) if diff.numel() else 0
        if err:
            bad = int((diff != 0).sum())
            raise AssertionError(f"{name}: {bad} elements differ from the "
                                 f"plain version (max |diff| {err})")
        worst = max(worst, err)
    return worst


def close_err(pairs, tol: float, atol: float | None = None) -> float:
    """Largest |kernel - plain| over matching float outputs; raises where
    an element is outside rtol = ``tol`` and atol (``tol`` unless given)
    or not finite."""
    atol = tol if atol is None else atol
    worst = 0.0
    for name, got, ref in pairs:
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite output")
        diff = (got - ref).abs()
        bad = int((diff > atol + tol * ref.abs()).sum())
        err = float(diff.max()) if diff.numel() else 0.0
        if bad:
            raise AssertionError(f"{name}: {bad} elements outside atol "
                                 f"{atol}, rtol {tol} (max |diff| {err})")
        worst = max(worst, err)
    return worst


def ssd_path_atol(ref: torch.Tensor) -> float:
    return SSD_PATH_ATOL_OF_MAX * float(ref.float().abs().max())


def ssd_path_err(pairs) -> float:
    """close_err for kernel 7 on the main path's inputs, at the bar of
    SSD_PATH_RTOL and SSD_PATH_ATOL_OF_MAX."""
    return max(close_err([(name, got, ref)], SSD_PATH_RTOL,
                         ssd_path_atol(ref)) for name, got, ref in pairs)


def attn_plain(qkv, causal: bool, keys=None) -> torch.Tensor:
    """Kernel 5's plain version (plain_attention: mha_ref, or blocked_mha
    above 2048 keys in blocks of 1024) on (q, k, v) in model layout
    (B, S, H|KH, D), in that layout; only the first ``keys`` keys when
    given."""
    q, k, v = (t.transpose(1, 2) for t in qkv)
    if keys is not None:
        k, v = k[:, :, :keys], v[:, :, :keys]
    return flash.plain_attention(q, k, v, causal).transpose(1, 2)


def attn_path_bar(ref: torch.Tensor, qkv, causal: bool) -> torch.Tensor:
    """Kernel 5's bar on the main path's views, element by element: rtol
    ATTN_PATH_RTOL and atol ATTN_PATH_ATOL_OF_ABS of the softmax average
    of |v| (the same softmax over |v|)."""
    q, k, v = qkv
    return ATTN_PATH_ATOL_OF_ABS * attn_plain((q, k, v.abs()), causal) \
        .float() + ATTN_PATH_RTOL * ref.float().abs()


def attn_path_err(pairs, qkv, causal: bool) -> float:
    """Largest |kernel - plain| over kernel 5's outputs on the main path's
    views ``qkv``; raises where an element is outside attn_path_bar or
    not finite."""
    worst = 0.0
    for name, got, ref in pairs:
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                 f"{tuple(ref.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        bad = int((diff > attn_path_bar(ref, qkv, causal)).sum())
        err = float(diff.max()) if diff.numel() else 0.0
        if bad:
            raise AssertionError(
                f"{name}: {bad} elements outside rtol {ATTN_PATH_RTOL} and "
                f"atol {ATTN_PATH_ATOL_OF_ABS} of the softmax average of "
                f"|v| (max |diff| {err})")
        worst = max(worst, err)
    return worst


def row_rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest over rows (T, d) of max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def paged_case(g, b, p, npages, ps):
    """Random page tables as tests/test_kernels.py builds them: each
    sequence uses 1..p distinct pages, the rest of its slots are -1, and
    its length ends inside its last page. Returns numpy int32 arrays."""
    pt = np.full((b, p), -1, np.int32)
    pos = np.zeros((b, p), np.int32)
    lens = np.zeros((b,), np.int32)
    for bi in range(b):
        used = g.integers(1, p + 1)
        pt[bi, :used] = g.choice(npages, used, replace=False)
        pos[bi, :used] = np.arange(used) * ps
        lens[bi] = (used - 1) * ps + g.integers(1, ps + 1)
    return pt, pos, lens


def device_summary(prof, wall: float) -> dict:
    """Device time by kernel from a torch.profiler run, and the device's
    busy share of ``wall`` seconds. It walks the profiler's raw device
    events: building its event tree for a train step's tens of thousands
    of launches takes seconds."""
    kernels: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            k = kernels.setdefault(e.name()[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.duration_ns() / 1e6
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3),
            "launches": sum(c for c, _ in kernels.values()),
            "top": [{"name": name, "calls": c, "device_ms": ms}
                    for name, (c, ms) in top]}


def synced(fn, *args):
    """(fn(*args), seconds on the host clock), synchronized on both
    sides so the device work is inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, setup=None):
    """(mean device ms of ``fn(*setup())`` over ``reps`` runs, the last
    run's output), from CUDA events around each call (``setup`` runs
    outside the timed region). Each call is queued behind about 1 ms of
    device spin, so the events time the device's work and not the
    host's launching of it."""
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        out = fn(*args)
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps, out


@contextlib.contextmanager
def recorded(module, name: str, replace=None, clone=False, pick=None):
    """Record the calls of ``module.name`` made inside the block, as a
    list of (positional args, output); ``replace`` maps a call's index to the
    output returned in place of the real one; ``clone`` keeps a copy of a
    tuple of tensors as it was returned (the caller may write into it);
    ``pick`` keeps ``pick(args, output)`` of each call instead (what a long
    run needs of it)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if pick is not None:
            calls.append(pick(args, out))
        else:
            calls.append((args, tuple(t.clone() for t in out) if clone
                          else out))
        return (replace or {}).get(len(calls) - 1, out)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def gc_meter():
    """The cyclic garbage collector's passes inside the block: the seconds
    they took and their count by generation."""
    m = {"s": 0.0, "collections": [0, 0, 0]}
    start = [0.0]

    def meter(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            m["s"] += time.perf_counter() - start[0]
            m["collections"][info["generation"]] += 1

    gc.callbacks.append(meter)
    try:
        yield m
    finally:
        gc.callbacks.remove(meter)


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block (checks of the main path, not the
    main path) leave the launch counts as they were."""
    saved = dict(_build.launches)
    try:
        yield
    finally:
        _build.launches.update(saved)


@contextlib.contextmanager
def held_probes(what: str):
    """Hold every kernel-A launch made inside the block to clht_probe_ref
    on the same lines, bucket ids and keys, bit for bit, as the launch
    returns (before the chain walk or the next index sync writes into
    them). Yields a dict whose ``checked`` counts the launches held and
    ``s`` the checks' seconds (for the caller to leave out of its time);
    calls that launch nothing (the plain version, on CPU tensors) are
    left alone."""
    real = probe_ops.clht_probe
    m = {"checked": 0, "s": 0.0}

    def wrapper(*args):
        launched = _build.launches["clht_probe"]
        out = real(*args)
        if _build.launches["clht_probe"] != launched:
            t0 = time.perf_counter()
            want_p, want_f = probe.clht_probe_ref(*args)
            if not (torch.equal(out[0], want_p)
                    and torch.equal(out[1], want_f)):
                raise AssertionError(f"{what}: a kernel-A launch disagrees "
                                     f"with clht_probe_ref")
            m["checked"] += 1
            m["s"] += time.perf_counter() - t0
        return out

    probe_ops.clht_probe = wrapper
    try:
        yield m
    finally:
        probe_ops.clht_probe = real


def probe_batch(table, keys: np.ndarray):
    """Batched index reads of ``keys`` on the card, as the DPM pool's
    index_lookup_batch makes them (kernel A on the primary lines, the
    chain walk for keys that missed a chained line). Returns (ptrs, lines
    walked, primary buckets), numpy, ptr -1 absent."""
    kd = torch.from_numpy(keys.astype(np.int32)).to(table.lines.device)
    ptrs, walked = probe.lookup_walk(table, kd)
    return (ptrs.cpu().numpy().astype(np.int64), walked.cpu().numpy(),
            clht.bucket_of(kd, table.num_buckets).cpu().numpy())


def _last_writes(keys: np.ndarray) -> np.ndarray:
    """Positions of each distinct key's last occurrence in ``keys``."""
    _, first = np.unique(keys[::-1], return_index=True)
    return keys.size - 1 - first


def _read_back_keys(last: np.ndarray):
    """A cluster's read-back: every written key (``last``: the global
    index of its last acknowledged write, -1 for none) and 2^12 unwritten
    keys, with what each must read (f"w{index}", or its loaded value
    f"v{key}"). Returns (written, unwritten, keys, want)."""
    written = np.flatnonzero(last >= 0)
    unwritten = np.flatnonzero(last < 0)[:1 << 12]
    want = [f"w{g}" for g in last[written].tolist()] + \
        [f"v{k}" for k in unwritten.tolist()]
    return written, unwritten, np.concatenate([written, unwritten]), want


class PoolView:
    """The slice-1 DPM pool as plan_dac_window reads it: one key's live
    index walk (``index_lookup`` -> (ptr or None, lines walked)), the
    values' lengths (``heap_len``; every value is 1 KB) and the log's
    segment size (a KN's segcache holds 4 segments)."""

    segment_capacity = KN_SEGMENT

    class _Lengths:
        def __getitem__(self, ptr):
            return VALUE_BYTES

    def __init__(self, table):
        self.table = table
        self.heap_len = self._Lengths()

    def index_lookup(self, key: int):
        ptr, walked, _ = probe_batch(self.table, np.array([key]))
        return (None if ptr[0] < 0 else int(ptr[0])), int(walked[0])


class Smoke:
    def __init__(self):
        self.dev = torch.device("cuda")
        self.errors: dict[str, int] = {}
        # each kernel's launches on the main path, summed over the phases
        # (tally), and each phase's own
        self.counts = dict.fromkeys(_build.KERNELS, 0)
        self.phase_counts: dict[str, dict] = {}
        # kernel vs plain on every launch of one main-path call (prefill,
        # a decode step)
        self.path_err: dict[str, float] = {}
        # each training phase's median step seconds
        self.train_step_s: dict[str, float] = {}

    def tally(self, phase: str, counts: dict) -> None:
        """Add a phase's main-path launches (counted from 0 just before
        it ran) to the kernels' totals."""
        self.phase_counts[phase] = {k: c for k, c in counts.items() if c}
        for k, c in counts.items():
            self.counts[k] += c

    def clone_table(self, t):
        return clht.CLHT(lines=t.lines.clone(),
                         overflow_head=t.overflow_head.clone(),
                         num_buckets=t.num_buckets)

    # ---------------------------------------------------------------- 1-2
    def environment(self) -> str:
        emit({"torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]})
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        self.card = smi
        cap = torch.cuda.get_device_capability(0)
        emit({"device": torch.cuda.get_device_name(0), "capability": cap})
        if cap != (9, 0):
            raise RuntimeError(f"needs an sm_90 card, found {cap}")
        return smi

    def static_analysis(self) -> None:
        """The port's six AST passes over this checkout, in this process;
        any finding stops the run."""
        t0 = time.perf_counter()
        corpus = analysis.Corpus(ROOT)
        findings = analysis.run_passes(corpus, ALL_PASSES)
        if findings:
            raise AssertionError("static analysis findings:\n" + "\n".join(
                f.render() for f in findings))
        emit({"phase": "static_analysis", "findings": 0,
              "passes": len(ALL_PASSES), "files": corpus.files_read,
              "s": time.perf_counter() - t0})

    def build_kernels(self) -> None:
        t0 = time.perf_counter()
        _build.build()
        so = _build.library_path()
        build_log = so.with_suffix(".log")
        regs = [ln.strip() for ln in
                (build_log.read_text().splitlines()
                 if build_log.exists() else [])
                if "registers" in ln or "spill" in ln]
        emit({"build_s": round(time.perf_counter() - t0, 3),
              "library": str(so.relative_to(ROOT)), "ptxas": regs})

    # ------------------------------------------------------------------ 3
    def check_kernels(self) -> None:
        g = np.random.default_rng(SEED)
        dev = self.dev
        # A and B: 2^16 buckets, 2^18 keys, chains and an exhausted
        # overflow region
        nb, nk = 1 << 16, 1 << 18
        keys = torch.from_numpy(g.choice(1 << 24, nk, replace=False)
                                .astype(np.int32)).to(dev)
        table = clht.clht_init(nb, device=dev)
        heap = log.heap_init(nk, WIDTH, device=dev)
        heap, ptrs = log.heap_append(
            heap, value_rows(keys, torch.zeros_like(keys)))
        clht.clht_insert(table, keys, ptrs)
        miss = torch.from_numpy(g.integers(1 << 24, 1 << 25, nk // 2 - 8)
                                .astype(np.int32)).to(dev)
        pk = torch.cat([keys[:nk // 2], miss,
                        torch.full((8,), -1, dtype=torch.int32, device=dev)])
        pk = pk[torch.from_numpy(g.permutation(nk)).to(dev)].contiguous()
        bids = clht.bucket_of(pk, nb)
        got = probe.clht_probe(table.lines, bids, pk)
        ref = probe.clht_probe_ref(table.lines, bids, pk)
        # the full lookups against the chain walk on real keys only (a
        # negative key matches empty slots in the reference's chain walk)
        real = pk[pk >= 0].contiguous()
        full = probe.lookup(table, real)
        walk = clht.clht_lookup(table, real)[:2]
        self.errors["clht_probe"] = max_abs_err(
            [("ptrs", got[0], ref[0]), ("found", got[1], ref[1]),
             ("lookup.ptrs", full[0], walk[0]),
             ("lookup.found", full[1], walk[1])])
        got = probe.kvs_lookup_fused(table.lines, heap.data, bids, pk)
        ref = probe.kvs_lookup_fused_ref(table.lines, heap.data, bids, pk)
        full = probe.kvs_lookup(table, heap, real)
        oracle = probe.kvs_lookup_ref(table, heap, real)
        self.errors["kvs_lookup_fused"] = max_abs_err(
            [(n, a, b) for n, a, b in zip(
                ("vals", "ptrs", "found", "kvs_lookup.vals",
                 "kvs_lookup.ptrs", "kvs_lookup.found"),
                got + full, ref + oracle)])
        assert bool(full[2].any()) and not bool(full[2].all())

        # C: ~2^15 entries with duplicates and full buckets
        nb = 1 << 12
        table = clht.clht_init(nb, device=dev)
        pre = torch.from_numpy(g.integers(0, 4 * nb, nb).astype(np.int32))
        clht.clht_insert(table, pre.to(dev), pre.to(dev) + 7000)
        ek = torch.from_numpy(g.integers(0, 4 * nb, 1 << 15)
                              .astype(np.int32)).to(dev)
        ek[::97] = -3
        ep = torch.arange(1 << 15, dtype=torch.int32, device=dev)
        eb = clht.bucket_of(torch.clamp(ek, min=0), nb)
        bs, order, starts = merge.sort_by_bucket(eb)
        ks, ps = ek[order].contiguous(), ep[order].contiguous()
        lk, lr = table.lines.clone(), table.lines.clone()
        got = merge.log_merge_sorted(lk, starts, bs, ks, ps)
        ref = merge.log_merge_sorted_ref(lr, starts, bs, ks, ps)
        # log_merge against the entry-at-a-time oracle, which knows no
        # padding keys
        pos = ek >= 0
        lo = table.lines.clone()
        _, o1, k1 = merge.log_merge(lo, eb[pos], ek[pos], ep[pos])
        l2, o2, k2 = merge.log_merge_ref(table.lines, eb[pos], ek[pos],
                                         ep[pos])
        self.errors["log_merge_sorted"] = max_abs_err(
            [("lines", lk, lr), ("old", got[0], ref[0]),
             ("ok", got[1], ref[1]), ("log_merge.lines", lo[:, :7], l2[:, :7]),
             ("log_merge.old", o1, o2), ("log_merge.ok", k1, k2)])
        assert not bool(got[1].all())        # some buckets were full
        # C on tests/torch_cases.py's adversarial groups (hot keys, more new
        # keys than empty slots, keys -1 and -3, a key twice in a line,
        # clamped bucket ids), each pattern in groups on both paths
        checks = []
        for name in MERGE_CASES:
            lines, *rest = (torch.from_numpy(x).to(dev)
                            for x in merge_case(name))
            lk, lr = lines.clone(), lines.clone()
            got = merge.log_merge_sorted(lk, *rest)
            ref = merge.log_merge_sorted_ref(lr, *rest)
            checks += [(f"{name}.{o}", a, b) for o, a, b in
                       zip(("lines", "old", "ok"), (lk, *got), (lr, *ref))]
        self.errors["log_merge_sorted"] = max(
            self.errors["log_merge_sorted"], max_abs_err(checks))

        # D: chain growth and overflow exhaustion (64 overflow buckets)
        table = clht.clht_init(1 << 10, 64, device=dev)
        dk = torch.from_numpy(g.integers(0, 1 << 13, 1 << 13)
                              .astype(np.int32)).to(dev)
        dp = torch.arange(1 << 13, dtype=torch.int32, device=dev)
        dm = torch.from_numpy(g.random(1 << 13) < 0.95).to(dev)
        tk, tr = self.clone_table(table), self.clone_table(table)
        got = clht.clht_insert(tk, dk, dp, dm)
        ref = clht.clht_insert_plain(tr, dk, dp, dm)
        self.errors["clht_insert"] = max_abs_err(
            [("lines", tk.lines, tr.lines),
             ("overflow_head", tk.overflow_head, tr.overflow_head),
             ("old", got[1], ref[1]), ("ok", got[2], ref[2]),
             ("num_new", got[3], ref[3])])
        assert int(tk.overflow_head) == tk.total_buckets   # exhausted
        assert not bool(got[2][dm].all())

        # 4: tests/test_kernels.py's random windows, and promotes whose
        # Eq. 1 deficit is negative and not a multiple of 32 with the zero
        # count at the truncated quotient (floor division refuses them)
        pairs = []
        for n, seed in ((256, 0), (512, 1)):
            opk = g.choice([0, 0, 0, 1, 1, 2], n)
            rows = transition.encode_window(
                opk, g.choice([0, 1, 2], n), g.choice([0, 0, 1, 5], n),
                g.choice([64, 128, 256], n), value_bytes=128)
            vic = g.choice([104, 168, 296], 200).astype(np.int32)
            cap = 4096 + 4096 * seed
            pairs.append((rows, vic, int(g.integers(0, cap)),
                          int(g.integers(0, 50)), cap))
        edge = np.zeros((256, transition.OP_LANES), np.int32)
        edge[:, 0], edge[:, 2] = 1, 232 + np.arange(256) % 31
        pairs.append((edge, np.full(64, 1064, np.int32), (1 << 16) - 100, 3,
                      1 << 16))
        checks = []
        for rows, vic, used0, z0, cap in pairs:
            r = torch.from_numpy(rows).to(dev)
            v = torch.from_numpy(vic).to(dev)
            got = transition.cache_transition(r, v, used0, z0, cap=cap)
            ref = transition.cache_transition_ref(r, v, used0, z0, cap=cap)
            plain = transition.cache_transition_np(rows, vic, used0, z0,
                                                   cap=cap)
            for o, a, b, c in zip(("dec", "nvic", "used"), got, ref, plain):
                checks += [(o, a, b),
                           (o + ".np", a.cpu(), torch.from_numpy(c))]
        assert not bool(got[0].any())        # floor division refused all
        # tests/torch_cases.py's adversarial windows: victims <= 0, an
        # empty queue, a queue run dry, tens of small victims a make-space,
        # promotes at Eq. 1's floor, 2^13 ops over 4,096 victims
        for name in TRANSITION_CASES:
            rows, vic, used0, z0, cap = transition_case(name)
            r = torch.from_numpy(rows).to(dev)
            v = torch.from_numpy(vic).to(dev)
            got = transition.cache_transition(r, v, used0, z0, cap=cap,
                                              top=int(rows[:, 2].max()))
            plain = transition.cache_transition_np(rows, vic, used0, z0,
                                                   cap=cap)
            checks += [(f"{name}.{o}", a.cpu(), torch.from_numpy(c))
                       for o, a, c in zip(("dec", "nvic", "used"), got,
                                          plain)]
        self.errors["cache_transition"] = max_abs_err(checks)
        torch.cuda.synchronize()
        emit({"kernels_vs_plain": self.errors})

    # ------------------------------------------------------------ 4-6
    def serve(self) -> dict:
        n = 1 << KEYS_LOG2
        batch = BATCH
        dev = self.dev
        t0 = time.perf_counter()
        reads = Workload(n, zipf=ZIPF, mix="read_only", seed=SEED)
        ro_keys = [reads.ops_arrays(batch)[1] for _ in range(BATCHES)]
        writes = Workload(n, zipf=ZIPF, mix="write_heavy_update",
                          seed=SEED + 1)
        wh_ops = [writes.ops_arrays(batch) for _ in range(BATCHES)]
        n_writes = int(sum(int(k.sum()) for k, _ in wh_ops))
        emit({"workload_s": round(time.perf_counter() - t0, 3),
              "keys": n, "batch": batch, "serve_writes": n_writes})

        # + the profiled batch and the KN phase's writes
        cap = n + n_writes + batch + len(KN_MIXES) * KN_OPS
        table = clht.clht_init(n, device=dev)
        seg = log.segment_init(cap, device=dev)
        heap = log.heap_init(cap, WIDTH, device=dev)
        shadow_ver = np.full(n, -1, np.int32)    # last acknowledged version
        shadow_ptr = np.full(n, -1, np.int32)
        heap_rows = heap.data.shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        perm = torch.randperm(n, generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)

        def ack(keys_h, vers_h, ptrs, ok):
            """Record the acknowledged writes of a batch, last in log
            order winning; returns the keys of its failed writes."""
            ok_h = ok.cpu().numpy()
            ptrs_h = ptrs.cpu().numpy()
            sel = np.flatnonzero(ok_h)[::-1]
            _, last = np.unique(keys_h[sel], return_index=True)
            last = sel[last]
            shadow_ver[keys_h[last]] = vers_h[last]
            shadow_ptr[keys_h[last]] = ptrs_h[last]
            return keys_h[~ok_h]

        def write(keys_d, vals):
            """One write batch through log_append_merge; returns (ptrs,
            ok, seconds on the host clock, synchronized)."""
            nonlocal table, seg, heap
            count0 = seg.count
            (table, seg, heap, ptrs, _, ok), sec = synced(
                merge.log_append_merge, table, seg, heap, keys_d, vals)
            if seg.count != count0 + keys_d.numel():
                raise AssertionError("a write batch did not fit the segment")
            if heap.head > heap_rows:
                raise AssertionError("the value heap overflowed")
            return ptrs, ok, sec

        def check_reads(keys_h, vals, ptrs, found):
            ver = torch.from_numpy(shadow_ver[keys_h]).to(dev)
            want_ptr = torch.from_numpy(shadow_ptr[keys_h]).to(dev)
            if not torch.equal(found, ver >= 0):
                raise AssertionError("a read's presence disagrees with the "
                                     "last acknowledged write")
            if not torch.equal(ptrs, torch.where(ver >= 0, want_ptr, -1)):
                raise AssertionError("a read's pointer disagrees with the "
                                     "last acknowledged write")
            want = value_rows(torch.from_numpy(keys_h).to(dev), ver)
            if not torch.equal(vals[found], want[found]):
                raise AssertionError("a read returned another value than "
                                     "the last acknowledged write")

        # set every count to 0 just before the main path
        _build.reset_counts()
        torch.cuda.reset_peak_memory_stats()

        # 4. load (data generation and the shadow are set-up: untimed)
        load_s = 0.0
        failed_load = 0
        for lo in range(0, n, batch):
            kd = perm[lo:lo + batch].contiguous()
            kh = kd.cpu().numpy().astype(np.int64)
            zero = np.zeros(kh.size, np.int32)
            vals = value_rows(kd, torch.from_numpy(zero).to(dev))
            ptrs, ok, sec = write(kd, vals)
            load_s += sec
            failed_load += ack(kh, zero, ptrs, ok).size
        slow = _build.work["clht_insert"]
        emit({"phase": "load", "keys": n, "seconds": load_s,
              "keys_per_s": n / load_s, "slow_path_entries": slow,
              "slow_path_share": slow / n, "failed_inserts": failed_load,
              "overflow_buckets_used": int(table.overflow_head) - n})

        # 5. serve
        served = {}
        t_serve = 0.0
        for keys in ro_keys:
            kd = torch.from_numpy(keys.astype(np.int32)).to(dev)
            out, sec = synced(probe.kvs_lookup, table, heap, kd)
            t_serve += sec
            check_reads(keys, *out)
        served["read_only"] = {"ops": BATCHES * batch, "seconds": t_serve,
                               "ops_per_s": BATCHES * batch / t_serve}
        t_serve = 0.0
        written, failed = [], []
        slow0 = _build.work["clht_insert"]
        for b, (kinds, keys) in enumerate(wh_ops):
            rk, wk = keys[kinds == 0], keys[kinds == 1]
            vers = (1 + b * batch + np.flatnonzero(kinds == 1)).astype(
                np.int32)
            rd = torch.from_numpy(rk.astype(np.int32)).to(dev)
            wd = torch.from_numpy(wk.astype(np.int32)).to(dev)
            vals = value_rows(wd, torch.from_numpy(vers).to(dev))
            out, sec = synced(probe.kvs_lookup, table, heap, rd)
            t_serve += sec
            check_reads(rk, *out)
            ptrs, ok, sec = write(wd, vals)
            t_serve += sec
            failed.append(ack(wk, vers, ptrs, ok))
            written.append(wk)
        failed_writes = int(sum(f.size for f in failed))
        served["write_heavy_update"] = {
            "ops": BATCHES * batch, "seconds": t_serve,
            "ops_per_s": BATCHES * batch / t_serve,
            "writes": n_writes, "failed_writes": failed_writes,
            "slow_path_entries": _build.work["clht_insert"] - slow0}
        emit({"phase": "serve", "zipf": ZIPF, **served})

        # 6. read-back of every key written while serving
        keys_w = np.unique(np.concatenate(written))
        for lo in range(0, keys_w.size, batch):
            kh = keys_w[lo:lo + batch]
            kd = torch.from_numpy(kh.astype(np.int32)).to(dev)
            ptrs, found = probe.lookup(table, kd)
            if not bool(found.all()) or not torch.equal(
                    ptrs, torch.from_numpy(shadow_ptr[kh]).to(dev)):
                raise AssertionError("read-back: lookup disagrees with the "
                                     "last acknowledged write")
            check_reads(kh, *probe.kvs_lookup(table, heap, kd))
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        emit({"phase": "read_back", "keys": int(keys_w.size),
              "failed_writes": failed_writes,
              "keys_with_failed_writes": int(
                  np.unique(np.concatenate(failed)).size),
              "heap_head": heap.head, "heap_capacity": heap_rows,
              "last_fit": True,
              "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30})
        emit({"launches": {k: counts[k] for k in DPM_KERNELS}})
        missing = [k for k in DPM_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
        self.tally("dpm_serve", counts)
        self.slow_per_launch = max(
            1, _build.work["clht_insert"]
            // max(1, counts["clht_insert"]))
        return {"table": table, "seg": seg, "heap": heap,
                "read_keys": ro_keys[0], "write_ops": wh_ops[0], "n": n,
                "workload": writes}

    # ------------------------------------------------------------------ 7
    def time_kernels(self, st) -> list[dict]:
        """Each kernel and its plain version at the shapes the main path
        gives it. Every callable returns its outputs, state it updated
        included, named by ``outs``; the last kernel run and the last
        plain run (each on a fresh copy of that state) are held against
        each other, and that comparison is the kernel's max_abs_err."""
        table, heap, dev = st["table"], st["heap"], self.dev

        # A and B on one served read batch against the full table
        kd = torch.from_numpy(st["read_keys"].astype(np.int32)).to(dev)
        bids = clht.bucket_of(kd, table.num_buckets)
        nk = kd.numel()
        lines_touched = int(torch.unique(bids).numel())
        a_bytes = nk * 16 + lines_touched * 32
        ptrs, found = probe.clht_probe(table.lines, bids, kd)
        rows_found = int(torch.unique(ptrs[found.bool()]).numel())
        b_bytes = a_bytes + nk * WIDTH * 4 + rows_found * WIDTH * 4
        safe = ptrs.long().clamp(0, heap.data.shape[0] - 1)
        out = [
            self._timed(
                "clht_probe", "clht_probe.cu",
                "src/repro/kernels/clht_probe/clht_probe.py:143",
                ("ptrs", "found"),
                lambda: probe.clht_probe(table.lines, bids, kd),
                lambda: probe.clht_probe_ref(table.lines, bids, kd), None,
                a_bytes, REPS),
            self._timed(
                "kvs_lookup_fused", "clht_probe.cu",
                "src/repro/kernels/clht_probe/clht_probe.py:97",
                ("vals", "ptrs", "found"),
                lambda: probe.kvs_lookup_fused(table.lines, heap.data, bids,
                                               kd),
                lambda: probe.kvs_lookup_fused_ref(table.lines, heap.data,
                                                   bids, kd),
                lambda: torch.index_select(heap.data, 0, safe), b_bytes,
                REPS),
        ]
        emit({"redesigned": "clht_probe", "ms": out[0]["ms"],
              "before_ms": BEFORE_SLICE8_MS["clht_probe"],
              "inputs": f"the {nk} keys of one served read_only batch at "
                        f"zipf {ZIPF}, {lines_touched} distinct lines",
              "before": BEFORE_SLICE8})

        # C on one served write batch: sorted entries, fresh copy of the
        # lines for every run. Per entry 8 B read (key, ptr) and 8 B
        # written (old, ok); per group its start and one bucket id read
        # and its line read and written once.
        kinds, keys = st["write_ops"]
        wk = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
        bs, order, starts = merge.sort_by_bucket(
            clht.bucket_of(wk, table.num_buckets))
        ks = wk[order].contiguous()
        ps = torch.arange(wk.numel(), dtype=torch.int32, device=dev)
        groups = starts.numel() - 1
        c_bytes = wk.numel() * 16 + groups * 4 + (groups + 1) * 4 \
            + groups * 64
        fresh = lambda: (table.lines.clone(),)        # noqa: E731
        out.append(self._timed(
            "log_merge_sorted", "log_merge.cu",
            "src/repro/kernels/log_merge/log_merge.py:74",
            ("lines", "old", "ok"),
            lambda lines: (lines, *merge.log_merge_sorted(lines, starts, bs,
                                                          ks, ps)),
            lambda lines: (lines, *merge.log_merge_sorted_ref(
                lines, starts, bs, ks, ps)),
            None, c_bytes, REPS, setup=fresh, plain_reps=1,
            extra={"entries": wk.numel(), "groups": groups,
                   "largest_group": int((starts[1:] - starts[:-1]).max())}))
        emit({"redesigned": "log_merge_sorted", "ms": out[-1]["ms"],
              "before_ms": BEFORE_SLICE7_MS["log_merge_sorted"],
              "inputs": f"the {wk.numel()} updates of one served "
                        f"write_heavy_update batch, bucket-sorted",
              "before": BEFORE_SLICE7})

        # D on the load's mean slow-path batch: fresh keys into the full
        # table (a copy per run), with no mask, as the main path calls it.
        # Per entry 8 B read (key, ptr), 8 B written (old, ok) and one
        # line written; one line read per chain step.
        k = self.slow_per_launch
        dk = torch.arange(st["n"], st["n"] + k, dtype=torch.int32,
                          device=dev)
        dp = dk.clone()
        probes = int(clht.clht_lookup(table, dk)[2].sum())
        d_bytes = k * 16 + probes * 32 + k * 32
        copy = lambda: (self.clone_table(table),)     # noqa: E731

        def insert_outs(res):
            t, old, ok, num_new = res
            return t.lines, t.overflow_head, old, ok, num_new

        out.append(self._timed(
            "clht_insert", "clht_insert.cu", "src/repro/core/clht.py:184",
            ("lines", "overflow_head", "old", "ok", "num_new"),
            lambda t: insert_outs(clht.clht_insert(t, dk, dp)),
            lambda t: insert_outs(clht.clht_insert_plain(t, dk, dp)), None,
            d_bytes, max(2, REPS // 4), setup=copy, plain_reps=1,
            extra={"entries": k, "lines_walked": probes}))

        # D where the write path spends it (an extra timing, not a row of
        # the kernels line): the slow-path entries of one served
        # write_heavy_update batch -- the updates log_merge leaves because
        # their key lives in an overflow bucket, the hot keys many times
        # over -- into the table as log_merge left it
        with uncounted():
            base = self.clone_table(table)
            wp = torch.arange(heap.head, heap.head + wk.numel(),
                              dtype=torch.int32, device=dev)
            _, _, wok = merge.log_merge(
                base.lines, clht.bucket_of(wk, table.num_buckets), wk, wp)
            slow = (wok != 1).nonzero().flatten()
            sk, sp = wk[slow].contiguous(), wp[slow].contiguous()
        sgroups = torch.unique(torch.stack([
            clht.bucket_of(sk, table.num_buckets), sk]), dim=1).shape[1]
        sprobes = int(clht.clht_lookup(base, sk)[2].sum())
        ws = self._timed(
            "clht_insert", "clht_insert.cu", "src/repro/core/clht.py:184",
            ("lines", "overflow_head", "old", "ok", "num_new"),
            lambda t: insert_outs(clht.clht_insert(t, sk, sp)),
            lambda t: insert_outs(clht.clht_insert_plain(t, sk, sp)), None,
            sk.numel() * 16 + sprobes * 32 + sgroups * 32,
            max(2, REPS // 4), setup=lambda: (self.clone_table(base),),
            plain_reps=1, label="clht_insert_write_batch",
            extra={"entries": sk.numel(), "chain_key_groups": sgroups,
                   "lines_walked": sprobes})
        del base
        emit({"redesigned": "clht_insert", "ms": out[-1]["ms"],
              "before_ms": BEFORE_SLICE6_MS["clht_insert"],
              "inputs": f"the load's mean slow-path batch, {k} fresh keys",
              "write_batch_ms": ws["ms"],
              "write_batch_before_ms":
                  BEFORE_SLICE6_MS["clht_insert_write_batch"],
              "write_batch_inputs": f"{sk.numel()} slow-path entries of one "
                                    f"served write_heavy_update batch, "
                                    f"{sgroups} (chain, key) groups",
              "before": BEFORE_SLICE6})
        return out

    def profile(self, st) -> None:
        """torch.profiler over one write_heavy_update batch (its reads,
        then its writes) on the loaded table: device time by kernel and
        the device's busy share of the batch's wall time."""
        from torch.profiler import ProfilerActivity, profile
        kinds, keys = st["write_ops"]
        dev = self.dev
        rd = torch.from_numpy(keys[kinds == 0].astype(np.int32)).to(dev)
        wd = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
        vals = value_rows(wd, torch.full_like(wd, -7))

        def batch():
            probe.kvs_lookup(st["table"], st["heap"], rd)
            merge.log_append_merge(st["table"], st["seg"], st["heap"],
                                        wd, vals)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(batch)
        emit({"profile": "write_heavy_update batch",
              **device_summary(prof, wall)})

    # ---------------------------------------------------------- 7b. the KN
    def kn_window(self, st) -> None:
        """One KN's planned DAC windows over the loaded pool: an ArrayDAC
        of KN_CACHE warmed full (the hottest keys as values, the next as
        shortcuts), then KN_OPS ops of each mix in KN_BATCH batches. Per
        batch the reads that miss the cache are probed on the card
        (kernel A, the probe_map) and the writes go through
        log_append_merge (kernels C and D, the pointers of the write
        plan); the batch is then cut into planning
        chunks of at most KN_WINDOW ops, as the reference's host engine
        cuts a KN window. A chunk the planner plans is gathered, run
        through kernel 4 on the card, held bit for bit against
        cache_transition_np and against the plan (twin_verdict), and
        applied; a chunk it cannot plan is replayed through ArrayDAC's
        per-op methods.

        The batch's writes are merged before its windows run: a read
        before its key's write in the batch takes the prefetched pointer,
        one after it finds the key in the cache or the segcache, so no
        prefetched probe goes stale (dkeys and dbuckets stay empty)."""
        n = st["n"]
        t0 = time.perf_counter()
        kn = KVSNode("kn1", DINOMO, KN_CACHE, PoolView(st["table"]),
                     initial_keys=n)
        cache = kn.cache
        # the serve phase's generator draws on: its key popularity is the
        # dataset's, and its mix is read at every draw
        load = st["workload"]
        # warm-up, load-through-KN: half the cache holds the hottest keys
        # as values (the hottest the most recent), the other half the next
        # keys as shortcuts, as the reference's warm load gives every
        # loaded key one
        nv = KN_CACHE // 2 // (VALUE_BYTES + VALUE_OVERHEAD_BYTES)
        ns = (KN_CACHE - nv * (VALUE_BYTES + VALUE_OVERHEAD_BYTES)) \
            // SHORTCUT_BYTES
        hot = np.asarray(load.hot_keys(min(n, nv + ns)), np.int64)
        vk, sk = hot[:nv][::-1], np.sort(hot[nv:])
        (vp, _, _), (sp, _, _) = (probe_batch(st["table"], k)
                                  for k in (vk, sk))
        if (vp < 0).any() or (sp < 0).any():
            raise AssertionError("a loaded key is missing from the index")
        warm_load(cache, vk, vp, sk, sp, VALUE_BYTES)
        emit({"phase": "kn_warm_up", "values": int(cache.num_values),
              "shortcuts": int(cache.num_shortcuts),
              "used": int(cache.used), "capacity": cache.capacity,
              "seconds": time.perf_counter() - t0})

        tally = self._kn_tally()
        reset_plan_stats()
        self.kn_pending = 0
        self.kn_version = 1 << 24
        self.transition_case = None
        _build.reset_counts()            # the KN path's launches from here
        t0 = time.perf_counter()
        for mix in KN_MIXES:
            load.mix = mix
            for _ in range(0, KN_OPS, KN_BATCH):
                kinds, keys = load.ops_arrays(KN_BATCH)
                self._kn_batch(st, kn, kinds, keys, tally)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = dict(_build.launches)
        self.tally("kn_window", counts)
        v, pv = tally["verdicts"], tally["prefix_verdicts"]
        planned = PLAN_STATS["planned_windows"]
        prefixes = sum(pv.values())
        emit({"phase": "kn_window", "mixes": list(KN_MIXES),
              "ops": len(KN_MIXES) * KN_OPS,
              "cut": "2^15 ops a mix, cut from 2^16 for the run's time",
              "seconds": sec,
              "ops_per_s": len(KN_MIXES) * KN_OPS / sec, **PLAN_STATS,
              **tally,
              "agree_share": v["agree"] / max(1, planned),
              "prefix_agree_share": pv["agree"] / max(1, prefixes),
              "stats": dataclasses.asdict(cache.stats),
              "used": int(cache.used), "values": int(cache.num_values),
              "shortcuts": int(cache.num_shortcuts),
              "zero_shortcuts": int(cache._zero_shortcuts),
              "launches": {k: c for k, c in counts.items() if c}})
        if counts["cache_transition"] != planned + prefixes:
            raise AssertionError(
                f"kernel 4 launched {counts['cache_transition']} times for "
                f"{planned} planned windows and {prefixes} prefixes")
        if not planned:
            raise AssertionError("the KN path planned no window")
        if not tally["windows_with_victims"] or self.transition_case is None:
            raise AssertionError("no planned window (of 512 ops) consumed "
                                 "a victim")
        if v["other"] or pv["other"]:
            raise AssertionError(f"{v['other'] + pv['other']} windows: kernel"
                                 f" 4 and the planner disagree for no named "
                                 f"cause")
        self.kn_profile(st, kn, load)

    def kn_profile(self, st, kn, load) -> None:
        """torch.profiler over one more read_mostly_update batch of the KN
        path: the device's busy share of its wall time."""
        from torch.profiler import ProfilerActivity, profile
        kinds, keys = load.ops_arrays(KN_BATCH)
        tally = self._kn_tally()
        with uncounted(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            _, wall = synced(self._kn_batch, st, kn, kinds, keys, tally)
        emit({"profile": f"kn_window batch of {KN_BATCH} ops "
                         f"({load.mix})", "host_s": tally["host_s"],
              **device_summary(prof, wall)})

    @staticmethod
    def _kn_tally() -> dict:
        verdicts = ("agree",) + transition.CAUSES
        return {"victims_consumed": 0, "windows_with_victims": 0,
                "refill_retries": 0, "queue_dry_windows": 0,
                "verdicts": dict.fromkeys(verdicts, 0),
                "prefixes_unplanned": 0,
                "prefix_verdicts": dict.fromkeys(verdicts, 0),
                # host seconds: probes and writes, planning, the twin
                # (gathers, launches, checks, prefix plans), the apply,
                # the replay
                "host_s": dict.fromkeys(("stage", "plan", "twin", "apply",
                                         "replay"), 0.0)}

    def _kn_batch(self, st, kn, kinds, keys, tally) -> None:
        cache = kn.cache
        clock = tally["host_s"]
        t0 = time.perf_counter()
        m = keys.size
        pool = PoolView(st["table"])
        # prefetch the reads that miss now (kernel A)
        rsel = np.flatnonzero((kinds == 0) & (cache.kind[keys] == 0))
        probe_map = {}
        if rsel.size:
            pp, walked, bids = probe_batch(st["table"], keys[rsel])
            probe_map = {i: (None if q < 0 else q, w, b) for i, q, w, b in
                         zip(rsel.tolist(), pp.tolist(), walked.tolist(),
                             bids.tolist())}
        # stage the writes through the write path (kernels C and D)
        wplan = _WritePlan()
        wpos = np.flatnonzero(kinds == 1)
        wplan.wrank = np.full(m, -1, np.int64)
        if wpos.size:
            wk = torch.from_numpy(keys[wpos].astype(np.int32)).to(self.dev)
            vals = value_rows(wk, torch.full_like(wk, self.kn_version))
            self.kn_version += 1
            (st["table"], st["seg"], st["heap"], ptrs, _, ok) = \
                merge.log_append_merge(st["table"], st["seg"], st["heap"],
                                       wk, vals)
            if not bool(ok.all()):
                raise AssertionError("a KN write failed to merge")
            if st["heap"].head > st["heap"].data.shape[0]:
                raise AssertionError("the value heap overflowed")
            # one flush RT every KN_WRITE_BATCH writes (amortized)
            nw = wpos.size
            flush = (self.kn_pending + np.arange(1, nw + 1)) \
                % KN_WRITE_BATCH == 0
            self.kn_pending = (self.kn_pending + nw) % KN_WRITE_BATCH
            wplan.ptrs = ptrs.cpu().numpy().astype(np.int64)
            wplan.rts = flush.astype(np.float64)
            wplan.wrank[wpos] = np.arange(nw)
        pos = np.arange(m)
        dkeys, dbuckets = set(), set()
        start = 0
        t1 = time.perf_counter()
        clock["stage"] += t1 - t0
        while start < m:
            end = min(m, start + KN_WINDOW)
            args = (keys[start:end], kinds[start:end], pos[start:end])
            t0 = time.perf_counter()
            wp = plan_dac_window(cache, kn, *args, wplan, probe_map, dkeys,
                                 dbuckets, pool, VALUE_BYTES, False)
            t1 = time.perf_counter()
            clock["plan"] += t1 - t0
            if wp is None:
                self._kn_replay(kn, pool, *args, wplan, probe_map)
                clock["replay"] += time.perf_counter() - t1
                PLAN_STATS["replayed_windows"] += 1
                PLAN_STATS["replayed_ops"] += end - start
                start = end
                continue
            ctx = (probe_map, dkeys, dbuckets, pool)
            verdict, win, (_, nvic, used) = self._kn_twin(kn, args, wp, ctx)
            tally["verdicts"][verdict] += 1
            tally["queue_dry_windows"] += bool(
                (used[:wp.ops] > cache.capacity).any())
            if win.rows.shape[0] == KN_WINDOW and nvic[-1] > 0:
                self.transition_case = (win.rows, win.victims, win.used0,
                                        win.z0, cache.capacity)
            if verdict == "read_miss":
                # the twin on the prefix the encoding represents in full:
                # planned as its own window, before the apply
                j = transition.miss_free_prefix(win, wp)
                pre = tuple(a[:j] for a in args)
                wp2 = plan_dac_window(cache, kn, *pre, wplan, probe_map,
                                      dkeys, dbuckets, pool, VALUE_BYTES,
                                      False)
                if wp2 is None:
                    tally["prefixes_unplanned"] += 1
                else:
                    tally["prefix_verdicts"][
                        self._kn_twin(kn, pre, wp2, ctx)[0]] += 1
            t2 = time.perf_counter()
            clock["twin"] += t2 - t1
            apply_window_plan(kn, cache, wp, None, VALUE_BYTES)
            clock["apply"] += time.perf_counter() - t2
            PLAN_STATS["planned_windows"] += 1
            PLAN_STATS["planned_ops"] += wp.ops
            tally["victims_consumed"] += len(wp.victims)
            tally["windows_with_victims"] += bool(wp.victims)
            tally["refill_retries"] += wp.include_refills
            start += wp.ops

    def _kn_twin(self, kn, args, wp, ctx):
        """Gather a planned window's inputs (before its apply), run kernel
        4 on the card (its int32 guard checked on the gathered rows, so
        nothing is read back before the launch), hold it bit for bit
        against cache_transition_np, and take its verdict against the
        plan. Returns (verdict, the gathered window, the outputs)."""
        cache = kn.cache
        win = transition.gather_window(cache, kn, *args, *ctx, VALUE_BYTES,
                                       wp.include_refills)
        rows = torch.from_numpy(win.rows).to(self.dev)
        vic = torch.from_numpy(win.victims.astype(np.int32)).to(self.dev)
        got = transition.cache_transition(rows, vic, win.used0, win.z0,
                                          cap=cache.capacity,
                                          top=int(win.rows[:, 2].max()))
        want = transition.cache_transition_np(
            win.rows, win.victims, win.used0, win.z0, cap=cache.capacity)
        max_abs_err([(f"cache_transition.{o}", g.cpu(), torch.from_numpy(w))
                     for o, g, w in zip(("dec", "nvic", "used"), got, want)])
        return (transition.twin_verdict(win, wp, args[0], *want,
                                        cache.capacity), win, want)

    @staticmethod
    def _kn_replay(kn, pool, keys, kinds, pos, wplan, probe_map) -> None:
        """A chunk the planner cannot prove, op by op through ArrayDAC's
        per-op methods (reads as the reference's _scalar_read_dac, writes
        as fill_after_write of a cached log segment)."""
        cache = kn.cache
        st = kn.stats
        for k, o, p in zip(keys.tolist(), kinds.tolist(), pos.tolist()):
            st.ops += 1
            if o == 0:
                st.reads += 1
                if cache.lookup(k) is not None:
                    continue
                seg = kn.segcache.get(k)
                if seg is not None:
                    cache.fill_after_write(k, seg[0], seg[1],
                                           segment_cached=True)
                    continue
                pr = probe_map.get(p)
                ptr, walked = pr[:2] if pr is not None \
                    else pool.index_lookup(k)
                if ptr is not None:
                    cache.note_miss_rts(walked + 1.0)
                    cache.fill_after_miss(k, ptr, pool.heap_len[ptr])
            else:
                st.writes += 1
                ptr = int(wplan.ptrs[wplan.wrank[p]])
                cache.fill_after_write(k, ptr, VALUE_BYTES,
                                       segment_cached=True)
                kn._segcache_put(k, ptr, VALUE_BYTES)

    # ------------------------------------------------------ 7c. the pool
    def dpm_pool(self) -> None:
        """The port's DPMPool on the card: 2^POOL_KEYS_LOG2 keys of 1 KB
        values (a value is its write's version with a length of 1 KB: the
        pool keeps an opaque payload and its length) loaded through the
        pool's batched writes and merge_all, then POOL_ROUNDS rounds of
        YCSB write_heavy_update at zipf 0.99 by three KNs (a key's owner
        is key % 3): each KN's updates through log_write_batch, then
        merge_budget of the round's writes, then the round's reads
        through index_lookup_batch on the card (kernel A and the chain
        walk on the pool's packed copy of its index).

        Every kernel-A launch of a batched read equals clht_probe_ref on
        the same lines, bucket ids and keys; every batched read equals
        the host index's walk
        (NumpyCLHT.lookup_batch: pointers and lines walked) and the
        pointer of its key's last acknowledged write that the merge has
        reached (a KN's log merges as a prefix, in order); after a final
        merge_all every written key reads its last acknowledged write,
        and verify_integrity() is empty. The same log, merged into a
        slice-1 table on the card by merge_segment_planned (the host plan
        as bulk scatters, the chain-growth tail through kernel D), equals
        the pool's index row for row after the load and at the end."""
        n = 1 << POOL_KEYS_LOG2
        dev = self.dev
        order = np.random.default_rng(SEED + 3).permutation(n)
        traffic = Workload(n, zipf=ZIPF, mix="write_heavy_update",
                           seed=SEED + 3)
        rounds = [traffic.ops_arrays(POOL_ROUND_OPS)
                  for _ in range(POOL_ROUNDS)]
        reset_merge_plan_stats()
        pool = DPMPool(num_buckets=n, segment_capacity=POOL_SEGMENT,
                       device=dev)
        acked = np.full(n, -1, np.int64)      # last acknowledged pointer
        merged = np.full(n, -1, np.int64)     # ... that the merge reached
        # set every count to 0 just before the main path
        _build.reset_counts()

        # load: batched writes by a loader KN, merge_all, the KN dropped
        t_phase = t0 = time.perf_counter()
        pool.register_kn("loader")
        for lo in range(0, n, POOL_LOAD_BATCH):
            keys = order[lo:lo + POOL_LOAD_BATCH]
            ptrs, _ = pool.log_write_batch("loader", keys.tolist(),
                                           [0] * keys.size,
                                           [VALUE_BYTES] * keys.size)
            acked[keys] = ptrs
        load_merged = pool.merge_all("loader")
        pool.drop_kn("loader")
        load_s = time.perf_counter() - t0
        merged[:] = acked
        if load_merged != n or pool.index.size != n:
            raise AssertionError(f"the load merged {load_merged} entries "
                                 f"and indexed {pool.index.size} keys of {n}")
        emit({"phase": "dpm_pool_load", "keys": n, "seconds": load_s,
              "keys_per_s": n / load_s, "segment_capacity": POOL_SEGMENT,
              "overflow_buckets_used": pool.index.overflow_head - n,
              **MERGE_PLAN_STATS})
        slice1 = clht.clht_init(n, device=dev)
        self._pool_slice1(pool, slice1, [(order, acked[order])], "load")

        for kn in POOL_KNS:
            pool.register_kn(kn)
        logs = {kn: ([], []) for kn in POOL_KNS}     # per KN, in log order
        segs_of = {kn: {} for kn in POOL_KNS}        # per KN, by creation
        frontier = dict.fromkeys(POOL_KNS, 0)        # entries merged
        read_s = merge_s = 0.0
        n_reads = n_merged = walked = version = n_checked = 0
        for kinds, keys in rounds:
            for i, kn in enumerate(POOL_KNS):
                wk = keys[(kinds == 1) & (keys % len(POOL_KNS) == i)]
                ptrs, _ = pool.log_write_batch(
                    kn, wk.tolist(), list(range(version, version + wk.size)),
                    [VALUE_BYTES] * wk.size)
                version += wk.size
                acked[wk] = ptrs          # a key's writes: one KN, in order
                logs[kn][0].append(wk)
                logs[kn][1].append(np.asarray(ptrs, np.int64))
                for seg in pool.segments[kn]:
                    segs_of[kn].setdefault(id(seg), seg)
            t0 = time.perf_counter()
            n_merged += pool.merge_budget(int((kinds == 1).sum()))
            merge_s += time.perf_counter() - t0
            for kn in POOL_KNS:
                f = sum(seg.merged_upto for seg in segs_of[kn].values())
                lk = np.concatenate(logs[kn][0])[frontier[kn]:f]
                lp = np.concatenate(logs[kn][1])[frontier[kn]:f]
                last = _last_writes(lk)
                merged[lk[last]] = lp[last]
                frontier[kn] = f
            rk = keys[kinds == 0]
            t0 = time.perf_counter()
            with recorded(probe_ops, "clht_probe", clone=True) as calls:
                ptrs, probes = pool.index_lookup_batch(rk)
            read_s += time.perf_counter() - t0
            n_checked += self._pool_probe_check(calls)
            n_reads += rk.size
            walked += int(probes.sum())
            self._pool_read_check(pool, rk, ptrs, probes, merged)
        t0 = time.perf_counter()
        n_merged += pool.merge_all()
        merge_s += time.perf_counter() - t0
        written = np.unique(np.concatenate(
            [k for kn in POOL_KNS for k in logs[kn][0]]))
        with recorded(probe_ops, "clht_probe", clone=True) as calls:
            ptrs, probes = pool.index_lookup_batch(written)
        n_checked += self._pool_probe_check(calls)
        self._pool_read_check(pool, written, ptrs, probes, acked)
        problems = pool.verify_integrity()
        if problems:
            raise AssertionError(f"dpm_pool: verify_integrity: "
                                 f"{problems[:4]}")
        torch.cuda.synchronize()
        if _build.launches["clht_probe"] != POOL_ROUNDS + 1 \
                or n_checked != POOL_ROUNDS + 1:
            raise AssertionError(f"dpm_pool: kernel A launched "
                                 f"{_build.launches['clht_probe']} times, "
                                 f"{n_checked} held to its plain version, "
                                 f"for {POOL_ROUNDS + 1} batched reads")
        self._pool_slice1(pool, slice1, [
            (np.concatenate(logs[kn][0]), np.concatenate(logs[kn][1]))
            for kn in POOL_KNS], "traffic")
        if not _build.launches["clht_insert"]:
            raise AssertionError("dpm_pool: merge_segment_planned never "
                                 "reached kernel D")
        self.tally("dpm_pool", dict(_build.launches))
        emit({"phase": "dpm_pool", "seconds": time.perf_counter() - t_phase,
              "kns": len(POOL_KNS),
              "rounds": POOL_ROUNDS, "ops": POOL_ROUNDS * POOL_ROUND_OPS,
              "writes": version, "reads": n_reads,
              "reads_per_s": n_reads / read_s,
              "mean_lines_walked": walked / n_reads,
              "merged_entries": n_merged,
              "merged_entries_per_s": n_merged / merge_s,
              "written_keys_read_back": int(written.size),
              "kernel_a_launches_equal_to_plain": n_checked,
              "host_walked_keys": pool.host_walked_keys,
              "integrity_problems": 0, **MERGE_PLAN_STATS,
              "launches": {k: c for k, c in _build.launches.items() if c}})

    @staticmethod
    def _pool_probe_check(calls, what: str = "dpm_pool") -> int:
        """Each recorded kernel-A call of a batched read against
        clht_probe_ref on the same lines, bucket ids and keys, bit for
        bit, raw (ptrs, found) before the chain walk writes into them.
        Returns the calls checked."""
        for args, (ptrs, found) in calls:
            want_p, want_f = probe.clht_probe_ref(*args)
            if not (torch.equal(ptrs, want_p) and torch.equal(found, want_f)):
                raise AssertionError(f"{what}: a kernel-A launch of a "
                                     f"batched read disagrees with "
                                     f"clht_probe_ref")
        return len(calls)

    @staticmethod
    def _pool_read_check(pool, keys, ptrs, probes, want) -> None:
        """A batched read on the card against the host index's walk
        (pointers and lines walked) and the expected pointers."""
        host = pool.index.lookup_batch(keys)
        if not (np.array_equal(ptrs, host[0])
                and np.array_equal(probes, host[1])):
            raise AssertionError("dpm_pool: a batched read on the card "
                                 "disagrees with the host index walk")
        if not np.array_equal(ptrs, want[keys]):
            raise AssertionError("dpm_pool: a read disagrees with the last "
                                 "acknowledged write the merge reached")

    def _pool_slice1(self, pool, table, logs, what: str) -> None:
        """Merge the (keys, ptrs) logs into the slice-1 card ``table``
        through merge_segment_planned, one segment each, and hold the
        table against the pool's index and its card copy, row for row."""
        dev = self.dev
        for keys, ptrs in logs:
            seg = log.segment_init(keys.size, device=dev)
            log.log_append(seg, torch.from_numpy(keys.astype(np.int32)).to(
                dev), torch.from_numpy(ptrs.astype(np.int32)).to(dev))
            _, _, ok = merge.merge_segment_planned(table, seg)
            if not bool(ok.all()):
                raise AssertionError(f"dpm_pool: the slice-1 table refused "
                                     f"an entry of the {what}")
        lines = pool.sync_index().lines
        ix = pool.index
        want = torch.full_like(table.lines, -1)
        want[:, :clht.SLOTS] = torch.from_numpy(ix.keys).to(dev)
        want[:, clht.SLOTS:clht.LINK] = torch.from_numpy(ix.ptrs).to(dev)
        want[:, clht.LINK] = torch.from_numpy(ix.nxt).to(dev)
        if not (torch.equal(table.lines, want) and torch.equal(lines, want)
                and int(table.overflow_head) == ix.overflow_head):
            raise AssertionError(f"dpm_pool: after the {what} the slice-1 "
                                 f"table, the pool's card copy and its host "
                                 f"index differ")
        emit({"phase": f"dpm_pool_slice1_{what}", "equal": True,
              "clht_insert_launches": _build.launches["clht_insert"]})

    # ---------------------------------------------------- 7d. the cluster
    def cluster(self) -> None:
        """The port's DinomoCluster on the card: the reference's dataplane
        cluster (dinomo, CLUSTER_KNS KNs, 1 KB values, segments of
        CLUSTER_SEGMENT, each KN's cache CACHE_FRAC of the dataset) over
        2^CLUSTER_KEYS_LOG2 keys, loaded warm, then copied: the host leg
        runs execute_batch with the host engine, the jit leg (the copy)
        with engine="jit" (each eligible KN window one kernel-E launch
        over the KN's state resident on the card). Both take the same
        streams: CLUSTER_BATCHES batches of CLUSTER_BATCH ops of YCSB
        write_heavy_update, then of read_mostly_update, at zipf 0.99, the
        DPM merging one simulated second's allowance between batches (as
        TimedSimulation's step); one more write_heavy_update batch each,
        the jit one under torch.profiler; then a KN added and kn2 failed,
        each followed by CLUSTER_RECONFIG_BATCHES batches. Each batch's
        cache-miss reads go through DPMPool.index_lookup_batch (kernel A),
        once per KN.

        Every BatchResult field equal between the legs, and after each mix
        and reconfiguration their aggregate_stats() and cluster_snapshot.
        Every kernel-A launch equals clht_probe_ref on its lines, bucket
        ids and keys (raw ptrs and found, held before the next batch's
        index sync writes into the lines); the first kernel-E launch of
        each KN in each mix equals fused_window_ref on host copies of its
        inputs. No op is refused. Every written key reads back its last
        acknowledged write (and a sample of the unwritten ones their
        loaded value), through batch_read on both legs; verify_integrity()
        is empty; dinomo's reconfigurations move no data. A twin at
        2^CLUSTER_TWIN_KEYS_LOG2 keys (_cluster_twin) holds the batched
        and jit engines to the fused per-op loop on the card."""
        n = 1 << CLUSTER_KEYS_LOG2
        t_phase = time.perf_counter()
        reset_merge_plan_stats()
        _build.reset_counts()            # the cluster's launches from here
        t0 = time.perf_counter()
        c = self._cluster_at(n, reference_cache=False)
        emit({"phase": "cluster_load", "keys": n, "kns": CLUSTER_KNS,
              "seconds": time.perf_counter() - t0,
              "cache_bytes_per_kn": c.cache_bytes,
              "shortcuts": sum(kn.cache.num_shortcuts
                               for kn in c.kns.values()),
              **MERGE_PLAN_STATS})
        t0 = time.perf_counter()
        cj = copy.deepcopy(c)            # the jit leg, as loaded
        self._cluster_equal(c, cj, "the copy")
        emit({"phase": "cluster_copy", "seconds": time.perf_counter() - t0})
        # the baselines' pool, as loaded (cluster_variants): a load leaves
        # the pool alike for every variant. Kept pickled, one bytes object
        # the garbage collector never walks: a live copy would add a
        # pool's objects to every full collection in this phase's batches
        t0 = time.perf_counter()
        self.loaded_pool = pickle.dumps(c.pool, pickle.HIGHEST_PROTOCOL)
        emit({"phase": "cluster_pool_copy",
              "seconds": time.perf_counter() - t0,
              "bytes": len(self.loaded_pool)})
        self.dinomo_host = {}
        legs = {"host": c, "jit": cj}
        # run: ops so far, each key's last acknowledged write (the global
        # index of the op, its value f"w{index}"), kernel-A calls checked,
        # kernel-E launches held to the plain version
        run = {"ops": 0, "last": np.full(n, -1, np.int64), "checked": 0,
               "e_checked": 0, "window_case": None}
        loads = {mix: Workload(n, zipf=ZIPF, mix=mix, seed=SEED + 4)
                 for mix in CLUSTER_MIXES}
        for mix in CLUSTER_MIXES:
            for cl in legs.values():
                cl.reset_stats()
            tally = {leg: {"sec": 0.0, "wall": self._zero_wall(),
                           "plan": dict.fromkeys(PLAN_STATS, 0),
                           "gc_s": 0.0, "gc_collections": [0, 0, 0]}
                     for leg in legs}
            jit_counts = dict(cj._jit.counts) if cj._jit else None
            e0 = _build.launches["fused_window"]
            first = set()                # KNs whose first launch was held
            for b in range(CLUSTER_BATCHES):
                self._cluster_pair_batch(
                    legs, loads[mix], run, tally, first=first,
                    time_window=mix == CLUSTER_MIXES[0] and b == 0)
            self._cluster_equal(c, cj, mix)
            counts = {k: v - (jit_counts or {}).get(k, 0)
                      for k, v in cj._jit.counts.items()}
            jw = tally["jit"]["wall"]
            up_s, sync_s = jw["jit_upload"], jw["jit_sync"]
            full_s = jw["jit_full_upload"]
            emit({"phase": "cluster_jit_transfers", "mix": mix,
                  "jit_ops_per_s": CLUSTER_BATCHES * CLUSTER_BATCH
                  / tally["jit"]["sec"],
                  "host_ops_per_s": CLUSTER_BATCHES * CLUSTER_BATCH
                  / tally["host"]["sec"],
                  "jit_wall_s": tally["jit"]["sec"],
                  "upload_s": up_s, "sync_s": sync_s,
                  "upload_and_sync_share_of_wall":
                  (up_s + sync_s) / tally["jit"]["sec"],
                  "full_upload_s": full_s,
                  "share_without_first_use_uploads":
                  (up_s - full_s + sync_s) / (tally["jit"]["sec"] - full_s),
                  "uploads": counts["uploads"],
                  "full_uploads": counts["full_uploads"],
                  "syncs": counts["syncs"],
                  "bytes_per_upload": counts["upload_bytes"]
                  / max(counts["uploads"], 1),
                  "delta_uploads_with_slots": counts["upload_deltas"],
                  "slots_per_delta_upload": counts["upload_slots"]
                  / max(counts["upload_deltas"], 1),
                  "bytes_per_sync": counts["sync_bytes"]
                  / max(counts["syncs"], 1),
                  "slots_per_sync": counts["sync_slots"]
                  / max(counts["syncs"], 1),
                  "launches": counts["launches"],
                  "dispatches": counts["dispatches"]})
            if mix == CLUSTER_MIXES[0]:
                # the moved-slot kernels' timed inputs: this mix's mean
                run["gather_n"] = counts["sync_slots"] // max(
                    counts["syncs"], 1)
                run["scatter_n"] = counts["upload_slots"] // max(
                    counts["upload_deltas"], 1)
            for leg, cl in legs.items():
                agg = cl.aggregate_stats()
                sec = tally[leg]["sec"]
                if leg == "host":
                    self.dinomo_host[mix] = {
                        "ops_per_s": CLUSTER_BATCHES * CLUSTER_BATCH / sec,
                        "rts_per_op": agg["rts_per_op"]}
                emit({"phase": "cluster_mix", "leg": leg, "mix": mix,
                      "ops": CLUSTER_BATCHES * CLUSTER_BATCH,
                      "execute_batch_s": sec,
                      "ops_per_s": CLUSTER_BATCHES * CLUSTER_BATCH / sec,
                      **{k: agg[k] for k in ("rts_per_op", "hit_ratio",
                                             "value_hit_ratio",
                                             "write_stalls")},
                      "plan_stats": tally[leg]["plan"],
                      "held_check_s_excluded":
                      tally[leg].get("held_check_s", 0.0),
                      "gc_s": tally[leg]["gc_s"],
                      "gc_collections": tally[leg]["gc_collections"],
                      "engine_wall_s": {
                          k: v for k, v in tally[leg]["wall"].items()
                          if v or k.startswith(leg)},
                      **({"jit": counts, "kernel_e_launches":
                          _build.launches["fused_window"] - e0,
                          "kernel_e_first_launches_equal_to_plain":
                          len(first)} if leg == "jit" else {})})
        from torch.profiler import ProfilerActivity, profile
        self._cluster_pair_batch(legs, loads["write_heavy_update"], run,
                                 None, profile_jit=(profile,
                                                    ProfilerActivity))
        for event in ("add", "fail"):
            for leg, cl in legs.items():
                t0 = time.perf_counter()
                if event == "add":
                    cl.add_kn()
                else:
                    cl.fail_kn("kn2")
                sec = time.perf_counter() - t0
                rec = cl.reconfig_log[-1]
                emit({"phase": "cluster_reconfig", "leg": leg,
                      "event": rec["event"], "node": rec["node"],
                      "seconds": sec,
                      "merged_entries": rec["merged_entries"],
                      "participants": rec["participants"],
                      "moved_fraction": rec["moved_fraction"],
                      "kns": len(cl.kns)})
            self._cluster_equal(c, cj, event)
            for _ in range(CLUSTER_RECONFIG_BATCHES):
                self._cluster_pair_batch(legs, loads["write_heavy_update"],
                                         run, None)
            self._cluster_equal(c, cj, f"the batches after {event}")
        if any(r["moved_fraction"] for cl in legs.values()
               for r in cl.reconfig_log):
            raise AssertionError("cluster: a dinomo reconfiguration moved "
                                 "data")
        written, unwritten, keys, want = _read_back_keys(run["last"])
        read_s = {}
        for leg, cl in legs.items():
            t0 = time.perf_counter()
            with recorded(probe_ops, "clht_probe", clone=True) as calls:
                vals, _ = cl.batch_read(keys)
            run["checked"] += self._pool_probe_check(calls, "cluster")
            read_s[leg] = time.perf_counter() - t0
            if vals != want:
                bad = next(i for i, (v, w) in enumerate(zip(vals, want))
                           if v != w)
                raise AssertionError(f"cluster ({leg}): key {keys[bad]} "
                                     f"read back {vals[bad]!r}, not "
                                     f"{want[bad]!r}")
            problems = cl.pool.verify_integrity()
            if problems:
                raise AssertionError(f"cluster ({leg}): verify_integrity: "
                                     f"{problems[:4]}")
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        if not run["checked"] or counts["clht_probe"] != run["checked"]:
            raise AssertionError(f"cluster: kernel A launched "
                                 f"{counts['clht_probe']} times, "
                                 f"{run['checked']} held to its plain "
                                 f"version")
        if not counts["fused_window"]:
            raise AssertionError("cluster: kernel E never launched")
        self.tally("cluster", counts)
        host_walked = {leg: cl.pool.host_walked_keys
                       for leg, cl in legs.items()}
        emit({"phase": "cluster_read_back", "written_keys": int(
            written.size), "unwritten_keys": int(unwritten.size),
              "seconds": read_s, "equal": True, "integrity_problems": 0,
              "host_walked_keys": host_walked})
        self.window_case = run["window_case"]
        self.held_jobs = run.get("held_jobs", {})
        self.moved_n = (run.get("gather_n", 0), run.get("scatter_n", 0))
        del c, cj, legs
        twin = self._cluster_twin()
        emit({"phase": "cluster", "seconds": time.perf_counter() - t_phase,
              "ops": run["ops"], "refused": 0,
              "kernel_a_launches": counts["clht_probe"],
              "kernel_a_launches_equal_to_plain": run["checked"],
              "kernel_e_launches": counts["fused_window"],
              "kernel_e_launches_equal_to_plain": run["e_checked"],
              "twin": twin,
              "launches": {k: v for k, v in counts.items() if v}})

    def _cluster_at(self, n: int, reference_cache: bool, variant=DINOMO,
                    pool=None, policy=None):
        """The phase's cluster over ``n`` keys on the card, loaded warm
        (the values v{key}); given ``pool``, a copy of such a cluster's
        pool as loaded, it takes that pool and warms its caches
        (torch_cluster_cases.loaded_like) instead of loading. ``policy``:
        the M-node's PolicyConfig (default: one that never acts)."""
        c = DinomoCluster(variant, num_kns=CLUSTER_KNS,
                          cache_bytes=int(n * VALUE_BYTES * CACHE_FRAC),
                          value_bytes=VALUE_BYTES, num_buckets=n,
                          segment_capacity=CLUSTER_SEGMENT,
                          policy=policy or PolicyConfig(grace_period_s=1e9,
                                                        epoch_s=1e9),
                          reference_cache=reference_cache, device=self.dev)
        if pool is None:
            c.load(((k, f"v{k}") for k in range(n)), warm=True)
        else:
            loaded_like(c, pool, range(n))
        return c

    @staticmethod
    def _zero_wall() -> dict:
        return dict.fromkeys(ENGINE_WALL, 0.0)

    @staticmethod
    def _cluster_equal(a, b, when: str) -> None:
        """The legs' aggregate_stats() and cluster_snapshot equal."""
        if a.aggregate_stats() != b.aggregate_stats() or \
                cluster_snapshot(a) != cluster_snapshot(b):
            raise AssertionError(f"cluster: the host and jit legs part "
                                 f"after {when}")

    def _cluster_pair_batch(self, legs, load, run, tally, first=None,
                            time_window=False, profile_jit=None) -> None:
        """One batch of ``load``'s ops through execute_batch
        on each leg (the jit leg with engine="jit"; its kernel-A launches
        recorded and held to clht_probe_ref), every BatchResult field
        equal, then one simulated second of DPM merging under its
        allowance on each; the batch's writes noted in ``run``. ``tally``
        gathers each leg's synchronized seconds, ENGINE_WALL, PLAN_STATS
        and the garbage collector's passes inside the batch. The first
        kernel-E launch of each KN not in ``first`` is held to
        fused_window_ref (``_held_windows``). ``time_window``
        times the host engine on each KN's window (the time_fused_window
        row's comparison); ``profile_jit`` profiles the jit leg's batch
        and emits its device summary."""
        kinds, keys = load.ops_arrays(CLUSTER_BATCH)
        base = run["ops"]
        held0 = run.get("held_s", 0.0)
        budget = int(DEFAULT_MODEL.merge_capacity())
        got = []
        for leg, c in legs.items():
            c.pool.merge_allowance = budget
            wall0 = dict(ENGINE_WALL)
            reset_plan_stats()
            with contextlib.ExitStack() as stack:
                calls = stack.enter_context(
                    recorded(probe_ops, "clht_probe", clone=True))
                g = stack.enter_context(gc_meter())
                if leg == "jit" and first is not None:
                    stack.enter_context(self._held_windows(
                        c, run, first, keep=time_window))
                if leg == "host" and time_window:
                    stack.enter_context(self._host_windows(c, run))
                prof = None
                if leg == "jit" and profile_jit:
                    profile, act = profile_jit
                    prof = stack.enter_context(profile(
                        activities=[act.CPU, act.CUDA]))
                res, sec = synced(lambda: c.execute_batch(
                    kinds, keys, values=lambda i: f"w{base + i}",
                    engine=leg))
            # the kernel-E launches held to their plain version: the
            # checks' seconds leave the leg's time and its dispatch wall
            held = run.get("held_s", 0.0) - held0
            sec -= held
            ENGINE_WALL["jit_dispatch"] -= held
            if prof is not None:
                emit({"profile": f"cluster jit write_heavy_update batch "
                                 f"of {CLUSTER_BATCH} ops",
                      **device_summary(prof, sec)})
            run["checked"] += self._pool_probe_check(calls, "cluster")
            c.advance_merge(budget)
            c.pool.merge_allowance = None
            refused = sum(kn.stats.refused for kn in c.kns.values())
            if res.executed != keys.size or refused \
                    or not np.array_equal(res.executed_keys, keys):
                raise AssertionError(f"cluster ({leg}): "
                                     f"{keys.size - res.executed} ops not "
                                     f"executed, {refused} refused")
            got.append((res.executed, res.writes, res.per_kn,
                        res.executed_keys.tolist(), res.values))
            if tally is not None:
                t = tally[leg]
                t["sec"] += sec
                t["held_check_s"] = t.get("held_check_s", 0.0) + held
                t["gc_s"] += g["s"]
                t["gc_collections"] = [a + b for a, b in zip(
                    t["gc_collections"], g["collections"])]
                for k, v in ENGINE_WALL.items():
                    t["wall"][k] += v - wall0[k]
                for k, v in PLAN_STATS.items():
                    t["plan"][k] += v
        if got[0] != got[1]:
            raise AssertionError("cluster: the host and jit legs' "
                                 "BatchResults part")
        wpos = np.flatnonzero(kinds == 1)
        lw = _last_writes(keys[wpos])
        run["last"][keys[wpos][lw]] = base + wpos[lw]
        run["ops"] += keys.size

    @contextlib.contextmanager
    def _held_windows(self, c, run, first, keep=False):
        """Hold kernel-E launches of ``c``'s jit engine to
        fused_window_ref, job by job (a launch runs one window of each KN
        with a dispatch ready), on host copies of each job's inputs:
        n_exec, the cut, the executed events and out_ptr, all eight state
        arrays. Only the first job of each KN not in ``first``
        (``first=None``: every job); the plain version's argmin victims
        are O(slots) an eviction. With ``keep``, each KN's first held job
        is kept in ``run["held_jobs"]`` (time_fused_window's four-KN
        launch), and the held job whose window the host leg ran as one
        window of the same ops (``_host_windows``), the largest such, in
        ``run["window_case"]``."""
        real = batch_executor.fused_windows

        def held(jobs):
            eng = c._jit
            jobs = [batch_executor.WindowJob(*j) for j in jobs]
            names = [next(nm for nm, r in eng.resident.items()
                          if r.state[0] is j.state[0]) for j in jobs]
            t_check = time.perf_counter()
            host = {}
            for i, (j, name) in enumerate(zip(jobs, names)):
                if first is not None and name in first:
                    continue
                host[i] = {
                    "kn": name,
                    "state": tuple(t.cpu().numpy().copy() for t in j.state),
                    "window": [t.cpu().numpy().copy() for t in j.window],
                    "n": int(j.n), "cap": int(j.cap), "wb": int(j.write_bytes),
                    "vmax": j.vmax.cpu().numpy(),
                    "trees": tuple(t.clone() for t in j.trees)
                    if keep and j.trees is not None else None}
            checking = time.perf_counter() - t_check
            outs = real(jobs)
            t_check = time.perf_counter()
            for i, case in host.items():
                t0 = time.perf_counter()
                want = batch_executor.fused_window_ref(
                    case["state"], *case["window"], case["n"], case["cap"],
                    case["wb"], case["vmax"])
                case["plain_s"] = time.perf_counter() - t0
                out = outs[i]
                ne = int(out[0])
                same = (ne, int(out[4])) == (want[0], want[4]) and \
                    np.array_equal(out[2][:ne].cpu().numpy(), want[2][:ne]) \
                    and np.array_equal(out[3][:ne].cpu().numpy(),
                                       want[3][:ne]) and \
                    all(np.array_equal(a.cpu().numpy(), b)
                        for a, b in zip(out[1], want[1]))
                if not same:
                    raise AssertionError(f"cluster: kernel E on "
                                         f"{case['kn']}'s window parts from "
                                         f"fused_window_ref")
                run["e_checked"] += 1
                if first is not None:
                    first.add(case["kn"])
                if not keep:
                    continue
                case["n_exec"] = ne
                run.setdefault("held_jobs", {}).setdefault(case["kn"], case)
                hw = run.get("host_window", {}).get(case["kn"])
                best = run["window_case"]
                if hw is not None and hw[0] == case["n"] and \
                        (best is None or case["n"] > best["n"]):
                    run["window_case"] = dict(case, host=hw)
            # the checks' host copies and plain runs are no part of the
            # path: _cluster_pair_batch takes them out of the leg's time
            run["held_s"] = run.get("held_s", 0.0) + checking + \
                time.perf_counter() - t_check
            return outs

        batch_executor.fused_windows = held
        try:
            yield
        finally:
            batch_executor.fused_windows = real

    @contextlib.contextmanager
    def _host_windows(self, c, run):
        """Time the host engine's windows of ``c`` (its planner and
        apply) by KN: the first per KN into ``run["host_window"]``, as
        (ops, seconds)."""
        run["host_window"] = {}
        real = c._run_window_at

        def timed(w, hi, *args):
            i0 = w.idx
            t0 = time.perf_counter()
            real(w, hi, *args)
            run["host_window"].setdefault(
                w.kn.name, (w.idx - i0, time.perf_counter() - t0))

        c._run_window_at = timed
        try:
            yield
        finally:
            del c._run_window_at

    def _cluster_twin(self) -> dict:
        """The phase's configuration at 2^CLUSTER_TWIN_KEYS_LOG2 keys, as
        three clusters on the card: the batched host engine, the jit
        engine and the fused per-op loop (reference_cache=True: the
        reference DAC, per-key index walks). The first
        CLUSTER_TWIN_BATCHES batches of each mix go to all three, a KN
        added to each between the mixes; after each, every BatchResult
        field and collected value, cluster_snapshot and aggregate_stats()
        are equal, the batched ones' kernel-A launches equal
        clht_probe_ref, and every kernel-E launch equals fused_window_ref
        on host copies of its inputs. Outside the main path's launch
        counts."""
        n = 1 << CLUSTER_TWIN_KEYS_LOG2
        checked = batches = 0
        run = {"e_checked": 0, "window_case": None}
        with uncounted(), recorded(probe_ops, "clht_probe",
                                   clone=True) as calls:
            trio = [(self._cluster_at(n, rc), e)
                    for rc, e in ((False, "host"), (False, "jit"),
                                  (True, "host"))]
            for mix in CLUSTER_MIXES:
                if mix != CLUSTER_MIXES[0]:
                    # a KN joins: the participants' caches are cleared,
                    # so the batched ones' reads miss and probe the card
                    for c, _ in trio:
                        c.add_kn()
                loads = [Workload(n, zipf=ZIPF, mix=mix, seed=SEED + 5)
                         for _ in trio]
                for _ in range(CLUSTER_TWIN_BATCHES):
                    got = []
                    for (c, engine), load in zip(trio, loads):
                        kinds, keys = load.ops_arrays(CLUSTER_BATCH)
                        budget = int(DEFAULT_MODEL.merge_capacity())
                        c.pool.merge_allowance = budget
                        with (self._held_windows(c, run, None)
                              if engine == "jit"
                              else contextlib.nullcontext()):
                            res = c.execute_batch(kinds, keys,
                                                  values=lambda i: f"w{i}",
                                                  collect_values=True,
                                                  engine=engine)
                        c.advance_merge(budget)
                        c.pool.merge_allowance = None
                        got.append((res.executed, res.writes, res.per_kn,
                                    res.executed_keys.tolist(), res.values,
                                    cluster_snapshot(c),
                                    c.aggregate_stats()))
                    checked += self._pool_probe_check(calls, "cluster twin")
                    calls.clear()
                    if not got[0] == got[1] == got[2]:
                        raise AssertionError(f"cluster twin: the batched, "
                                             f"jit and per-op engines part "
                                             f"in {mix}")
                    batches += 1
        if not checked or not run["e_checked"]:
            raise AssertionError("cluster twin: no kernel-A or kernel-E "
                                 "launch")
        return {"keys": n, "batches": batches, "equal": True,
                "kernel_a_launches_equal_to_plain": checked,
                "kernel_e_launches_equal_to_plain": run["e_checked"],
                "jit": trio[1][0]._jit.counts,
                "aggregate": got[0][-1]}

    # ------------------------------------------------------- the baselines
    def cluster_variants(self) -> None:
        """The paper's baselines on the card: the cluster phase's
        configuration (CLUSTER_KNS KNs, 1 KB values, segments of
        CLUSTER_SEGMENT, caches CACHE_FRAC of the data, 2^CLUSTER_KEYS_LOG2
        keys loaded warm) built as dinomo-s (static shortcut-only caches,
        windows planned by plan_static_window or replayed) and as clover
        (shared everything: the batched Clover plane reads the index for
        every op of a batch, index_lookup_batch and so kernel A once a
        batch, and lands the batch's index updates on the host index; the
        next batch's sync_index uploads the changed rows). Each takes a
        copy of the cluster phase's pool as loaded, unpickled from the
        bytes that phase kept (torch_cluster_cases.loaded_like; a CPU test
        holds such a cluster to one loaded itself), its caches warmed key
        by key and the cluster phase's streams: CLUSTER_BATCHES batches
        of write_heavy_update, then of read_mostly_update, the merge
        allowance of one simulated second between batches; then
        BASELINE_READ_BATCHES of read_only; add_kn(), then fail_kn("kn2"),
        each followed by CLUSTER_RECONFIG_BATCHES batches; the read-back.

        Every kernel-A launch equals clht_probe_ref on its inputs (held
        before the next sync writes into the lines) and every batched
        read the host index's walk; clover launches kernel A in every
        batch. No op is refused. Every written key reads back its last
        acknowledged write and a sample of unwritten keys its loaded
        value, through batch_read; verify_integrity() is empty. RTs an
        op on write_heavy_update are ordered dinomo < dinomo-s < clover
        (the reference's test_rts_ordering). A twin at
        2^CLUSTER_TWIN_KEYS_LOG2 keys holds each baseline's batched engine
        on the card to its per-op oracle (reference_cache=True)."""
        n = 1 << CLUSTER_KEYS_LOG2
        t_phase = time.perf_counter()
        _build.reset_counts()
        blob = self.loaded_pool          # the timed phase deletes it
        # ops, kernel-A launches held, and each (variant, mix)'s ops/s
        # and RTs an op
        out = {"ops": 0, "checked": 0, "mix": {}}
        for variant in BASELINES:
            t0 = time.perf_counter()
            c = self._cluster_at(n, False, VARIANTS[variant],
                                 pool=pickle.loads(blob))
            emit({"phase": "cluster_variant_load", "variant": variant,
                  "seconds": time.perf_counter() - t0,
                  "cache_bytes_per_kn": c.cache_bytes})
            run = {"ops": 0, "last": np.full(n, -1, np.int64),
                   "checked": 0}
            probe = self._probe_meter(c.pool)
            loads = {mix: Workload(n, zipf=ZIPF, mix=mix, seed=SEED + 4)
                     for mix in CLUSTER_MIXES + ("read_only",)}
            for mix in loads:
                nb = BASELINE_READ_BATCHES if mix == "read_only" \
                    else CLUSTER_BATCHES
                self._variant_mix(c, variant, mix, loads[mix], nb, run,
                                  probe, out)
            for event in ("add", "fail"):
                t0 = time.perf_counter()
                if event == "add":
                    c.add_kn()
                else:
                    c.fail_kn("kn2")
                rec = c.reconfig_log[-1]
                emit({"phase": "cluster_variant_reconfig",
                      "variant": variant, "event": rec["event"],
                      "seconds": time.perf_counter() - t0,
                      "merged_entries": rec["merged_entries"],
                      "moved_fraction": rec["moved_fraction"]})
                self._variant_mix(c, variant, f"write_heavy_update after "
                                  f"{event}", loads["write_heavy_update"],
                                  CLUSTER_RECONFIG_BATCHES, run, probe, out)
            written, unwritten, keys, want = _read_back_keys(run["last"])
            t0 = time.perf_counter()
            with recorded(probe_ops, "clht_probe", clone=True) as calls:
                vals, _ = c.batch_read(keys)
            run["checked"] += self._pool_probe_check(calls, variant)
            if vals != want:
                bad = next(i for i, (v, w) in enumerate(zip(vals, want))
                           if v != w)
                raise AssertionError(f"{variant}: key {keys[bad]} read "
                                     f"back {vals[bad]!r}, not "
                                     f"{want[bad]!r}")
            problems = c.pool.verify_integrity()
            if problems:
                raise AssertionError(f"{variant}: verify_integrity: "
                                     f"{problems[:4]}")
            emit({"phase": "cluster_variant_read_back", "variant": variant,
                  "written_keys": int(written.size),
                  "unwritten_keys": int(unwritten.size),
                  "seconds": time.perf_counter() - t0, "equal": True,
                  "integrity_problems": 0,
                  "host_walked_keys": c.pool.host_walked_keys,
                  "index_lookups": probe["calls"]})
            out["ops"] += run["ops"]
            out["checked"] += run["checked"]
            del c
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        if counts["clht_probe"] != out["checked"]:
            raise AssertionError(f"cluster_variants: kernel A launched "
                                 f"{counts['clht_probe']} times, "
                                 f"{out['checked']} held to its plain "
                                 f"version")
        self.tally("cluster_variants", counts)
        for mix in CLUSTER_MIXES + ("read_only",):
            row = {"dinomo (host leg)": self.dinomo_host.get(mix, {}),
                   **{v: out["mix"][(v, mix)] for v in BASELINES}}
            emit({"phase": "cluster_variants_compare", "mix": mix,
                  "measure": "host wall-clock ops/s of the functional "
                             "plane (execute_batch, synchronized), not the "
                             "paper's modelled throughput",
                  **{k: {v: r.get(k) for v, r in row.items()}
                     for k in ("ops_per_s", "rts_per_op")}})
        rts = {"dinomo": self.dinomo_host[CLUSTER_MIXES[0]]["rts_per_op"],
               **{v: out["mix"][(v, CLUSTER_MIXES[0])]["rts_per_op"]
                  for v in BASELINES}}
        if not rts["dinomo"] < rts["dinomo-s"] < rts["clover"]:
            raise AssertionError(f"cluster_variants: RTs an op on "
                                 f"write_heavy_update not ordered dinomo < "
                                 f"dinomo-s < clover: {rts}")
        twins = {v: self._variant_twin(v) for v in BASELINES}
        emit({"phase": "cluster_variants",
              "seconds": time.perf_counter() - t_phase, "ops": out["ops"],
              "refused": 0, "rts_ordered": True,
              "rts_per_op_write_heavy_update": rts,
              "kernel_a_launches": counts["clht_probe"],
              "kernel_a_launches_equal_to_plain": out["checked"],
              "twins": twins,
              "launches": {k: v for k, v in counts.items() if v}})

    @staticmethod
    def _probe_meter(pool) -> dict:
        """Meter ``pool``'s batched index reads: each call's seconds,
        keys and kernel-A launches; its sync_index uploads (rows, bytes;
        the first one the whole table) inside them, each upload's span
        between two CUDA events (``events``: no synchronization is added
        to the batch; ``_variant_mix`` reads them into ``sync_s`` once the
        batch is synchronized); every read held to the host index's walk
        (``check_s``, left out of the batches' time)."""
        m = {"calls": 0, "keys": 0, "s": 0.0, "sync_s": 0.0, "rows": 0,
             "bytes": 0, "check_s": 0.0, "events": []}
        real_sync, real_lookup = pool.sync_index, pool.index_lookup_batch

        def sync_index():
            t0 = time.perf_counter()
            ix = pool.index
            full = pool.index_dev is None
            rows = ix.nxt.shape[0] if full else int(ix.noted_rows().size)
            m["check_s"] += time.perf_counter() - t0
            span = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            span[0].record()
            table = real_sync()
            span[1].record()
            m["events"].append(span)
            m["rows"] += rows
            m["bytes"] += rows * table.lines.shape[1] * 4 + \
                (0 if full else rows * 4)
            return table

        def index_lookup_batch(keys):
            t0 = time.perf_counter()
            ptrs, probes = real_lookup(keys)
            t1 = time.perf_counter()
            m["s"] += t1 - t0
            m["calls"] += 1
            m["keys"] += int(np.size(keys))
            want = pool.index.lookup_batch(np.asarray(keys, np.int64))
            if not (np.array_equal(ptrs, want[0])
                    and np.array_equal(probes, want[1])):
                raise AssertionError("cluster_variants: a batched read on "
                                     "the card disagrees with the host "
                                     "index walk")
            m["check_s"] += time.perf_counter() - t1
            return ptrs, probes

        pool.sync_index = sync_index
        pool.index_lookup_batch = index_lookup_batch
        return m

    def _variant_mix(self, c, variant, mix, load, batches, run, probe,
                     out) -> None:
        """``batches`` batches of ``load``'s ops through ``c``'s
        execute_batch, each followed by one simulated second's merging
        under its allowance; each batch's kernel-A launches held to
        clht_probe_ref; its writes noted in ``run``. Emits the mix's
        ops/s (synchronized execute_batch seconds less the read checks),
        aggregate_stats(), ms_ops, PLAN_STATS, kernel A's launches and
        keys, index_lookup_batch's seconds split into the sync_index
        upload and the probe, and the garbage collector's passes inside
        execute_batch (seconds, count by generation)."""
        c.reset_stats()
        budget = int(DEFAULT_MODEL.merge_capacity())
        probe["events"].clear()          # uploads outside these batches
        before = dict(probe)
        a0 = _build.launches["clht_probe"]
        plan = dict.fromkeys(PLAN_STATS, 0)
        sec = 0.0
        gcs = {"s": 0.0, "collections": [0, 0, 0]}
        for _ in range(batches):
            kinds, keys = load.ops_arrays(CLUSTER_BATCH)
            base = run["ops"]
            c.pool.merge_allowance = budget
            reset_plan_stats()
            check0 = probe["check_s"]
            with recorded(probe_ops, "clht_probe", clone=True) as calls, \
                    gc_meter() as g:
                res, s = synced(lambda: c.execute_batch(
                    kinds, keys, values=lambda i: f"w{base + i}"))
            sec += s - (probe["check_s"] - check0)
            probe["sync_s"] += sum(a.elapsed_time(b)
                                   for a, b in probe["events"]) / 1e3
            probe["events"].clear()
            gcs["s"] += g["s"]
            gcs["collections"] = [a + b for a, b in
                                  zip(gcs["collections"], g["collections"])]
            for k, v in PLAN_STATS.items():
                plan[k] += v
            n_calls = self._pool_probe_check(calls, variant)
            run["checked"] += n_calls
            if variant == "clover" and not n_calls:
                raise AssertionError(f"clover: a {mix} batch launched no "
                                     f"kernel A")
            c.advance_merge(budget)
            c.pool.merge_allowance = None
            refused = sum(kn.stats.refused for kn in c.kns.values())
            if res.executed != keys.size or refused:
                raise AssertionError(f"{variant}: {keys.size - res.executed}"
                                     f" ops not executed, {refused} "
                                     f"refused")
            wpos = np.flatnonzero(kinds == 1)
            lw = _last_writes(keys[wpos])
            run["last"][keys[wpos][lw]] = base + wpos[lw]
            run["ops"] += keys.size
        agg = c.aggregate_stats()
        d = {k: probe[k] - before[k] for k in probe if k != "events"}
        ops = batches * CLUSTER_BATCH
        out["mix"][(variant, mix)] = {"ops_per_s": ops / sec,
                                      "rts_per_op": agg["rts_per_op"]}
        emit({"phase": "cluster_variant_mix", "variant": variant,
              "mix": mix, "ops": ops, "execute_batch_s": sec,
              "ops_per_s": ops / sec,
              **{k: float(agg[k]) for k in ("rts_per_op", "hit_ratio",
                                            "value_hit_ratio")},
              "write_stalls": agg["write_stalls"], "ms_ops": c.ms_ops,
              "plan_stats": plan,
              "kernel_a_launches": _build.launches["clht_probe"] - a0,
              "kernel_a_keys": d["keys"],
              "index_lookup_s": d["s"], "sync_upload_s": d["sync_s"],
              "sync_rows": d["rows"], "sync_bytes": d["bytes"],
              "probe_s": d["s"] - d["sync_s"],
              "host_walk_check_s_excluded": d["check_s"],
              "gc_s": gcs["s"], "gc_collections": gcs["collections"]})

    def _variant_twin(self, variant: str) -> dict:
        """``variant`` at 2^CLUSTER_TWIN_KEYS_LOG2 keys as two clusters
        on the card: the batched engine (array caches; clover's batched
        plane) and the fused per-op loop over the reference caches
        (reference_cache=True). The first CLUSTER_TWIN_BATCHES batches of
        each mix, then a read_only batch, a KN added between the mixes;
        after each batch every BatchResult field and collected value,
        cluster_snapshot, aggregate_stats(), the versions, the
        metadata-server ops, the pool's index row for row and each KN's
        cache contents (torch_cluster_cases.cache_contents: entries in
        LRU order) are equal. Outside the main path's launch counts."""
        n = 1 << CLUSTER_TWIN_KEYS_LOG2
        batches = 0
        budget = int(DEFAULT_MODEL.merge_capacity())
        with uncounted():
            pair = [self._cluster_at(n, rc, VARIANTS[variant])
                    for rc in (False, True)]
            steps = [(m, CLUSTER_TWIN_BATCHES) for m in CLUSTER_MIXES] + \
                [("read_only", 1)]
            for mix, nb in steps:
                if mix == CLUSTER_MIXES[1]:
                    for c in pair:
                        c.add_kn()
                loads = [Workload(n, zipf=ZIPF, mix=mix, seed=SEED + 5)
                         for _ in pair]
                for _ in range(nb):
                    got = []
                    for c, load in zip(pair, loads):
                        kinds, keys = load.ops_arrays(CLUSTER_BATCH)
                        c.pool.merge_allowance = budget
                        res = c.execute_batch(kinds, keys,
                                              values=lambda i: f"w{i}",
                                              collect_values=True)
                        c.advance_merge(budget)
                        c.pool.merge_allowance = None
                        got.append((
                            res.executed, res.writes, res.per_kn,
                            res.executed_keys.tolist(), res.values,
                            cluster_snapshot(c), c.aggregate_stats(),
                            dict(c.versions), c.ms_ops, pool_index(c.pool),
                            {nm: cache_contents(kn.cache)
                             for nm, kn in c.kns.items()}))
                    if got[0] != got[1]:
                        part = next(i for i, (a, b) in enumerate(
                            zip(*got)) if a != b)
                        raise AssertionError(f"{variant} twin: the batched "
                                             f"engine and the per-op oracle "
                                             f"part in {mix} (field "
                                             f"{part})")
                    batches += 1
        return {"keys": n, "batches": batches, "equal": True,
                "aggregate": {k: float(v) for k, v in got[0][6].items()},
                "ms_ops": got[0][8]}

    # ------------------------------------------- the planes around the cluster
    def timed(self) -> None:
        """The paper's Fig. 6 timeline (auto-scaling under a bursty load,
        benchmarks/fig6_elasticity.py) through the port's TimedSimulation
        on the cluster phase's dataset: three legs, each a cluster taking
        its own copy of that phase's pool as loaded (unpickled from the
        bytes it kept; 4 KNs, caches CACHE_FRAC of the data, segments of
        CLUSTER_SEGMENT) under the figure's policy (TIMED_POLICY):
        dinomo by the host engine, dinomo by engine="jit" (kernel E) in
        lockstep with it, one step of each at a time, and dinomo-n (the
        figure's contrast: a physical reorganization of the 32 GB dataset
        at every membership change). TIMED_DURATION simulated seconds at
        TIMED_DT, TIMED_SAMPLE_OPS sampled ops a step of YCSB
        write_heavy_update at zipf 0.5, 8e6/7 ops/s offered, 8e6 inside
        TIMED_BURST. After every join and removal the participants' caches
        are cleared and their outage windows block them for the next
        steps (blocked_kns, on the jit path too); their reads then miss
        and go through kernel A.

        After every step the dinomo legs' newest TimePoints are equal
        field for field, and so are their aggregate_stats() and
        reconfiguration records; after every join or removal their
        cluster_snapshots. Both make a join and a removal. Every kernel-A
        launch equals clht_probe_ref on its inputs, and the first
        kernel-E launch of each KN after each membership change
        fused_window_ref. Then every key written in the timeline and 2^12
        unwritten ones read through batch_read, equal between the dinomo
        legs and to the pool's host walk (index, indirection, heap) after
        merge_all; verify_integrity() empty on every leg. Last, the
        open-loop request plane on the host leg (run_open_loop over
        OPEN_LOOP_S s at OPEN_LOOP_POINTS of estimated_capacity): no shed
        or failed request ID applied, integrity empty, and past
        saturation something shed and the admitted p999 within
        admitted_latency_bound (bench_latency.py's gates)."""
        n = 1 << CLUSTER_KEYS_LOG2
        t_phase = time.perf_counter()
        _build.reset_counts()
        blob = self.loaded_pool
        del self.loaded_pool
        sims, written = {}, []
        for leg, variant, engine in TIMED_LEGS:
            t0 = time.perf_counter()
            c = self._cluster_at(n, False, VARIANTS[variant],
                                 pool=pickle.loads(blob),
                                 policy=PolicyConfig(**TIMED_POLICY))
            wl = Workload(n, zipf=TIMED_ZIPF, mix=TIMED_MIX, seed=SEED)
            sample = wl.timed_batched
            if leg == "host":
                def sample(t, rng, k, _wl=wl):
                    kinds, keys = _wl.timed_batched(t, rng, k)
                    written.append(keys[kinds != 0])
                    return kinds, keys
            sims[leg] = TimedSimulation(
                c, sample, dt=TIMED_DT, sample_ops=TIMED_SAMPLE_OPS,
                seed=SEED, dataset_bytes=TIMED_DATASET_BYTES, engine=engine)
            emit({"phase": "timed_load", "leg": leg, "variant": variant,
                  "seconds": time.perf_counter() - t0})
        del blob
        # the three clusters' loaded objects live to the end of the phase:
        # out of the collector's walks, as bench_dataplane.py's timed
        # loop keeps them (gc.disable there)
        gc.collect()
        gc.freeze()
        reconfigs = []
        # per leg: the steps timed and their seconds (a profiled step is
        # left out), execute_batch's and the DPM merges' seconds inside
        # them, ENGINE_WALL's
        legs = {leg: {"steps": 0, "s": 0.0, "execute_batch_s": 0.0,
                      "merge_s": 0.0, "wall": self._zero_wall()}
                for leg in sims}
        for leg, sim in sims.items():
            self._timed_reconfigs(sim, leg, reconfigs)
            self._timed_batches(sim.c, legs[leg])
        host, jit = sims["host"].c, sims["jit"].c
        run = {"e_checked": 0, "window_case": None, "held_s": 0.0}
        first: set = set()          # KNs whose first launch was held
        gcs = {"s": 0.0, "collections": [0, 0, 0]}
        # profiled: the second step after the first join (the step right
        # after it is blocked by the participants' outage)
        steps, profile_at = 0, None
        from torch.profiler import ProfilerActivity as act, profile
        with held_probes("timed") as probes:
            while sims["host"].now < TIMED_DURATION:
                nrec = len(host.reconfig_log)
                for leg, sim in sims.items():
                    t = legs[leg]
                    merge0 = sim.c.pool.merge_wall_s
                    with contextlib.ExitStack() as stack:
                        g = stack.enter_context(gc_meter())
                        if leg == "jit":
                            stack.enter_context(
                                self._held_windows(sim.c, run, first))
                        prof = stack.enter_context(profile(
                            activities=[act.CPU, act.CUDA])) \
                            if steps == profile_at and leg != "dinomo-n" \
                            else None
                        wall0, held0 = dict(ENGINE_WALL), run["held_s"]
                        eb0, probe0 = t["execute_batch_s"], probes["s"]
                        _, s = synced(lambda: sim.run(sim.now + TIMED_DT,
                                                      self._timed_offered))
                    # the held checks' seconds are no part of the path:
                    # kernel E's sit inside the jit engine's dispatch
                    held_e = run["held_s"] - held0
                    held = held_e + probes["s"] - probe0
                    s -= held
                    ENGINE_WALL["jit_dispatch"] -= held_e
                    t["execute_batch_s"] -= held
                    if prof is not None:
                        t["execute_batch_s"] = eb0
                        emit({"profile": f"timed {leg} leg, the step at "
                                         f"t={sim.now - TIMED_DT}, the "
                                         f"second after the first join",
                              **device_summary(prof, s)})
                        continue
                    t["steps"] += 1
                    t["s"] += s
                    t["merge_s"] += sim.c.pool.merge_wall_s - merge0
                    for k, v in ENGINE_WALL.items():
                        t["wall"][k] += v - wall0[k]
                    gcs["s"] += g["s"]
                    gcs["collections"] = [a + b for a, b in zip(
                        gcs["collections"], g["collections"])]
                steps += 1
                a, b = sims["host"], sims["jit"]
                if dataclasses.astuple(a.trace[-1]) != \
                        dataclasses.astuple(b.trace[-1]) or \
                        host.aggregate_stats() != jit.aggregate_stats() or \
                        host.reconfig_log != jit.reconfig_log:
                    raise AssertionError(f"timed: the host and jit legs "
                                         f"part at t={a.trace[-1].t}")
                for rec in host.reconfig_log[nrec:]:
                    self._cluster_equal(host, jit, f"the timeline's "
                                        f"{rec['event']} of {rec['node']}")
                    first.clear()   # hold each KN's next launch again
                    if len(host.reconfig_log) == 1:
                        profile_at = steps + 1
            events = {leg: [r["event"] for r in sim.c.reconfig_log]
                      for leg, sim in sims.items()}
            for leg in ("host", "jit"):
                if "add" not in events[leg] or "remove" not in events[leg]:
                    raise AssertionError(f"timed ({leg}): the timeline made "
                                         f"no join or no removal: "
                                         f"{events[leg]}")
            emit({"phase": "timed_timeline", "steps": steps,
                  "simulated_s": TIMED_DURATION,
                  "sampled_ops_per_s": {
                      leg: t["steps"] * TIMED_SAMPLE_OPS / t["s"]
                      for leg, t in legs.items()},
                  "steps_timed": {leg: t["steps"] for leg, t in
                                  legs.items()},
                  "seconds": {leg: t["s"] for leg, t in legs.items()},
                  "execute_batch_s": {leg: t["execute_batch_s"]
                                      for leg, t in legs.items()},
                  "merge_s": {leg: t["merge_s"] for leg, t in
                              legs.items()},
                  "held_check_s_excluded": run["held_s"] + probes["s"],
                  "gc_s": gcs["s"], "gc_collections": gcs["collections"],
                  "kns_over_time": {
                      leg: self._kn_changes(sim.trace)
                      for leg, sim in sims.items()},
                  "reconfigs_by_leg": events,
                  "burst_min_tput": {
                      leg: min(p.throughput for p in sims[leg].trace
                               if 40.0 <= p.t <= TIMED_DURATION - 75.0)
                      for leg in ("host", "dinomo-n")},
                  "engine_wall_s": {
                      leg: {k: v for k, v in t["wall"].items() if v}
                      for leg, t in legs.items()},
                  "jit": jit._jit.counts,
                  "kernel_e_launches": _build.launches["fused_window"],
                  "kernel_e_first_launches_equal_to_plain":
                  run["e_checked"],
                  "kernel_a_launches": _build.launches["clht_probe"]})
            for rec in reconfigs:
                emit({"phase": "timed_reconfig", **rec})
            self._timed_read_back(sims, written)
            for leg, sim in sims.items():
                problems = sim.c.pool.verify_integrity()
                if problems:
                    raise AssertionError(f"timed ({leg}): verify_integrity:"
                                         f" {problems[:4]}")
            for frac, kind in OPEN_LOOP_POINTS:
                self._open_loop(sims["host"], frac, kind)
            checked = probes["checked"]
        gc.unfreeze()
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        if counts["clht_probe"] != checked or not checked:
            raise AssertionError(f"timed: kernel A launched "
                                 f"{counts['clht_probe']} times, {checked} "
                                 f"held to its plain version")
        if not counts["fused_window"] or not run["e_checked"]:
            raise AssertionError("timed: no kernel-E launch, or none held")
        self.tally("timed", counts)
        emit({"phase": "timed", "seconds": time.perf_counter() - t_phase,
              "kernel_a_launches_equal_to_plain": checked,
              "kernel_e_launches_equal_to_plain": run["e_checked"],
              "launches": {k: v for k, v in counts.items() if v}})

    @staticmethod
    def _timed_offered(t: float) -> float:
        """Fig. 6's offered load: TIMED_HIGH inside TIMED_BURST, else
        TIMED_LOW."""
        lo, hi = TIMED_BURST
        return TIMED_HIGH if lo <= t <= hi else TIMED_LOW

    @staticmethod
    def _kn_changes(trace) -> list:
        """(t, KNs) at the start and at each change of the KN count."""
        out = []
        for p in trace:
            if not out or out[-1][1] != p.num_kns:
                out.append((p.t, p.num_kns))
        return out

    @staticmethod
    def _timed_batches(c, tally: dict) -> None:
        """Add the host seconds of each of ``c``'s execute_batch calls
        (synchronized: the pool's index reads and the jit engine's
        scatter-backs end in copies to the host) to
        ``tally["execute_batch_s"]``."""
        real = c.execute_batch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                tally["execute_batch_s"] += time.perf_counter() - t0

        c.execute_batch = timed

    @staticmethod
    def _timed_reconfigs(sim, leg: str, out: list) -> None:
        """Time each reconfiguration the M-node's decisions make (the
        synchronous merge and handoff on the host, the cleared caches
        leaving the card) into ``out``, with its record."""
        real = sim._apply

        def apply(action):
            n0 = len(sim.c.reconfig_log)
            t0 = time.perf_counter()
            real(action)
            torch.cuda.synchronize()
            if len(sim.c.reconfig_log) > n0:
                rec = sim.c.reconfig_log[-1]
                out.append({"leg": leg, "t": sim.now, "event": rec["event"],
                            "node": rec["node"],
                            "seconds": time.perf_counter() - t0,
                            "merged_entries": rec["merged_entries"],
                            "participants": rec["participants"],
                            "moved_fraction": rec["moved_fraction"],
                            "kns": len(sim.c.kns)})

        sim._apply = apply

    def _timed_read_back(self, sims, written) -> None:
        """Every key written in the timeline (whether its op ran or its
        owner was blocked) and 2^12 never written, read through batch_read
        on both dinomo legs after merge_all: equal between the legs and to
        the pool's host walk (the index, the indirection table for a
        replicated key, the heap)."""
        keys = np.unique(np.concatenate(written))
        never = np.setdiff1d(np.arange(1 << 13, dtype=np.int64), keys)
        keys = np.concatenate([keys, never[:1 << 12]])
        got = {}
        for leg in ("host", "jit"):
            c = sims[leg].c
            t0 = time.perf_counter()
            c.pool.merge_all()
            vals, _ = c.batch_read(keys)
            pool = c.pool
            ptrs = pool.index.lookup_batch(keys)[0]
            want = [pool.read_value(pool.indirect.get(k, p))[0]
                    if p >= 0 else None
                    for k, p in zip(keys.tolist(), ptrs.tolist())]
            if vals != want:
                bad = next(i for i, (v, w) in enumerate(zip(vals, want))
                           if v != w)
                raise AssertionError(f"timed ({leg}): key {keys[bad]} read "
                                     f"{vals[bad]!r}, the host walk "
                                     f"{want[bad]!r}")
            got[leg] = vals
            emit({"phase": "timed_read_back", "leg": leg,
                  "keys": int(keys.size),
                  "written_keys": int(keys.size - min(never.size, 1 << 12)),
                  "seconds": time.perf_counter() - t0, "equal": True})
        if got["host"] != got["jit"]:
            raise AssertionError("timed: the dinomo legs read back apart")

    def _open_loop(self, sim, frac: float, kind: str) -> None:
        """One open-loop run on ``sim`` (OPEN_LOOP_S s of ``kind``
        arrivals at ``frac`` of the alive KNs' estimated capacity, the
        request plane's defaults) and bench_latency.py's gates."""
        cfg = RequestPlaneConfig()
        alive = len(sim._alive_kns())
        cap = scen.estimated_capacity(sim.model, alive, TIMED_MIX)
        res, s = synced(lambda: sim.run_open_loop(
            OPEN_LOOP_S, ArrivalProcess(rate=frac * cap, kind=kind),
            config=cfg))
        pool = sim.c.pool
        never = [op.req_id for op in res.records
                 if op.kind != 0 and op.status in ("shed", "failed")
                 and not op.dispatched_ever]
        leaked = [r for r in never if pool.req_applied(r)]
        problems = pool.verify_integrity()
        pct = res.percentiles()
        cnt = res.counters
        bound = scen.admitted_latency_bound(cfg)
        row = {"phase": "timed_open_loop", "load_frac": frac,
               "arrival": kind, "kns": alive, "capacity_est": cap,
               "offered_rate": res.offered_rate, "goodput": res.goodput(),
               **pct, "offered": cnt["offered"],
               "completed": cnt["completed"], "shed": cnt["shed"],
               "failed": cnt["failed"], "retries": cnt["retries"],
               "dedup_hits": cnt["dedup_hits"],
               "queue_expired": cnt["queue_expired"],
               "executed": cnt["executed"], "latency_bound": bound,
               "exactly_once_leaks": len(leaked), "seconds": s}
        emit(row)
        if leaked or problems or not cnt["completed"]:
            raise AssertionError(f"timed open loop {frac}x {kind}: "
                                 f"{len(leaked)} shed or failed request IDs "
                                 f"applied, integrity {problems[:4]}, "
                                 f"{cnt['completed']} completed")
        if frac >= 1.5 and kind == "poisson" and (
                not cnt["shed"] or pct["p999"] is None
                or pct["p999"] > bound):
            raise AssertionError(f"timed open loop {frac}x: shed "
                                 f"{cnt['shed']}, admitted p999 "
                                 f"{pct['p999']} against {bound}")

    def scenarios(self) -> None:
        """The scenario harness (core/scenarios.py) on the card. Every row
        of run_suite's smoke profile (SCENARIOS x BENCH_VARIANTS, the
        fence scenarios for dinomo and dinomo-n) and run_overload(smoke)
        for dinomo and clover, on the card and again on the CPU in this
        process: each pair's row(), events, phases and gates equal (the
        CPU tests hold the CPU path to the reference). Then the full
        profile on the card alone (ScenarioConfig(), as
        benchmarks/bench_scenarios.py runs it): FULL_ROWS and
        run_overload for dinomo. Every row's violations empty, but
        composed on dinomo, which holds exactly the reference's own fault
        (REFERENCE_FAULT); the zombie's stale writes all fenced and its
        history linearizable; the overload's gates passed. Every kernel-A
        launch (every Clover batch, every miss read after a membership
        change) equals clht_probe_ref on its inputs."""
        t_phase = time.perf_counter()
        _build.reset_counts()
        over_variants = ("dinomo", "clover")
        with held_probes("scenarios") as probes:
            t0 = time.perf_counter()
            card = scen.run_suite(seed=SEED, smoke=True, device=self.dev)
            card_over = [scen.run_overload(variant=v, seed=SEED, smoke=True,
                                           device=self.dev)
                         for v in over_variants]
            smoke_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = scen.run_suite(seed=SEED, smoke=True, device="cpu")
            cpu_over = [scen.run_overload(variant=v, seed=SEED, smoke=True,
                                          device="cpu")
                        for v in over_variants]
            cpu_s = time.perf_counter() - t0
            for a, b in zip(card, cpu, strict=True):
                if a.row() != b.row() or a.events != b.events:
                    raise AssertionError(f"scenarios: {a.scenario} on "
                                         f"{a.variant} parts between the "
                                         f"card and the CPU")
                if a.violations:
                    raise AssertionError(f"scenarios: {a.scenario} on "
                                         f"{a.variant}: {a.violations}")
            for a, b in zip(card_over, cpu_over, strict=True):
                if a.row() != b.row() or not a.passed:
                    raise AssertionError(f"scenarios: the smoke overload on "
                                         f"{a.variant} parts between the "
                                         f"card and the CPU, or failed a "
                                         f"gate: {a.gates}")
            emit({"phase": "scenarios_smoke", "rows": len(card),
                  "overload_rows": len(card_over),
                  "card_equal_to_cpu": True, "card_s": smoke_s,
                  "cpu_s": cpu_s,
                  "kernel_a_launches": _build.launches["clht_probe"]})
            full = []
            for scenario, variant in FULL_ROWS:
                t0 = time.perf_counter()
                r = scen.run_scenario(scenario, variant, seed=SEED,
                                      device=self.dev)
                full.append(r)
                emit({"phase": "scenarios_full", "seconds":
                      time.perf_counter() - t0,
                      **{k: v for k, v in r.row().items()
                         if k not in ("recovery",)}})
            t0 = time.perf_counter()
            over = scen.run_overload(variant="dinomo", seed=SEED,
                                     device=self.dev)
            emit({"phase": "scenarios_full_overload",
                  "seconds": time.perf_counter() - t0, **over.row()})
            checked = probes["checked"]
        for r in full:
            want = []
            if (r.scenario, r.variant) == REFERENCE_FAULT[:2]:
                want = [v for v in r.violations
                        if v.startswith(REFERENCE_FAULT[2])]
                if len(want) != 1:
                    raise AssertionError(f"scenarios: composed on dinomo "
                                         f"lost the reference's fault: "
                                         f"{r.violations}")
            if r.violations != want:
                raise AssertionError(f"scenarios: {r.scenario} on "
                                     f"{r.variant}: {r.violations}")
            if r.scenario == "zombie" and not (
                    r.extra["zombie_fenced"] == r.extra["zombie_attempts"]
                    and r.extra["linearizable"]):
                raise AssertionError(f"scenarios: zombie {r.extra}")
        if not over.passed:
            raise AssertionError(f"scenarios: the full overload failed: "
                                 f"{over.gates} {over.violations}")
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        if counts["clht_probe"] != checked or not checked:
            raise AssertionError(f"scenarios: kernel A launched "
                                 f"{counts['clht_probe']} times, {checked} "
                                 f"held to its plain version")
        self.tally("scenarios", counts)
        emit({"phase": "scenarios", "seconds": time.perf_counter() - t_phase,
              "smoke_rows_equal_to_cpu": len(card) + len(card_over),
              "full_rows": len(full) + 1,
              "reference_fault": REFERENCE_FAULT[2],
              "kernel_a_launches_equal_to_plain": checked,
              "launches": {k: v for k, v in counts.items() if v}})

    def time_transition(self) -> list[dict]:
        """Kernel 4 on a 512-op window of the KN path that consumed
        victims, the launch alone, against the plain torch loop; beside it
        the wrapper's time by both routes (its int32 guard reading the
        rows' largest value size back, or given it by a caller that holds
        the rows, as the KN path does) and the launch over as many
        neutral rows (no scan work). No PyTorch call runs a sequential
        space machine, so library_ms is null.

        Bound: the bytes the function moves -- each 32-byte row read,
        each victim consumed read (4 B), three int32 outputs per op
        written -- at the memory rate. The scan is one dependent chain,
        so the kernel is latency-bound, as kernel D is."""
        rows, victims, used0, z0, cap = self.transition_case
        dev = self.dev
        r = torch.from_numpy(rows).to(dev)
        v = torch.from_numpy(victims.astype(np.int32)).to(dev)
        n = rows.shape[0]
        nvic = int(transition.cache_transition_np(rows, victims, used0, z0,
                                                  cap=cap)[1][-1])

        def launch_only():
            outs = [torch.empty(n, dtype=torch.int32, device=dev)
                    for _ in range(3)]
            transition.launch(r, v, used0, z0, cap, *outs)
            return outs

        wrapper_ms = event_ms(lambda: transition.cache_transition(
            r, v, used0, z0, cap=cap), REPS)[0]
        top = int(rows[:, 2].max())
        host_guard_ms = event_ms(lambda: transition.cache_transition(
            r, v, used0, z0, cap=cap, top=top), REPS)[0]
        # the same launch over neutral rows: what a launch costs with no
        # scan work behind it
        idle = torch.zeros_like(r)
        launch_ms = event_ms(lambda: transition.launch(
            idle, v, used0, z0, cap, *(torch.empty(n, dtype=torch.int32,
                                                   device=dev)
                                       for _ in range(3))), REPS)[0]
        row = self._timed(
            "cache_transition", "cache_transition.cu",
            "src/repro/kernels/cache_transition/cache_transition.py:125",
            ("dec", "nvic", "used"), launch_only,
            lambda: transition.cache_transition_ref(r, v, used0, z0, cap=cap),
            None, n * 32 + nvic * 4 + 3 * 4 * n, REPS, plain_reps=1,
            extra={"ops": n, "victims_consumed": nvic,
                   "queue": int(victims.size), "wrapper_ms": wrapper_ms,
                   "wrapper_host_guard_ms": host_guard_ms,
                   "neutral_rows_ms": launch_ms})
        emit({"redesigned": "cache_transition", "ms": row["ms"],
              "before_ms": BEFORE_SLICE7_MS["cache_transition"],
              "inputs": f"a {n}-op window of the KN path that consumed "
                        f"{nvic} victims, the launch alone",
              "before": BEFORE_SLICE7})
        return [row]

    def time_fused_window(self) -> list[dict]:
        """Kernel E and the three kernels that move a resident state's
        changed slots, at the cluster phase's shapes (2^21 slots).

        Kernel E's row: the largest KN window held to its plain version in
        the write-heavy mix (one job over 2^21 slots: kn2's first window,
        the one BEFORE_SLICE10 timed), the launch alone on fresh copies of
        its state, trees and an empty dirty record each run (as the jit
        engine runs it), and with the tree build first. Plain ms is
        fused_window_ref on the host (its argmin victims scan the slots);
        beside it the host engine's time for that KN's window of the same
        batch. Then a window that consumes victims from both trees
        (tests/torch_cases.py:window_victims_case at 2^21 slots), and the
        four KNs' first held windows in one launch against the four
        launched one by one. No PyTorch call runs the DAC state machine,
        so library_ms is null.

        Bound: the bytes the function must move -- the window's six
        int32 inputs, per distinct key its ops touch the entry's six
        fields read and written, per victim its length and count read and
        kind written, the histogram and registers in and out, the header
        and the event and out_ptr tapes written -- at the memory rate (the
        build adds kind, count and stamp read and both trees written). The
        loop is a chain of dependent steps: it is latency-bound."""
        case = self.window_case
        if case is None:
            raise AssertionError("time_fused_window: no write-heavy window "
                                 "was held in the cluster phase")
        dev = self.dev
        fw = importlib.import_module("repro_torch.kernels.batch_executor"
                                     ".ops")

        def on_card(c):
            return {"state": tuple(torch.from_numpy(a).to(dev)
                                   for a in c["state"]),
                    "window": tuple(torch.from_numpy(a).to(dev)
                                    for a in c["window"]),
                    "vmax": torch.from_numpy(c["vmax"]).to(dev),
                    "trees": c["trees"] if c["trees"] is not None else
                    batch_executor.build_trees(tuple(
                        torch.from_numpy(a).to(dev) for a in c["state"]))}

        def jobs_of(cases_, build=False):
            """Fresh card copies of the cases' states, trees and dirty
            records as jobs, with their launch descriptor (the trees are
            built at the launch with ``build``)."""
            jobs = []
            for c, d in cases_:
                st = tuple(t.clone() for t in d["state"])
                tr = None if build else tuple(t.clone() for t in d["trees"])
                jobs.append(batch_executor.WindowJob(
                    st, d["window"], c["n"], c["cap"], c["wb"], d["vmax"],
                    tr, batch_executor.new_dirty(st[0].shape[0], dev)))
            if build:
                return None, None, 0, jobs
            return (*fw.prepare(jobs), jobs)

        def launch_only(desc, out, ops, jobs):
            if desc is None:         # the tree build, then the launch
                jobs = [j._replace(trees=batch_executor.build_trees(j.state))
                        for j in jobs]
                desc, out, ops = fw.prepare(jobs)
            fw.launch(desc, ops)
            return out, jobs

        def held(c, out, job):
            """max |kernel - plain| over the header, tapes and state, and
            the plain version's seconds."""
            t0 = time.perf_counter()
            want = batch_executor.fused_window_ref(
                tuple(a.copy() for a in c["state"]), *c["window"], c["n"],
                c["cap"], c["wb"], c["vmax"])
            plain_s = time.perf_counter() - t0
            ne, n = want[0], c["n"]
            head = np.array([ne, want[4], *want[1][7]], np.int64)
            h = out.packed.cpu().numpy().astype(np.int64)
            pairs = [(h[:fw.HEADER], head),
                     (h[fw.HEADER:fw.HEADER + ne], want[2][:ne]),
                     (h[fw.HEADER + n:fw.HEADER + n + ne], want[3][:ne])]
            pairs += [(a.cpu().numpy(), b) for a, b in zip(job.state,
                                                           want[1])]
            err = max(int(np.abs(a.astype(np.int64)
                                 - b.astype(np.int64)).max())
                      for a, b in pairs if a.size)
            return err, plain_s, want

        def window_bytes(c, want):
            ne = want[0]
            touched = np.unique(c["window"][1][:ne]).size
            regs0, regs1 = c["state"][7], want[1][7]
            victims = int(regs1[6] - regs0[6] + regs1[7] - regs0[7])
            return (6 * c["n"] * 4 + touched * 6 * 4 * 2 + victims * 12
                    + 2 * (65 + 8) * 4 + (fw.HEADER + 1) * 4
                    + 2 * c["n"] * 4), touched, victims

        with uncounted():
            one = [(case, on_card(case))]
            ms, (outs, jobs) = event_ms(launch_only, REPS,
                                        lambda: jobs_of(one))
            build_ms, (outs_b, jobs_b) = event_ms(
                launch_only, REPS, lambda: jobs_of(one, build=True))
            err, plain_s, want = held(case, outs[0], jobs[0])
            err = max(err, held(case, outs_b[0], jobs_b[0])[0])
            nbytes, touched, victims = window_bytes(case, want)
            s = case["state"][0].shape[0]
            build_bytes = 3 * s * 4 + 2 * (2 * s) * 8
            host = case["host"]
            row = {"name": "fused_window", "route": "cuda",
                   "source": "src/repro_torch/csrc/fused_window.cu",
                   "replaces": "src/repro/kernels/batch_executor/ops.py:419",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_s * 1e3,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "library_ms": None}
            emit({"timing": "fused_window", "ms": ms,
                  "plain_ms": row["plain_ms"], "library_ms": None,
                  "bound_ms": row["bound_ms"], "max_abs_err": err,
                  "kn": case["kn"], "slots": s, "ops": case["n"],
                  "executed": want[0], "cut": int(want[4]),
                  "us_per_op": ms * 1e3 / max(want[0], 1),
                  "distinct_keys": touched, "victims": victims,
                  "with_tree_build_ms": build_ms,
                  "with_tree_build_bound_ms": (nbytes + build_bytes)
                  / HBM_BYTES_PER_S * 1e3,
                  "held_check_plain_s": case["plain_s"],
                  "host_engine_window": None if host is None else
                  {"ops": host[0], "ms": host[1] * 1e3}})
            emit({"redesigned": "fused_window", "ms": ms,
                  "before_ms": BEFORE_SLICE10_MS["fused_window"],
                  "ops": case["n"],
                  "before_ops": BEFORE_SLICE10_MS["fused_window_ops"],
                  "inputs": f"{case['kn']}'s first write-heavy window of "
                            f"{case['n']} ops over {s} slots, the launch "
                            f"alone",
                  "before": BEFORE_SLICE10})

            # a window that consumes victims from both trees
            vcase = dict(zip(("state", "wins", "cap", "wb", "amr"),
                             window_victims_case(SEED, s, VICTIM_WINDOW_OPS,
                                                 1, VICTIM_WINDOW_VALUES)))
            win = vcase["wins"][0]
            vc = {"state": vcase["state"], "window": list(win[:6]),
                  "n": win[6], "cap": vcase["cap"], "wb": vcase["wb"],
                  "vmax": batch_executor.build_promote_table(vcase["amr"]),
                  "trees": None}
            vone = [(vc, on_card(vc))]
            vms, (vouts, vjobs) = event_ms(launch_only, REPS,
                                           lambda: jobs_of(vone))
            verr, vplain_s, vwant = held(vc, vouts[0], vjobs[0])
            vbytes, vtouched, vvictims = window_bytes(vc, vwant)
            if verr or not (vwant[1][7][6] > vc["state"][7][6]
                            and vwant[1][7][7] > vc["state"][7][7]):
                raise AssertionError(f"time_fused_window: the victim window "
                                     f"parts from its plain version (err "
                                     f"{verr}) or did not demote and "
                                     f"evict")
            emit({"timing": "fused_window_victims", "ms": vms,
                  "plain_ms": vplain_s * 1e3,
                  "bound_ms": vbytes / HBM_BYTES_PER_S * 1e3,
                  "max_abs_err": verr, "slots": s, "ops": vc["n"],
                  "executed": vwant[0], "cut": int(vwant[4]),
                  "us_per_op": vms * 1e3 / max(vwant[0], 1),
                  "distinct_keys": vtouched, "victims": vvictims,
                  "demotions": int(vwant[1][7][6] - vc["state"][7][6]),
                  "evictions": int(vwant[1][7][7] - vc["state"][7][7])})

            # the four KNs' first held windows: one launch, and one by one
            four = [(c, on_card(c)) for c in self.held_jobs.values()]
            fms, (fouts, fjobs) = event_ms(launch_only, REPS,
                                           lambda: jobs_of(four))
            ferr = 0
            fops = 0
            fbytes = 0
            for (c, _), out, job in zip(four, fouts, fjobs):
                e, _, w = held(c, out, job)
                ferr = max(ferr, e)
                fops += w[0]
                fbytes += window_bytes(c, w)[0]
            sep = sum(event_ms(launch_only, REPS,
                               lambda c=c: jobs_of([c]))[0] for c in four)
            if ferr:
                raise AssertionError("time_fused_window: the four-KN launch "
                                     "parts from its plain version")
            emit({"timing": "fused_window_four_kns", "ms": fms,
                  "one_by_one_ms": sep, "kns": [c["kn"] for c, _ in four],
                  "ops": [c["n"] for c, _ in four], "executed": fops,
                  "us_per_op": fms * 1e3 / max(fops, 1),
                  "bound_ms": fbytes / HBM_BYTES_PER_S * 1e3,
                  "max_abs_err": ferr})
            rows = [row] + self.time_moved_slots(case, on_card(case)["state"])
        return rows

    def time_moved_slots(self, case, state) -> list[dict]:
        """The jit engine's three transfer kernels at the cluster phase's
        shapes (2^21 slots): fused_window_gather on as many dirty slots as
        a write-heavy sync moved on average, fused_window_scatter on as
        many as a delta upload sent (fields from the state, the trees
        repaired, or rebuilt past 2048 slots), fused_window_guards over
        the slots. Each against its plain version on host copies (gather
        as sets: the record's order is the launch's); plain ms is that
        version's host time. No one PyTorch call computes any of the
        three (each also clears or repairs what the engine keeps), so
        library_ms is null.

        Bounds, bytes: gather reads the count, n list entries and the n
        slots' five fields and writes the 73 + 6 n outputs, n wrote
        flags and n bitmap words; scatter reads 73 + 6 n inputs, writes
        n slots' five fields, their leaves and every distinct tree node
        on their paths; guards reads four arrays over the slots and
        writes three maxima."""
        dev = self.dev
        s = state[0].shape[0]
        rng = np.random.default_rng(SEED + 21)
        gather_n, scatter_n = self.moved_n
        gather_n = max(int(gather_n), 1)
        scatter_n = max(int(scatter_n), 1)
        words = (s + 31) // 32
        rows = []

        # gather: a dirty record of gather_n slots
        keys = rng.choice(s, gather_n, replace=False).astype(np.int32)
        rec = np.zeros(1 + words + s, np.int32)
        rec[0] = gather_n
        bits = rec[1:1 + words].view(np.uint32)
        np.bitwise_or.at(bits, keys >> 5, (np.uint32(1) << (keys & 31))
                         .astype(np.uint32))
        rec[1 + words:1 + words + gather_n] = keys
        drec = torch.from_numpy(rec).to(dev)

        def g_setup():
            return tuple(t.clone() for t in state), drec.clone()

        ms, got = event_ms(lambda st, d: batch_executor.gather_dirty(
            st, d, gather_n), REPS, g_setup)
        cpu = tuple(torch.from_numpy(a.copy()) for a in case["state"])
        t0 = time.perf_counter()
        want = batch_executor.gather_dirty(cpu, torch.from_numpy(rec.copy()),
                                           gather_n).numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = got.cpu().numpy()
        meta = batch_executor.META
        go = np.argsort(got[meta:meta + gather_n])
        wo = np.argsort(want[meta:meta + gather_n])
        err = int(np.abs(got[:meta].astype(np.int64) - want[:meta]).max())
        for f in range(1 + batch_executor.FIELDS):
            blk = slice(meta + f * gather_n, meta + (f + 1) * gather_n)
            err = max(err, int(np.abs(got[blk][go].astype(np.int64)
                                      - want[blk][wo]).max()))
        nbytes = 4 + gather_n * 4 * (1 + 5) + (meta + 6 * gather_n) * 4 \
            + gather_n * 4 * 2
        rows.append(self._moved_row("fused_window_gather", ms, plain_ms,
                                    nbytes, err, {"slots": s,
                                                  "moved": gather_n}))

        # scatter: scatter_n slots' fields (the state's own, perturbed)
        keys = np.sort(rng.choice(s, scatter_n, replace=False)).astype(
            np.int32)
        fields = [case["state"][j][keys].astype(np.int64) for j in range(5)]
        fields[0] = rng.integers(0, 3, scatter_n)
        fields[1] = fields[1] + rng.integers(0, 3, scatter_n)
        srec = np.concatenate([case["state"][6], case["state"][7], keys,
                               *fields]).astype(np.int32)
        dsrec = torch.from_numpy(srec).to(dev)
        trees0 = batch_executor.build_trees(state)

        def s_setup():
            return (tuple(t.clone() for t in state),
                    tuple(t.clone() for t in trees0))

        def scatter(st, tr):
            batch_executor.scatter_slots(st, tr, dsrec)
            return st, tr

        ms, (st, tr) = event_ms(scatter, REPS, s_setup)
        cpu = tuple(torch.from_numpy(a.copy()) for a in case["state"])
        t0 = time.perf_counter()
        batch_executor.scatter_slots(cpu, None, torch.from_numpy(srec))
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((a.cpu().long() - b.long()).abs().max())
                  for a, b in zip(st, cpu))
        fresh = batch_executor.build_trees(st)
        if not all(torch.equal(a[1:], b[1:]) for a, b in zip(tr, fresh)):
            raise AssertionError("fused_window_scatter: the repaired trees "
                                 "differ from a fresh build")
        h = s.bit_length() - 1
        nodes = sum(np.unique((s + keys.astype(np.int64)) >> j).size
                    for j in range(h + 1))
        nbytes = (meta + 6 * scatter_n) * 4 + 5 * scatter_n * 4 \
            + 2 * nodes * 8
        rows.append(self._moved_row("fused_window_scatter", ms, plain_ms,
                                    nbytes, err, {"slots": s,
                                                  "moved": scatter_n,
                                                  "tree_nodes": 2 * nodes}))

        # guards: the three maxima over the slots
        ms, got = event_ms(lambda: batch_executor.guard_maxima(state, s),
                           REPS)
        cpu = tuple(torch.from_numpy(a.copy()) for a in case["state"])
        t0 = time.perf_counter()
        want = batch_executor.guard_maxima(cpu, s).numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int(np.abs(got.cpu().numpy().astype(np.int64) - want).max())
        rows.append(self._moved_row("fused_window_guards", ms, plain_ms,
                                    4 * s * 4 + 12, err, {"slots": s}))
        return rows

    @staticmethod
    def _moved_row(name, ms, plain_ms, nbytes, err, extra) -> dict:
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/csrc/fused_window.cu",
               "replaces": "src/repro/kernels/batch_executor/ops.py:419",
               "launches": None, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": None}
        if err:
            raise AssertionError(f"{name}: kernel and plain version part "
                                 f"by {err}")
        emit({"timing": name, "ms": ms, "plain_ms": plain_ms,
              "library_ms": None, "bound_ms": row["bound_ms"],
              "max_abs_err": err, **extra})
        return row

    # --------------------------------------------------- 8. check 5 and 6
    def check_attention(self) -> None:
        """Kernels 5 and 6 against their plain versions at the sweep
        shapes of tests/test_kernels.py (causal only at Sq == Sk; GQA,
        f32 and bf16, slots with page id -1 or past the length), and the
        ownership split/merge invariance."""
        dev = self.dev
        g = np.random.default_rng(SEED)

        def rand(shape, dtype):
            return torch.from_numpy(g.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)

        errs = {"flash_attention": 0.0, "paged_decode_attention": 0.0}
        for b, h, kh, sq, sk, d, causal, dt in [
                (1, 4, 4, 64, 64, 32, True, torch.float32),
                (2, 8, 2, 128, 128, 64, True, torch.bfloat16),
                (1, 4, 1, 32, 128, 32, False, torch.float32),
                (1, 2, 2, 256, 256, 16, True, torch.float32),
                # D = 128: causal group 3, non-causal Sq != Sk, ragged
                # Sq = 200 at group 8, and the f32 kernel
                (2, 6, 2, 256, 256, 128, True, torch.bfloat16),
                (1, 6, 2, 100, 300, 128, False, torch.bfloat16),
                (1, 8, 1, 200, 200, 128, True, torch.bfloat16),
                (1, 6, 2, 200, 200, 128, True, torch.float32)]:
            q, k, v = (rand(shape, dt) for shape in
                       ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)))
            err = close_err([("flash_attention.out",
                              flash.flash_attention(q, k, v, causal=causal),
                              flash.mha_ref(q, k, v, causal=causal))],
                            TOL[dt]["flash_attention"])
            errs["flash_attention"] = max(errs["flash_attention"], err)
        for b, h, kh, d, ps, npages, p, dt in [
                (2, 8, 2, 32, 16, 12, 4, torch.float32),
                (1, 4, 4, 64, 8, 20, 6, torch.float32),
                (2, 4, 2, 16, 16, 8, 2, torch.bfloat16),
                # D = 128: groups 3 and 6 (head_block 1 and 2)
                (2, 24, 8, 128, 8, 40, 6, torch.float32),
                (1, 12, 2, 128, 16, 30, 5, torch.bfloat16)]:
            q, kp, vp = (rand(shape, dt) for shape in
                         ((b, h, d), (npages, ps, kh, d), (npages, ps, kh, d)))
            tables = [torch.from_numpy(x).to(dev)
                      for x in paged_case(g, b, p, npages, ps)]
            got = decode.paged_decode_attention(q, kp, vp, *tables)
            ref = decode.paged_decode_ref(q, kp, vp, *tables)
            err = close_err([(f"paged_decode_attention.{o}", x, y)
                             for o, x, y in zip("acc m l".split(), got, ref)],
                            TOL[dt]["paged_decode_attention"])
            errs["paged_decode_attention"] = max(
                errs["paged_decode_attention"], err)
        # any split of the pages across owners merges to the whole
        b, h, kh, d, ps, npages, p = 2, 4, 2, 16, 8, 16, 6
        q, kp, vp = (rand(shape, torch.float32) for shape in
                     ((b, h, d), (npages, ps, kh, d), (npages, ps, kh, d)))
        pt = torch.tensor([[0, 1, 2, 3, 4, 5], [6, 7, 8, -1, -1, -1]],
                          dtype=torch.int32, device=dev)
        pos = torch.tensor([[0, 8, 16, 24, 32, 40], [0, 8, 16, 0, 0, 0]],
                           dtype=torch.int32, device=dev)
        lens = torch.tensor([44, 20], dtype=torch.int32, device=dev)
        whole = decode.normalize(*decode.paged_decode_ref(q, kp, vp, pt, pos,
                                                          lens))
        for nsplit in (2, 3):
            owned = (torch.arange(p, device=dev) % nsplit)[None]
            parts = [decode.paged_decode_attention(
                q, kp, vp, torch.where(owned == s, pt, -1), pos, lens)
                for s in range(nsplit)]
            errs["split_merge"] = max(errs.get("split_merge", 0.0), close_err(
                [(f"split_merge.{nsplit}",
                  decode.normalize(*decode.merge_partials(parts)), whole)],
                TOL[torch.float32]["paged_decode_attention"]))
        torch.cuda.synchronize()
        emit({"attention_kernels_vs_plain": errs})

    # ------------------------------------------------------- 9. prefill
    def prefill(self) -> None:
        """qwen1.5-0.5b's prefill at its published widths: B x S tokens
        through 24 layers, one flash_attention launch per layer."""
        _, _, out, qkv = self._prefill("prefill", get_config(ARCH), PREFILL_B,
                                       PREFILL_S, PREFILL_REPS)
        self.path_err["flash_attention"] = out["flash_attention_vs_plain"]
        self.prefill_qkv = qkv
        emit(out)

    def _prefill(self, phase: str, cfg, batch: int, seq: int, reps: int):
        """``build_model(cfg).prefill`` of ``batch`` x ``seq`` seeded
        tokens on random weights from SEED: a warm-up call (cuBLAS, the
        caches), then ``reps`` timed calls counted from 0, one
        flash_attention launch a layer each; the logits and KV shapes
        checked. Then kernel 5 on the inputs prefill gives it (every
        layer's q, k, v in model layout (B, S, H, D), read through
        transposed strides) held against mha_ref, uncounted. Returns
        (params, tokens, the phase's line, layer 0's (q, k, v))."""
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=self.dev)
        synced(model.prefill, params, tokens)     # warm-up: cuBLAS, caches
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        secs = []
        for _ in range(reps):
            (logits, kv), sec = synced(model.prefill, params, tokens)
            secs.append(sec)
        launches = _build.launches["flash_attention"]
        if launches != cfg.num_layers * reps:
            raise AssertionError(f"{phase}: prefill launched flash_attention "
                                 f"{launches} times, not one per layer")
        kv_shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.hd)
        if tuple(logits.shape) != (batch, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{phase}: logits of the wrong shape, type "
                                 "or not finite")
        for name in ("k", "v"):
            if tuple(kv[name].shape) != kv_shape or \
                    not bool(torch.isfinite(kv[name]).all()):
                raise AssertionError(f"{phase}: {name} cache wrong or not "
                                     "finite")
        self.tally(phase, dict(_build.launches))
        peak = torch.cuda.max_memory_allocated() / 2**30
        del logits, kv
        with uncounted(), recorded(layers, "attention") as calls:
            model.prefill(params, tokens)
        err = max(attn_path_err(
            [(f"{phase}.flash_attention.layer{li}", out,
              attn_plain(args, True))], args, True)
            for li, (args, out) in enumerate(calls))
        qkv = calls[0][0]
        del calls
        sec = sorted(secs)[len(secs) // 2]
        return params, tokens, {
            "phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "head_dim": cfg.hd, "params": cfg.param_count(),
            "init_s": init_s, "batch": batch, "seq": seq, "seconds": secs,
            "tokens_per_s": batch * seq / sec,
            "flash_attention_launches": launches,
            "launches_per_call": launches // reps,
            "flash_attention_vs_plain": err, "peak_device_gib": peak}, qkv

    # --------------------------------------------------------- 10. serve
    def serve_paged(self) -> PagedServer:
        """PagedServer at qwen1.5-0.5b's widths: 2 prompts sharing a
        prefix, a worker added mid-flight, greedy decode."""
        srv, out = self._serve("serve_paged", get_config(ARCH),
                               SERVE_REQUESTS, PROMPT, SHARED, DECODE_STEPS,
                               RECONFIG_AFTER, NUM_PAGES)
        emit({"phase": "serve", **out})
        self.path_err["paged_decode_attention"], self.decode_args = \
            self._decode_step_held(srv, "serve")
        return srv

    def _serve(self, phase: str, cfg, requests: int, prompt_len: int,
               shared_len: int, decode_steps: int, reconfig_after: int,
               num_pages: int):
        """PagedServer(cfg=cfg) with random weights from SEED: ``requests``
        prompts of ``prompt_len`` tokens sharing ``shared_len``, w2 added
        after ``reconfig_after`` of them (uncounted: reconfigure), then
        ``decode_steps`` greedy steps each; launches counted from 0.
        Returns (the server, the phase's line without its name)."""
        srv = PagedServer(cfg=cfg, page_size=PAGE_SIZE, num_pages=num_pages,
                          workers=("w0", "w1"), seed=SEED)
        g = np.random.default_rng(SEED)
        shared = g.integers(0, cfg.vocab_size, shared_len).tolist()
        prompts = [shared + g.integers(0, cfg.vocab_size,
                                       prompt_len - shared_len).tolist()
                   for _ in range(requests)]
        # set every count to 0 just before the main path
        _build.reset_counts()
        sids, admit_s, decode_s = [], 0.0, 0.0
        for r, prompt in enumerate(prompts):
            (sid, logits), sec = synced(srv.admit, prompt)
            admit_s += sec
            sids.append(sid)
            if logits is None or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{phase}: request {r}: no finite "
                                     "logits")
            if r + 1 == reconfig_after:
                with uncounted():
                    reconfig = self.reconfigure(srv, sids[0])
        admitted = srv.stats["tokens"]
        decoded = []
        for sid in sids:
            out, sec = synced(srv.decode, sid, decode_steps)
            decode_s += sec
            decoded.append(out)
        counts = dict(_build.launches)
        if srv.stats["prefix_hits"] != requests - 1:
            raise AssertionError(f"{phase}: prefix hits "
                                 f"{srv.stats['prefix_hits']}, expected "
                                 f"{requests - 1}")
        if counts["paged_decode_attention"] == 0:
            raise AssertionError(f"{phase}: the server never launched "
                                 "paged_decode_attention")
        if any(srv.ctl.sequences[s].length != prompt_len + decode_steps
               for s in sids) or any(not 0 <= t < cfg.vocab_size
                                     for out in decoded for t in out):
            raise AssertionError(f"{phase}: a sequence has the wrong length "
                                 "or token")
        self.tally(phase, counts)
        total = srv.stats["tokens"]
        return srv, {
            "arch": cfg.name, "cut": SERVE_CUT, "requests": requests,
            "prompt": prompt_len,
            "shared_prefix": shared_len, "decode_steps": decode_steps,
            **srv.stats, "admit_tokens": admitted, "admit_s": admit_s,
            "decode_tokens": total - admitted, "decode_s": decode_s,
            "tokens_per_s": total / (admit_s + decode_s),
            "decode_tokens_per_s": (total - admitted) / decode_s,
            "reconfig": reconfig, "workers": srv.ctl.workers,
            "local_copy_ratio": {w: srv.ctl.local_copy_ratio(w)
                                 for w in srv.ctl.workers},
            "pages_used": num_pages - len(srv.ctl.free),
            "launches": {k: counts[k] for k in
                         ("flash_attention", "paged_decode_attention")}}

    def _decode_step_held(self, srv: PagedServer, what: str):
        """Kernel 6 on the inputs the server gives it: one more decode
        step of the last request (uncounted), one launch a layer over the
        owners' stacked tables, each owner's row held against the plain
        version on that row alone. Returns (max |diff|, the last launch's
        arguments)."""
        sid = max(srv.tokens)
        with uncounted(), recorded(paged_store,
                                   "paged_decode_partial") as calls:
            srv.decode(sid, 1)
        if len(calls) != srv.cfg.num_layers:
            raise AssertionError(f"{what}: one decode step launched kernel 6 "
                                 f"{len(calls)} times, not once a layer")
        err = close_err(
            [(f"{what}.paged_decode_attention.step{i}.row{r}.{o}",
              x[r:r + 1], y)
             for i, (args, out) in enumerate(calls)
             for r in range(args[0].shape[0])
             for o, x, y in zip("acc m l".split(), out,
                                decode.paged_decode_ref(
                                    *(a[r:r + 1] for a in args[:1]),
                                    *args[1:3],
                                    *(a[r:r + 1] for a in args[3:])))],
            TOL[torch.float32]["paged_decode_attention"])
        args = calls[-1][0]
        emit({"check": f"paged_decode_attention on one decode step ({what})",
              "launches": len(calls), "owners": args[0].shape[0],
              "slots": args[3].shape[1], "heads": args[0].shape[1],
              "kv_heads": args[1].shape[2], "head_dim": args[0].shape[2],
              "max_abs_err": err})
        return err, args

    def reconfigure(self, srv: PagedServer, sid: int) -> dict:
        """Add w2 mid-flight. Every layer's decode_over_owners call in
        logits_for_next is recorded before and after the join.

        Where ownership acts: with the server's own q of each layer, the
        f32 attention merged over the owners before the join is held
        against the one after (2e-5, the decode kernel's f32 bar: only
        the merge order changed). The logits stay within LOGIT_TOL. The
        witness for that bar: the first layer whose bf16 attention
        differs across the join, how many elements differ there, and the
        logit shift those elements cause alone (the after-join pass run
        again with that layer's output swapped for its before-join
        value, so nothing else differs)."""
        with recorded(serve_mod, "decode_over_owners") as calls0:
            before = srv.logits_for_next(sid)
        srv.reconfigure(add="w2")
        with recorded(serve_mod, "decode_over_owners") as calls1:
            after = srv.logits_for_next(sid)

        def merged_f32(args, tables):
            q, pool, li, _, lengths = args
            return decode_over_owners(q.float(), pool, li, tables, lengths)

        att_err = close_err(
            [(f"reconfig.attention.{li}", merged_f32(a0, a1[3]),
              merged_f32(a0, a0[3]))
             for li, ((a0, _), (a1, _)) in enumerate(zip(calls0, calls1))],
            TOL[torch.float32]["paged_decode_attention"])
        flips = [int((o0 != o1).sum())
                 for (_, o0), (_, o1) in zip(calls0, calls1)]
        first = next((li for li, n in enumerate(flips) if n), None)
        out = {"attention_max_abs_diff": att_err,
               "logits_rel_diff": rel_diff(after, before),
               "top1_same": int(after.argmax()) == int(before.argmax()),
               "first_layer_differing": first,
               "bf16_elements_differing": flips[first] if first is not None
               else 0}
        if first is not None:
            with recorded(serve_mod, "decode_over_owners",
                          replace={first: calls0[first][1]}):
                swapped = srv.logits_for_next(sid)
            out["logits_shift_from_that_layer_alone"] = rel_diff(swapped,
                                                                 after)
            out["logits_rel_diff_left_after_undoing_it"] = rel_diff(swapped,
                                                                    before)
        if out["logits_rel_diff"] > LOGIT_TOL:
            raise AssertionError(f"reconfiguration moved the logits by "
                                 f"{out['logits_rel_diff']} of max |logit|")
        return out


    # --------------------------------------------------- 11. equivalence
    def equivalence(self, srv: PagedServer, tokens: int = PROMPT,
                    phase: str = "equivalence") -> None:
        """One prompt of ``tokens`` through the server (token by token,
        kernel 6) against prefill's last-token logits (kernel 5)."""
        g = np.random.default_rng(SEED + 1)
        prompt = g.integers(0, srv.cfg.vocab_size, tokens).tolist()
        hits = srv.stats["prefix_hits"]
        _, paged = srv.admit(prompt)
        if srv.stats["prefix_hits"] != hits:
            raise AssertionError(f"{phase}: the prompt hit the prefix cache")
        dense, _ = srv.model.prefill(
            srv.params, torch.tensor([prompt], device=self.dev))
        rel = rel_diff(paged, dense[0])
        same = int(paged.argmax()) == int(dense[0].argmax())
        emit({"phase": phase, "arch": srv.cfg.name, "tokens": tokens,
              "max_abs_diff": float((paged - dense[0]).abs().max()),
              "max_abs_logit": float(dense[0].abs().max()),
              "rel_diff": rel, "tolerance": LOGIT_TOL, "top1_same": same})
        if rel > LOGIT_TOL:
            raise AssertionError(f"{phase}: server and prefill logits differ "
                                 f"by {rel} of max |logit|")

    def profile_decode(self, srv: PagedServer) -> None:
        """torch.profiler over one decode step of one served sequence."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(srv.decode, 0, 1)
        emit({"profile": f"one decode step ({srv.cfg.num_layers} layers, "
                         f"{srv.cfg.name})",
              **device_summary(prof, wall)})

    # ---------------------------------------------------- 12. time 5, 6
    def time_attention(self) -> list[dict]:
        """Kernels 5 and 6 on inputs the main path gave them (layer 0 of
        a prefill call; the last layer's stacked launch of the decode
        step, and its owner row with the most pages alone) against their
        plain versions; the last runs of each are held against each
        other. Each redesigned kernel's time is printed beside its time
        in the design it replaced (BEFORE_MS). Then kernel 6 at a batched decode shape,
        which the server does not form (it decodes one sequence at a
        time), on a line of its own."""
        cfg = get_config(ARCH)
        dev = self.dev
        q, k, v = self.prefill_qkv           # (B, S, H, D), strided views
        b, s, h, d = q.shape
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows = [self._timed(
            "flash_attention", "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:81",
            ("out",), lambda: (flash.attention(q, k, v, causal=True),),
            lambda: (flash.mha_ref(qt, kt, vt).transpose(1, 2),),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True),
            4 * q.numel() * q.element_size(), REPS, plain_reps=3,
            # the scores and P.V over the keys each query sees: 2 x 2D
            # per pair
            flops=2 * b * h * d * s * (s + 1), peak=BF16_FLOPS,
            extra={"shape": [b, s, h, d]},
            compare=lambda pairs: attn_path_err(pairs, (q, k, v), True))]

        # kernel 6 as the server calls it: one sequence's owners stacked
        # as rows of one launch (q a stride-0 view, tables with -1
        # tails), over one layer of the f32 pool. No single torch call
        # returns the partials, so library_ms is null.
        qd, kp, vp, pt, pos, lens = self.decode_args
        kh, ps = kp.shape[2], kp.shape[1]
        rows_valid = ((pos[:, :, None] + torch.arange(ps, device=dev))
                      < lens[:, None, None]) & (pt >= 0)[:, :, None]
        tokens = int(rows_valid.sum())
        rows.append(self._timed(
            "paged_decode_attention", "paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:85",
            ("acc", "m", "l"),
            lambda: decode.paged_decode_attention(qd, kp, vp, pt, pos, lens),
            lambda: decode.paged_decode_ref(qd, kp, vp, pt, pos, lens),
            None, self._decode_bytes(qd, kp, pt, tokens), REPS,
            flops=4 * tokens * h * d, peak=F32_FLOPS,
            extra={"owners": qd.shape[0], "slots": pt.shape[1],
                   "pages": int((pt >= 0).sum()), "tokens": tokens,
                   "splits": decode.split_count(
                       qd.shape[0] * kh, pt.shape[1], ps,
                       torch.cuda.get_device_properties(
                           dev).multi_processor_count)},
            compare=lambda pairs: close_err(
                pairs, TOL[torch.float32]["paged_decode_attention"])))
        for row in rows:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     self.path_err[row["name"]])
        # the owner row with the most pages alone: one launch of the
        # shape the previous design launched once per owner
        r = int((pt >= 0).sum(dim=1).argmax())
        one = [t[r:r + 1] for t in (qd, pt, pos, lens)]
        one_ms = event_ms(lambda: decode.paged_decode_attention(
            one[0], kp, vp, *one[1:]), REPS)[0]
        emit({"redesigned": "flash_attention", "ms": rows[0]["ms"],
              "before_ms": BEFORE_MS["flash_attention"],
              "inputs": "prefill's layer-0 views, (4, 2048, 16, 64) bf16",
              "before": BEFORE})
        redesigned("flash_attention", rows[0])
        emit({"redesigned": "paged_decode_attention",
              "stacked_launch_ms": rows[1]["ms"], "owners": qd.shape[0],
              "one_owner_launch_ms": one_ms,
              "before_ms_per_owner_launch":
                  BEFORE_MS["paged_decode_attention"],
              "before_ms_per_layer": BEFORE_MS["paged_decode_attention"]
              * qd.shape[0],
              "inputs": "one decode step's owner tables, one layer",
              "before": BEFORE})

        # a batched decode step: DECODE_B sequences of DECODE_CTX tokens,
        # each over its own pages, f32 pages as on the server
        gen = torch.Generator(device=dev).manual_seed(SEED)
        kh = cfg.num_kv_heads
        slots = DECODE_CTX // PAGE_SIZE
        npages = DECODE_B * slots
        kp, vp = (torch.randn((npages, PAGE_SIZE, kh, d), generator=gen,
                              device=dev) for _ in range(2))
        qd = torch.randn((DECODE_B, h, d), generator=gen,
                         device=dev).to(torch.bfloat16)
        pt = torch.randperm(npages, generator=gen, device=dev).to(
            torch.int32).reshape(DECODE_B, slots)
        pos = (torch.arange(slots, dtype=torch.int32, device=dev)
               * PAGE_SIZE).expand(DECODE_B, slots).contiguous()
        lens = torch.full((DECODE_B,), DECODE_CTX, dtype=torch.int32,
                          device=dev)
        tokens = int(lens.sum())
        batch = self._timed(
            "paged_decode_attention", "paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:85",
            ("acc", "m", "l"),
            lambda: decode.paged_decode_attention(qd, kp, vp, pt, pos, lens),
            lambda: decode.paged_decode_ref(qd, kp, vp, pt, pos, lens),
            None, self._decode_bytes(qd, kp, pt, tokens), REPS, plain_reps=2,
            flops=4 * tokens * h * d, peak=F32_FLOPS,
            extra={"batched_decode": "not a shape the server forms",
                   "sequences": DECODE_B, "context": DECODE_CTX,
                   "pages": npages, "page_bytes": int(kp.nbytes + vp.nbytes)},
            compare=lambda pairs: close_err(
                pairs, TOL[torch.float32]["paged_decode_attention"]))
        emit({"batched_decode_bound_ms": batch["bound_ms"],
              "bound_by": batch["bound_by"]})
        emit({"redesigned": "paged_decode_attention", "ms": batch["ms"],
              "before_ms": BEFORE_MS["paged_decode_attention_64x2048"],
              "inputs": f"{DECODE_B} x {DECODE_CTX} batched decode",
              "before": BEFORE})
        return rows

    # ----------------------------------------- 12b. the families at D = 128
    def prefill_llama(self) -> dict:
        """llama3.2-3b's prefill at its published widths (28 layers,
        d_model 3072, 24 heads over 8 kv heads of 128): kernel 5 at D = 128
        with GQA group 3, 28 launches a call, each layer's launch held to
        mha_ref; then kernel 5 timed at layer 0's views beside mha_ref and
        scaled_dot_product_attention. Returns the kernels line's row."""
        cfg = get_config(LLAMA)
        params, tokens, out, qkv = self._prefill(
            "prefill_llama", cfg, PREFILL_B, PREFILL_S, PREFILL_REPS)
        emit(out)
        self.llama_params = params
        row = self._flash_row(qkv, True, "flash_attention_d128",
                              f"{LLAMA} prefill's layer-0 views")
        row["max_abs_err"] = max(row["max_abs_err"],
                                 out["flash_attention_vs_plain"])
        emit({"flash_attention_d128": {
            "ms": row["ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "sdpa_ms": row["library_ms"],
            "plain_ms": row["plain_ms"],
            "share_of_bound": row["bound_ms"] / row["ms"],
            "share_of_prefill_call": cfg.num_layers * row["ms"]
            / (out["batch"] * out["seq"] / out["tokens_per_s"] * 1e3)}})
        del qkv, tokens
        return row

    def _flash_row(self, qkv, causal: bool, label: str, inputs: str) -> dict:
        """The kernels line's row for kernel 5 on ``qkv``, a main path's
        (q, k, v) in model layout (B, S, H|KH, D), read through transposed
        strides: beside its plain version (mha_ref, or blocked_mha above
        2048 keys) and scaled_dot_product_attention on the same views.
        Bound: the products' FLOP at the bf16 tensor-core rate
        (2 S (S + 1) D a head causal, 4 Sq Sk D non-causal) or q, k, v
        read and the output written once at the memory rate."""
        q, k, v = qkv
        b, sq, h, d = q.shape
        sk = k.shape[1]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 2 * b * h * d * sq * (sq + 1) if causal \
            else 4 * b * h * d * sq * sk
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        row = self._timed(
            "flash_attention", "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:81",
            ("out",), lambda: (flash.attention(q, k, v, causal=causal),),
            lambda: (flash.plain_attention(qt, kt, vt, causal)
                     .transpose(1, 2),),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            nbytes, REPS, plain_reps=3, flops=flops, peak=BF16_FLOPS,
            extra={"shape": [b, sq, h, d], "kv_len": sk,
                   "kv_heads": k.shape[2], "causal": causal,
                   "gflop": flops / 1e9, "bytes": nbytes},
            compare=lambda pairs: attn_path_err(pairs, qkv, causal),
            label=label)
        row.update(head_dim=d, inputs=f"{inputs}, {(b, sq, h, d)} over "
                   f"{k.shape[2]} kv heads of {sk}, "
                   f"{'causal' if causal else 'non-causal'}")
        redesigned(label, row)
        return row

    def dense_decode_llama(self) -> None:
        """steps.serve_step with the three dense-cache decodes (v1, v2,
        v3) at batch DENSE_B from one cache that prefill_step filled with a
        DENSE_PROMPT-token prompt: v1 decodes DENSE_STEPS greedy tokens,
        v2 and v3 take v1's tokens (so that one near-tie cannot part the
        sequences), and every step's logits of the three agree within
        DECODE_IMPL_TOL of max |logit|; each against forward's logits on
        the whole sequence within LOGIT_TOL. Then one profiled step each."""
        from torch.profiler import ProfilerActivity, profile
        cfg = get_config(LLAMA)
        params = self.llama_params
        g = np.random.default_rng(SEED + 4)
        prompt = torch.from_numpy(g.integers(
            0, cfg.vocab_size, (DENSE_B, DENSE_PROMPT))).to(self.dev)
        total = DENSE_PROMPT + DENSE_STEPS
        _build.reset_counts()
        (first, kv), prefill_s = synced(steps.prefill_step, params, prompt,
                                        cfg)
        caches = {}
        for impl in DENSE_IMPLS:
            c = steps.init_cache(cfg, DENSE_B, total + 1, impl)
            for name in ("k", "v"):
                dst = c[name].transpose(2, 3) if impl else c[name]
                dst[:, :, :DENSE_PROMPT] = kv[name]
            caches[impl] = c
        del kv
        toks = torch.empty((DENSE_B, DENSE_STEPS + 1), dtype=torch.int64,
                           device=self.dev)
        toks[:, 0] = first.argmax(-1)
        logits = {impl: [] for impl in DENSE_IMPLS}
        secs = {}
        for impl in DENSE_IMPLS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DENSE_STEPS):
                out, caches[impl] = steps.serve_step(
                    params, caches[impl], toks[:, i], DENSE_PROMPT + i, cfg,
                    optimized=impl)
                if impl is False:
                    toks[:, i + 1] = out.argmax(-1)
                logits[impl].append(out)
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t0
        self.tally("dense_decode_llama", dict(_build.launches))
        name = {False: "v1", "v2": "v2", "v3": "v3"}
        agree = {name[impl]: max(rel_diff(a, b) for a, b in zip(
            logits[impl], logits[False])) for impl in DENSE_IMPLS[1:]}
        with uncounted():
            full = transformer.forward(
                params, torch.cat([prompt, toks[:, :DENSE_STEPS]], 1),
                cfg)[0][:, DENSE_PROMPT:]
        vs_forward = {name[impl]: rel_diff(torch.stack(logits[impl], 1),
                                           full) for impl in DENSE_IMPLS}
        top1 = {name[impl]: float((torch.stack(logits[impl], 1).argmax(-1)
                                   == full.argmax(-1)).float().mean())
                for impl in DENSE_IMPLS}
        del full, logits
        step = {}
        for impl in DENSE_IMPLS:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = synced(steps.serve_step, params, caches[impl],
                                 toks[:, DENSE_STEPS], total, cfg, impl)
            summary = device_summary(prof, wall)
            step[name[impl]] = {k: summary[k] for k in (
                "wall_ms", "device_busy_ms", "device_busy_share", "launches")}
        del caches
        torch.cuda.empty_cache()
        emit({"phase": "dense_decode_llama", "arch": LLAMA, "cut": STEPS_CUT,
              "batch": DENSE_B,
              "prompt": DENSE_PROMPT, "steps": DENSE_STEPS,
              "prefill_s": prefill_s,
              "seconds": {name[i]: secs[i] for i in DENSE_IMPLS},
              "tokens_per_s": {name[i]: DENSE_B * DENSE_STEPS / secs[i]
                               for i in DENSE_IMPLS},
              "rel_diff_vs_v1": agree, "impl_tolerance": DECODE_IMPL_TOL,
              "rel_diff_vs_forward": vs_forward, "top1_vs_forward": top1,
              "tolerance": LOGIT_TOL, "profiled_step": step,
              "distinct_tokens": int(torch.unique(toks).numel())})
        if max(agree.values()) > DECODE_IMPL_TOL:
            raise AssertionError(f"dense decode implementations differ: "
                                 f"{agree}")
        if max(vs_forward.values()) > LOGIT_TOL:
            raise AssertionError(f"dense decode and forward differ: "
                                 f"{vs_forward}")
        if not 0 <= int(toks.min()) <= int(toks.max()) < cfg.vocab_size:
            raise AssertionError("dense decode: a token out of range")

    def serve_llama(self) -> list[dict]:
        """PagedServer at llama3.2-3b's widths (kernel 6 at D = 128, group
        3: one stacked launch a layer), a worker joining mid-flight, the
        server against prefill on one prompt, a profile of one step, and
        kernel 6 timed on one decode step's last stacked launch. Returns
        the kernels line's row."""
        srv, out = self._serve("serve_llama", get_config(LLAMA),
                               LLAMA_REQUESTS, LLAMA_PROMPT, LLAMA_SHARED,
                               LLAMA_DECODE_STEPS, LLAMA_RECONFIG_AFTER,
                               LLAMA_NUM_PAGES)
        emit({"phase": "serve_llama", **out})
        err, args = self._decode_step_held(srv, "serve_llama")
        self.profile_decode(srv)
        self.equivalence(srv, LLAMA_PROMPT, "equivalence_llama")
        qd, kp, vp, pt, pos, lens = args
        h, d = qd.shape[1], qd.shape[2]
        kh, ps = kp.shape[2], kp.shape[1]
        valid = ((pos[:, :, None] + torch.arange(ps, device=self.dev))
                 < lens[:, None, None]) & (pt >= 0)[:, :, None]
        tokens = int(valid.sum())
        row = self._timed(
            "paged_decode_attention", "paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:85",
            ("acc", "m", "l"),
            lambda: decode.paged_decode_attention(qd, kp, vp, pt, pos, lens),
            lambda: decode.paged_decode_ref(qd, kp, vp, pt, pos, lens),
            None, self._decode_bytes(qd, kp, pt, tokens), REPS,
            flops=4 * tokens * h * d, peak=F32_FLOPS,
            extra={"owners": qd.shape[0], "slots": pt.shape[1],
                   "tokens": tokens, "heads": h, "kv_heads": kh,
                   "head_block": decode.head_block(h // kh)},
            compare=lambda pairs: close_err(
                pairs, TOL[torch.float32]["paged_decode_attention"]),
            label="paged_decode_attention_group3")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(head_dim=d, group=h // kh,
                   inputs=f"{LLAMA} server, one decode step's last layer")
        del srv, args, qd, kp, vp
        torch.cuda.empty_cache()
        return row

    def moe_olmoe(self) -> None:
        """olmoe-1b-7b at its published widths (16 layers, d_model 2048, 16
        heads of 128, 64 experts top-8): prefill of PREFILL_B x PREFILL_S
        (16 kernel-5 launches a call, each held to mha_ref), each layer's
        expert loads and the choices dropped at capacity; then
        serve_step v3 for MOE_DECODE_STEPS greedy steps at batch PREFILL_B
        from that prefill's cache, with decode's capacity (1 at batch 4:
        the reference's semantics, mirrored) and its drops."""
        cfg = get_config(OLMOE)
        params, tokens, out, _ = self._prefill(
            "moe_olmoe", cfg, PREFILL_B, PREFILL_S, PREFILL_REPS)
        t, k, e = PREFILL_B * PREFILL_S, cfg.experts_per_token, \
            cfg.num_experts
        with uncounted(), recorded(transformer, "moe_ff") as calls:
            logits, kv = steps.prefill_step(params, tokens, cfg)
        loads = torch.stack([aux["expert_load"] for _, (_, aux) in calls])
        del calls
        cap = max(int(t * k / e * cfg.moe_capacity_factor), 1)
        dropped = (loads * t * k).round().sub(cap).clamp(min=0).sum(1)
        out.update(capacity=cap, dropped_per_layer=dropped.tolist(),
                   dropped_share=float(dropped.sum()) / (cfg.num_layers * t
                                                        * k),
                   expert_load_layer0=loads[0].tolist(),
                   expert_load_min_max=[float(loads.min()),
                                        float(loads.max())])
        emit(out)
        # decode: v3 from the prefill's cache
        cache = steps.init_cache(cfg, PREFILL_B, PREFILL_S + MOE_DECODE_STEPS,
                                 "v3")
        for name in ("k", "v"):
            cache[name].transpose(2, 3)[:, :, :PREFILL_S] = kv[name]
        del kv
        tok = logits.argmax(-1)
        _build.reset_counts()
        decoded = []
        with recorded(transformer, "moe_ff") as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(MOE_DECODE_STEPS):
                logits, cache = steps.serve_step(params, cache, tok,
                                                 PREFILL_S + i, cfg,
                                                 optimized="v3")
                tok = logits.argmax(-1)
                decoded.append(tok)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        self.tally("moe_olmoe_decode", dict(_build.launches))
        dec_cap = max(int(PREFILL_B * k / e * cfg.moe_capacity_factor), 1)
        dec_loads = torch.stack([aux["expert_load"] for _, (_, aux) in calls])
        del calls
        dec_dropped = float((dec_loads * PREFILL_B * k).round().sub(dec_cap)
                            .clamp(min=0).sum())
        decoded = torch.stack(decoded, 1)
        if not bool(torch.isfinite(logits).all()) or not bool(
                ((decoded >= 0) & (decoded < cfg.vocab_size)).all()):
            raise AssertionError("moe decode: non-finite logits or a token "
                                 "out of range")
        emit({"phase": "moe_olmoe_decode", "arch": OLMOE, "impl": "v3",
              "batch": PREFILL_B, "context": PREFILL_S,
              "steps": MOE_DECODE_STEPS, "seconds": sec,
              "step_ms": sec / MOE_DECODE_STEPS * 1e3,
              "tokens_per_s": PREFILL_B * MOE_DECODE_STEPS / sec,
              "capacity_per_expert": dec_cap,
              "choices": MOE_DECODE_STEPS * cfg.num_layers * PREFILL_B * k,
              "dropped_choices": dec_dropped,
              "distinct_tokens": int(torch.unique(decoded).numel())})
        del params, cache, tokens, logits
        torch.cuda.empty_cache()

    def widths_d128(self) -> None:
        """internlm2-20b, nemotron-4-15b, chameleon-34b (D = 128, GQA
        groups 6, 6 and 8; nemotron's squared-ReLU MLP and 256 K vocab)
        and granite-moe-1b-a400m (MoE at D = 64) at their published widths
        cut to WIDTH_LAYERS layers: one prefill of 1 x WIDTH_SEQ, every
        kernel-5 launch held to mha_ref."""
        for arch in WIDTH_ARCHS:
            cfg = get_config(arch).replace(num_layers=WIDTH_LAYERS)
            params, _, out, _ = self._prefill(
                f"widths_d128.{arch}", cfg, 1, WIDTH_SEQ, 1)
            out.update(phase="widths_d128", cut=f"{WIDTH_LAYERS} of "
                       f"{get_config(arch).num_layers} layers",
                       group=cfg.num_heads // cfg.num_kv_heads,
                       mlp=cfg.mlp, vocab=cfg.vocab_size, family=cfg.family)
            emit(out)
            del params
            torch.cuda.empty_cache()

    # ------------------------------------------------- 13. check kernel 7
    def check_ssd(self) -> None:
        """Kernel 7 against the plain chunked scan and the recurrence at
        the sweep shapes of tests/test_kernels.py (f32 and bf16; G = 2)."""
        dev = self.dev
        g = np.random.default_rng(SEED)
        worst = 0.0
        for b, s, h, grp, n, p, chunk, dt in [
                (1, 64, 2, 1, 16, 8, 16, torch.float32),
                (2, 128, 4, 2, 32, 16, 32, torch.float32),
                (1, 64, 2, 1, 16, 8, 64, torch.float32),
                (1, 64, 2, 1, 16, 8, 16, torch.bfloat16)]:
            f = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a, np.float32)).to(dev)
            args = (f(g.standard_normal((b, s, h, p))).to(dt),
                    f(g.uniform(0.01, 0.2, (b, s, h))),
                    f(-g.uniform(0.5, 2.0, (h,))),
                    f(g.standard_normal((b, s, grp, n)) * 0.3).to(dt),
                    f(g.standard_normal((b, s, grp, n)) * 0.3).to(dt),
                    f(g.standard_normal(h) * 0.1))
            got = ssd_k.ssd_scan(*args, chunk=chunk)
            worst = max(worst, close_err(
                [("ssd_scan.vs_chunked", got, ssd_k.ssd_chunked(*args, chunk)),
                 ("ssd_scan.vs_ref", got, ssd_k.ssd_ref(*args)[0])],
                TOL[dt]["ssd_scan"]))
        torch.cuda.synchronize()
        emit({"ssd_kernel_vs_plain": worst})

    # ---------------------------------------------------- 14. ssm prefill
    def ssm_prefill(self) -> None:
        """mamba2-2.7b's prefill step at its published widths: B x S
        tokens through 64 layers, one ssd_scan launch per layer. Kernel 7
        is then held against the plain chunked scan on every layer of one
        call, and against the recurrence on layer 0; on every layer the
        bar must also reject what a kernel that lost the state carried
        between chunks would return."""
        cfg = get_config(SSM_ARCH)
        t0 = time.perf_counter()
        params = ssm_lm.init_params(SEED, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        self.ssm_params = params
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (SSM_B, SSM_S),
                               generator=gen, device=self.dev)
        synced(steps.prefill_step, params, tokens, cfg)     # warm-up
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        secs = []
        for _ in range(SSM_REPS):
            logits, sec = synced(steps.prefill_step, params, tokens, cfg)
            secs.append(sec)
        launches = _build.launches["ssd_scan"]
        if launches != cfg.num_layers * SSM_REPS:
            raise AssertionError(f"prefill launched ssd_scan {launches} "
                                 "times, not one per layer")
        if tuple(logits.shape) != (SSM_B, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("ssm prefill: logits of the wrong shape, "
                                 "type or not finite")
        self.tally("ssm_prefill", dict(_build.launches))
        peak = torch.cuda.max_memory_allocated() / 2**30
        sec = sorted(secs)[len(secs) // 2]
        self.ssm_prefill_s = sec
        emit({"phase": "ssm_prefill", "arch": SSM_ARCH,
              "params": cfg.param_count(), "init_s": init_s,
              "batch": SSM_B, "seq": SSM_S, "seconds": secs,
              "tokens_per_s": SSM_B * SSM_S / sec,
              "ssd_scan_launches": launches,
              "launches_per_call": launches // SSM_REPS,
              "peak_device_gib": peak})
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(steps.prefill_step, params, tokens, cfg)
        emit({"profile": f"one prefill call, {SSM_B} x {SSM_S} "
                         f"({cfg.num_layers} layers)",
              **device_summary(prof, wall)})
        # kernel 7 on the inputs prefill gives it: every layer's (x, dt, a,
        # b, c, d), x, b and c strided views of the conv's output
        with uncounted(), recorded(mamba2, "ssd") as calls:
            steps.prefill_step(params, tokens, cfg)
        err, ref_max, ref_med, fault = 0.0, [], [], []
        for li, (args, out) in enumerate(calls):
            ref = ssd_k.ssd_chunked(*args, SSM_CHUNK)
            err = max(err, ssd_path_err([(f"ssd_scan.layer{li}", out, ref)]))
            mag = ref.float().abs()
            ref_max.append(float(mag.max()))
            ref_med.append(float(mag.median()))
            fault.append(self.lost_carry(args, ref))
        self.ssd_args = calls[0][0]
        ref_err = ssd_path_err([("ssd_scan.layer0.vs_ref", calls[0][1],
                                 ssd_k.ssd_ref(*self.ssd_args)[0])])
        del calls
        self.path_err["ssd_scan"] = max(err, ref_err)
        x = self.ssd_args[0]
        caught = [f["outside"] > 0 for f in fault]
        emit({"check": "ssd_scan on every layer of one prefill call",
              "layers": cfg.num_layers, "shape": list(x.shape),
              "x_strides": list(x.stride()), "max_abs_err_vs_chunked": err,
              "layer0_max_abs_err_vs_ref": ref_err,
              "rtol": SSD_PATH_RTOL, "atol_of_max_abs_ref":
              SSD_PATH_ATOL_OF_MAX,
              "max_abs_ref_min_max": [min(ref_max), max(ref_max)],
              "median_abs_ref_min_max": [min(ref_med), max(ref_med)],
              "lost_carry_max_abs_diff_min_max": [
                  min(f["max_abs_diff"] for f in fault),
                  max(f["max_abs_diff"] for f in fault)],
              "lost_carry_outside_min_max": [
                  min(f["outside"] for f in fault),
                  max(f["outside"] for f in fault)],
              "lost_carry_caught_layers": sum(caught)})
        if not all(caught):
            raise AssertionError("the bar does not see a lost chunk carry "
                                 "on layers "
                                 f"{[i for i, c in enumerate(caught) if not c]}")

    @staticmethod
    def lost_carry(args, ref) -> dict:
        """What a kernel that dropped exp(cum) (C h), the state carried
        into each chunk, would return on ``args``: the plain scan of every
        chunk as a sequence of its own. Its distance from the true output
        ``ref`` is the power of the main path's bar against that fault:
        the number of elements outside it."""
        x, dt, a, b, c, d = args
        bsz, s, h, p = x.shape
        nc = s // SSM_CHUNK
        split = [t.reshape(bsz * nc, SSM_CHUNK, *t.shape[2:])
                 for t in (x, dt, b, c)]
        bad = ssd_k.ssd_chunked(split[0], split[1], a, split[2], split[3], d,
                                SSM_CHUNK).reshape(ref.shape).float()
        diff = (bad - ref.float()).abs()
        bar = ssd_path_atol(ref) + SSD_PATH_RTOL * ref.float().abs()
        return {"max_abs_diff": float(diff.max()),
                "outside": int((diff > bar).sum())}

    # ----------------------------------------------------- 15. ssm decode
    def teacher_forced(self, params, cfg, cache, prompt, full,
                       watch=()) -> tuple[dict, list]:
        """``prompt`` (1, T) through ``serve_step`` token by token from
        ``cache``, against ``full``, forward's logits (T, V) on the same
        tokens: max |diff| / max |logit| over all T steps and the top-1
        agreement. ``watch`` lists (module, name, pick): each such
        function's calls over the T steps are recorded as ``pick(args,
        out)`` and returned beside, a list each."""
        t_len = prompt.shape[1]
        dec = []
        with contextlib.ExitStack() as stack:
            calls = [stack.enter_context(recorded(m, n, pick=pick))
                     for m, n, pick in watch]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(t_len):
                logits, cache = steps.serve_step(params, cache, prompt[:, t],
                                                 t, cfg)
                dec.append(logits[0])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        dec = torch.stack(dec)
        out = {"tokens": t_len, "seconds": sec,
               "max_abs_diff": float((dec - full).abs().max()),
               "max_abs_logit": float(full.abs().max()),
               "top1_agree": float((dec.argmax(-1) == full.argmax(-1))
                                   .float().mean())}
        out["rel_diff"] = out["max_abs_diff"] / out["max_abs_logit"]
        return out, calls

    @staticmethod
    def block_gaps(decoded, refs) -> list[float]:
        """Decode's output of each of n blocks, ``decoded`` (T x n rows of
        d, step by step, as teacher_forced records them), against
        forward's, ``refs`` (n of (T, d)): row_rel_diff each. Cumulative:
        a block's input in decode already carries the earlier blocks'
        differences."""
        y = torch.stack(decoded).view(refs[0].shape[0], len(refs), -1)
        return [row_rel_diff(y[:, i], ref) for i, ref in enumerate(refs)]

    @staticmethod
    def mamba_local(layer_params, blocks, cfg) -> list[float]:
        """Each mamba layer's decode fed forward's own input to the layer
        (``blocks``: forward's recorded mamba_block calls) token by token
        from a fresh state, against forward's output of the layer:
        row_rel_diff each (what the layer alone adds)."""
        local = []
        for lp, (args, ref) in zip(layer_params, blocks, strict=True):
            xin = args[1][0]                                   # (T, d)
            st = mamba2.mamba_state_init(cfg, 1)
            ys = []
            for t in range(xin.shape[0]):
                y, st = mamba2.mamba_decode(lp["mamba"], xin[t][None, None],
                                            cfg, st)
                ys.append(y[0, 0])
            local.append(row_rel_diff(torch.stack(ys), ref[0]))
        return local

    def greedy(self, phase: str, params, cfg, cache, tok, start: int,
               what: str, **fields) -> None:
        """GREEDY_STEPS greedy tokens through ``serve_step`` from ``cache``
        and tokens ``tok`` (B,) at position ``start``, timed and held to
        finite logits and tokens in the vocabulary; then one step
        profiled. Emits the phase's line (with ``fields``) and the
        profile's (``what`` names the step)."""
        from torch.profiler import ProfilerActivity, profile
        b = tok.shape[0]
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(start, start + GREEDY_STEPS):
            logits, cache = steps.serve_step(params, cache, tok, t, cfg)
            tok = logits.argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out = torch.stack(out, dim=1)
        if not bool(torch.isfinite(logits).all()) or \
                not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"{phase}: non-finite logits or a token "
                                 "out of range")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(steps.serve_step, params, cache, tok,
                             start + GREEDY_STEPS, cfg)
        summary = device_summary(prof, wall)
        emit({"phase": phase, "batch": b, **fields, "cut": STEPS_CUT,
              "steps": GREEDY_STEPS,
              "seconds": sec, "step_ms": sec / GREEDY_STEPS * 1e3,
              "tokens_per_s": b * GREEDY_STEPS / sec,
              "distinct_tokens": int(torch.unique(out).numel())})
        emit({"profile": f"one {what}", "launches_per_token":
              summary["launches"] / b, **summary})

    def ssm_decode(self) -> None:
        """A prompt teacher-forced through the recurrent decode step against
        forward's logits on the same tokens, then greedy decode of a
        batch, and a profile of one step.

        Where the two paths part: prefill and decode round differently by
        design (the reference's prefill conv multiplies and sums in bf16,
        its decode conv in f32; the matrix products see M = T rows or
        M = 1), so in bf16 each layer's block output differs by a few
        units in the last place, and 64 random layers carry that forward.
        The checks: every layer, fed forward's own input, agrees with
        forward's block output within LOGIT_TOL (no layer parts from the
        others), and an f32 copy of the model through the same code and
        kernel agrees end to end within F32_LOGIT_TOL (the two paths
        compute one function). The bf16 end-to-end gap is reported beside
        them, with the share of it that the reference's bf16 prefill conv
        causes: the same comparison with that conv taken in f32 (a
        diagnostic; the model keeps the reference's conv)."""
        cfg = get_config(SSM_ARCH)
        params = self.ssm_params
        g = np.random.default_rng(SEED + 2)
        prompt = torch.from_numpy(g.integers(0, cfg.vocab_size,
                                             (1, TF_PROMPT))).to(self.dev)

        def gap(p):
            return self.teacher_forced(p, cfg, ssm_lm.init_cache(cfg, 1),
                                       prompt,
                                       ssm_lm.forward(p, prompt, cfg)[0][0])[0]

        _build.reset_counts()
        with recorded(ssm_lm, "mamba_block") as blocks:
            full = ssm_lm.forward(params, prompt, cfg)[0][0]   # (T, V)
        bf16, (dec,) = self.teacher_forced(
            params, cfg, ssm_lm.init_cache(cfg, 1), prompt, full,
            watch=[(ssm_lm, "mamba_decode", decode_y)])
        if _build.launches["ssd_scan"] != cfg.num_layers:
            raise AssertionError("the teacher-forced forward did not run "
                                 "ssd_scan once a layer, or decode ran it")
        self.tally("ssm_decode", dict(_build.launches))
        cum = self.block_gaps(dec, [out[0] for _, out in blocks])
        local = self.mamba_local(params["layers"], blocks, cfg)
        del blocks, dec, full
        conv = mamba2._causal_conv
        with mock.patch.object(mamba2, "_causal_conv",
                               lambda xbc, w, b: conv(xbc.float(), w.float(),
                                                      b.float())):
            conv_f32 = gap(params)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("f32 matrix products must not run in TF32")
        p32 = {"embed": params["embed"].float(),
               "ln_f": params["ln_f"].float(),
               "layers": [{"ln": lp["ln"].float(),
                           "mamba": {k: v.float()
                                     for k, v in lp["mamba"].items()}}
                          for lp in params["layers"]]}
        f32 = gap(p32)
        del p32
        torch.cuda.empty_cache()
        over = [li for li, v in enumerate(cum) if v > LOGIT_TOL]
        emit({"phase": "ssm_decode_teacher_forced", **bf16,
              "tolerance": LOGIT_TOL,
              "within_tolerance": bf16["rel_diff"] <= LOGIT_TOL,
              "block_rel_diff_local_max": max(local),
              "block_rel_diff_local_first_last": [local[0], local[-1]],
              "block_rel_diff_cumulative_every_8th": cum[::8] + [cum[-1]],
              "first_layer_cumulative_over_tolerance": over[0] if over
              else None,
              "rel_diff_prefill_conv_f32": conv_f32["rel_diff"],
              "top1_agree_prefill_conv_f32": conv_f32["top1_agree"],
              "f32_model_rel_diff": f32["rel_diff"],
              "f32_model_top1_agree": f32["top1_agree"],
              "f32_tolerance": F32_LOGIT_TOL})
        if max(local) > LOGIT_TOL:
            raise AssertionError(f"a layer's decode parts from its prefill by "
                                 f"{max(local)} of its max |output|")
        if f32["rel_diff"] > F32_LOGIT_TOL:
            raise AssertionError(f"in f32, decode and forward logits differ "
                                 f"by {f32['rel_diff']} of max |logit|")
        del bf16, conv_f32, f32
        # greedy decode of a batch
        gen = torch.Generator(device=self.dev).manual_seed(SEED + 3)
        tok = torch.randint(0, cfg.vocab_size, (GREEDY_B,), generator=gen,
                            device=self.dev)
        cache = ssm_lm.init_cache(cfg, GREEDY_B)
        synced(steps.serve_step, params, cache, tok, 0, cfg)    # warm-up
        self.greedy("ssm_decode_greedy", params, cfg,
                    ssm_lm.init_cache(cfg, GREEDY_B), tok, 0,
                    f"decode step, batch {GREEDY_B} ({cfg.num_layers} "
                    "layers)")

    # ------------------------------------------------------- 16. time 7
    def time_ssd(self) -> list[dict]:
        """Kernel 7 on prefill's layer-0 inputs against the plain chunked
        scan. No single PyTorch call computes the SSD scan, so library_ms
        is null.

        Bound: the FLOP the function needs, at the bf16 tensor-core rate
        (the bf16 kernel's products run there): per (b, h, chunk)
        L (L + 1) P for S x (S is lower triangular with its diagonal) and
        4 L N P for C h and the state update; per (b, group, chunk)
        L (L + 1) N for C B^T, which the heads of a group share. Bytes
        are x and y once, b, c and dt once, a and d, at the memory rate,
        which bounds it. The f32 CUDA-core rate, at which the f32 kernel
        runs, is printed beside it. Also printed: kernel 7's share of a
        prefill call (its launches a call times its time, over the
        call's median)."""
        row, flops = self._ssd_row(self.ssd_args, "ssd_scan")
        row["max_abs_err"] = max(row["max_abs_err"], self.path_err["ssd_scan"])
        layers = self.phase_counts["ssm_prefill"]["ssd_scan"] // SSM_REPS
        emit({"ssd_scan_needed_tflops": flops / row["ms"] / 1e9,
              "share_of_bound": row["bound_ms"] / row["ms"],
              "bound_by": row["bound_by"],
              "share_of_f32_cuda_core_bound": flops / F32_FLOPS * 1e3
              / row["ms"],
              "share_of_prefill_call": layers * row["ms"]
              / (self.ssm_prefill_s * 1e3), "prefill_call_ms":
              self.ssm_prefill_s * 1e3, "launches_per_call": layers})
        emit({"redesigned": "ssd_scan", "ms": row["ms"],
              "before_ms": BEFORE_SLICE6_MS["ssd_scan"],
              "inputs": "prefill's layer-0 views, (4, 2048, 80, 64) bf16, "
                        "N 128, G 1, L 64",
              "before": BEFORE_SLICE6})
        return [row]

    # ------------------------------------------------ 17. hybrid zamba2
    def _held_prefill(self, phase: str, call, causal=None) -> dict:
        """Run one prefill ``call()`` uncounted, recording every kernel-7
        and kernel-5 launch, and hold each to its plain version: kernel 7
        to the plain chunked scan at the main path's bar, kernel 5 to
        mha_ref at attn_path_bar (``causal`` lists each attention call's
        mask; all causal when None). Returns the worst errors, each
        attention call's max |ref| and max |diff|, and the first launch's
        inputs of each kernel."""
        attn = layers.attention
        calls = []

        def attention(q, k, v, *, causal=True):
            out = attn(q, k, v, causal=causal)
            calls.append(((q, k, v), causal, out))
            return out

        with uncounted(), recorded(mamba2, "ssd") as scans, \
                mock.patch.object(layers, "attention", attention):
            call()
        if causal is not None and [c for _, c, _ in calls] != causal:
            raise AssertionError(f"{phase}: attention calls' masks "
                                 f"{[c for _, c, _ in calls]}, not {causal}")
        out = {"ssd_scan_launches_held": len(scans),
               "flash_attention_launches_held": len(calls)}
        if scans:
            out["ssd_scan_vs_plain"] = max(ssd_path_err([(
                f"{phase}.ssd_scan.layer{li}", y,
                ssd_k.ssd_chunked(*args, SSM_CHUNK))])
                for li, (args, y) in enumerate(scans))
            out["ssd_args"] = scans[0][0]
        by_call = []
        for i, (qkv, c, o) in enumerate(calls):
            ref = attn_plain(qkv, c)
            by_call.append([float(ref.float().abs().max()), attn_path_err(
                [(f"{phase}.flash_attention.call{i}", o, ref)], qkv, c)])
        out["flash_attention_vs_plain"] = max(e for _, e in by_call)
        # [max |ref|, max |diff|] of each attention call, in call order
        out["flash_attention_by_call"] = by_call
        out["qkv"] = [(qkv, c) for qkv, c, _ in calls]
        return out

    def shared_local(self, attns, mlps, cfg) -> list[float]:
        """Each shared-block site's attention and MLP as decode runs them,
        fed forward's own inputs to them (``attns``, ``mlps``: forward's
        recorded attention_block and mlp calls) token by token, the
        attention over a fresh KV cache, against forward's outputs:
        row_rel_diff each, attention and MLP of site 0, then of site 1, and
        so on (what each alone adds; a site's output less its input would
        be lost in the bf16 rounding of the residual stream)."""
        local = []
        for (args, ref), (margs, mref) in zip(attns, mlps, strict=True):
            xin, hin = args[1], margs[1]                     # (1, T, d)
            t_len = xin.shape[1]
            k, v = (torch.zeros((1, t_len, cfg.num_kv_heads, cfg.hd),
                                dtype=xin.dtype, device=self.dev)
                    for _ in range(2))
            ys = [zamba2.attention_decode(args[0], xin[:, t:t + 1], cfg, k,
                                          v, t)[0][0, 0]
                  for t in range(t_len)]
            fs = [zamba2.mlp(margs[0], hin[:, t:t + 1], cfg)[0, 0]
                  for t in range(t_len)]
            local += [row_rel_diff(torch.stack(ys), ref[0]),
                      row_rel_diff(torch.stack(fs), mref[0])]
        return local

    def hybrid_zamba2(self) -> dict:
        """zamba2-1.2b at its published widths (38 mamba layers, d_model
        2048, 64 SSD heads of 64, N 64; the shared block's 32 heads of 64
        after every 6 layers: 6 sites and 2 tail layers; random bf16
        weights): prefill_step on HYBRID_B x HYBRID_S tokens (38 kernel-7
        and 6 kernel-5 launches a call), every launch of one call held to
        its plain version; a HYBRID_TF-token prompt teacher-forced through
        serve_step against forward, held as ssm_decode holds mamba2's:
        each mamba layer and each shared-block site's attention and MLP,
        fed forward's own input, within LOGIT_TOL, and an f32 copy of the
        model end to end
        within F32_LOGIT_TOL (the two paths computing one function), the
        bf16 end-to-end gap reported beside; greedy decode at batch
        GREEDY_B after a HYBRID_TF-token prompt fed through serve_step,
        and a profile of one step. Returns the kernels line's rows for
        kernel 7 at layer 0's inputs and kernel 5 at the first shared-block
        site's views."""
        cfg = get_config(ZAMBA)
        every, groups, tail = zamba2._group_shape(cfg)
        t0 = time.perf_counter()
        params = zamba2.init_params(SEED, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (HYBRID_B, HYBRID_S),
                               generator=gen, device=self.dev)
        synced(steps.prefill_step, params, tokens, cfg)     # warm-up
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        secs = []
        for _ in range(HYBRID_REPS):
            logits, sec = synced(steps.prefill_step, params, tokens, cfg)
            secs.append(sec)
        want = {"ssd_scan": cfg.num_layers * HYBRID_REPS,
                "flash_attention": groups * HYBRID_REPS}
        got = {k: _build.launches[k] for k in want}
        if got != want:
            raise AssertionError(f"hybrid prefill launched {got}, not {want}")
        if tuple(logits.shape) != (HYBRID_B, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("hybrid prefill: logits of the wrong shape, "
                                 "type or not finite")
        self.tally("hybrid_zamba2", dict(_build.launches))
        peak = torch.cuda.max_memory_allocated() / 2**30
        prefill_s = sorted(secs)[len(secs) // 2]
        held = self._held_prefill(
            "hybrid_zamba2", lambda: steps.prefill_step(params, tokens, cfg))
        emit({"phase": "hybrid_zamba2", "arch": ZAMBA,
              "params": cfg.param_count(), "init_s": init_s,
              "layers": cfg.num_layers, "every": every, "sites": groups,
              "tail": tail, "batch": HYBRID_B, "seq": HYBRID_S,
              "seconds": secs,
              "tokens_per_s": HYBRID_B * HYBRID_S / prefill_s,
              "launches_per_call": {k: v // HYBRID_REPS
                                    for k, v in got.items()},
              "peak_device_gib": peak,
              **{k: v for k, v in held.items()
                 if k not in ("ssd_args", "qkv")}})
        self.path_err["ssd_scan_zamba2"] = held["ssd_scan_vs_plain"]
        self.path_err["flash_attention_zamba2"] = \
            held["flash_attention_vs_plain"]
        ssd_args = held.pop("ssd_args")
        shared_qkv = held["qkv"][0][0]
        del held
        # teacher-forced decode against forward, bf16 and f32
        g = np.random.default_rng(SEED + 5)
        prompt = torch.from_numpy(g.integers(0, cfg.vocab_size,
                                             (1, HYBRID_TF))).to(self.dev)
        _build.reset_counts()
        with recorded(zamba2, "mamba_block") as blocks, \
                recorded(zamba2, "attention_block") as attns, \
                recorded(zamba2, "mlp") as mlps:
            full = zamba2.forward(params, prompt, cfg)[0][0]   # (T, V)
        bf16, (dec, dec_attns) = self.teacher_forced(
            params, cfg, steps.init_cache(cfg, 1, HYBRID_TF), prompt, full,
            watch=[(zamba2, "mamba_decode", decode_y),
                   (zamba2, "attention_decode", decode_y)])
        self.tally("hybrid_zamba2_decode", dict(_build.launches))
        cum = self.block_gaps(dec, [out[0] for _, out in blocks])
        cum_sites = self.block_gaps(dec_attns, [out[0] for _, out in attns])
        local = self.mamba_local(params["layers"], blocks, cfg)
        local_sites = self.shared_local(attns, mlps, cfg)
        del blocks, attns, mlps, dec, dec_attns, full
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("f32 matrix products must not run in TF32")

        def to_f32(tree):
            if isinstance(tree, dict):
                return {k: to_f32(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to_f32(v) for v in tree]
            return tree.float()

        p32 = to_f32(params)
        with uncounted():
            f32, _ = self.teacher_forced(
                p32, cfg, steps.init_cache(cfg, 1, HYBRID_TF,
                                           dtype=torch.float32),
                prompt, zamba2.forward(p32, prompt, cfg)[0][0])
        del p32
        torch.cuda.empty_cache()
        emit({"phase": "hybrid_zamba2_teacher_forced", **bf16,
              "tolerance": LOGIT_TOL,
              "within_tolerance": bf16["rel_diff"] <= LOGIT_TOL,
              "block_rel_diff_local_max": max(local),
              "site_attn_mlp_rel_diff_local": local_sites,
              "block_rel_diff_cumulative_every_8th": cum[::8] + [cum[-1]],
              "site_attn_rel_diff_cumulative": cum_sites,
              "f32_model_rel_diff": f32["rel_diff"],
              "f32_model_top1_agree": f32["top1_agree"],
              "f32_tolerance": F32_LOGIT_TOL})
        if max(local + local_sites) > LOGIT_TOL:
            raise AssertionError(f"hybrid: a layer's or a site's decode parts "
                                 f"from its prefill by "
                                 f"{max(local + local_sites)} of its max "
                                 "|output|")
        if f32["rel_diff"] > F32_LOGIT_TOL:
            raise AssertionError(f"hybrid: in f32, decode and forward logits "
                                 f"differ by {f32['rel_diff']} of max |logit|")
        # greedy decode of a batch after a prompt fed through serve_step
        prompt = torch.from_numpy(g.integers(
            0, cfg.vocab_size, (GREEDY_B, HYBRID_TF))).to(self.dev)
        cache = steps.init_cache(cfg, GREEDY_B, HYBRID_TF + GREEDY_STEPS + 1)
        for t in range(HYBRID_TF):
            logits, cache = steps.serve_step(params, cache, prompt[:, t], t,
                                             cfg)
        self.greedy("hybrid_zamba2_greedy", params, cfg, cache,
                    logits.argmax(-1), HYBRID_TF,
                    f"hybrid decode step, batch {GREEDY_B} "
                    f"({cfg.num_layers} mamba layers, {groups} sites)",
                    prompt=HYBRID_TF)
        del cache, params, tokens
        torch.cuda.empty_cache()
        row, flops = self._ssd_row(ssd_args, "ssd_scan_zamba2")
        row["max_abs_err"] = max(row["max_abs_err"],
                                 self.path_err["ssd_scan_zamba2"])
        x, b = ssd_args[0], ssd_args[3]
        row.update(inputs=f"{ZAMBA} prefill's layer-0 views, "
                   f"{tuple(x.shape)} bf16, N {b.shape[3]}, G {b.shape[2]}, "
                   f"L {SSM_CHUNK}", state=b.shape[3])
        emit({"ssd_scan_zamba2": {
            "ms": row["ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "plain_ms": row["plain_ms"],
            "share_of_bound": row["bound_ms"] / row["ms"],
            "needed_tflops": flops / row["ms"] / 1e9,
            "share_of_prefill_call": cfg.num_layers * row["ms"]
            / (prefill_s * 1e3), "prefill_call_ms": prefill_s * 1e3}})
        attn = self._flash_row(shared_qkv, True, "flash_attention_zamba2",
                               f"{ZAMBA} prefill's first shared-block views")
        attn["max_abs_err"] = max(attn["max_abs_err"],
                                  self.path_err["flash_attention_zamba2"])
        emit({"flash_attention_zamba2": {
            "ms": attn["ms"], "bound_ms": attn["bound_ms"],
            "bound_by": attn["bound_by"], "sdpa_ms": attn["library_ms"],
            "plain_ms": attn["plain_ms"],
            "share_of_bound": attn["bound_ms"] / attn["ms"],
            "share_of_prefill_call": groups * attn["ms"]
            / (prefill_s * 1e3)}})
        del shared_qkv
        return [row, attn]

    # ---------------------------------------------- 18. encdec seamless
    @staticmethod
    def tail_fault(qkv, label: str) -> dict:
        """The fault a ragged non-causal tile could hide, planted in the
        plain version on a main path's (q, k, v) in model layout: the keys
        past the last whole 64-key tile dropped. Held to mha_ref at
        attn_path_bar, which must see it; the count outside TOL's fixed bar
        is reported beside."""
        sk = qkv[1].shape[1]
        cut = sk - sk % 64
        if cut == sk:
            raise AssertionError(f"{label}: {sk} keys leave no ragged tile")
        ref = attn_plain(qkv, False).float()
        diff = (attn_plain(qkv, False, keys=cut).float() - ref).abs()
        tol = TOL[torch.bfloat16]["flash_attention"]
        out = {"planted_fault": f"{label}: keys {cut}..{sk - 1} of {sk} "
                                "dropped",
               "elements": ref.numel(),
               "max_abs_ref": float(ref.abs().max()),
               "mean_abs_ref": float(ref.abs().mean()),
               "fault_max_abs_diff": float(diff.max()),
               "fault_outside_bar": int(
                   (diff > attn_path_bar(ref, qkv, False)).sum()),
               "fault_outside_fixed_tol": int((diff > tol + tol * ref.abs())
                                              .sum())}
        if not out["fault_outside_bar"]:
            raise AssertionError(f"{label}: attn_path_bar does not see the "
                                 "planted fault")
        return out

    def encdec_seamless(self) -> dict:
        """seamless-m4t-medium at its published widths (12 + 12 layers,
        d_model 1024, 16 heads of 64, vocab 256,206; random bf16 weights;
        random frame embeddings, the frontend being a stub):
        prefill_step on ENC_B x ENC_FRAMES frames and ENC_B x ENC_TOKENS
        tokens (12 encoder launches of kernel 5, 12 causal self and 12
        cross launches at Sq ENC_TOKENS against Sk ENC_FRAMES), every
        launch of one call held to mha_ref, and the bar shown to see a
        dropped ragged tail at the first encoder and cross views; encode
        and prepare_cross, then ENC_TOKENS tokens teacher-forced through
        serve_step at batch 1 against forward within LOGIT_TOL; greedy
        decode at batch ENC_B over the batch's memory. Returns the kernels
        line's rows for kernel 5 at the first cross-attention's views and
        at the first encoder layer's."""
        cfg = get_config(SEAMLESS)
        t0 = time.perf_counter()
        params = encdec.init_params(SEED, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        frames = torch.randn((ENC_B, ENC_FRAMES, cfg.d_model), generator=gen,
                             device=self.dev) * 0.02
        tokens = torch.randint(0, cfg.vocab_size, (ENC_B, ENC_TOKENS),
                               generator=gen, device=self.dev)

        def call():
            return steps.prefill_step(params, tokens, cfg, frames=frames)

        synced(call)                                        # warm-up
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        secs = []
        for _ in range(ENC_REPS):
            logits, sec = synced(call)
            secs.append(sec)
        per_call = cfg.encoder_layers + 2 * cfg.num_layers
        launches = _build.launches["flash_attention"]
        if launches != per_call * ENC_REPS:
            raise AssertionError(f"encdec prefill launched flash_attention "
                                 f"{launches} times, not {per_call} a call")
        if tuple(logits.shape) != (ENC_B, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("encdec prefill: logits of the wrong shape, "
                                 "type or not finite")
        self.tally("encdec_seamless", dict(_build.launches))
        peak = torch.cuda.max_memory_allocated() / 2**30
        sec = sorted(secs)[len(secs) // 2]
        held = self._held_prefill(
            "encdec_seamless", call,
            causal=[False] * cfg.encoder_layers + [True, False]
            * cfg.num_layers)
        first_cross = cfg.encoder_layers + 1
        cross = held["qkv"][first_cross][0]
        encoder = held["qkv"][0][0]
        emit({"phase": "encdec_seamless", "arch": SEAMLESS,
              "params": cfg.param_count(), "init_s": init_s,
              "encoder_layers": cfg.encoder_layers,
              "decoder_layers": cfg.num_layers, "batch": ENC_B,
              "frames": ENC_FRAMES, "tokens": ENC_TOKENS, "seconds": secs,
              "frames_per_s": ENC_B * ENC_FRAMES / sec,
              "tokens_per_s": ENC_B * ENC_TOKENS / sec,
              "flash_attention_launches": launches,
              "launches_per_call": per_call, "peak_device_gib": peak,
              "cross_shape": {"q": list(cross[0].shape),
                              "k": list(cross[1].shape)},
              **{k: v for k, v in held.items() if k != "qkv"}})
        for i, label in ((0, "encoder layer 0"),
                         (first_cross, "cross-attention, decoder layer 0")):
            max_ref, err = held["flash_attention_by_call"][i]
            emit({"phase": "encdec_seamless_tail_fault",
                  **self.tail_fault(held["qkv"][i][0], label),
                  "kernel_max_abs_diff": err, "kernel_max_abs_ref": max_ref,
                  "rtol": ATTN_PATH_RTOL,
                  "atol_of_abs_average": ATTN_PATH_ATOL_OF_ABS})
        self.path_err["flash_attention_cross"] = \
            held["flash_attention_vs_plain"]
        del held, logits
        torch.cuda.empty_cache()
        # encode + prepare_cross, then teacher-forced decode at batch 1
        _build.reset_counts()
        f1, t1 = frames[:1], tokens[:1]
        full = encdec.forward(params, f1, t1, cfg)[0][0]        # (T, V)
        cache = encdec.prepare_cross(
            params, encdec.encode(params, f1, cfg), cfg,
            steps.init_cache(cfg, 1, ENC_TOKENS, enc_len=ENC_FRAMES))
        self.tally("encdec_seamless_decode", dict(_build.launches))
        gap, _ = self.teacher_forced(params, cfg, cache, t1, full)
        del full, cache
        torch.cuda.empty_cache()
        emit({"phase": "encdec_seamless_teacher_forced", **gap,
              "frames": ENC_FRAMES, "tolerance": LOGIT_TOL})
        if gap["rel_diff"] > LOGIT_TOL:
            raise AssertionError(f"encdec decode and forward logits differ "
                                 f"by {gap['rel_diff']} of max |logit|")
        # greedy decode of the batch over its memory
        with uncounted():
            cache = encdec.prepare_cross(
                params, encdec.encode(params, frames, cfg), cfg,
                steps.init_cache(cfg, ENC_B, GREEDY_STEPS + 1,
                                 enc_len=ENC_FRAMES))
        self.greedy("encdec_seamless_greedy", params, cfg, cache,
                    tokens[:, 0], 0,
                    f"encdec decode step, batch {ENC_B} ({cfg.num_layers} "
                    f"decoder layers over {ENC_FRAMES} frames)")
        del cache, params, frames, tokens
        torch.cuda.empty_cache()
        row = self._flash_row(cross, False, "flash_attention_cross",
                              f"{SEAMLESS} prefill's first cross-attention "
                              "views")
        row["max_abs_err"] = max(row["max_abs_err"],
                                 self.path_err["flash_attention_cross"])
        emit({"flash_attention_cross": {
            "ms": row["ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "sdpa_ms": row["library_ms"],
            "plain_ms": row["plain_ms"],
            "share_of_bound": row["bound_ms"] / row["ms"]}})
        enc = self._flash_row(encoder, False, "flash_attention_encoder",
                              f"{SEAMLESS} prefill's first encoder "
                              "self-attention views")
        enc["max_abs_err"] = max(enc["max_abs_err"],
                                 self.path_err["flash_attention_cross"])
        emit({"flash_attention_encoder": {
            "ms": enc["ms"], "bound_ms": enc["bound_ms"],
            "bound_by": enc["bound_by"], "sdpa_ms": enc["library_ms"],
            "plain_ms": enc["plain_ms"],
            "share_of_bound": enc["bound_ms"] / enc["ms"]}})
        del cross, encoder
        return [row, enc]

    # ----------------------------------------------------- 19. training
    def train_qwen(self) -> None:
        """qwen1.5-0.5b at its published widths (24 layers, d_model 1024,
        16 heads of 64, d_ff 2816, vocab 151,936, untied; random bf16
        weights): train_step on TRAIN_B x TRAIN_S tokens, 48 kernel-5
        launches a step (each block's forward, and again in its
        checkpointed recompute)."""
        self._train("train_qwen", ARCH)

    def train_zamba2(self) -> None:
        """zamba2-1.2b at its published widths (38 mamba layers, 6
        shared-block sites, vocab 32,000; random bf16 weights): train_step
        on TRAIN_B x TRAIN_S tokens, 76 kernel-7 launches a step (each
        mamba layer's forward and its recompute) and 6 kernel-5 (the shared
        block is not checkpointed, as in the reference)."""
        self._train("train_zamba2", ZAMBA)

    @contextlib.contextmanager
    def held_step(self, phase: str):
        """Hold every kernel-5 and kernel-7 launch made inside the block (a
        train step: the forward, and the backward's recompute of each
        checkpointed block) to its plain version as it returns, at the
        main path's bars (attn_path_bar, ssd_path_err). Yields a dict of
        the launches held and the worst errors."""
        attn, scan = layers.attention, mamba2.ssd
        m = {"flash_attention_held": 0, "ssd_scan_held": 0,
             "flash_attention_vs_plain": 0.0, "ssd_scan_vs_plain": 0.0}

        def attention(q, k, v, *, causal=True):
            n0 = _build.launches["flash_attention"]
            out = attn(q, k, v, causal=causal)
            if _build.launches["flash_attention"] != n0 + 1:
                raise AssertionError(f"{phase}: an attention call launched "
                                     "no kernel")
            with torch.no_grad():
                qkv = (q.detach(), k.detach(), v.detach())
                err = attn_path_err([(
                    f"{phase}.flash_attention.call"
                    f"{m['flash_attention_held']}", out.detach(),
                    attn_plain(qkv, causal))], qkv, causal)
            m["flash_attention_held"] += 1
            m["flash_attention_vs_plain"] = max(
                m["flash_attention_vs_plain"], err)
            return out

        def ssd(x, dt, a, b, c, d, *, chunk=64):
            n0 = _build.launches["ssd_scan"]
            y = scan(x, dt, a, b, c, d, chunk=chunk)
            if _build.launches["ssd_scan"] != n0 + 1:
                raise AssertionError(f"{phase}: an SSD call launched no "
                                     "kernel")
            with torch.no_grad():
                args = [t.detach() for t in (x, dt, a, b, c, d)]
                err = ssd_path_err([(
                    f"{phase}.ssd_scan.call{m['ssd_scan_held']}",
                    y.detach(), ssd_k.ssd_chunked(
                        *args, min(chunk, x.shape[1])))])
            m["ssd_scan_held"] += 1
            m["ssd_scan_vs_plain"] = max(m["ssd_scan_vs_plain"], err)
            return y

        with mock.patch.object(layers, "attention", attention), \
                mock.patch.object(mamba2, "ssd", ssd):
            yield m

    @staticmethod
    def _finite(params, loss) -> bool:
        """The loss and every parameter finite (one read-back)."""
        flags = [torch.isfinite(loss).all()] + \
            [torch.isfinite(t).all() for _, t in optim.adamw.leaves(params)]
        return bool(torch.stack(flags).all())

    def _train(self, phase: str, arch: str) -> None:
        """TRAIN_STEPS + 1 steps of steps.train_step at ``arch``'s published
        widths on one fixed batch, counted from 0: the first with every
        kernel launch held to its plain version (held_step), the next
        TRAIN_STEPS timed (tokens/s from their median), the last profiled
        (the device's busy share). The launches a step must be one a
        forward call and one a checkpointed block's recompute; the loss
        and every parameter finite after each step; the last step's loss
        below the first's. Then the gradients on the card held to the
        CPU's at a cut depth (_train_grad_hold)."""
        from torch.profiler import ProfilerActivity, profile
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        _, groups, _ = zamba2._group_shape(cfg)
        per_step = ({"flash_attention": 2 * cfg.num_layers, "ssd_scan": 0}
                    if cfg.family == "dense" else
                    {"flash_attention": groups,
                     "ssd_scan": 2 * cfg.num_layers})
        t0 = time.perf_counter()
        params = build_model(cfg).init(SEED)
        opt_state = optim.init_state(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = make_batch(cfg, TRAIN_B, TRAIN_S, gen=torch.Generator(
            device=self.dev).manual_seed(SEED))
        opt = optim.AdamWConfig(warmup_steps=1)
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        metrics, secs = [], []

        def step():
            nonlocal params, opt_state
            (params, opt_state, m), sec = synced(
                steps.train_step, params, opt_state, batch, cfg, opt)
            metrics.append({k: float(v) for k, v in m.items()})
            if not self._finite(params, m["loss"]):
                raise AssertionError(f"{phase}: step {len(metrics)}: the "
                                     "loss or a parameter is not finite")
            return sec

        with self.held_step(phase) as held:
            first_s = step()
        want = {k: v for k, v in per_step.items() if v}
        got = {k: _build.launches[k] for k in want}
        if got != want or held["flash_attention_held"] != \
                per_step["flash_attention"] or \
                held["ssd_scan_held"] != per_step["ssd_scan"]:
            raise AssertionError(f"{phase}: the first step launched {got} "
                                 f"and held {held}, not {want}")
        for _ in range(TRAIN_STEPS):
            secs.append(step())
        # the device's activity alone: a step launches tens of thousands
        # of kernels, and the host's events would take seconds to walk
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = step()
        summary = device_summary(prof, wall)
        profile_s = time.perf_counter() - t1
        steps_run = len(metrics)
        got = {k: _build.launches[k] for k in want}
        if got != {k: v * steps_run for k, v in want.items()}:
            raise AssertionError(f"{phase}: {steps_run} steps launched {got}, "
                                 f"not {want} a step")
        if not metrics[-1]["loss"] < metrics[0]["loss"]:
            raise AssertionError(f"{phase}: the loss did not fall: "
                                 f"{[m['loss'] for m in metrics]}")
        self.tally(phase, dict(_build.launches))
        peak = torch.cuda.max_memory_allocated() / 2**30
        sec = sorted(secs)[len(secs) // 2]
        self.train_step_s[phase] = sec
        del params, opt_state, batch
        torch.cuda.empty_cache()
        hold = self._train_grad_hold(phase, cfg)
        emit({"phase": phase, "arch": arch, "params": cfg.param_count(),
              "layers": cfg.num_layers, "init_s": init_s, "batch": TRAIN_B,
              "seq": TRAIN_S, "cut": TRAIN_CUT, "steps": steps_run,
              "first_step_s": first_s, "seconds": secs,
              "tokens_per_s": TRAIN_B * TRAIN_S / sec,
              "peak_device_gib": peak,
              "loss": [m["loss"] for m in metrics],
              "grad_norm": [m["grad_norm"] for m in metrics],
              "lr": metrics[-1]["lr"], "launches_per_step": want,
              "launches": got, **held, "busy_share_profiled_step":
              summary["device_busy_share"], "profile_s": profile_s,
              "grad_hold": hold, "phase_s": time.perf_counter() - t_phase})
        emit({"profile": f"one {arch} train step, {TRAIN_B} x {TRAIN_S}",
              **summary})

    def _train_grad_hold(self, phase: str, cfg) -> dict:
        """The loss and every parameter's gradient of one batch on the card
        (kernels 5 and 7 forward, their plain versions' backward) against
        the same on the CPU (the plain versions throughout): ``cfg`` cut to
        TRAIN_HOLD_LAYERS layers at full width, train_step's remat and
        loss chunk, f32 weights from the seeded bf16 ones (so both hold the
        same values), TF32 off, TRAIN_HOLD_B x TRAIN_HOLD_S tokens; within
        TRAIN_GRAD_TOL of each leaf's max |g|. Uncounted."""
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("f32 matrix products must not run in TF32")
        cut = cfg.replace(num_layers=TRAIN_HOLD_LAYERS[cfg.name],
                          remat="full", loss_chunk=512)
        t0 = time.perf_counter()
        with uncounted():
            card = optim.adamw.tree_map(lambda t: t.float(),
                                        build_model(cut).init(SEED + 1))
            host = optim.adamw.tree_map(lambda t: t.cpu(), card)
            batch = make_batch(cut, TRAIN_HOLD_B, TRAIN_HOLD_S,
                               gen=torch.Generator(device=self.dev)
                               .manual_seed(SEED + 1))
            n0 = dict(_build.launches)
            loss_c, _, grads_c = steps.value_and_grad(card, batch, cut)
            launched = {k: _build.launches[k] - n0[k]
                        for k in ("flash_attention", "ssd_scan")}
            loss_h, _, grads_h = steps.value_and_grad(
                host, {k: v.cpu() for k, v in batch.items()}, cut)
        if not any(launched.values()):
            raise AssertionError(f"{phase}: the gradient hold launched no "
                                 "kernel on the card")
        worst, where = 0.0, None
        for (path, gc_), (_, gh) in zip(optim.adamw.leaves(grads_c),
                                        optim.adamw.leaves(grads_h),
                                        strict=True):
            scale = float(gh.abs().max()) or 1.0
            gap = float((gc_.cpu() - gh).abs().max()) / scale
            if gap > worst:
                worst, where = gap, "/".join(map(str, path))
        loss_gap = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
        out = {"layers": cut.num_layers, "batch": TRAIN_HOLD_B,
               "seq": TRAIN_HOLD_S, "dtype": "float32",
               "launches": launched, "loss_card": float(loss_c),
               "loss_cpu": float(loss_h), "loss_rel_diff": loss_gap,
               "worst_leaf_rel_diff": worst, "worst_leaf": where,
               "tolerance": TRAIN_GRAD_TOL,
               "seconds": time.perf_counter() - t0}
        if worst > TRAIN_GRAD_TOL or loss_gap > TRAIN_GRAD_TOL:
            emit({"phase": f"{phase}_grad_hold", **out})
            raise AssertionError(f"{phase}: card and CPU gradients part by "
                                 f"{worst} of a leaf's max |g| at {where} "
                                 f"(loss by {loss_gap})")
        return out

    # ------------------------------------------------ 20. training's loop
    def train_loop(self) -> None:
        """launch.train.train at qwen1.5-0.5b's published widths, TRAIN_B x
        TRAIN_S tokens a step from SyntheticLM through the Prefetcher,
        checkpoints in a temporary directory under build/ (removed at the
        end): LOOP_STEPS steps with a failure injected after step
        LOOP_FAIL_AT (one sealed checkpoint, step LOOP_RESUME_AT), then
        LOOP_RESUME_STEPS steps resumed from it, as the reference's
        tests/test_system.py drives it. The first step's kernel-5 launches
        are held to the plain version (held_step); the phase's launches
        must be 48 a step; every step's loss and each run's parameters
        finite. The state the resumed run restores must equal the saved
        one bit for bit (_restored_as_saved, before the loop unstacks it).
        Timed: each step between synchronizations, the waits in
        Prefetcher.next and in the batch's upload, the save (its blocking
        host copy, the asynchronous flush by stage, the steps that overlap
        it) and the restores (validation with its CRC passes, the load,
        the upload, the unstacking)."""
        phase = "train_loop"
        t_phase = time.perf_counter()
        cfg = get_config(ARCH)
        build = ROOT / "build"
        build.mkdir(exist_ok=True)
        ckpt_bytes = cfg.param_count() * (2 + 4 + 4)
        free = shutil.disk_usage(build).free
        if free < 2 * ckpt_bytes:
            raise RuntimeError(f"{phase}: {free / 1e9:.1f} GB free under "
                               f"{build}, a checkpoint needs "
                               f"{ckpt_bytes / 1e9:.1f} GB (twice that "
                               "asked for)")
        d = tempfile.mkdtemp(prefix="train_loop_", dir=build)
        rec = {"step_s": [], "step_span": [], "losses": [], "held": None,
               "next_s": [], "steps_given": [], "tokens": [],
               "upload_s": [], "saves": [], "restores": [],
               "from_checkpoint_s": [], "restore_check": None}
        real = {"step": steps.train_step, "next": Prefetcher.next,
                "upload": train_mod.upload,
                "save": ckpt_mod.CheckpointStore.save,
                "restore": ckpt_mod.CheckpointStore.restore,
                "from_ckpt": state_mod.from_checkpoint}

        def train_step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rec["held"] is None:
                with self.held_step(phase) as held:
                    out = real["step"](*args)
                rec["held"] = dict(held)
            else:
                out = real["step"](*args)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["step_s"].append(t1 - t0)
            rec["step_span"].append((t0, t1))
            loss = float(out[2]["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"{phase}: step {len(rec['step_s'])}: "
                                     f"loss {loss}")
            rec["losses"].append(loss)
            return out

        def next_batch(pf):
            t0 = time.perf_counter()
            step, batch = real["next"](pf)
            rec["next_s"].append(time.perf_counter() - t0)
            rec["steps_given"].append(step)
            rec["tokens"].append(batch["tokens"])
            return step, batch

        def upload(batch, dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real["upload"](batch, dev)
            torch.cuda.synchronize()
            rec["upload_s"].append(time.perf_counter() - t0)
            return out

        def save(store, step, tree, extra=None):
            t0 = time.perf_counter()
            fut = real["save"](store, step, tree, extra)
            t1 = time.perf_counter()
            entry = {"step": step, "store": store, "call_s": t1 - t0,
                     "returned": t1, "flushed": None}
            fut.add_done_callback(
                lambda _: entry.update(flushed=time.perf_counter()))
            rec["saves"].append(entry)
            return fut

        def restore(store, template, step=None, device=None):
            before = dict(store.stats)
            t0 = time.perf_counter()
            out = real["restore"](store, template, step, device)
            rec["restores"].append({
                "step": out[2], "call_s": time.perf_counter() - t0,
                "store": store,
                **{k: store.stats[k] - before[k] for k in
                   ("validate_s", "crc_s", "crc_passes", "crc_bytes",
                    "load_s", "upload_s", "bytes_read")}})
            return out

        def from_checkpoint(tree, cfg_, device=None):
            # the state the loop resumes from, as restored
            rec["restore_check"] = self._restored_as_saved(
                phase, d, LOOP_RESUME_AT, tree, self.dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real["from_ckpt"](tree, cfg_, device)
            torch.cuda.synchronize()
            rec["from_checkpoint_s"].append(time.perf_counter() - t0)
            return out

        run = dict(smoke=False, batch=TRAIN_B, seq=TRAIN_S, ckpt_dir=d,
                   log_every=LOOP_LOG_EVERY, seed=SEED)
        # set every count to 0 just before the main path
        _build.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            with mock.patch.object(steps, "train_step", train_step), \
                    mock.patch.object(Prefetcher, "next", next_batch), \
                    mock.patch.object(train_mod, "upload", upload), \
                    mock.patch.object(ckpt_mod.CheckpointStore, "save",
                                      save), \
                    mock.patch.object(ckpt_mod.CheckpointStore, "restore",
                                      restore), \
                    mock.patch.object(state_mod, "from_checkpoint",
                                      from_checkpoint):
                t0 = time.perf_counter()
                params, opt_state, losses_a = train_mod.train(
                    ARCH, steps=LOOP_STEPS, fail_at=LOOP_FAIL_AT, **run)
                first_run_s = time.perf_counter() - t0
                if not self._finite(params, torch.tensor(losses_a,
                                                         device=self.dev)):
                    raise AssertionError(f"{phase}: the first run's loss or "
                                         "a parameter is not finite")
                del params, opt_state
                torch.cuda.empty_cache()
                first_steps = len(rec["step_s"])
                t0 = time.perf_counter()
                params, opt_state, losses_b = train_mod.train(
                    ARCH, steps=LOOP_RESUME_STEPS, resume=True, **run)
                resumed_run_s = time.perf_counter() - t0
            if not self._finite(params, torch.tensor(losses_b,
                                                     device=self.dev)):
                raise AssertionError(f"{phase}: the resumed run's loss or a "
                                     "parameter is not finite")
            self.tally(phase, dict(_build.launches))
            peak = torch.cuda.max_memory_allocated() / 2**30
            steps_run = len(rec["step_s"])
            want_given = list(range(LOOP_STEPS)) + list(range(
                LOOP_RESUME_AT, LOOP_RESUME_AT + LOOP_RESUME_STEPS))
            if rec["steps_given"] != want_given or \
                    [r["step"] for r in rec["restores"]] != [LOOP_RESUME_AT]:
                raise AssertionError(
                    f"{phase}: the loop ran steps {rec['steps_given']} and "
                    f"restored {[r['step'] for r in rec['restores']]}, not "
                    f"{want_given} from step {LOOP_RESUME_AT}")
            per_step = 2 * cfg.num_layers
            held = rec["held"]
            launched = _build.launches["flash_attention"]
            if launched != per_step * steps_run or \
                    held["flash_attention_held"] != per_step:
                raise AssertionError(f"{phase}: {steps_run} steps launched "
                                     f"kernel 5 {launched} times and held "
                                     f"{held}, not {per_step} a step")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        self.loop = {"params": params, "opt_state": opt_state, "cfg": cfg,
                     "tokens": rec["tokens"]}
        save = rec["saves"][0]
        flush_s = save["flushed"] - save["returned"]
        overlap = [sec for sec, (a, b) in zip(rec["step_s"],
                                              rec["step_span"])
                   if b > save["returned"] and a < save["flushed"]]
        firsts = {0, first_steps}
        steady = sorted(sec for i, (sec, (a, b)) in enumerate(zip(
            rec["step_s"], rec["step_span"])) if i not in firsts
            and not (b > save["returned"] and a < save["flushed"]))
        median = steady[len(steady) // 2]
        stats = save["store"].stats
        logged = [i + 1 for i in range(LOOP_STEPS)
                  if (i + 1) % LOOP_LOG_EVERY == 0 or i == 0] + \
            [i + 1 for i in range(LOOP_RESUME_AT,
                                  LOOP_RESUME_AT + LOOP_RESUME_STEPS)
             if (i + 1) % LOOP_LOG_EVERY == 0 or i == LOOP_RESUME_AT]
        emit({"phase": phase, "arch": ARCH, "params": cfg.param_count(),
              "batch": TRAIN_B, "seq": TRAIN_S, "cut": LOOP_CUT,
              "steps": steps_run,
              "runs": [{"steps": LOOP_STEPS, "fail_at": LOOP_FAIL_AT,
                        "seconds": first_run_s},
                       {"steps": LOOP_RESUME_STEPS,
                        "resumed_at": LOOP_RESUME_AT,
                        "seconds": resumed_run_s}],
              "step_s": rec["step_s"],
              "median_step_s": median,
              "median_of": "steps but each run's first and those "
                           "overlapping the flush",
              "tokens_per_s": TRAIN_B * TRAIN_S / median,
              "train_qwen_median_step_s": self.train_step_s.get(
                  "train_qwen"),
              "prefetch_wait_s": rec["next_s"],
              "prefetch_wait_total_s": sum(rec["next_s"]),
              "upload_s": rec["upload_s"],
              "upload_total_s": sum(rec["upload_s"]),
              "save": {"step": save["step"], "bytes": stats["bytes_written"],
                       "blocking_call_s": save["call_s"],
                       "host_copy_s": stats["copy_s"],
                       "flush_s": flush_s,
                       "flush_gbps": stats["bytes_written"] / flush_s / 1e9,
                       **{k: stats[k] for k in
                          ("write_s", "fsync_s", "manifest_s", "gc_s")},
                       "crc_s_write_and_gc": stats["crc_s"],
                       "crc_passes_write_and_gc": stats["crc_passes"],
                       "steps_overlapping_flush_s": overlap},
              "restore": {**{k: v for k, v in rec["restores"][0].items()
                             if k != "store"},
                          "resumed_run_store": dict(
                              rec["restores"][0]["store"].stats)},
              "unstack_s": rec["from_checkpoint_s"],
              "restore_check": rec["restore_check"],
              "logged_steps": logged, "losses": losses_a + losses_b,
              "step_losses": rec["losses"],
              # step LOOP_RESUME_AT + 1's loss twice from the same state
              # and batch: the first run's, the resumed run's first
              "resumed_step_loss": {
                  "first_run": rec["losses"][LOOP_RESUME_AT],
                  "resumed_run": rec["losses"][first_steps]},
              "launches": {"flash_attention": launched},
              "launches_per_step": {"flash_attention": per_step},
              **held, "checkpoint_bytes_estimate": ckpt_bytes,
              "disk_free_gb": free / 1e9, "peak_device_gib": peak,
              "phase_s": time.perf_counter() - t_phase})

    @staticmethod
    def _restored_as_saved(phase: str, d: str, step: int, tree,
                           dev) -> dict:
        """The restored checkpoint ``tree`` equals what was saved at
        ``step`` in the store at ``d``, bit for bit: every leaf on ``dev``
        and, copied back to the host as the store would save it, byte for
        byte its segment (whose CRC the restore has just checked against
        the manifest written at the save), with the entry's shape and
        dtype."""
        t0 = time.perf_counter()
        with open(Path(d) / f"MANIFEST-{step}.json") as f:
            entries = json.load(f)["entries"]
        leaves = ckpt_mod._leaf_paths(tree)
        if sorted(name for name, _ in leaves) != sorted(entries):
            raise AssertionError(f"{phase}: restored leaves {len(leaves)} "
                                 f"against {len(entries)} in the manifest")
        nbytes = 0
        for name, leaf in leaves:
            if leaf.device.type != dev.type:
                raise AssertionError(f"{phase}: {name} restored onto "
                                     f"{leaf.device}")
            stored, dtype = ckpt_mod._to_storage(leaf)
            ent = entries[name]
            seg = np.load(Path(d) / "segments" / str(step) / ent["file"],
                          mmap_mode="r")
            nbytes += stored.nbytes
            if [dtype, list(stored.shape)] != [ent["dtype"], ent["shape"]] \
                    or seg.dtype != stored.dtype or not np.array_equal(
                        seg.reshape(-1).view(np.uint8),
                        stored.reshape(-1).view(np.uint8)):
                raise AssertionError(f"{phase}: restored leaf {name} "
                                     f"({dtype}, {list(stored.shape)}) "
                                     f"differs from its segment {ent}")
        return {"leaves": len(leaves), "equal": True, "bytes": nbytes,
                "seconds": time.perf_counter() - t0}

    # ---------------------------------------------------- 21. hot rows
    def hot_rows(self) -> None:
        """The hot-row replica (embedding/hot_rows.py) of the embedding
        table train_loop trained (151,936 x 1,024 bf16): the token ids of
        the loop's batches counted, the M-node's rule (k_sigma HOT_K_SIGMA,
        at most HOT_MAX_ROWS rows), build_replica padded to HOT_MAX_ROWS;
        lookup of the next TRAIN_B x TRAIN_S batch bit for bit the plain
        gather, is_hot np.isin; then one more train_step (48 kernel-5
        launches) changes the table, the old replica must now disagree on
        the hot ids, refresh_after_update, and the lookup must equal the
        gather again. Timed: lookup against the plain gather."""
        phase = "hot_rows"
        t_phase = time.perf_counter()
        loop = self.loop
        params, opt_state, cfg = loop["params"], loop["opt_state"], \
            loop["cfg"]
        table = params["embed"]
        counts = np.bincount(np.concatenate(
            [t.ravel() for t in loop["tokens"]]), minlength=cfg.vocab_size)
        hot = embedding.select_hot_rows(counts, HOT_K_SIGMA, HOT_MAX_ROWS)
        if not len(hot):
            raise AssertionError(f"{phase}: no hot row among the loop's "
                                 "tokens")
        st = embedding.build_replica(table, hot, pad_to=HOT_MAX_ROWS)
        nxt = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=SEED).batch(
            LOOP_RESUME_AT + LOOP_RESUME_STEPS)
        ids_np = nxt["tokens"]
        ids = torch.from_numpy(ids_np).to(self.dev)
        want_hot = np.isin(ids_np, hot)

        def check(state, when: str) -> float:
            out, is_hot = embedding.lookup(table, state, ids)
            gather = table[ids.long()]
            if not torch.equal(out, gather):
                raise AssertionError(f"{phase}: lookup {when} differs from "
                                     "the gather")
            if not np.array_equal(is_hot.cpu().numpy(), want_hot):
                raise AssertionError(f"{phase}: is_hot {when} differs from "
                                     "np.isin")
            return float(is_hot.float().mean())

        hot_share = check(st, "before the update")
        lookup_ms = event_ms(lambda: embedding.lookup(table, st, ids),
                             REPS)[0]
        gather_ms = event_ms(lambda: table[ids.long()], REPS)[0]
        # one more step changes every row (weight decay) and the replica
        # goes stale
        _build.reset_counts()
        opt = optim.AdamWConfig(warmup_steps=1)
        params, opt_state, m = steps.train_step(
            params, opt_state, train_mod.upload(nxt, self.dev),
            cfg.replace(loss_chunk=min(TRAIN_S, 512)), opt)
        self.tally(phase, dict(_build.launches))
        if _build.launches["flash_attention"] != 2 * cfg.num_layers:
            raise AssertionError(f"{phase}: the step launched kernel 5 "
                                 f"{_build.launches['flash_attention']} "
                                 "times")
        stale, _ = embedding.lookup(table, st, ids)
        hot_mask = torch.from_numpy(want_hot).to(self.dev)
        if torch.equal(stale[hot_mask], table[ids.long()][hot_mask]):
            raise AssertionError(f"{phase}: the stale replica still equals "
                                 "the updated table")
        st = embedding.refresh_after_update(table, st)
        check(st, "after the refresh")
        emit({"phase": phase, "arch": ARCH, "table": list(table.shape),
              "dtype": str(table.dtype), "tokens_counted": int(counts.sum()),
              "hot_rows": int(len(hot)), "k_sigma": HOT_K_SIGMA,
              "max_rows": HOT_MAX_ROWS, "lookups": int(ids.numel()),
              "hot_share_of_lookups": hot_share,
              "lookup_ms": lookup_ms, "gather_ms": gather_ms,
              "loss_after_step": float(m["loss"]),
              "launches": {"flash_attention":
                           _build.launches["flash_attention"]},
              "phase_s": time.perf_counter() - t_phase})
        del self.loop, params, opt_state, table, st

    # ------------------------------------------- 21. the launch side
    @staticmethod
    def _long_cells() -> dict:
        return {"prefill": ShapeConfig("prefill_32k_cut", LONG_PREFILL_S,
                                       LONG_PREFILL_B, "prefill"),
                "train": ShapeConfig("train_4k_cut", LONG_TRAIN_S,
                                     LONG_TRAIN_B, "train")}

    def dryrun(self) -> None:
        """launch.dryrun.run_cell on meta tensors, on the card's host:
        long_context's two cut cells on the (1, 1) mesh (their
        predictions), in this process (two spawned workers took 10-15 s
        to start beside 5-7 s of cells). Both must be OK."""
        t0 = time.perf_counter()
        host = train_mod.make_host_mesh("meta")
        cut = self._long_cells()
        jobs = [(ARCH, "prefill_32k", {"shape": cut["prefill"],
                                       "mesh": host}),
                (ARCH, "train_4k", {"shape": cut["train"], "mesh": host})]
        procs = 1
        recs = dryrun_mod.run_cells(jobs, procs)
        bad = [(r["arch"], r["shape"], r.get("error")) for r in recs
               if r["status"] != "OK"]
        if bad:
            raise AssertionError(f"dryrun: cells failed: {bad}")
        for rec in recs:
            mem = rec["memory"]
            emit({"dryrun_cell": f"{rec['arch']} x {rec['shape']}",
                  "mesh": rec["mesh"], "status": rec["status"],
                  "step": rec["step"], "flops": rec["flops"],
                  "bytes": rec["bytes"],
                  "argument_bytes_per_device": mem["argument_bytes"],
                  "temp_bytes": mem["temp_bytes"], "run_s": rec["compile_s"]})
        self.predicted = {"prefill": recs[0], "train": recs[1]}
        emit({"phase": "dryrun", "cells": len(jobs), "cut": DRYRUN_CUT,
              "processes": procs, "host": self.card,
              "seconds": time.perf_counter() - t0})

    def _peak_against_prediction(self, kind: str, base: int) -> dict:
        """The peak device memory since the last reset, beyond ``base``
        bytes allocated before the cell's state, beside the dry run's
        prediction for the cut cell (arguments and temp bytes on one
        device)."""
        mem = self.predicted[kind]["memory"]
        want = mem["argument_bytes"] + mem["temp_bytes"]
        got = torch.cuda.max_memory_allocated() - base
        return {"peak_device_gib": got / 2**30,
                "predicted_peak_gib": want / 2**30,
                "peak_over_predicted": got / want,
                "predicted_arguments_gib": mem["argument_bytes"] / 2**30,
                "predicted_temp_gib": mem["temp_bytes"] / 2**30}

    def long_context(self) -> list[dict]:
        """qwen1.5-0.5b at its published widths through the launch layer's
        bundles on the card's (1, 1) mesh: build_prefill_step at
        LONG_PREFILL_B x LONG_PREFILL_S (24 kernel-5 launches a call,
        causal over 32,768 keys; layer 0's launch held to blocked_mha),
        then build_train_step at LONG_TRAIN_B x LONG_TRAIN_S (48 kernel-5
        launches a step, every launch of the first held to blocked_mha as
        it returns, LONG_TRAIN_STEPS timed). Peak memory against the dry
        run's prediction; the train step's FLOPs (op_analysis on meta)
        over its time. Returns kernel 5's rows at both views."""
        t_phase = time.perf_counter()
        cfg, cut = get_config(ARCH), self._long_cells()
        rules = make_rules(train_mod.make_host_mesh())
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        base = torch.cuda.memory_allocated()
        params = build_model(cfg).init(SEED)
        pre = steps.build_prefill_step(cfg, cut["prefill"], rules)
        batch = {"tokens": torch.randint(
            0, cfg.vocab_size, (LONG_PREFILL_B, LONG_PREFILL_S),
            generator=gen, device=self.dev)}
        with torch.no_grad():
            synced(pre.fn, params, batch)     # warm-up: cuBLAS, caches
            torch.cuda.reset_peak_memory_stats()
            # set every count to 0 just before the main path
            _build.reset_counts()
            secs = []
            for _ in range(LONG_PREFILL_REPS):
                (logits, kv), sec = synced(pre.fn, params, batch)
                secs.append(sec)
            launches = _build.launches["flash_attention"]
            if launches != cfg.num_layers * LONG_PREFILL_REPS:
                raise AssertionError(f"long_prefill: {launches} kernel-5 "
                                     "launches, not one a layer")
            kv_shape = (cfg.num_layers, LONG_PREFILL_B, LONG_PREFILL_S,
                        cfg.num_kv_heads, cfg.hd)
            if tuple(logits.shape) != (LONG_PREFILL_B, cfg.vocab_size) or \
                    tuple(kv["k"].shape) != kv_shape or not bool(
                        torch.isfinite(logits).all()
                        & torch.isfinite(kv["k"]).all()
                        & torch.isfinite(kv["v"]).all()):
                raise AssertionError("long_prefill: logits or KV of the "
                                     "wrong shape or not finite")
            self.tally("long_prefill", dict(_build.launches))
            pre_peak = self._peak_against_prediction("prefill", base)
            del logits, kv
            with uncounted(), recorded(layers, "attention") as calls:
                pre.fn(params, batch)
            qkv, out = calls[0]
            del calls
            err = attn_path_err([("long_prefill.flash_attention.layer0",
                                  out, attn_plain(qkv, True))], qkv, True)
        sec = sorted(secs)[len(secs) // 2]
        emit({"phase": "long_prefill", "arch": ARCH, "card": self.card,
              "batch": LONG_PREFILL_B, "seq": LONG_PREFILL_S,
              "cut": LONG_CUT, "seconds": secs,
              "tokens_per_s": LONG_PREFILL_B * LONG_PREFILL_S / sec,
              "flash_attention_launches": launches,
              "flash_attention_vs_plain": err,
              "flops_dry_run": self.predicted["prefill"]["flops"],
              **pre_peak})
        rows = [self._flash_row(qkv, True, "flash_attention_32k",
                                f"{ARCH} long prefill, layer 0")]
        rows[0]["card"] = self.card
        del qkv, out, batch, pre
        torch.cuda.empty_cache()

        # training at TRAIN_4K's length
        opt = optim.AdamWConfig(warmup_steps=1)
        opt_state = optim.init_state(params)
        tr = steps.build_train_step(cfg, cut["train"], rules, opt)
        batch = make_batch(cfg, LONG_TRAIN_B, LONG_TRAIN_S, gen=gen)
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        metrics, secs = [], []

        def step():
            nonlocal params, opt_state
            (params, opt_state, m), sec = synced(tr.fn, params, opt_state,
                                                 batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if not self._finite(params, m["loss"]):
                raise AssertionError(f"long_train: step {len(metrics)}: "
                                     "the loss or a parameter is not finite")
            return sec

        with self.held_step("long_train") as held:
            first_s = step()
        per_step = 2 * cfg.num_layers
        if _build.launches["flash_attention"] != per_step or \
                held["flash_attention_held"] != per_step:
            raise AssertionError(f"long_train: the first step launched "
                                 f"{_build.launches['flash_attention']} and "
                                 f"held {held}, not {per_step}")
        for _ in range(LONG_TRAIN_STEPS):
            secs.append(step())
        if _build.launches["flash_attention"] != per_step * len(metrics):
            raise AssertionError("long_train: not 48 kernel-5 launches a "
                                 "step")
        if not metrics[-1]["loss"] < metrics[0]["loss"]:
            raise AssertionError(f"long_train: the loss did not fall: "
                                 f"{[m['loss'] for m in metrics]}")
        self.tally("long_train", dict(_build.launches))
        train_peak = self._peak_against_prediction("train", base)
        sec = sorted(secs)[len(secs) // 2]
        flops = self.predicted["train"]["flops"]
        emit({"phase": "long_train", "arch": ARCH, "card": self.card,
              "batch": LONG_TRAIN_B, "seq": LONG_TRAIN_S, "cut": LONG_CUT,
              "steps": len(metrics), "first_step_s": first_s,
              "seconds": secs,
              "tokens_per_s": LONG_TRAIN_B * LONG_TRAIN_S / sec,
              "loss": [m["loss"] for m in metrics],
              "launches_per_step": per_step, **held,
              "flops_op_analysis": flops,
              "achieved_tflop_s": flops / sec / 1e12,
              "share_of_bf16_peak": flops / sec / BF16_FLOPS, **train_peak,
              "phase_s": time.perf_counter() - t_phase})
        # kernel 5 at the train step's views: layer 0 of one forward
        with torch.no_grad(), uncounted(), \
                recorded(layers, "attention") as calls:
            build_model(cfg).loss(params, batch)
        qkv = calls[0][0]
        del calls, params, opt_state, batch
        rows.append(self._flash_row(qkv, True, "flash_attention_4k_train",
                                    f"{ARCH} long train step, layer 0"))
        rows[1]["card"] = self.card
        del qkv
        torch.cuda.empty_cache()
        return rows

    # ----------------------------------------- 22. the multi-device paths
    def multi_rank(self) -> None:
        """The mesh-of-ranks paths on the card: NCCL at world size 1
        through a file:// store in a temporary directory, the (1, 1) mesh
        of ranks on cuda:0, then the collectives through NCCL
        (_nccl_collectives), the expert-parallel MoE (_multi_rank_moe)
        and the partitioned train step (_multi_rank_step). The group is
        destroyed at the phase's end, whatever happens."""
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            dev = mesh_mod.init_ranks(1, 0, f"file://{tmp}/store",
                                      device="cuda:0", timeout=120)
            try:
                mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
                if mesh.device != dev or dist.get_backend() != "nccl":
                    raise AssertionError(f"multi_rank: the mesh is on "
                                         f"{mesh.device} over "
                                         f"{dist.get_backend()}")
                nccl = self._nccl_collectives(dev)
                moe_out = self._multi_rank_moe(mesh)
                step_out = self._multi_rank_step(mesh, ARCH,
                                                 "multi_rank_step")
                t_paths = time.perf_counter()
                zamba_out = self._multi_rank_step(mesh, ZAMBA,
                                                  "multi_rank_zamba2_step")
                paths = self._multi_rank_paths(mesh)
                paths_s = time.perf_counter() - t_paths
            finally:
                dist.destroy_process_group()
        emit({"phase": "multi_rank", "card": self.card,
              "nccl": str(torch.cuda.nccl.version()),
              "world_size": 1, "mesh": [1, 1], "collectives": nccl,
              "moe": moe_out, "step": step_out, "zamba2_step": zamba_out,
              **paths, "paths_s": paths_s,
              "seconds": time.perf_counter() - t_phase})

    @staticmethod
    def _nccl_collectives(dev) -> dict:
        """Each collective kind the port issues, through the collectives
        module's own calls on the world's group (which skip a group of one
        rank), on a bf16 CUDA tensor: at one rank each gives back its
        input. Their calls and bytes, and the seconds."""
        t0 = time.perf_counter()
        collectives.reset_counts()
        x = torch.randn((1024, 64), device=dev).to(torch.bfloat16)
        outs = {"all_gather": collectives._gather(x, 0, None, 1),
                "reduce_scatter": collectives._scatter_sum(x, 0, None, 1),
                "all_to_all": collectives._exchange(x, 0, 1, None, 1),
                "all_reduce": collectives._sum(x, None)}
        torch.cuda.synchronize()
        bad = [k for k, y in outs.items() if not torch.equal(y, x)]
        if bad or any(collectives.calls[k] != 1 for k in outs):
            raise AssertionError(f"multi_rank: NCCL collectives {bad} did "
                                 f"not give back their input "
                                 f"({collectives.calls})")
        out = {"calls": dict(collectives.calls),
               "bytes": dict(collectives.nbytes),
               "seconds": time.perf_counter() - t0}
        collectives.reset_counts()
        return out

    def _multi_rank_moe(self, mesh) -> dict:
        """moe_ff_sharded on one olmoe-1b-7b MoE layer at its published
        widths (random weights from SEED) over MULTI_B x MULTI_S bf16
        tokens, against moe_ff on the same inputs, and moe_ff against
        itself (index_add_'s unfixed order, the floor under the bar)."""
        t0 = time.perf_counter()
        cfg = get_config(OLMOE)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        p = moe.moe_init(gen, cfg)
        x = torch.randn((MULTI_B, MULTI_S, cfg.d_model), generator=gen,
                        device=self.dev).to(torch.bfloat16)
        with torch.no_grad():
            # first: the warm-up of the shared ops, and the floor's other side
            y_again, _ = moe.moe_ff(p, x, cfg)
            collectives.reset_counts()
            (y_sh, aux_sh), sec_sh = synced(
                moe.moe_ff_sharded, p, x, cfg, mesh, ("data",), "model",
                cfg.moe_capacity_factor)
            calls = dict(collectives.calls)
            (y, aux), sec = synced(moe.moe_ff, p, x, cfg)
        scale = float(y.float().abs().max())
        gap = float((y_sh.float() - y.float()).abs().max()) / scale
        floor = float((y_again.float() - y.float()).abs().max()) / scale
        t = MULTI_B * MULTI_S
        k, e = cfg.experts_per_token, cfg.num_experts
        capacity = max(int(t * k / e * cfg.moe_capacity_factor), 1)
        counts = torch.round(aux_sh["expert_load"] * t * k).long()
        drops = int(torch.clamp(counts - capacity, min=0).sum())
        out = {"arch": OLMOE, "tokens": [MULTI_B, MULTI_S],
               "experts": e, "top_k": k, "capacity": capacity,
               "dropped": drops, "dropped_share": drops / (t * k),
               "bit_equal": bool(torch.equal(y_sh, y)),
               "max_diff_over_max_y": gap, "moe_ff_vs_itself": floor,
               "bar": MOE_PATH_BAR,
               "aux_equal": all(torch.equal(aux_sh[a], aux[a])
                                for a in aux),
               "collective_calls": calls, "sharded_s": sec_sh,
               "moe_ff_s": sec, "seconds": time.perf_counter() - t0}
        if gap > MOE_PATH_BAR or tuple(y_sh.shape) != tuple(x.shape) or \
                not bool(torch.isfinite(y_sh).all()):
            emit({"phase": "multi_rank_moe", **out})
            raise AssertionError(f"multi_rank: moe_ff_sharded parts from "
                                 f"moe_ff by {gap} of max |y|")
        del p, x, y, y_sh, y_again
        torch.cuda.empty_cache()
        return out

    def _multi_rank_step(self, mesh, arch: str, phase: str) -> dict:
        """``arch`` at its published widths (qwen1.5-0.5b, or zamba2-1.2b:
        its mamba layers through the SSD carry's path, its shared block's
        rotary positions the rank's): MULTI_STEPS steps of the
        mesh-of-ranks build_train_step (the state placed by its
        in_shardings) and as many of train_step alone from the same
        parameters and batch (uncounted). Step 1 held (held_step): every
        kernel-5 and kernel-7 launch; its loss and grad_norm within
        STEP1_TOL relative, step 2's loss within STEP2_TOL."""
        t0 = time.perf_counter()
        cfg = get_config(arch)
        _, groups, _ = zamba2._group_shape(cfg)
        per_step = ({"flash_attention": 2 * cfg.num_layers}
                    if cfg.family == "dense" else
                    {"flash_attention": groups,
                     "ssd_scan": 2 * cfg.num_layers})
        opt = optim.AdamWConfig(warmup_steps=1)
        params = build_model(cfg).init(SEED, device=mesh.device)
        batch = make_batch(cfg, MULTI_B, MULTI_S, gen=torch.Generator(
            device=self.dev).manual_seed(SEED))
        bundle = steps.build_train_step(
            cfg, ShapeConfig("multi_rank", MULTI_S, MULTI_B, "train"),
            make_rules(mesh), opt)
        p_sh, o_sh, b_sh = bundle.in_shardings
        p_local = sharding.place(params, p_sh)
        o_local = sharding.place(optim.init_state(params), o_sh)
        b_local = sharding.place(batch, b_sh)
        # set every count to 0 just before the main path
        _build.reset_counts()
        collectives.reset_counts()
        got, secs = [], []
        with self.held_step(phase) as held:
            (p_local, o_local, m), sec = synced(bundle.fn, p_local, o_local,
                                                b_local)
        got.append({k: float(v) for k, v in m.items()})
        secs.append(sec)
        for _ in range(MULTI_STEPS - 1):
            (p_local, o_local, m), sec = synced(bundle.fn, p_local, o_local,
                                                b_local)
            got.append({k: float(v) for k, v in m.items()})
            secs.append(sec)
        launches = {k: _build.launches[k] for k in per_step}
        calls = dict(collectives.calls)
        self.tally(phase, dict(_build.launches))
        finite = self._finite(p_local, m["loss"])
        del p_local, o_local, b_local
        want = []
        o_state = optim.init_state(params)
        with uncounted():
            for _ in range(MULTI_STEPS):
                params, o_state, m = steps.train_step(params, o_state, batch,
                                                      cfg, opt)
                want.append({k: float(v) for k, v in m.items()})
        del params, o_state, batch
        torch.cuda.empty_cache()
        rel = {k: abs(got[0][k] - want[0][k]) / abs(want[0][k])
               for k in ("loss", "grad_norm")}
        out = {"arch": arch, "tokens": [MULTI_B, MULTI_S],
               "steps": MULTI_STEPS, "loss": [g["loss"] for g in got],
               "grad_norm": [g["grad_norm"] for g in got],
               "train_step_loss": [w["loss"] for w in want],
               "train_step_grad_norm": [w["grad_norm"] for w in want],
               "step1_rel_diff": rel,
               "step2_loss_diff": abs(got[1]["loss"] - want[1]["loss"]),
               "tolerances": [STEP1_TOL, STEP2_TOL],
               "launches": launches, "launches_per_step": per_step, **held,
               "collective_calls": calls, "step_s": secs,
               "seconds": time.perf_counter() - t0}
        if max(rel.values()) > STEP1_TOL or \
                out["step2_loss_diff"] > STEP2_TOL or not finite or \
                launches != {k: v * MULTI_STEPS for k, v in
                             per_step.items()} or \
                held["flash_attention_held"] != per_step["flash_attention"] \
                or held["ssd_scan_held"] != per_step.get("ssd_scan", 0):
            emit({"phase": phase, **out})
            raise AssertionError(f"multi_rank: the partitioned step parts "
                                 f"from train_step or its launches: {out}")
        return out

    def _multi_rank_paths(self, mesh) -> dict:
        """The prefill and decode bundles on the (1, 1) mesh of ranks for
        qwen1.5-0.5b and mamba2-2.7b at their published widths, each equal
        to prefill_step and serve_step (_bundles_on_ranks); between them,
        with mamba2's weights, the SSD carry on one card (_carry_on_card)
        and, with qwen's prefilled cache, the ownership merge
        (_owners_on_card)."""
        return {"qwen_bundles": self._bundles_on_ranks(mesh, ARCH),
                "mamba2_bundles": self._bundles_on_ranks(mesh, SSM_ARCH)}

    def _bundles_on_ranks(self, mesh, arch: str) -> dict:
        """build_prefill_step on MULTI_B x MULTI_S tokens (the parameters
        and tokens placed by its in_shardings; every kernel launch held,
        held_step), then MULTI_DECODE greedy steps of build_decode_step
        (qwen: v1 and v3 over a cache of MULTI_S + MULTI_DECODE slots that
        holds the prefill's KV; mamba2: from a zero state), each call equal
        to the one-card step's on the same inputs (uncounted)."""
        t0 = time.perf_counter()
        cfg = get_config(arch)
        rules = make_rules(mesh)
        params = build_model(cfg).init(SEED, device=mesh.device)
        tokens = torch.randint(0, cfg.vocab_size, (MULTI_B, MULTI_S),
                               generator=torch.Generator(
                                   device=self.dev).manual_seed(SEED),
                               device=self.dev)
        pre = steps.build_prefill_step(
            cfg, ShapeConfig("multi_rank", MULTI_S, MULTI_B, "prefill"),
            rules)
        p_sh, b_sh = pre.in_shardings
        p_local = sharding.place(params, p_sh)
        b_local = sharding.place({"tokens": tokens}, b_sh)
        phase = f"multi_rank_prefill_{cfg.family}"
        # set every count to 0 just before the main path
        _build.reset_counts()
        collectives.reset_counts()
        with self.held_step(phase) as held:
            out, prefill_s = synced(pre.fn, p_local, b_local)
        launches = {k: c for k, c in _build.launches.items() if c}
        self.tally(phase, dict(_build.launches))
        calls = dict(collectives.calls)
        logits, kv = out if isinstance(out, tuple) else (out, None)
        with uncounted(), torch.no_grad():
            want = steps.prefill_step(params, tokens, cfg)
        want_logits, want_kv = want if kv is not None else (want, None)
        prefill_equal = torch.equal(logits, want_logits) and (
            kv is None or all(torch.equal(kv[k], want_kv[k]) for k in kv))
        del want, want_kv
        res = {"arch": arch, "tokens": [MULTI_B, MULTI_S],
               "prefill_s": prefill_s, "prefill_launches": launches,
               **held, "prefill_collective_calls": calls,
               "prefill_equal": prefill_equal}
        per_call = ({"flash_attention": cfg.num_layers}
                    if cfg.family == "dense" else
                    {"ssd_scan": cfg.num_layers})
        if cfg.family == "ssm":
            res["carry"] = self._carry_on_card(params, tokens, cfg)
        slots = MULTI_S + MULTI_DECODE
        decodes = {}
        for impl in ((False, "v3") if cfg.family == "dense" else (False,)):
            dec = steps.build_decode_step(
                cfg, ShapeConfig("multi_rank", slots, MULTI_B, "decode"),
                rules, impl)
            _, c_sh, t_sh, _ = dec.in_shardings
            cache = steps.init_cache(cfg, MULTI_B, slots, impl,
                                     device=mesh.device)
            if kv is not None:
                for k in ("k", "v"):
                    dst = cache[k][:, :, :MULTI_S] if not impl else \
                        cache[k][:, :, :, :MULTI_S]
                    dst.copy_(kv[k] if not impl else kv[k].transpose(2, 3))
            ref_cache = optim.adamw.tree_map(torch.clone, cache)
            c_local = sharding.place(cache, c_sh)
            del cache
            tok = logits.argmax(-1)
            equal, secs = True, []
            for t in range(MULTI_DECODE):
                (lg, c_local), sec = synced(dec.fn, p_local, c_local,
                                            t_sh.local(tok), MULTI_S + t)
                secs.append(sec)
                with uncounted(), torch.no_grad():
                    lg_ref, ref_cache = steps.serve_step(
                        params, ref_cache, tok, MULTI_S + t, cfg, impl)
                equal = equal and torch.equal(lg, lg_ref)
                tok = lg.argmax(-1)
            equal = equal and all(
                torch.equal(a, b) for a, b in
                zip(sharding.tree_leaves(c_local),
                    sharding.tree_leaves(ref_cache)))
            decodes[impl or "v1"] = {"equal": equal, "step_s": secs}
            if impl == "v3":
                res["owners"] = self._owners_on_card(params, ref_cache,
                                                     logits.argmax(-1), cfg)
            del c_local, ref_cache
        res["decode"] = decodes
        res["seconds"] = time.perf_counter() - t0
        del params, p_local, logits, kv
        torch.cuda.empty_cache()
        bad = (not prefill_equal or launches != per_call
               or any(not d["equal"] for d in decodes.values())
               or held["flash_attention_held"]
               != per_call.get("flash_attention", 0)
               or held["ssd_scan_held"] != per_call.get("ssd_scan", 0))
        if bad:
            emit({"phase": phase, **res})
            raise AssertionError(f"multi_rank: the bundles on the mesh of "
                                 f"ranks part from the one-card steps: {res}")
        return res

    def _carry_on_card(self, params, tokens, cfg) -> dict:
        """mamba2's layer-0 SSD inputs at the prefill's shape, cut into
        MULTI_PIECES pieces along the sequence: each piece through kernel 7
        from a zero state, then ``carry`` with every piece's
        ``piece_state`` (the functions each rank of a model axis calls),
        against kernel 7 over the whole sequence at kernel 7's bar
        (ssd_path_err); the pieces without the carry must fail it. Every
        launch held to ssd_chunked. Uncounted."""
        t0 = time.perf_counter()
        lp = params["layers"][0]
        with uncounted(), torch.no_grad():
            x = params["embed"][tokens.long()]
            with recorded(mamba2, "ssd") as calls:
                mamba2.mamba_block(lp["mamba"],
                                   layers.rmsnorm(lp["ln"], x, cfg.norm_eps),
                                   cfg)
            args = [t.contiguous() for t in calls[0][0]]
            del calls, x
            xs, dt, a, b, c, d = args
            size = MULTI_S // MULTI_PIECES
            held = []

            def scan(*part):
                n0 = _build.launches["ssd_scan"]
                y = ssd_k.ssd(*part, chunk=SSM_CHUNK)
                if _build.launches["ssd_scan"] != n0 + 1:
                    raise AssertionError("carry: a piece launched no kernel")
                held.append(ssd_path_err([(f"carry.piece{len(held)}", y,
                                           ssd_k.ssd_chunked(*part,
                                                             SSM_CHUNK))]))
                return y

            whole = scan(*args)
            cut = [slice(i * size, (i + 1) * size)
                   for i in range(MULTI_PIECES)]
            pieces = [[t[:, sl].contiguous() if t.dim() > 1 else t
                       for t in args] for sl in cut]
            ys = [scan(*p) for p in pieces]
            made = [ssd_k.piece_state(p[0], p[1], p[2], p[3])
                    for p in pieces]
            states = torch.stack([st for st, _ in made])
            decays = torch.stack([dc for _, dc in made])
            got = torch.cat([ssd_k.carry(y, p[1], a, p[4], states, decays, i)
                             for i, (y, p) in enumerate(zip(ys, pieces))],
                            dim=1)
            err = ssd_path_err([("carry", got, whole)])
            try:
                ssd_path_err([("lost_carry", torch.cat(ys, dim=1), whole)])
                lost_rejected = False
            except AssertionError:
                lost_rejected = True
            lost_gap = float((torch.cat(ys, dim=1).float() - whole.float())
                             .abs().max())
        if not lost_rejected:
            raise AssertionError("carry: the bar does not reject the pieces "
                                 "without their carried state")
        return {"shape": list(xs.shape), "state": int(b.shape[-1]),
                "pieces": MULTI_PIECES, "max_abs_err": err,
                "max_abs_y": float(whole.float().abs().max()),
                "bar": [SSD_PATH_RTOL, SSD_PATH_ATOL_OF_MAX],
                "lost_carry_gap": lost_gap, "lost_carry_rejected": True,
                "launches_held": len(held), "held_max_err": max(held),
                "seconds": time.perf_counter() - t0}

    def _owners_on_card(self, params, cache, tok, cfg) -> dict:
        """One v3 decode step of qwen at position MULTI_S over its
        prefilled KH-major cache, with the cache's MULTI_S + MULTI_DECODE
        slots cut into MULTI_PIECES owners: each owner's partial
        (layers.owner_partial) merged by layers.merge_owners, the functions
        the ranks of a model axis call on their blocks, against the step
        over the whole cache, within OWNERS_TOL of max |logit|.
        Uncounted."""
        t0 = time.perf_counter()
        slots = cache["k"].shape[3]
        size = slots // MULTI_PIECES

        def owners(q, k, v, length, layout, name="k", own=None):
            return layers.merge_owners(
                [layers.owner_partial(q, k[:, :, i * size:(i + 1) * size],
                                      v[:, :, i * size:(i + 1) * size],
                                      length, i * size)
                 for i in range(MULTI_PIECES)], q, own)

        with uncounted(), torch.no_grad():
            whole, _ = steps.serve_step(
                params, optim.adamw.tree_map(torch.clone, cache), tok,
                MULTI_S, cfg, "v3")
            with mock.patch.object(transformer, "cache_attend", owners):
                owned, _ = steps.serve_step(
                    params, optim.adamw.tree_map(torch.clone, cache), tok,
                    MULTI_S, cfg, "v3")
        gap = float((owned - whole).abs().max()) / \
            float(whole.abs().max())
        out = {"owners": MULTI_PIECES, "slots_per_owner": size,
               "pos": MULTI_S, "max_diff_over_max_logit": gap,
               "bar": OWNERS_TOL, "top1_equal": bool(torch.equal(
                   owned.argmax(-1), whole.argmax(-1))),
               "seconds": time.perf_counter() - t0}
        if gap > OWNERS_TOL or not bool(torch.isfinite(owned).all()):
            emit({"phase": "multi_rank_owners", **out})
            raise AssertionError(f"multi_rank: the owners' merge parts from "
                                 f"the whole-cache step by {gap}")
        return out

    def _ssd_row(self, args, label: str):
        """The kernels line's row for kernel 7 on a prefill call's
        (x, dt, a, b, c, d), x, b and c strided views of the conv's output,
        against the plain chunked scan at the main path's bar; and the
        FLOP the function needs."""
        x, dt, a, b, c, d = args
        bsz, s, h, p = x.shape
        grp, n = b.shape[2], b.shape[3]
        lc = SSM_CHUNK
        nc = s // lc
        flops = (bsz * h * nc * (lc * (lc + 1) * p + 4 * lc * n * p)
                 + bsz * grp * nc * lc * (lc + 1) * n)
        nbytes = 2 * x.numel() * x.element_size() \
            + (b.numel() + c.numel()) * b.element_size() \
            + dt.numel() * 4 + (a.numel() + d.numel()) * 4
        row = self._timed(
            "ssd_scan", "ssd_scan.cu",
            "src/repro/kernels/ssd_scan/ssd_scan.py:70", ("y",),
            lambda: (ssd_k.ssd(x, dt, a, b, c, d, chunk=lc),),
            lambda: (ssd_k.ssd_chunked(x, dt, a, b, c, d, lc),),
            None, nbytes, REPS, plain_reps=3, flops=flops, peak=BF16_FLOPS,
            extra={"shape": [bsz, s, h, p], "state": n, "groups": grp,
                   "chunk": lc, "gflop": flops / 1e9, "bytes": nbytes,
                   "f32_cuda_core_bound_ms": flops / F32_FLOPS * 1e3},
            compare=ssd_path_err, label=label)
        return row, flops

    @staticmethod
    def _decode_bytes(q, pages, table, tokens: int) -> int:
        """Kernel 6's bytes: each valid token's K and V row, q, the page
        table and positions, the lengths, and the partials written."""
        b, h, d = q.shape
        q_rows = 1 if q.stride(0) == 0 else b    # stacked owners share q
        return (2 * tokens * pages.shape[2] * d * pages.element_size()
                + q_rows * h * d * q.element_size() + 2 * table.numel() * 4
                + b * 4 + b * h * (d + 2) * 4)

    def _timed(self, name, source, replaces, outs, fn, plain, library,
               nbytes, reps, setup=None, plain_reps=None, extra=None,
               compare=max_abs_err, flops=0, peak=1.0, label=None):
        """One row of the kernels line: device ms of the kernel, its
        plain version and the library call, the kernel held against the
        plain version, and the bound: the larger of ``nbytes`` at the
        memory rate and ``flops`` at ``peak``."""
        ms, got = event_ms(fn, reps, setup)
        plain_ms, ref = event_ms(plain, plain_reps or max(1, reps // 4),
                                 setup)
        err = compare([(f"{name}.{o}", a, b)
                       for o, a, b in zip(outs, got, ref, strict=True)])
        del got, ref
        lib_ms = None
        if library:
            library()        # warm-up: library calls pick and plan kernels
            lib_ms = event_ms(library, reps)[0]
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / peak * 1e3
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/csrc/{source}",
               "replaces": replaces, "launches": None,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "library_ms": lib_ms}
        emit({"timing": label or name, "ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "bound_ms": row["bound_ms"],
              "max_abs_err": err, **(extra or {})})
        return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smoke = Smoke()
    smoke.environment()
    smoke.static_analysis()
    smoke.build_kernels()
    smoke.check_kernels()
    smoke.check_attention()
    st = smoke.serve()
    kernels = smoke.time_kernels(st)
    smoke.profile(st)
    smoke.kn_window(st)
    kernels += smoke.time_transition()
    del st
    torch.cuda.empty_cache()
    smoke.dpm_pool()
    torch.cuda.empty_cache()
    smoke.cluster()
    smoke.cluster_variants()
    kernels += smoke.time_fused_window()
    del smoke.window_case, smoke.held_jobs
    torch.cuda.empty_cache()
    smoke.timed()
    torch.cuda.empty_cache()
    smoke.scenarios()
    torch.cuda.empty_cache()
    smoke.prefill()
    srv = smoke.serve_paged()
    kernels += smoke.time_attention()
    smoke.profile_decode(srv)
    smoke.equivalence(srv)
    del srv, smoke.prefill_qkv, smoke.decode_args
    torch.cuda.empty_cache()
    kernels.append(smoke.prefill_llama())
    smoke.dense_decode_llama()
    del smoke.llama_params
    torch.cuda.empty_cache()
    kernels.append(smoke.serve_llama())
    smoke.moe_olmoe()
    smoke.widths_d128()
    smoke.check_ssd()
    smoke.ssm_prefill()
    smoke.ssm_decode()
    kernels += smoke.time_ssd()
    del smoke.ssm_params, smoke.ssd_args
    torch.cuda.empty_cache()
    kernels += smoke.hybrid_zamba2()
    kernels += smoke.encdec_seamless()
    smoke.train_qwen()
    torch.cuda.empty_cache()
    smoke.train_zamba2()
    torch.cuda.empty_cache()
    smoke.train_loop()
    smoke.hot_rows()
    smoke.dryrun()
    kernels += smoke.long_context()
    smoke.multi_rank()
    emit({"total_s": time.perf_counter() - t_start})
    # launches on the main path, summed over every phase that ran it
    emit({"launches_by_phase": smoke.phase_counts})
    for row in kernels:
        row["launches"] = smoke.counts[row["name"]]
    missing = [k for k in _build.KERNELS if not smoke.counts[k]]
    if missing or {row["name"] for row in kernels} != set(_build.KERNELS):
        raise AssertionError(f"kernels never launched on the main path or "
                             f"missing from the kernels line: {missing}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
