#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA H100: the DPM data plane,
one KN's planned DAC windows over it, the DPM pool with its planned merge,
the paged LLM serving path and the SSM family's prefill and recurrent
decode.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels (src/repro_torch/csrc/*.cu, nvcc for
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
             dataset) warmed full, then YCSB write_heavy_update and
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

Then it runs qwen1.5-0.5b at its published widths (24 layers, d_model 1024, 16
heads, vocab 151,936; random bf16 weights from a seeded generator):

  prefill      build_model(CONFIG).prefill of 4 prompts x 2048 tokens
               (flash_attention, 24 launches a call)
  serve        PagedServer(cfg=CONFIG): 8 requests of 256-token prompts
               sharing a 128-token prefix, a worker added after the
               fourth (logits unchanged), 64 greedy decode steps each
               (paged_decode_attention, one launch a layer over the
               page owners' stacked tables)
  equivalence  the server's logits for a 256-token prompt (token by token
               through paged_decode_attention) against prefill's
               (flash_attention)

and times both attention kernels at the main path's shapes. Last,
mamba2-2.7b at its published widths (64 layers, d_model 2560, 80 SSD
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
               against forward's logits, then 64 greedy steps for a
               batch of 4, and a profile of one step
  time_ssd     ssd_scan at prefill's layer-0 inputs

Every failure raises. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernels, each
with its launches summed over every phase that ran it.
Without a card, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import clht, log  # noqa: E402
from repro_torch.core.cluster import (KVSNode, _WritePlan,  # noqa: E402
                                      apply_window_plan, warm_load)
from repro_torch.core.dac import (SHORTCUT_BYTES,  # noqa: E402
                                  VALUE_OVERHEAD_BYTES)
from repro_torch.core.dpm_pool import DPMPool  # noqa: E402
from repro_torch.core.transition import (MERGE_PLAN_STATS,  # noqa: E402
                                         PLAN_STATS, plan_dac_window,
                                         reset_merge_plan_stats,
                                         reset_plan_stats)
from repro_torch.data import Workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_transition as transition  # noqa: E402
from repro_torch.kernels import clht_probe as probe  # noqa: E402
from repro_torch.kernels.clht_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import log_merge as merge  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.kvcache import paged_store  # noqa: E402
from repro_torch.kvcache.paged_store import decode_over_owners  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import PagedServer  # noqa: E402
from repro_torch.models import mamba2, ssm_lm, transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from torch_cases import (MERGE_CASES, TRANSITION_CASES,  # noqa: E402
                         merge_case, transition_case)

KEYS_LOG2 = 25              # the paper's 32 GB of 1 KB values
WIDTH = 256                 # int32 lanes per value row = 1 KB
ZIPF = 0.99
BATCH = 1 << 20             # keys or ops per load / served batch
BATCHES = 8                 # served batches per mix
REPS = 20                   # timed runs per kernel
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12           # H100 SXM f32 rate outside the tensor cores
SPIN_CYCLES = 2_000_000     # about 1 ms of device spin before a timed call

DPM_KERNELS = ("clht_probe", "kvs_lookup_fused", "log_merge_sorted",
               "clht_insert")
# one KN's planned DAC windows over the DPM pool: the paper's 1 GB KN cache
# against its 32 GB dataset (benchmarks/bench_dataplane.py:65-67)
KN_CACHE = 1 << 30
KN_MIXES = ("write_heavy_update", "read_mostly_update")
KN_OPS = 1 << 16            # ops per mix
KN_BATCH = 1 << 13          # ops whose reads are probed and writes merged
KN_WINDOW = 512             # ops per planning chunk, as _run_window_at
KN_SEGCACHE = 4 * 2048      # segcache entries: 4 of the reference's segments
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
ARCH = "qwen1.5-0.5b"
PREFILL_B, PREFILL_S, PREFILL_REPS = 4, 2048, 3
SERVE_REQUESTS, PROMPT, SHARED, DECODE_STEPS = 8, 256, 128, 64
PAGE_SIZE, NUM_PAGES = 8, 4096
RECONFIG_AFTER = 4          # requests admitted before w2 joins
DECODE_B, DECODE_CTX = 64, 2048     # kernel 6 at a batched decode shape
SSM_ARCH = "mamba2-2.7b"
SSM_B, SSM_S, SSM_REPS = 4, 2048, 3     # prefill prompts x tokens, calls
SSM_CHUNK = 64
TF_PROMPT = 256                         # teacher-forced decode tokens
GREEDY_B, GREEDY_STEPS = 4, 64
# the two attention kernels' times in the design they replace (commit
# 6166d87: kernel 5 on mma.sync, kernel 6 one block per (row, kv head),
# one launch per page owner), measured by this script on the same seeded
# inputs on an NVIDIA H100 80GB HBM3 at 700 W; printed beside the new
# times
BEFORE = "commit 6166d87, NVIDIA H100 80GB HBM3, 700.00 W"
BEFORE_MS = {"flash_attention": 0.45325759798288345,
             "paged_decode_attention": 0.017422399949282408,
             "paged_decode_attention_64x2048": 0.4994655936956406}
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
# the same comparison for mamba2 in f32 (weights and activations), where
# the two paths differ only in the order of f32 sums (about 1e-5 of max
# |logit| on an H100): far below the bf16 floor, so a path that computed
# another function would show
F32_LOGIT_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    busy share of ``wall`` seconds."""
    kernels: dict[str, list] = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            k = kernels.setdefault(e.name[:60], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
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
def recorded(module, name: str, replace=None, clone=False):
    """Record the calls of ``module.name`` made inside the block, as a
    list of (positional args, output); ``replace`` maps a call's index to the
    output returned in place of the real one; ``clone`` keeps a copy of a
    tuple of tensors as it was returned (the caller may write into it)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, tuple(t.clone() for t in out) if clone else out))
        return (replace or {}).get(len(calls) - 1, out)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block (checks of the main path, not the
    main path) leave the launch counts as they were."""
    saved = dict(_build.launches)
    try:
        yield
    finally:
        _build.launches.update(saved)


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


class PoolView:
    """The slice-1 DPM pool as plan_dac_window reads it: one key's live
    index walk (``index_lookup`` -> (ptr or None, lines walked)) and the
    values' lengths (``heap_len``; every value is 1 KB)."""

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
        cap = torch.cuda.get_device_capability(0)
        emit({"device": torch.cuda.get_device_name(0), "capability": cap})
        if cap != (9, 0):
            raise RuntimeError(f"needs an sm_90 card, found {cap}")
        return smi

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
        kn = KVSNode("kn1", KN_CACHE, KN_SEGCACHE, initial_keys=n)
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
              "ops": len(KN_MIXES) * KN_OPS, "seconds": sec,
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
              "integrity_problems": 0, **MERGE_PLAN_STATS,
              "launches": {k: c for k, c in _build.launches.items() if c}})

    @staticmethod
    def _pool_probe_check(calls) -> int:
        """Each recorded kernel-A call of a batched read against
        clht_probe_ref on the same lines, bucket ids and keys, bit for
        bit, raw (ptrs, found) before the chain walk writes into them.
        Returns the calls checked."""
        for args, (ptrs, found) in calls:
            want_p, want_f = probe.clht_probe_ref(*args)
            if not (torch.equal(ptrs, want_p) and torch.equal(found, want_f)):
                raise AssertionError("dpm_pool: a kernel-A launch of a "
                                     "batched read disagrees with "
                                     "clht_probe_ref")
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
                (1, 2, 2, 256, 256, 16, True, torch.float32)]:
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
                (2, 4, 2, 16, 16, 8, 2, torch.bfloat16)]:
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
        cfg = get_config(ARCH)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                               generator=gen, device=self.dev)
        synced(model.prefill, params, tokens)     # warm-up: cuBLAS, caches
        torch.cuda.reset_peak_memory_stats()
        # set every count to 0 just before the main path
        _build.reset_counts()
        secs = []
        for _ in range(PREFILL_REPS):
            (logits, kv), sec = synced(model.prefill, params, tokens)
            secs.append(sec)
        launches = _build.launches["flash_attention"]
        if launches != cfg.num_layers * PREFILL_REPS:
            raise AssertionError(f"prefill launched flash_attention "
                                 f"{launches} times, not one per layer")
        kv_shape = (cfg.num_layers, PREFILL_B, PREFILL_S, cfg.num_kv_heads,
                    cfg.hd)
        if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size) or \
                logits.dtype != torch.float32 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill: logits of the wrong shape, type "
                                 "or not finite")
        for name in ("k", "v"):
            if tuple(kv[name].shape) != kv_shape or \
                    not bool(torch.isfinite(kv[name]).all()):
                raise AssertionError(f"prefill: {name} cache wrong or not "
                                     "finite")
        self.tally("prefill", dict(_build.launches))
        # kernel 5 on the inputs prefill gives it: every layer's q, k, v
        # in model layout (B, S, H, D), read through transposed strides
        with uncounted(), recorded(transformer, "attention") as calls:
            model.prefill(params, tokens)
        tol = TOL[torch.bfloat16]["flash_attention"]
        self.path_err["flash_attention"] = max(close_err(
            [(f"flash_attention.layer{li}", out, flash.mha_ref(
                *(t.transpose(1, 2) for t in args)).transpose(1, 2))],
            tol) for li, (args, out) in enumerate(calls))
        self.prefill_qkv = calls[0][0]
        del calls
        sec = sorted(secs)[len(secs) // 2]
        emit({"phase": "prefill", "arch": ARCH, "params": cfg.param_count(),
              "init_s": init_s, "batch": PREFILL_B, "seq": PREFILL_S,
              "seconds": secs, "tokens_per_s": PREFILL_B * PREFILL_S / sec,
              "flash_attention_launches": launches,
              "launches_per_call": launches // PREFILL_REPS,
              "flash_attention_vs_plain": self.path_err["flash_attention"],
              "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30})

    # --------------------------------------------------------- 10. serve
    def serve_paged(self) -> PagedServer:
        """PagedServer at qwen1.5-0.5b's widths: 8 prompts sharing a
        prefix, a worker added mid-flight, greedy decode."""
        cfg = get_config(ARCH)
        srv = PagedServer(cfg=cfg, page_size=PAGE_SIZE, num_pages=NUM_PAGES,
                          workers=("w0", "w1"), seed=SEED)
        g = np.random.default_rng(SEED)
        shared = g.integers(0, cfg.vocab_size, SHARED).tolist()
        prompts = [shared + g.integers(0, cfg.vocab_size,
                                       PROMPT - SHARED).tolist()
                   for _ in range(SERVE_REQUESTS)]
        # set every count to 0 just before the main path
        _build.reset_counts()
        sids, admit_s, decode_s = [], 0.0, 0.0
        for r, prompt in enumerate(prompts):
            (sid, logits), sec = synced(srv.admit, prompt)
            admit_s += sec
            sids.append(sid)
            if logits is None or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"request {r}: no finite logits")
            if r + 1 == RECONFIG_AFTER:
                with uncounted():
                    reconfig = self.reconfigure(srv, sids[0])
        admitted = srv.stats["tokens"]
        decoded = []
        for sid in sids:
            out, sec = synced(srv.decode, sid, DECODE_STEPS)
            decode_s += sec
            decoded.append(out)
        counts = dict(_build.launches)
        if srv.stats["prefix_hits"] != SERVE_REQUESTS - 1:
            raise AssertionError(f"prefix hits {srv.stats['prefix_hits']}, "
                                 f"expected {SERVE_REQUESTS - 1}")
        if counts["paged_decode_attention"] == 0:
            raise AssertionError("the server never launched "
                                 "paged_decode_attention")
        if any(srv.ctl.sequences[s].length != PROMPT + DECODE_STEPS
               for s in sids) or any(not 0 <= t < cfg.vocab_size
                                     for out in decoded for t in out):
            raise AssertionError("a sequence has the wrong length or token")
        self.tally("serve_paged", counts)
        total = srv.stats["tokens"]
        emit({"phase": "serve", "arch": ARCH, "requests": SERVE_REQUESTS,
              "prompt": PROMPT, "shared_prefix": SHARED,
              "decode_steps": DECODE_STEPS, **srv.stats,
              "admit_tokens": admitted, "admit_s": admit_s,
              "decode_tokens": total - admitted, "decode_s": decode_s,
              "tokens_per_s": total / (admit_s + decode_s),
              "decode_tokens_per_s": (total - admitted) / decode_s,
              "reconfig": reconfig, "workers": srv.ctl.workers,
              "local_copy_ratio": {w: srv.ctl.local_copy_ratio(w)
                                   for w in srv.ctl.workers},
              "pages_used": NUM_PAGES - len(srv.ctl.free),
              "launches": {k: counts[k] for k in
                           ("flash_attention", "paged_decode_attention")}})
        # kernel 6 on the inputs the server gives it: one more decode
        # step of the last request, one launch a layer over the owners'
        # stacked tables, each owner's row held against the plain version
        # on that row alone
        with uncounted(), recorded(paged_store,
                                   "paged_decode_partial") as calls:
            srv.decode(sids[-1], 1)
        if len(calls) != cfg.num_layers:
            raise AssertionError(f"one decode step launched kernel 6 "
                                 f"{len(calls)} times, not once a layer")
        self.path_err["paged_decode_attention"] = close_err(
            [(f"paged_decode_attention.step{i}.row{r}.{o}", x[r:r + 1], y)
             for i, (args, out) in enumerate(calls)
             for r in range(args[0].shape[0])
             for o, x, y in zip("acc m l".split(), out,
                                decode.paged_decode_ref(
                                    *(a[r:r + 1] for a in args[:1]),
                                    *args[1:3],
                                    *(a[r:r + 1] for a in args[3:])))],
            TOL[torch.float32]["paged_decode_attention"])
        self.decode_args = calls[-1][0]
        emit({"check": "paged_decode_attention on one decode step",
              "launches": len(calls), "owners": self.decode_args[0].shape[0],
              "slots": self.decode_args[3].shape[1],
              "max_abs_err": self.path_err["paged_decode_attention"]})
        return srv

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
    def equivalence(self, srv: PagedServer) -> None:
        """One 256-token prompt through the server (token by token,
        kernel 6) against prefill's last-token logits (kernel 5)."""
        g = np.random.default_rng(SEED + 1)
        prompt = g.integers(0, srv.cfg.vocab_size, PROMPT).tolist()
        hits = srv.stats["prefix_hits"]
        _, paged = srv.admit(prompt)
        if srv.stats["prefix_hits"] != hits:
            raise AssertionError("the equivalence prompt hit the prefix "
                                 "cache")
        dense, _ = srv.model.prefill(
            srv.params, torch.tensor([prompt], device=self.dev))
        rel = rel_diff(paged, dense[0])
        same = int(paged.argmax()) == int(dense[0].argmax())
        emit({"phase": "equivalence", "tokens": PROMPT,
              "max_abs_diff": float((paged - dense[0]).abs().max()),
              "max_abs_logit": float(dense[0].abs().max()),
              "rel_diff": rel, "tolerance": LOGIT_TOL, "top1_same": same})
        if rel > LOGIT_TOL:
            raise AssertionError(f"server and prefill logits differ by "
                                 f"{rel} of max |logit|")

    def profile_decode(self, srv: PagedServer) -> None:
        """torch.profiler over one decode step of one served sequence."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(srv.decode, 0, 1)
        emit({"profile": "one decode step (24 layers)",
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
            compare=lambda pairs: close_err(
                pairs, TOL[torch.bfloat16]["flash_attention"]))]

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
    def teacher_forced(self, params, prompt, cfg, by_layer=False) -> dict:
        """``prompt`` (1, T) through ``serve_step`` token by token from
        ``init_cache``, against ``forward``'s logits on the same tokens:
        max |diff| / max |logit| over all T steps and the top-1 agreement.

        With ``by_layer``, each layer's block output is compared too: the
        decode path's (cumulative: its input already carries the earlier
        layers' differences), and the layer's own decode fed forward's
        input to that layer (local: what the layer alone adds)."""
        t_len = prompt.shape[1]
        with recorded(ssm_lm, "mamba_block") as blocks:
            full = ssm_lm.forward(params, prompt, cfg)[0][0]   # (T, V)
        block_in = [args[1][0] for args, _ in blocks]        # (T, d) each
        block_out = [out[0] for _, out in blocks]
        del blocks
        cache = ssm_lm.init_cache(cfg, 1)
        cum = torch.zeros(cfg.num_layers, device=self.dev)
        diffs, same = [], 0
        t0 = time.perf_counter()
        for t in range(t_len):
            with recorded(ssm_lm, "mamba_decode") as dec:
                logits, cache = steps.serve_step(params, cache, prompt[:, t],
                                                 t, cfg)
            if by_layer:
                for li, (_, (y, _)) in enumerate(dec):
                    ref = block_out[li][t].float()
                    cum[li] = torch.maximum(cum[li], (y[0, 0].float() - ref)
                                            .abs().max() / ref.abs().max())
            diffs.append((logits[0] - full[t]).abs().max())
            same += int(logits[0].argmax()) == int(full[t].argmax())
        torch.cuda.synchronize()
        out = {"tokens": t_len, "seconds": time.perf_counter() - t0,
               "max_abs_diff": float(torch.stack(diffs).max()),
               "max_abs_logit": float(full.abs().max())}
        out["rel_diff"] = out["max_abs_diff"] / out["max_abs_logit"]
        out["top1_agree"] = same / t_len
        if by_layer:
            local = torch.zeros(cfg.num_layers, device=self.dev)
            for li, lp in enumerate(params["layers"]):
                st = mamba2.mamba_state_init(cfg, 1)
                for t in range(t_len):
                    y, st = mamba2.mamba_decode(lp["mamba"],
                                                block_in[li][t][None, None],
                                                cfg, st)
                    ref = block_out[li][t].float()
                    local[li] = torch.maximum(local[li], (y[0, 0].float() - ref)
                                              .abs().max() / ref.abs().max())
            out["block_rel_diff_cumulative"] = cum.tolist()
            out["block_rel_diff_local"] = local.tolist()
        return out

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
        from torch.profiler import ProfilerActivity, profile
        cfg = get_config(SSM_ARCH)
        params = self.ssm_params
        g = np.random.default_rng(SEED + 2)
        prompt = torch.from_numpy(g.integers(0, cfg.vocab_size,
                                             (1, TF_PROMPT))).to(self.dev)
        _build.reset_counts()
        bf16 = self.teacher_forced(params, prompt, cfg, by_layer=True)
        if _build.launches["ssd_scan"] != cfg.num_layers:
            raise AssertionError("the teacher-forced forward did not run "
                                 "ssd_scan once a layer, or decode ran it")
        self.tally("ssm_decode", dict(_build.launches))
        conv = mamba2._causal_conv
        with mock.patch.object(mamba2, "_causal_conv",
                               lambda xbc, w, b: conv(xbc.float(), w.float(),
                                                      b.float())):
            conv_f32 = self.teacher_forced(params, prompt, cfg)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("f32 matrix products must not run in TF32")
        p32 = {"embed": params["embed"].float(),
               "ln_f": params["ln_f"].float(),
               "layers": [{"ln": lp["ln"].float(),
                           "mamba": {k: v.float()
                                     for k, v in lp["mamba"].items()}}
                          for lp in params["layers"]]}
        f32 = self.teacher_forced(p32, prompt, cfg)
        del p32
        torch.cuda.empty_cache()
        local, cum = bf16["block_rel_diff_local"], \
            bf16["block_rel_diff_cumulative"]
        over = [li for li, v in enumerate(cum) if v > LOGIT_TOL]
        emit({"phase": "ssm_decode_teacher_forced", **{
            k: v for k, v in bf16.items() if not k.startswith("block")},
            "tolerance": LOGIT_TOL, "within_tolerance": bf16["rel_diff"]
            <= LOGIT_TOL,
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
        cache = ssm_lm.init_cache(cfg, GREEDY_B)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(GREEDY_STEPS):
            logits, cache = steps.serve_step(params, cache, tok, t, cfg)
            tok = logits.argmax(-1)
            out.append(tok)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out = torch.stack(out, dim=1)
        if not bool(torch.isfinite(logits).all()) or \
                not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError("greedy decode: non-finite logits or a "
                                 "token out of range")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = synced(steps.serve_step, params, cache, tok,
                             GREEDY_STEPS, cfg)
        summary = device_summary(prof, wall)
        emit({"phase": "ssm_decode_greedy", "batch": GREEDY_B,
              "steps": GREEDY_STEPS, "seconds": sec,
              "step_ms": sec / GREEDY_STEPS * 1e3,
              "tokens_per_s": GREEDY_B * GREEDY_STEPS / sec,
              "distinct_tokens": int(torch.unique(out).numel())})
        emit({"profile": f"one decode step, batch {GREEDY_B} "
                         f"({cfg.num_layers} layers)",
              "launches_per_token": summary["launches"] / GREEDY_B,
              **summary})

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
        x, dt, a, b, c, d = self.ssd_args
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
            compare=ssd_path_err)
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
    smoke.prefill()
    srv = smoke.serve_paged()
    kernels += smoke.time_attention()
    smoke.profile_decode(srv)
    smoke.equivalence(srv)
    del srv
    torch.cuda.empty_cache()
    smoke.check_ssd()
    smoke.ssm_prefill()
    smoke.ssm_decode()
    kernels += smoke.time_ssd()
    del smoke.ssm_params, smoke.ssd_args
    torch.cuda.empty_cache()
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
