#!/usr/bin/env python3
"""Time the port's kernels 7 (ssd_scan), D (clht_insert), C
(log_merge_sorted), 4 (cache_transition), A (clht_probe) and E
(fused_window) against an earlier version of them on the same card, in
one process, on the same inputs.

    python3 tools/ab_kernels.py --baseline DIR [--only NAME,...]

DIR is a checkout of the earlier commit (for example ``git archive
<commit> | tar -x -C DIR``); its package is loaded under another name and
builds its own kernel library under DIR/build/. Each shape is timed in
turns: baseline, current, current, baseline (CUDA events behind about
1 ms of device spin, REPS runs each, a fresh copy of the table before
every insert, outside the timed region), and both outputs are held
against the plain version. Shapes:

  ssd_scan     mamba2-2.7b prefill's layer shape: x, B and C as bf16
               views of one (4, 2048, 5376) projection, 80 heads of 64,
               N 128, G 1, chunk 64; held to chip_smoke.py's main-path
               bar against ssd_chunked; then the current kernel alone at
               batch 1 (one block an SM)
  clht_insert  a table of 2^25 keys (2^25 buckets, 2^24 overflow
               buckets, the keys inserted in a seeded random order), then
               (a) the load's mean slow-path batch, 21,836 fresh keys,
               and (b) the slow-path entries of one YCSB
               write_heavy_update batch of 2^20 ops at zipf 0.99 (the
               updates log_merge leaves to kernel D); each bit for bit
               against clht_insert_plain
  log_merge_sorted
               the 2^19 updates of a YCSB write_heavy_update batch of
               2^20 ops at zipf 0.99, bucket-sorted, into the same 2^25-key
               table (a fresh copy of its lines before every run), bit for
               bit against log_merge_sorted_ref; then the current kernel
               at other values of WALK_MAX (the largest group one thread
               walks)
  cache_transition
               the launch alone on (a) a seeded 512-op window of a full
               1 GiB cache whose fills and promotes make space, with a
               queue of 1,064-byte victims, and (b) tests/torch_cases.py's
               2^13-op window with a 4,096-victim queue, which crosses the
               staged tiles; each also over as many neutral rows (no scan
               work); bit for bit against cache_transition_np

  clht_probe   the 2^20 keys of a YCSB read_only batch at zipf 0.99
               against the same 2^25-key table, bit for bit against
               clht_probe_ref; both versions on the same keys read
               against line 0 only (the streamed bytes alone), sorted by
               bucket (each line once, in order), and on 2^20 uniform
               keys (a line each), and on a KN prefetch's 300 keys; then
               the launch-shape sweep: a trial build of the current
               kernel with its keys per thread a pass and threads a
               block as arguments (tools/clht_probe_sweep.cu, built here
               with the package's nvcc flags) at the read batch and at
               the prefetch, each shape bit for bit against
               clht_probe_ref
  fused_window the launch alone on two KN windows over 2^21 slots
               (tests/torch_cases.py:window_victims_case): 3,072 ops
               with room to spare (hits and inserts, no victim) and
               2,048 ops that demote and evict from a full cache; a fresh
               copy of the state and its trees before every run; each
               version held to fused_window_ref (n_exec and the state);
               then trial builds of the current source with one part of
               the op loop cut (ABLATIONS: the leaves' notes and repairs,
               the dirty record's notes, the event tapes, all three),
               timed only: each computes another function, so the
               differences say what the parts cost; and one with the
               trees' top levels left in device memory

Needs a CUDA card; prints one JSON object per line, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from repro_torch.core import clht  # noqa: E402
from repro_torch.data import Workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_transition as trans  # noqa: E402
from repro_torch.kernels import clht_probe as probe  # noqa: E402
from repro_torch.kernels import log_merge as merge  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from torch_cases import transition_case  # noqa: E402

# the module behind kernel C's wrapper (the package exports the function
# log_merge over its name)
merge_k = importlib.import_module("repro_torch.kernels.log_merge.log_merge")

SPIN_CYCLES = 2_000_000
REPS = 30
KEYS_LOG2 = 25
LOAD_SLOW = 21_836      # the load's mean slow-path entries per launch
KERNELS = ("ssd_scan", "clht_insert", "log_merge_sorted", "cache_transition",
           "clht_probe", "fused_window")
HBM_BYTES_PER_S = 3.35e12


def load_baseline(root: Path):
    """The package at root/src/repro_torch, imported as
    ``baseline_repro_torch``: its ssd_scan, clht, log_merge,
    cache_transition, clht_probe and batch_executor ops modules."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "baseline_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"baseline_repro_torch.{m}") for m in
                 ("kernels.ssd_scan.ssd_scan", "core.clht",
                  "kernels.log_merge.log_merge",
                  "kernels.cache_transition.cache_transition",
                  "kernels.clht_probe.clht_probe",
                  "kernels.batch_executor.ops"))


def event_ms(fn, reps: int, setup=None) -> float:
    fn(*(setup() if setup else ()))
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def turns(base, cur, reps: int, base_setup=None, cur_setup=None) -> dict:
    """base, cur, cur, base: the mean of each version's two runs (each
    with its own setup, outside the timed region)."""
    b1 = event_ms(base, reps, base_setup)
    c1 = event_ms(cur, reps, cur_setup)
    c2 = event_ms(cur, reps, cur_setup)
    b2 = event_ms(base, reps, base_setup)
    return {"baseline_ms": (b1 + b2) / 2, "ms": (c1 + c2) / 2,
            "baseline_runs": [b1, b2], "runs": [c1, c2],
            "speedup": (b1 + b2) / (c1 + c2)}


def ssd_inputs(dev, seed=0):
    """Prefill's layer-0 shape as the model hands it: x, B, C strided
    views of one projection; dt after softplus, a < 0."""
    b, s, h, p, g, n = 4, 2048, 80, 64, 1, 128
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    xbc = f(rng.standard_normal((b, s, h * p + 2 * g * n)) * 0.5).to(
        torch.bfloat16)
    x = xbc[..., :h * p].view(b, s, h, p)
    bm = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
    cm = xbc[..., h * p + g * n:].view(b, s, g, n)
    dt = f(rng.uniform(0.001, 0.1, (b, s, h)))
    a = f(-rng.uniform(1.0, 16.0, (h,)))
    d = f(rng.standard_normal(h))
    return x, dt, a, bm, cm, d


def ssd_err(got, ref) -> float:
    """max |diff| over the bar's allowance (<= 1 passes the bar)."""
    got, ref = got.float(), ref.float()
    bar = 2 ** -8 * ref.abs().max() + 2 ** -7 * ref.abs()
    return float(((got - ref).abs() / bar).max())


def full_table(dev, seed=0):
    """2^25 keys, inserted in a seeded random order through log_merge and
    the slow path, as the load inserts them."""
    n = 1 << KEYS_LOG2
    table = clht.clht_init(n, device=dev)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n)
                            .astype(np.int32)).to(dev)
    for lo in range(0, n, 1 << 20):
        k = perm[lo:lo + (1 << 20)].contiguous()
        _, _, ok = merge.log_merge(table.lines,
                                   clht.bucket_of(k, n), k, k)
        slow = (ok != 1).nonzero().flatten()
        if slow.numel():
            clht.clht_insert(table, k[slow].contiguous(),
                             k[slow].contiguous())
    return table


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="comma-separated kernels to time")
    args = ap.parse_args()
    only = args.only.split(",")
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    old = load_baseline(args.baseline.resolve())
    dev = torch.device("cuda")
    if "ssd_scan" in only:
        ab_ssd(old[0], dev, args.reps)
    if "cache_transition" in only:
        ab_transition(old[3], dev, args.reps)
    if "fused_window" in only:
        ab_window(old[5], dev, args.reps)
    if {"clht_insert", "log_merge_sorted", "clht_probe"} & set(only):
        table = full_table(dev)
        if "clht_probe" in only:
            ab_probe(old[4], table, args.reps)
        kinds, keys = Workload(table.num_buckets, zipf=0.99,
                               mix="write_heavy_update",
                               seed=1).ops_arrays(1 << 20)
        wk = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
        if "clht_insert" in only:
            ab_insert(old[1], table, wk, args.reps)
        if "log_merge_sorted" in only:
            ab_merge(old[2], table, wk, args.reps)
    return 0


def ab_ssd(old_ssd, dev, reps: int) -> None:
    """Kernel 7 at prefill's layer shape, then the current kernel at
    batch 1."""
    xs = ssd_inputs(dev)
    ref = ssd_k.ssd_chunked(*xs, 64)
    row = {"kernel": "ssd_scan", "shape": [4, 2048, 80, 64], "state": 128,
           "groups": 1, "chunk": 64,
           **turns(lambda: old_ssd.ssd_scan(*xs, chunk=64),
                   lambda: ssd_k.ssd_scan(*xs, chunk=64), reps),
           "baseline_err_over_bar": ssd_err(
               old_ssd.ssd_scan(*xs, chunk=64), ref),
           "err_over_bar": ssd_err(ssd_k.ssd_scan(*xs, chunk=64), ref)}
    print(json.dumps(row), flush=True)
    # the same heads at batch 1: 80 blocks, one an SM, so each block runs
    # alone and its time is its own chain of dependent steps
    one = [t[:1] if t.dim() > 1 else t for t in xs]
    print(json.dumps({"kernel": "ssd_scan", "shape": [1, 2048, 80, 64],
                      "blocks": 80, "ms": event_ms(
                          lambda: ssd_k.ssd_scan(*one, chunk=64),
                          reps)}), flush=True)


def ab_insert(old_clht, table, wk, reps: int) -> None:
    """Kernel D on the full table: the load's mean slow-path batch, and
    the slow-path entries of a write batch's updates."""
    n, dev = table.num_buckets, wk.device
    fresh = torch.arange(n, n + LOAD_SLOW, dtype=torch.int32, device=dev)
    wp = torch.arange(n, n + wk.numel(), dtype=torch.int32, device=dev)
    after = clht.CLHT(table.lines.clone(), table.overflow_head.clone(), n)
    _, _, ok = merge.log_merge(after.lines, clht.bucket_of(wk, n), wk, wp)
    slow = (ok != 1).nonzero().flatten()
    sk, sp = wk[slow].contiguous(), wp[slow].contiguous()
    reps = max(2, reps // 3)
    for name, base, k, p in (("load slow path", table, fresh, fresh),
                             ("write_heavy_update slow path", after, sk,
                              sp)):
        def copy(mod, base=base):
            return lambda: (mod.CLHT(base.lines.clone(),
                                     base.overflow_head.clone(), n),)
        row = {"kernel": "clht_insert", "shape": name,
               "entries": k.numel(),
               **turns(lambda t, k=k, p=p: old_clht.clht_insert(t, k, p),
                       lambda t, k=k, p=p: clht.clht_insert(t, k, p), reps,
                       copy(old_clht), copy(clht)),
               "equal_to_plain": insert_equal(base, k, p, old_clht)}
        print(json.dumps(row), flush=True)


def ab_merge(old_merge, table, wk, reps: int) -> None:
    """Kernel C on a write batch's updates, bucket-sorted, into the full
    table's lines (a fresh copy before every run); each version bit for
    bit against the plain version; then the current kernel at other
    values of WALK_MAX."""
    n = table.num_buckets
    bs, order, starts = merge.sort_by_bucket(clht.bucket_of(wk, n))
    ks = wk[order].contiguous()
    ps = torch.arange(ks.numel(), dtype=torch.int32, device=wk.device)
    args = (starts, bs, ks, ps)
    fresh = lambda: (table.lines.clone(),)        # noqa: E731
    sizes = starts[1:] - starts[:-1]
    ref_lines = table.lines.clone()
    ref = [ref_lines, *merge.log_merge_sorted_ref(ref_lines, *args)]

    def equal(fn) -> bool:
        lines = table.lines.clone()
        got = [lines, *fn(lines, *args)]
        return all(torch.equal(a, b) for a, b in zip(got, ref))

    row = {"kernel": "log_merge_sorted", "entries": ks.numel(),
           "groups": sizes.numel(), "largest_group": int(sizes.max()),
           **turns(lambda lines: old_merge.log_merge_sorted(lines, *args),
                   lambda lines: merge.log_merge_sorted(lines, *args), reps,
                   fresh, fresh),
           "equal_to_plain": {"baseline": equal(old_merge.log_merge_sorted),
                              "current": equal(merge.log_merge_sorted)}}
    print(json.dumps(row), flush=True)
    default = merge_k.WALK_MAX
    for walk_max in (0, 8, 128, 1024):
        merge_k.WALK_MAX = walk_max
        print(json.dumps({
            "kernel": "log_merge_sorted", "walk_max": walk_max,
            "groups_walked": int((sizes <= walk_max).sum()),
            "ms": event_ms(lambda lines: merge.log_merge_sorted(
                lines, *args), reps, fresh),
            "equal_to_plain": equal(merge.log_merge_sorted)}), flush=True)
    merge_k.WALK_MAX = default


def sweep_probe_lib() -> ctypes.CDLL:
    """tools/clht_probe_sweep.cu, kernel A with its launch shape as
    arguments, built with the package's nvcc flags under build/tools/."""
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libclht_probe_sweep.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-I{_build.CSRC}", str(ROOT / "tools" /
                                            "clht_probe_sweep.cu"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.clht_probe_sweep_launch.restype = ctypes.c_int
    lib.clht_probe_sweep_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2
        + [ctypes.c_int64] + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
        + [ctypes.c_void_p])
    return lib


def ab_probe(old_probe, table, reps: int) -> None:
    """Kernel A on a read batch's 2^20 keys against the full table, each
    version bit for bit against the plain version; both on other line
    traffic and on a KN prefetch's 300 keys; then the launch-shape
    sweep on a trial build."""
    n, dev = table.num_buckets, table.lines.device
    _, keys = Workload(n, zipf=0.99, mix="read_only",
                       seed=0).ops_arrays(1 << 20)
    kd = torch.from_numpy(keys.astype(np.int32)).to(dev)
    bids = clht.bucket_of(kd, n)
    lines = int(torch.unique(bids).numel())
    nbytes = kd.numel() * 16 + lines * 32

    def equal(fn, k=kd, b=bids) -> bool:
        return all(torch.equal(x, y) for x, y in zip(
            fn(table.lines, b, k), probe.clht_probe_ref(table.lines, b, k)))

    row = {"kernel": "clht_probe", "keys": kd.numel(),
           "distinct_lines": lines,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           **turns(lambda: old_probe.clht_probe(table.lines, bids, kd),
                   lambda: probe.clht_probe(table.lines, bids, kd), reps),
           "equal_to_plain": {"baseline": equal(old_probe.clht_probe),
                              "current": equal(probe.clht_probe)}}
    print(json.dumps(row), flush=True)
    # where the time goes: the same work with other line traffic
    order = torch.argsort(bids)
    uni = torch.from_numpy(np.random.default_rng(1).integers(
        0, n, 1 << 20).astype(np.int32)).to(dev)
    few, fb = kd[:300].contiguous(), bids[:300].contiguous()
    for shape, k, b in (
            ("line 0 only", kd, torch.zeros_like(bids)),
            ("sorted by bucket", kd[order].contiguous(),
             bids[order].contiguous()),
            ("uniform keys", uni, clht.bucket_of(uni, n)),
            ("KN prefetch", few, fb)):
        lines_b = int(torch.unique(b).numel())
        print(json.dumps({
            "kernel": "clht_probe", "keys": k.numel(), "shape": shape,
            "distinct_lines": lines_b, "bound_ms":
                (k.numel() * 16 + lines_b * 32) / HBM_BYTES_PER_S * 1e3,
            **turns(lambda k=k, b=b: old_probe.clht_probe(table.lines, b, k),
                    lambda k=k, b=b: probe.clht_probe(table.lines, b, k),
                    reps),
            "equal_to_plain": {"baseline": equal(old_probe.clht_probe, k, b),
                               "current": equal(probe.clht_probe, k, b)}}),
            flush=True)
    lib = sweep_probe_lib()
    for shape, k, b in (("read batch", kd, bids), ("KN prefetch", few, fb)):
        for kpp in (1, 2, 4, 8):
            for block in (64, 128, 256, 512, 1024):
                def trial(kpp=kpp, block=block, k=k, b=b):
                    ptrs = torch.empty_like(k)
                    found = torch.empty_like(k)
                    err = lib.clht_probe_sweep_launch(
                        table.lines.data_ptr(), table.lines.shape[0],
                        b.data_ptr(), k.data_ptr(), k.numel(),
                        ptrs.data_ptr(), found.data_ptr(), kpp, block,
                        _build.stream(k))
                    if err:
                        raise RuntimeError(f"sweep launch failed: {err}")
                    return ptrs, found
                print(json.dumps({
                    "kernel": "clht_probe", "sweep": shape,
                    "keys": k.numel(), "keys_per_thread": kpp,
                    "block": block, "ms": event_ms(trial, reps),
                    "shipped_ms": event_ms(lambda k=k, b=b: probe.clht_probe(
                        table.lines, b, k), reps),
                    "equal_to_plain": equal(lambda *_, t=trial: t(), k,
                                            b)}), flush=True)


def ab_transition(old_trans, dev, reps: int) -> None:
    """Kernel 4's launch on a 512-op make-space window of a full 1 GiB
    cache and on a 2^13-op window over 4,096 victims, and on as many
    neutral rows; each version bit for bit against the plain loop."""
    g = np.random.default_rng(7)
    n = 512
    opk = g.choice([0, 1], n)
    rows = trans.encode_window(opk, g.choice([1, 2], n),
                               g.choice([0, 1, 3], n), np.full(n, 1024),
                               value_bytes=1024)
    cap = 1 << 30
    windows = {"make_space_512": (rows, np.full(1100, 1064, np.int32),
                                  cap - 500, 40, cap),
               "window_8192": transition_case("window_8192")}
    for name, (rows, vic, used0, z0, cap) in windows.items():
        r, v = torch.from_numpy(rows).to(dev), torch.from_numpy(vic).to(dev)
        idle = torch.zeros_like(r)
        want = trans.cache_transition_np(rows, vic, used0, z0, cap=cap)

        def launch(mod, ops):
            outs = [torch.empty(rows.shape[0], dtype=torch.int32, device=dev)
                    for _ in range(3)]
            return lambda: (mod.launch(ops, v, used0, z0, cap, *outs), outs)

        def equal(mod) -> bool:
            outs = launch(mod, r)()[1]
            return all(np.array_equal(o.cpu().numpy(), w)
                       for o, w in zip(outs, want))

        row = {"kernel": "cache_transition", "window": name,
               "ops": rows.shape[0], "queue": int(vic.size),
               "victims_consumed": int(want[1][-1]),
               **turns(launch(old_trans, r), launch(trans, r), reps),
               "neutral_rows": turns(launch(old_trans, idle),
                                     launch(trans, idle), reps),
               "equal_to_plain": {"baseline": equal(old_trans),
                                  "current": equal(trans)}}
        print(json.dumps(row), flush=True)


# kernel E's op loop with one part cut, for trial builds (source edits of
# csrc/fused_window.cu; each must match once)
_NOTE_SLOT = ("    if (ev != EV_MISS_ABSENT) m.note_slot(k);\n", "")
_NOTE_LEAF = ("    if (lru_dirty) note_leaf(true, k, lru_val);\n"
              "    if (lfu_dirty) note_leaf(false, k, lfu_val);\n", "")
_TAPES = ("      events[i] = ev;\n      out_ptr[i] = outp;\n", "")
# and with the trees' top levels left in device memory (a root in shared
# memory only), which computes the same function
_TOP = ("constexpr int kTop = 4096;", "constexpr int kTop = 2;")
ABLATIONS = {"no_leaf_notes": (_NOTE_LEAF,), "no_slot_notes": (_NOTE_SLOT,),
             "no_tapes": (_TAPES,),
             "none_of_the_three": (_NOTE_LEAF, _NOTE_SLOT, _TAPES),
             "top_levels_in_device_memory": (_TOP,)}


def window_trial_lib(name: str, edits) -> ctypes.CDLL:
    """csrc/fused_window.cu with ``edits`` applied, built with the
    package's nvcc flags under build/tools/ (its fused_windows_launch)."""
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_window.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {name}: an edit does not match")
        src = src.replace(old, new)
    cu = out / f"fused_window_{name}.cu"
    cu.write_text(src)
    so = out / f"libfused_window_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.fused_windows_launch.restype = ctypes.c_int
    lib.fused_windows_launch.argtypes = (ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p)
    return lib


def ab_window(old_ops, dev, reps: int) -> None:
    """Kernel E's launch alone on two 2^21-slot windows (one with no
    victim, one demoting and evicting), each version held to
    fused_window_ref; then the ablation trial builds, timed only."""
    from repro_torch.kernels import batch_executor as be
    from repro_torch.kernels.batch_executor import ops as cur_ops
    from torch_cases import window_victims_case
    s = 1 << 21
    cases = {}
    state, wins, _, wb, amr = window_victims_case(0, s, 3072, 1, 1 << 16)
    cases["no_victim_3072"] = (state, wins[0], 1 << 30, wb, amr)
    state, wins, cap, wb, amr = window_victims_case(1, s, 2048, 1, 32)
    cases["victims_2048"] = (state, wins[0], cap, wb, amr)
    libs = {name: window_trial_lib(name, edits)
            for name, edits in ABLATIONS.items()}
    for name, (state, win, cap, wb, amr) in cases.items():
        vmax_h = be.build_promote_table(amr)
        want = be.fused_window_ref(tuple(a.copy() for a in state), *win[:6],
                                   win[6], cap, wb, vmax_h)
        n = win[6]
        dwin = [torch.from_numpy(a).to(dev) for a in win[:6]]
        vmax = torch.from_numpy(vmax_h).to(dev)
        st0 = tuple(torch.from_numpy(a).to(dev) for a in state)
        tr0 = be.build_trees(st0)

        def fresh():
            return (tuple(t.clone() for t in st0),
                    tuple(t.clone() for t in tr0))

        def old_setup():
            st, tr = fresh()
            return st, tr, torch.empty(old_ops.HEADER + 2 * n,
                                       dtype=torch.int32, device=dev)

        def cur_setup():
            st, tr = fresh()
            job = be.WindowJob(st, tuple(dwin), n, cap, wb, vmax, tr,
                               be.new_dirty(s, dev))
            desc, out, ops = cur_ops.prepare([job])
            return desc, out, ops, st

        def old_launch(st, tr, packed):
            old_ops.launch(st, tr, dwin, n, cap, wb, vmax, packed)

        def cur_launch(desc, out, ops, st):
            cur_ops.launch(desc, ops)

        def equal(launch, setup, state_at, n_exec) -> bool:
            args = setup()
            launch(*args)
            return n_exec(args) == want[0] and all(
                np.array_equal(a.cpu().numpy(), b)
                for a, b in zip(state_at(args), want[1]))

        def trial(lib):
            def run(desc, out, ops, st):
                err = lib.fused_windows_launch(desc.data_ptr(), 1,
                                               _build.stream(desc))
                if err:
                    raise RuntimeError(f"trial launch failed: {err}")
            return run

        regs0, regs1 = state[7], want[1][7]
        row = {"kernel": "fused_window", "window": name, "slots": s,
               "ops": n, "executed": int(want[0]),
               "demotions": int(regs1[6] - regs0[6]),
               "evictions": int(regs1[7] - regs0[7]),
               **turns(old_launch, cur_launch, reps, old_setup, cur_setup),
               "equal_to_plain": {
                   "baseline": equal(old_launch, old_setup,
                                     lambda a: a[0], lambda a: int(a[2][0])),
                   "current": equal(cur_launch, cur_setup,
                                    lambda a: a[3],
                                    lambda a: int(a[1][0][0]))},
               "ablations_ms": {k: event_ms(trial(lib), reps, cur_setup)
                                for k, lib in libs.items()}}
        print(json.dumps(row), flush=True)


def insert_equal(base, keys, ptrs, old_clht) -> dict:
    """Each version's result on a copy of ``base`` against the plain loop,
    bit for bit: lines, overflow_head, old, ok and num_new."""
    def run(mod, fn):
        t = mod.CLHT(base.lines.clone(), base.overflow_head.clone(),
                     base.num_buckets)
        _, old, ok, num_new = fn(t, keys, ptrs)
        return [t.lines, t.overflow_head, old, ok, num_new]

    ref = run(clht, clht.clht_insert_plain)
    out = {}
    for label, mod in (("baseline", old_clht), ("current", clht)):
        got = run(mod, mod.clht_insert)
        out[label] = all(torch.equal(a, b) for a, b in zip(got, ref))
    return out


if __name__ == "__main__":
    sys.exit(main())
