#!/usr/bin/env python3
"""Time the port's kernels 7 (ssd_scan) and D (clht_insert) against an
earlier version of them on the same card, in one process, on the same
inputs.

    python3 tools/ab_kernels.py --baseline DIR

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

Needs a CUDA card; prints one JSON object per line, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import clht  # noqa: E402
from repro_torch.data import Workload  # noqa: E402
from repro_torch.kernels import log_merge as merge  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402

SPIN_CYCLES = 2_000_000
REPS = 30
KEYS_LOG2 = 25
LOAD_SLOW = 21_836      # the load's mean slow-path entries per launch


def load_baseline(root: Path):
    """The package at root/src/repro_torch, imported as
    ``baseline_repro_torch``: its (ssd_scan module, clht module)."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "baseline_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(
                "baseline_repro_torch.kernels.ssd_scan.ssd_scan"),
            importlib.import_module("baseline_repro_torch.core.clht"))


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    old_ssd, old_clht = load_baseline(args.baseline.resolve())
    dev = torch.device("cuda")

    # kernel 7 at prefill's layer shape
    xs = ssd_inputs(dev)
    ref = ssd_k.ssd_chunked(*xs, 64)
    row = {"kernel": "ssd_scan", "shape": [4, 2048, 80, 64], "state": 128,
           "groups": 1, "chunk": 64,
           **turns(lambda: old_ssd.ssd_scan(*xs, chunk=64),
                   lambda: ssd_k.ssd_scan(*xs, chunk=64), args.reps),
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
                          args.reps)}), flush=True)
    del xs, ref, one

    # kernel D on the full table
    table = full_table(dev)
    n = 1 << KEYS_LOG2
    fresh = torch.arange(n, n + LOAD_SLOW, dtype=torch.int32, device=dev)
    kinds, keys = Workload(n, zipf=0.99, mix="write_heavy_update",
                           seed=1).ops_arrays(1 << 20)
    wk = torch.from_numpy(keys[kinds == 1].astype(np.int32)).to(dev)
    wp = torch.arange(n, n + wk.numel(), dtype=torch.int32, device=dev)
    after = clht.CLHT(table.lines.clone(), table.overflow_head.clone(), n)
    _, _, ok = merge.log_merge(after.lines, clht.bucket_of(wk, n), wk, wp)
    slow = (ok != 1).nonzero().flatten()
    sk, sp = wk[slow].contiguous(), wp[slow].contiguous()
    reps = max(2, args.reps // 3)
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
    return 0


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
