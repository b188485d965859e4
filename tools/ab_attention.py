#!/usr/bin/env python3
"""Time the port's two attention kernels against an earlier version of
them on the same card, in one process, on the same inputs.

    python3 tools/ab_attention.py --baseline DIR

DIR is a checkout of the earlier commit (for example ``git archive
<commit> | tar -x -C DIR``); its package is loaded under another name and
builds its own kernel library under DIR/build/. Each shape is timed in
turns: baseline, current, current, baseline (CUDA events behind about
1 ms of device spin, REPS runs each), and both outputs are held against
the plain version. Shapes:

  flash_attention         qwen1.5-0.5b prefill's layer shape: q, k, v as
                          (B, H, S, D) views of (4, 2048, 16, 64) bf16,
                          causal; SDPA's time beside them
  paged_decode_attention  the server's decode step: one sequence of 120
                          tokens whose 15 pages are dealt to 3 owners,
                          41 slots, 16 kv heads of 64, f32 pages; the
                          three owners stacked as one call, and the
                          baseline's one call per owner as the server
                          made them; then 64 sequences x 2048 tokens

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

from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402

SPIN_CYCLES = 2_000_000
REPS = 50


def load_baseline(root: Path):
    """The package at root/src/repro_torch, imported as
    ``baseline_repro_torch``."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "baseline_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("baseline_repro_torch.kernels."
                                    "flash_attention"),
            importlib.import_module("baseline_repro_torch.kernels."
                                    "decode_attention"))


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def turns(base, cur, reps: int) -> dict:
    """base, cur, cur, base: the mean of each version's two runs."""
    b1 = event_ms(base, reps)
    c1 = event_ms(cur, reps)
    c2 = event_ms(cur, reps)
    b2 = event_ms(base, reps)
    return {"baseline_ms": (b1 + b2) / 2, "ms": (c1 + c2) / 2,
            "baseline_runs": [b1, b2], "runs": [c1, c2],
            "speedup": (b1 + b2) / (c1 + c2)}


def err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def server_tables(dev, context=120, owners=3, slots=41, ps=8, seed=0):
    rng = np.random.default_rng(seed)
    npages = -(-context // ps)
    pids = rng.choice(4096, npages, replace=False)
    pt = np.full((owners, slots), -1, np.int32)
    pos = np.zeros((owners, slots), np.int32)
    for j, pid in enumerate(pids):
        o, c = j % owners, j // owners
        pt[o, c], pos[o, c] = pid, j * ps
    lens = np.full((owners,), context, np.int32)
    return [torch.from_numpy(x).to(dev) for x in (pt, pos, lens)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    old_flash, old_decode = load_baseline(args.baseline.resolve())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # kernel 5 at prefill's layer shape, model-layout views
    q, k, v = (torch.randn((4, 2048, 16, 64), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    ref = flash.mha_ref(q, k, v)
    row = {"kernel": "flash_attention", "shape": [4, 2048, 16, 64],
           **turns(lambda: old_flash.flash_attention(q, k, v),
                   lambda: flash.flash_attention(q, k, v), args.reps),
           "sdpa_ms": event_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=True), args.reps),
           "baseline_err": err(old_flash.flash_attention(q, k, v), ref),
           "err": err(flash.flash_attention(q, k, v), ref)}
    print(json.dumps(row), flush=True)
    del q, k, v, ref

    # kernel 6 at the server's decode step (one layer)
    kp, vp = (torch.randn((4096, 8, 16, 64), generator=gen, device=dev)
              for _ in range(2))
    qd = torch.randn((1, 16, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    pt, pos, lens = server_tables(dev)
    stacked = qd.expand(3, -1, -1)
    ref = decode.paged_decode_ref(stacked, kp, vp, pt, pos, lens)

    def per_owner(mod):
        return [mod.paged_decode_attention(qd, kp, vp, pt[o:o + 1],
                                           pos[o:o + 1], lens[o:o + 1])
                for o in range(3)]

    row = {"kernel": "paged_decode_attention", "shape": "server step, "
           "3 owners x 41 slots, 120 tokens, 16 kv heads x 64, f32 pages",
           "stacked": turns(
               lambda: old_decode.paged_decode_attention(
                   stacked, kp, vp, pt, pos, lens),
               lambda: decode.paged_decode_attention(
                   stacked, kp, vp, pt, pos, lens), args.reps),
           "baseline_per_owner_ms": event_ms(lambda: per_owner(old_decode),
                                             args.reps),
           "per_owner_ms": event_ms(lambda: per_owner(decode), args.reps),
           "splits": decode.split_count(48, 41, 8),
           "baseline_err": max(err(a, b) for a, b in zip(
               old_decode.paged_decode_attention(stacked, kp, vp, pt, pos,
                                                 lens), ref)),
           "err": max(err(a, b) for a, b in zip(
               decode.paged_decode_attention(stacked, kp, vp, pt, pos, lens),
               ref))}
    print(json.dumps(row), flush=True)
    del kp, vp

    # kernel 6 at a batched decode: 64 sequences x 2048 tokens
    b, ctx, ps = 64, 2048, 8
    slots = ctx // ps
    kp, vp = (torch.randn((b * slots, ps, 16, 64), generator=gen,
                          device=dev) for _ in range(2))
    qd = torch.randn((b, 16, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    pt = torch.randperm(b * slots, generator=gen, device=dev).to(
        torch.int32).reshape(b, slots)
    pos = (torch.arange(slots, dtype=torch.int32, device=dev) * ps).expand(
        b, slots).contiguous()
    lens = torch.full((b,), ctx, dtype=torch.int32, device=dev)
    ref = decode.paged_decode_ref(qd, kp, vp, pt, pos, lens)
    row = {"kernel": "paged_decode_attention", "shape": [b, ctx],
           **turns(lambda: old_decode.paged_decode_attention(
               qd, kp, vp, pt, pos, lens),
               lambda: decode.paged_decode_attention(
               qd, kp, vp, pt, pos, lens), args.reps),
           "err": max(err(a, b) for a, b in zip(
               decode.paged_decode_attention(qd, kp, vp, pt, pos, lens),
               ref))}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
