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

  flash_attention         kernel 5 at the main path's seven views (VIEWS):
                          q, k, v as (B, H, S, D) views of model-layout
                          (B, S, H, D) bf16 tensors; both outputs held to
                          the plain version (mha_ref, or blocked_mha above
                          2048 keys) at the main path's bar, SDPA's time
                          and the bound beside them
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
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
# kernel 5's views on the main path: (label, batch, Sq, heads, kv heads,
# Sk, D, causal)
VIEWS = (
    ("llama3.2-3b prefill", 4, 2048, 24, 8, 2048, 128, True),
    ("seamless cross", 4, 256, 16, 16, 1500, 64, False),
    ("qwen long prefill", 1, 32768, 16, 16, 32768, 64, True),
    ("qwen prefill", 4, 2048, 16, 16, 2048, 64, True),
    ("qwen long train", 2, 4096, 16, 16, 4096, 64, True),
    ("seamless encoder", 4, 1500, 16, 16, 1500, 64, False),
    ("zamba2 shared block", 4, 2048, 32, 32, 2048, 64, True),
)
# the main path's bar (chip_smoke.py: attn_path_bar)
ATTN_RTOL, ATTN_ATOL_OF_ABS = 2 ** -7, 2 ** -8


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


def attn_err(got, ref, bar) -> dict:
    """max |got - ref| and the count of elements outside ``bar``."""
    diff = (got.float() - ref).abs()
    return {"max_abs_err": float(diff.max()),
            "outside_bar": int((diff > bar).sum()),
            "finite": bool(torch.isfinite(got).all())}


def time_view(view, old_flash, gen, dev, reps: int) -> dict:
    """Kernel 5 at one main-path view: baseline and current in turns, SDPA
    beside them, both outputs held to the plain version at the bar."""
    label, b, sq, h, kh, sk, d, causal = view
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((b, sk, kh, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref = flash.plain_attention(qt, kt, vt, causal).float()
    bar = ATTN_ATOL_OF_ABS * flash.plain_attention(
        qt, kt, vt.abs(), causal).float() + ATTN_RTOL * ref.abs()
    flops = 2 * b * h * d * sq * (sq + 1) if causal \
        else 4 * b * h * d * sq * sk
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    row = {"kernel": "flash_attention", "view": label,
           "shape": [b, sq, h, d], "kv_heads": kh, "kv_len": sk,
           "causal": causal,
           **turns(lambda: old_flash.flash_attention(qt, kt, vt,
                                                     causal=causal),
                   lambda: flash.flash_attention(qt, kt, vt, causal=causal),
                   reps),
           "sdpa_ms": event_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True), reps),
           "bound_ms": bound,
           "bound_by": "operations" if flops / BF16_FLOPS
           >= nbytes / HBM_BYTES_PER_S else "bytes",
           "baseline": attn_err(old_flash.flash_attention(
               qt, kt, vt, causal=causal), ref, bar),
           "current": attn_err(flash.flash_attention(
               qt, kt, vt, causal=causal), ref, bar)}
    row["share_of_bound"] = bound / row["ms"]
    row["over_sdpa"] = row["ms"] / row["sdpa_ms"]
    return row


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
    ap.add_argument("--only", nargs="*", default=None,
                    help="time only these kernel-5 views (labels of VIEWS)"
                    " and stop")
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

    # kernel 5 at the main path's views
    bad = 0
    for view in VIEWS:
        if args.only and view[0] not in args.only:
            continue
        row = time_view(view, old_flash, gen, dev, args.reps)
        bad += row["current"]["outside_bar"] + (not row["current"]["finite"])
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.only:
        return int(bad > 0)

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
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
