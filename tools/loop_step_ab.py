#!/usr/bin/env python3
"""Time launch/steps.py:train_step at qwen1.5-0.5b's published widths on
the batches of chip_smoke.py's two training cells, in turns, in one
process:

    python3 tools/loop_step_ab.py [--rounds 4]

  fixed        train_qwen's batch: make_batch's uniform tokens over the
               vocabulary, the same batch every step
  markov       train_loop's batches: SyntheticLM (seed 0) step by step,
               uploaded as launch/train.py uploads them
  prefetched   the same batches taken from a Prefetcher, whose thread
               makes the next batch while the step runs

Each round runs one step of each (fixed, markov, prefetched, then back),
each step between synchronizations, after two warm-up steps. It tells
whether a loop step that is slower than train_qwen's comes from its
tokens (the embedding's backward over repeated ids) or from the
prefetcher's thread competing for the interpreter lock. Needs a CUDA
card; prints one JSON object per line, the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import upload  # noqa: E402
from repro_torch.models.model_zoo import build_model, make_batch  # noqa: E402

ARCH, B, S, SEED = "qwen1.5-0.5b", 4, 2048, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("loop_step_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(ARCH).replace(loss_chunk=512)
    params = build_model(cfg).init(SEED, device=dev)
    opt_state = optim.init_state(params)
    opt = optim.AdamWConfig(warmup_steps=1)
    fixed = make_batch(cfg, B, S, gen=torch.Generator(device=dev)
                       .manual_seed(SEED))
    src = SyntheticLM(cfg.vocab_size, S, B, seed=SEED)
    markov_step = [0]

    def markov():
        markov_step[0] += 1
        return upload(src.batch(markov_step[0]), dev)

    pf = Prefetcher(src, start_step=1000)

    def prefetched():
        return upload(pf.next()[1], dev)

    def step(batch):
        nonlocal params, opt_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = steps.train_step(params, opt_state, batch,
                                                cfg, opt)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, float(m["loss"])

    try:
        for _ in range(2):
            step(fixed)
        secs = {"fixed": [], "markov": [], "prefetched": []}
        order = ("fixed", "markov", "prefetched", "prefetched", "markov",
                 "fixed")
        make = {"fixed": lambda: fixed, "markov": markov,
                "prefetched": prefetched}
        for _ in range(args.rounds):
            for name in order:
                secs[name].append(step(make[name]())[0])
    finally:
        pf.close()
    out = {name: {"median_s": float(np.median(v)), "seconds": v,
                  "tokens_per_s": B * S / float(np.median(v))}
           for name, v in secs.items()}
    ids = src.batch(1)["tokens"]
    print(json.dumps({"loop_step_ab": out, "batch": [B, S],
                      "distinct_ids_markov": int(np.unique(ids).size),
                      "distinct_ids_fixed": int(torch.unique(
                          fixed["tokens"]).numel())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
