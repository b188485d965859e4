"""Training driver: the port's copy of the reference's ``launch/train.py``,
on one card (or the CPU when asked for). It runs real steps of
``steps.train_step`` with:

  * deterministic restart-safe data (step-indexed batches from
    ``SyntheticLM``, made ahead by the ``Prefetcher``'s thread and
    uploaded in the loop's),
  * log-structured async checkpointing (DINOMO T4) + resume: the
    checkpoints are the reference's files, so a run of either package
    resumes from the other's,
  * elastic re-own on resume: the same checkpoint bytes are loaded onto
    whichever device runs the job (ownership remap, no data rewrite);
    the reference's host mesh has no counterpart on one card,
  * simulated failure injection (--fail-at) proving recovery works.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt CKPT_DIR [--resume] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import state
from ..checkpoint import CheckpointStore
from ..configs import get_config, get_smoke_config
from ..data.lm_data import Prefetcher, SyntheticLM
from ..device import resolve_device
from ..models.model_zoo import build_model
from ..optim.adamw import AdamWConfig, init_state
from . import steps as step_fns


def upload(batch: dict, dev) -> dict:
    """A host batch of numpy arrays on ``dev`` as the port's losses take
    it: ``tokens`` and ``labels`` int64 (as ``model_zoo.make_batch`` gives
    them), ``frames`` float32."""
    return {k: torch.from_numpy(v).to(
        dev, torch.int64 if np.issubdtype(v.dtype, np.integer)
        else torch.float32) for k, v in batch.items()}


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
          resume: bool = False, fail_at: int | None = None,
          log_every: int = 10, lr: float = 3e-4, seed: int = 0,
          device=None):
    """``steps`` training steps of ``arch`` (its smoke config unless
    ``smoke`` is False) on ``device`` (the card unless ``"cpu"``), from
    step 0 or, with ``resume``, from the latest valid checkpoint in
    ``ckpt_dir``. A checkpoint is saved after every step i + 1 that is a
    multiple of max(log_every, 10); ``fail_at`` raises after step
    ``fail_at`` runs (before its save), and the run ends there. Returns
    (params, opt_state, the logged losses)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = cfg.replace(loss_chunk=min(seq, 512))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=max(steps, 1))
    params = build_model(cfg).init(seed, device=dev)
    opt_state = init_state(params)
    start_step = 0
    store = None
    if ckpt_dir:
        store = CheckpointStore(ckpt_dir)
        latest = store.latest_valid() if resume else None
        if latest is not None:
            template = state.checkpoint_template(params, opt_state, cfg)
            del params, opt_state
            tree, _, start_step = store.restore(template, step=latest,
                                                device=dev)
            params, opt_state = state.from_checkpoint(tree, cfg, dev)
            del tree
            print(f"[train] resumed from step {start_step} "
                  f"(elastic re-own onto {dev})")

    src = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                      encdec_d_model=cfg.d_model
                      if cfg.encoder_layers else 0)
    pf = Prefetcher(src, start_step=start_step)
    losses = []
    t0 = time.time()
    try:
        for i in range(start_step, start_step + steps):
            step_idx, b = pf.next()
            if step_idx != i:
                raise AssertionError(f"the prefetcher gave step {step_idx} "
                                     f"for step {i}")
            b = upload(b, dev)
            params, opt_state, metrics = step_fns.train_step(
                params, opt_state, b, cfg, opt_cfg)
            if fail_at is not None and i == fail_at:
                raise RuntimeError("injected failure")
            if (i + 1) % log_every == 0 or i == start_step:
                loss = float(metrics["loss"])
                losses.append(loss)
                print(f"[train] step {i + 1} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f}")
            if store and (i + 1) % max(log_every, 10) == 0:
                store.save(i + 1, state.checkpoint_tree(params, opt_state,
                                                        cfg))
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
        print(f"[train] simulated failure at step {fail_at}; "
              "restart with --resume to recover from the last "
              "sealed checkpoint")
    finally:
        pf.close()
        if store:
            store.wait()
    dt = time.time() - t0
    print(f"[train] {steps} steps in {dt:.1f}s "
          f"({steps / max(dt, 1e-9):.2f} it/s)")
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, ckpt_dir=args.ckpt, resume=args.resume,
          fail_at=args.fail_at, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
