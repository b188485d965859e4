"""Training driver: the port's copy of the reference's ``launch/train.py``,
on one card (or the CPU when asked for), or on a mesh of ranks. It runs
real steps of ``steps.build_train_step``'s step with:

  * deterministic restart-safe data (step-indexed batches from
    ``SyntheticLM``, made ahead by the ``Prefetcher``'s thread and
    uploaded in the loop's),
  * log-structured async checkpointing (DINOMO T4) + resume: the
    checkpoints are the reference's files, so a run of either package
    resumes from the other's,
  * elastic re-own on resume: the same checkpoint bytes are loaded onto
    whichever device runs the job (ownership remap, no data rewrite);
    the host mesh is the (1, 1) mesh over that device, or in a world of
    more ranks the reference's (n/2, 2) mesh of ranks: there each rank
    holds its blocks of the state by their train specs, the prefetcher
    gives it its block of every batch, the step is the partitioned one,
    and the checkpoints are saved gathered and restored each rank its
    blocks (``CheckpointStore.save`` / ``restore`` with shardings),
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
import torch.distributed as dist

from .. import state
from ..checkpoint import CheckpointStore
from ..configs import get_config, get_smoke_config
from ..configs.base import ShapeConfig
from ..data.lm_data import Prefetcher, SyntheticLM
from ..device import resolve_device
from ..distributed.sharding import make_rules, param_shardings, place
from ..models.model_zoo import build_model
from ..optim.adamw import AdamWConfig, init_state, tree_map
from . import steps as step_fns
from .mesh import Mesh, make_mesh


def make_host_mesh(device=None) -> Mesh:
    """The reference's host mesh: in an initialised world of n > 1 ranks
    the (n // 2, n // (n // 2)) ("data", "model") mesh of ranks
    (``make_mesh``, this rank on ``device``); otherwise the (1, 1) mesh over
    ``device`` (the card unless ``"cpu"`` or ``"meta"``), one process
    driving one device."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        n = dist.get_world_size()
        d = max(n // 2, 1)
        return make_mesh((d, n // d), ("data", "model"), device=device)
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))


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
          device=None, dtype=None):
    """``steps`` training steps of ``arch`` (its smoke config unless
    ``smoke`` is False) on ``device`` (the card unless ``"cpu"``), from
    step 0 or, with ``resume``, from the latest valid checkpoint in
    ``ckpt_dir``. A checkpoint is saved after every step i + 1 that is a
    multiple of max(log_every, 10); ``fail_at`` raises after step
    ``fail_at`` runs (before its save), and the run ends there. Each
    step is ``build_train_step``'s on the host mesh. ``dtype``
    torch.float32 makes every parameter f32 (the model's types unless
    given). Returns (params, opt_state, the logged losses): on a mesh of
    ranks, this rank's blocks of the state, which every rank calls
    ``train`` for; the rank of coordinate 0 alone prints."""
    mesh = make_host_mesh(device)
    dev = mesh.device
    rules = make_rules(mesh)
    say = print if mesh.place is None or dist.get_rank() == 0 \
        else (lambda *_: None)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = cfg.replace(loss_chunk=min(seq, 512))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=max(steps, 1))
    bundle = step_fns.build_train_step(
        cfg, ShapeConfig("custom", seq, batch, "train"), rules, opt_cfg)
    step_fn = bundle.fn
    params = build_model(cfg).init(seed, device=dev)
    if dtype is not None:
        params = tree_map(lambda t: t.to(dtype), params)
    opt_state = init_state(params)
    template = state.checkpoint_template(params, opt_state, cfg)
    # one process calls the store as it always has; a mesh of ranks adds
    # the checkpoint's shardings, f32 parameters their type
    sharded = {}
    typed = {} if dtype is None else {"dtype": dtype}
    cut = None
    if mesh.place is not None:
        p_sh, o_sh, b_sh = bundle.in_shardings
        params, opt_state = place(params, p_sh), place(opt_state, o_sh)
        sharded = {"shardings": param_shardings(template, rules, "train")}

        def cut(host):
            """The rank's block of a host batch (rows and sequence)."""
            return {k: np.ascontiguousarray(
                b_sh[k].local(torch.from_numpy(v)).numpy())
                for k, v in host.items()}
    start_step = 0
    store = None
    if ckpt_dir:
        store = CheckpointStore(ckpt_dir)
        latest = store.latest_valid() if resume else None
        if latest is not None:
            del params, opt_state
            tree, _, start_step = store.restore(template, step=latest,
                                                device=dev, **sharded)
            params, opt_state = state.from_checkpoint(tree, cfg, dev, **typed)
            del tree
            say(f"[train] resumed from step {start_step} "
                f"(elastic re-own onto {dev})")

    src = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                      encdec_d_model=cfg.d_model
                      if cfg.encoder_layers else 0)
    pf = Prefetcher(src, start_step=start_step, local=cut)
    losses = []
    t0 = time.time()
    try:
        for i in range(start_step, start_step + steps):
            step_idx, b = pf.next()
            if step_idx != i:
                raise AssertionError(f"the prefetcher gave step {step_idx} "
                                     f"for step {i}")
            b = upload(b, dev)
            params, opt_state, metrics = step_fn(params, opt_state, b)
            if fail_at is not None and i == fail_at:
                raise RuntimeError("injected failure")
            if (i + 1) % log_every == 0 or i == start_step:
                loss = float(metrics["loss"])
                losses.append(loss)
                say(f"[train] step {i + 1} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"gnorm {float(metrics['grad_norm']):.2f}")
            if store and (i + 1) % max(log_every, 10) == 0:
                store.save(i + 1, state.checkpoint_tree(params, opt_state,
                                                        cfg), **sharded)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
        say(f"[train] simulated failure at step {fail_at}; "
            "restart with --resume to recover from the last "
            "sealed checkpoint")
    finally:
        pf.close()
        if store:
            store.wait()
    dt = time.time() - t0
    say(f"[train] {steps} steps in {dt:.1f}s "
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
