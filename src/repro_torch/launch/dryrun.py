"""Dry run: every (architecture x input shape) cell at its full size, on
the meta device -- the port's copy of the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell's step on a forced 512-way
host platform and reads XLA's memory and cost analyses and the post-SPMD
HLO. The port has no compiler to ask: it builds the cell's bundle
(``launch/steps.py``) and runs its ``fn`` once on the bundle's meta
stand-ins under ``op_analysis.analyze``. Meta tensors carry shapes and
types and no data, so the whole step (the train step's backward and
AdamW included) dispatches every operation and computes nothing; the
kernels' wrappers take their plain versions there, as the reference
lowers its jnp paths off the TPU. A decode step's position is the last
slot of its cache (a meta tensor has no value to read).

Record keys are the reference's; in the port they mean:

  devices, mesh        the production mesh's (16x16 or 2x16x16)
  step                 the bundle's name
  lower_s, compile_s   seconds to build the bundle, and to run it on meta
  flops, bytes         the whole step's matrix-product FLOPs and traffic
                       bytes (op_analysis)
  flops_per_device,    those divided by the devices: the port has no
  bytes_per_device     partitioner, so an even split is assumed
  collective_bytes,    0 and {}: nothing is partitioned, so no collective
  collectives          is inserted
  xla_flops_per_device,
  xla_bytes_per_device None: there is no compiler's own count
  memory.argument_bytes, output_bytes
                       one device's share of the step's arguments and
                       outputs under the bundle's shardings, exact: each
                       leaf's shard shape from the partition rules
  memory.temp_bytes    the most bytes the whole step holds at once beyond
                       its arguments, on one device (op_analysis'
                       peak_bytes), not divided
  memory.alias_bytes   one device's share of the outputs that are
                       arguments updated in place (the reference's donated
                       buffers)

``long_500k`` is skipped for the pure full-attention families, exactly as
in the reference (``"SKIP(full-attn)"``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape decode_32k [--multi-pod] [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8]
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import sys
import time

import torch

from ..configs import ALIASES, ARCHS, SHAPES, get_config
from ..configs.base import ShapeConfig
from ..distributed.sharding import NamedSharding, make_rules, tree_leaves
from .mesh import Mesh, make_production_mesh
from .op_analysis import analyze
from .steps import build_decode_step, build_step

# long_500k needs sub-quadratic sequence handling: run for ssm/hybrid,
# skip for pure full-attention archs (as the reference)
LONG_OK_FAMILIES = ("ssm", "hybrid")
# a number in a state tree (the encoder-decoder cache's enc_len) is an
# int32 scalar in the reference's
SCALAR_BYTES = 4


def _leaf_bytes(leaf, sharding: NamedSharding) -> int:
    if not isinstance(leaf, torch.Tensor):
        return SCALAR_BYTES
    return math.prod(sharding.shard_shape(leaf.shape)) * leaf.element_size()


def _pairs(tree, shardings):
    """(leaf, its sharding) over ``tree``; a single sharding covers a
    whole subtree."""
    if isinstance(shardings, NamedSharding):
        for leaf in tree_leaves(tree):
            yield leaf, shardings
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], shardings[k])
    else:
        for t, s in zip(tree, shardings, strict=True):
            yield from _pairs(t, s)


def per_device_bytes(tree, shardings, only=None) -> int:
    """One device's bytes of ``tree`` under ``shardings``; with ``only``,
    of the leaves for which ``only(leaf)`` holds."""
    return sum(_leaf_bytes(leaf, sh) for leaf, sh in _pairs(tree, shardings)
               if only is None or only(leaf))


def _storage_ids(tree) -> set:
    return {id(t.untyped_storage()) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             bundle_override=None,
             shape: ShapeConfig | None = None,
             mesh: Mesh | None = None) -> dict:
    """The record of one cell. ``shape`` and ``mesh`` replace the named
    shape and the production mesh (a cut cell, or the one card's (1, 1)
    mesh)."""
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    if shape_name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return {"arch": arch, "shape": shape_name,
                "status": "SKIP(full-attn)"}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(mesh)
    t0 = time.perf_counter()
    bundle = (bundle_override or build_step)(cfg, shape, rules)
    t_lower = time.perf_counter() - t0
    args = list(bundle.in_specs)
    if bundle.name == "serve_step":
        args[3] = shape.seq_len - 1
    held = _storage_ids(tuple(args))
    t0 = time.perf_counter()
    totals = analyze(bundle.fn, *args)
    t_run = time.perf_counter() - t0
    devices = mesh.size
    rec = {
        "arch": arch, "shape": shape_name, "status": "OK",
        "mesh": "x".join(map(str, mesh.sizes)), "devices": devices,
        "step": bundle.name,
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "flops": totals.flops, "bytes": totals.bytes,
        "flops_per_device": totals.flops / devices,
        "bytes_per_device": totals.bytes / devices,
        "collective_bytes": totals.collective_bytes,
        "collectives": totals.collectives,
        "xla_flops_per_device": None, "xla_bytes_per_device": None,
        "ops": totals.ops,
        "traffic_breakdown": dict(list(
            totals.traffic_breakdown.items())[:8]),
        "memory": {
            "argument_bytes": per_device_bytes(bundle.in_specs,
                                               bundle.in_shardings),
            "output_bytes": per_device_bytes(totals.outputs,
                                             bundle.out_shardings),
            "temp_bytes": totals.peak_bytes,
            "alias_bytes": per_device_bytes(
                totals.outputs, bundle.out_shardings,
                only=lambda t: isinstance(t, torch.Tensor)
                and id(t.untyped_storage()) in held),
        },
    }
    mem = rec["memory"]
    print(f"[dryrun] {arch} x {shape_name} ({rec['mesh']}): "
          f"run {t_run:.0f}s, {totals.ops} ops")
    print(f"  memory: args={mem['argument_bytes'] / 1e9:.2f}GB"
          f" out={mem['output_bytes'] / 1e9:.2f}GB (per device)"
          f" temp={mem['temp_bytes'] / 1e9:.2f}GB (one device, whole step)")
    print(f"  flops={totals.flops:.3e} bytes={totals.bytes:.3e} "
          f"(per device {rec['flops_per_device']:.3e} / "
          f"{rec['bytes_per_device']:.3e})", flush=True)
    return rec


def _optimized_override(cfg, shape, rules):
    """§Perf variants: head-sharded attention (set in the worker) and the
    pool-invariant decode."""
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, rules, optimized=True)
    return build_step(cfg, shape, rules)


def _cell(job) -> dict:
    """``run_cell(arch, shape_name, **kw)`` of a job (arch, shape_name,
    kw); a failure is recorded, not raised. ``kw["optimized"]`` turns on
    the §Perf variants."""
    arch, shape, kw = job
    kw = dict(kw)
    if kw.pop("optimized", False):
        from ..kernels.flash_attention.ops import set_head_sharded_attention
        set_head_sharded_attention(True)
        kw["bundle_override"] = _optimized_override
    try:
        return run_cell(arch, shape, **kw)
    except Exception as e:  # a dry-run failure is a bug in our system
        print(f"[dryrun] FAIL {arch} x {shape}: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return {"arch": arch, "shape": shape, "status": "FAIL",
                "error": f"{type(e).__name__}: {e}"}


def run_cells(jobs, processes: int = 1) -> list[dict]:
    """The records of ``jobs`` ((arch, shape_name, run_cell's keyword
    arguments)), in order, over ``processes`` worker processes (started
    fresh: the cells share nothing)."""
    if processes <= 1:
        return [_cell(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes) as pool:
        return pool.map(_cell, jobs, chunksize=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id (e.g. qwen1.5-0.5b)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--optimized", action="store_true",
                    help="§Perf variants: head-sharded attention + "
                         "pool-invariant decode")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (the cells are independent)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape required (or --all)")
    os.makedirs(args.out, exist_ok=True)
    kw = {"multi_pod": args.multi_pod, "optimized": args.optimized}
    recs = run_cells([(a, s, kw) for a, s in cells], args.jobs)
    failures = 0
    for (arch, shape), rec in zip(cells, recs):
        key = ALIASES.get(arch, arch)
        suffix = ("opt_" if args.optimized else "") + \
            ("mp" if args.multi_pod else "sp")
        failures += rec["status"] == "FAIL"
        with open(os.path.join(args.out, f"{key}__{shape}__{suffix}.json"),
                  "w") as f:
            json.dump(rec, f, indent=2)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
