"""Quickstart on the PyTorch port: the twin of examples/quickstart.py, on
the card unless --device cpu.

  1. DINOMO core      -- the paper's KV store with exact RT accounting
  2. model zoo        -- any assigned arch, a train loss + a decode step
  3. paged serving    -- the KV cache *as* a DINOMO store

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import DINOMO, DinomoCluster
from repro_torch.launch.serve import PagedServer
from repro_torch.models.model_zoo import build_model, make_batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    # ------------------------------------------------------------ 1. KVS
    cluster = DinomoCluster(DINOMO, num_kns=4, cache_bytes=1 << 20,
                            num_buckets=1 << 14, segment_capacity=256,
                            device=dev)
    cluster.load((k, f"value-{k}") for k in range(10_000))
    cluster.write(42, "hello-dpm")
    value, rts, ok = cluster.read(42)
    print(f"[kvs] read key 42 -> {value!r} in {rts} network RTs")
    cluster.add_kn()                     # elastic scale-out: ownership only
    value, _, _ = cluster.read(42)
    assert value == "hello-dpm"
    print(f"[kvs] after adding a KN (zero data moved): still {value!r}")

    # --------------------------------------------------------- 2. models
    cfg = get_smoke_config("olmoe-1b-7b")          # any of the 10 archs
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batch = make_batch(cfg, batch=4, seq=32, device=dev)
    loss, _ = model.loss(params, batch)
    print(f"[model] {cfg.name}: one train-step loss = {float(loss):.3f}")

    cache = model.init_cache(4, 64, device=dev)
    with torch.no_grad():
        logits, cache = model.decode_step(params, cache,
                                          batch["tokens"][:, 0], 0)
    print(f"[model] decode step -> logits {tuple(logits.shape)}")

    # --------------------------------------------------- 3. paged serving
    srv = PagedServer("qwen1.5-0.5b", page_size=8, device=dev)
    prompt = [int(t) for t in np.random.default_rng(0).integers(
        0, srv.cfg.vocab_size, 20)]
    sid, _ = srv.admit(prompt)
    out = srv.decode(sid, steps=5)
    print(f"[serve] decoded {out} over the DINOMO page pool "
          f"(workers={srv.ctl.workers})")
    srv.reconfigure(add="w2")            # elastic serving: zero pages moved
    print(f"[serve] scaled serving workers to {srv.ctl.workers}; "
          f"page tables re-mapped, pool untouched")


if __name__ == "__main__":
    main()
