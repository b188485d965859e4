"""DINOMO elasticity end-to-end on the PyTorch port: autoscaling, hot
keys, failure. The twin of examples/kvs_elasticity.py, on the card
unless --device cpu.

Reproduces the paper's Sec. 5.3 scenarios in one run with the timed
simulator (policy engine + reconfiguration protocol on real data
structures). ``--smoke`` cuts the keys and the timeline tenfold.

Run:  PYTHONPATH=src python examples/kvs_elasticity_torch.py [--device cpu]
"""

import argparse

from repro_torch.core import (DINOMO, DinomoCluster, PolicyConfig,
                              TimedSimulation)
from repro_torch.data import Workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="5,000 keys and a 17 s timeline")
    args = ap.parse_args(argv)
    keys, t = (5_000, 0.1) if args.smoke else (50_000, 1.0)

    cluster = DinomoCluster(DINOMO, num_kns=2, cache_bytes=1 << 21,
                            num_buckets=1 << 16, segment_capacity=512,
                            vnodes=8,
                            policy=PolicyConfig(grace_period_s=20.0 * t,
                                                epoch_s=5.0 * t, max_kns=8,
                                                min_kns=2),
                            device=args.device)
    cluster.load((k, f"v{k}") for k in range(keys))
    w = Workload(num_keys=keys, zipf=0.99, mix="write_heavy_update")
    sim = TimedSimulation(cluster, w.timed, dt=1.0 * t, sample_ops=500,
                          dataset_bytes=32e9)

    print("== phase 1: 7x load burst -> M-node adds KNs ==")
    sim.run(90 * t, lambda now: 8e6 if now >= 15 * t else 1.1e6)
    print(f"   KNs now: {len(cluster.kns)} (started with 2)")

    print("== phase 2: failure injection -> fast ownership failover ==")
    victim = sorted(cluster.kns)[0]
    window = sim.inject_failure(victim)
    print(f"   {victim} failed; recovery window {window * 1e3:.0f} ms "
          "(merge pending logs + re-map ownership; no data copied)")
    sim.run(110 * t, lambda now: 8e6)

    print("== phase 3: load drops -> M-node removes an idle KN ==")
    sim.run(170 * t, lambda now: 2e5)
    print(f"   KNs now: {len(cluster.kns)}")

    print("== timeline (t, kns, throughput, p99 ms) ==")
    for p in sim.trace[::15]:
        print(f"   t={p.t:5.1f}  kns={p.num_kns}  "
              f"tput={p.throughput:9.2e}  p99={p.p99_latency * 1e3:7.1f}")
    print("reconfigurations:",
          [(r['event'], r['node']) for r in cluster.reconfig_log])


if __name__ == "__main__":
    main()
