"""The control of the benchmark's comparison: the plain reference put in
the program's place with its value rows kept as float32, the narrower
type a store might be tempted to keep 32-bit lanes in. A value of more
than 24 significant bits comes back changed, which breaks the
configuration's guarantee that a read returns its write bit for bit, so
every cell has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3

runs the cell once a seed with the control in the program's place and
prints each run's checks; exits 0 only if every run came out not
correct. The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402


class ControlStore:
    """A last-write-wins map of the dense keyspace whose rows are float32."""

    def __init__(self, cfg: dict, device):
        self.n = 1 << cfg["records_log2"]
        self.lanes = cfg["value_lanes"]
        self.device = torch.device(device)
        self.rows = self.present = None

    def build(self) -> None:
        pass

    @staticmethod
    def counters() -> dict:
        return {}

    def create(self) -> None:
        self.rows = torch.zeros((self.n, self.lanes), dtype=torch.float32,
                                device=self.device)
        self.present = torch.zeros(self.n, dtype=torch.bool,
                                   device=self.device)

    def release(self) -> None:
        self.rows = self.present = None

    def write(self, keys: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        k = keys.long()
        self.rows[k] = values.to(torch.float32)
        self.present[k] = True
        return torch.ones(keys.numel(), dtype=torch.bool, device=self.device)

    def read(self, keys: torch.Tensor):
        k = keys.long()
        found = self.present[k]
        vals = torch.where(found[:, None], self.rows[k], 0.0)
        return vals.to(torch.int32), found


def main(argv=None) -> int:
    from portbench import harness
    ap = argparse.ArgumentParser(description="the benchmark's control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run_cell(args.workload, seed, args.seconds, False,
                                store_cls=ControlStore)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "compared": line["compared"],
                          "checks": line["checks"]}), flush=True)
        wrong += line["correct"]
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
