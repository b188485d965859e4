"""Batched serving on the DINOMO paged KV-cache store, on the PyTorch
port: the twin of examples/serve_paged.py, on the card unless --device
cpu.

Shows the full serving story: shared-prefix admission (selective
replication of hot prompt pages), owner-partitioned decode attention,
and mid-flight worker reconfiguration with identical logits and zero
page movement.

Run:  PYTHONPATH=src python examples/serve_paged_torch.py [--device cpu]
"""

import argparse

from repro_torch.launch.serve import main as serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    serve(["--arch", "qwen1.5-0.5b", "--requests", "6",
           "--prompt-len", "24", "--decode-steps", "8",
           "--reconfig-at", "3"]
          + (["--device", args.device] if args.device else []))


if __name__ == "__main__":
    main()
