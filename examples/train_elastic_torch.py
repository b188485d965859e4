"""End-to-end elastic training driver on the PyTorch port: the twin of
examples/train_elastic.py, on the card unless --device cpu.

Trains qwen1.5-0.5b (smoke width) on the synthetic Markov LM stream
with log-structured async checkpointing, injects a failure, and resumes
from the last sealed checkpoint -- the training-side realization of
DINOMO's reconfiguration story. The checkpoints are the reference's
files: examples/train_elastic.py could resume from them.

Run:  PYTHONPATH=src python examples/train_elastic_torch.py [--steps 200]
"""

import argparse
import shutil
import tempfile

from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--resume-steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run = dict(batch=args.batch, seq=args.seq, log_every=20,
               device=args.device)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_ck_")
    try:
        print(f"== phase 1: train {args.steps} steps "
              f"(failure injected at {args.steps - 5}) ==")
        train(args.arch, steps=args.steps, ckpt_dir=ckpt,
              fail_at=args.steps - 5, **run)

        print("== phase 2: restart + resume from last sealed "
              "checkpoint ==")
        _, _, losses = train(args.arch, steps=args.resume_steps,
                             ckpt_dir=ckpt, resume=True, **run)
        print(f"final loss {losses[-1]:.4f} "
              "(loss continues to improve across the failure)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
