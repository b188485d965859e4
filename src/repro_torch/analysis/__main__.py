"""CLI: ``python -m repro_torch.analysis [--root] [--strict]
[--write-baseline --justify] [--pass]``."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import (BASELINE_PATH, Corpus, load_baseline, repo_root,
               run_passes, unjustified, write_baseline)
from .passes import ALL_PASSES, BY_NAME


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's invariant lints (see the repro_torch."
                    "analysis docstring for the pass catalog)")
    ap.add_argument("--root", type=Path, default=None,
                    help="tree to analyze (default: this checkout)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather current findings into the baseline "
                         "(requires --justify with a real reason)")
    ap.add_argument("--justify", default="",
                    help="one-line justification stamped on every entry "
                         "--write-baseline records (placeholder text is "
                         "rejected; strict runs fail unjustified entries)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=sorted(BY_NAME), default=None,
                    help="run only the named pass (repeatable)")
    args = ap.parse_args(argv)

    corpus = Corpus(args.root or repo_root())
    passes = [BY_NAME[p] for p in args.passes] if args.passes \
        else list(ALL_PASSES)
    findings = run_passes(corpus, passes)

    if args.write_baseline:
        try:
            write_baseline(findings, justification=args.justify)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"wrote {len(findings)} finding(s) to {BASELINE_PATH}")
        return 0

    baseline = load_baseline()
    # an entry whose justification is blank or still the placeholder does
    # not shield its finding: strict treats it as fresh
    shielded = {fp for fp, entry in baseline.items()
                if not unjustified(entry)}
    fresh = [f for f in findings if f.fingerprint not in shielded]
    grandfathered = [f for f in findings if f.fingerprint in shielded]
    for f in fresh:
        tag = " [baselined without justification]" \
            if f.fingerprint in baseline else ""
        print(f.render() + tag)
    for f in grandfathered:
        just = baseline[f.fingerprint].get("justification", "")
        print(f"{f.render()} [baselined: {just}]")
    for fp in sorted(set(baseline) - {f.fingerprint for f in findings}):
        print(f"note: baseline entry {fp} no longer fires; remove it "
              f"from {BASELINE_PATH.name}")

    print(f"{len(findings)} finding(s) from {len(passes)} pass(es); "
          f"{len(fresh)} new, {len(grandfathered)} baselined")
    if args.strict and fresh:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
