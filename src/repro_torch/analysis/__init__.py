"""The port's static analysis (``python -m repro_torch.analysis``).

The port keeps the reference's correctness conventions -- pure planning
halves, a closed registry of crash points, fenced DPM mutations, seeded
determinism, plain versions beside every kernel, dead deprecated shims --
and adds its own: a kernel wrapper reads no environment switch and never
falls back to its plain version. Generic linters see none of these. This
package checks them by AST: each pass in :mod:`repro_torch.analysis.passes`
walks the parsed tree of the files it concerns and emits
:class:`Finding` objects with a *stable fingerprint* (hashed from the
pass, file, symbol and detail -- never the line number, so findings
survive unrelated line drift). The recipe is the reference's
(``src/repro/analysis``), so one finding has one fingerprint in both
packages.

Workflow:

- ``python -m repro_torch.analysis``          report all findings
- ``python -m repro_torch.analysis --strict`` exit 1 on any finding whose
  fingerprint is not justified in ``baseline.json``
- ``python -m repro_torch.analysis --write-baseline --justify "..."``
  grandfather the current findings, each with a one-line justification

The committed baseline stays empty: a finding is fixed when it is
introduced; only an intentional, justified exception may live there.

The package imports the standard library alone (``ast``, ``hashlib``,
``json``, ``pathlib``, ``dataclasses``; ``argparse`` and ``sys`` for the
CLI): no torch and nothing of the reference, so it runs wherever the
port's sources are, the card's machine included.
"""

from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Finding", "Corpus", "run_passes", "load_baseline",
           "write_baseline", "repo_root", "BASELINE_PATH",
           "PLACEHOLDER_JUSTIFICATION", "unjustified", "PORT_PACKAGE",
           "PORT_TESTS"]

BASELINE_PATH = Path(__file__).with_name("baseline.json")

#: the stamp older baselines carried for every grandfathered entry; a
#: justification equal to it (or blank) is treated as absent
PLACEHOLDER_JUSTIFICATION = "TODO: justify or fix"

#: the package a corpus analyzes by default: the port
PORT_PACKAGE = "src/repro_torch"
#: the top-level test files that count as the port's tests
PORT_TESTS = ("tests/test_torch_*.py", "tests/torch_*cases.py")


def unjustified(entry: dict) -> bool:
    """True when a baseline entry lacks a real justification (missing,
    blank, or still the write-baseline placeholder)."""
    just = str(entry.get("justification", "")).strip()
    return not just or just == PLACEHOLDER_JUSTIFICATION


def repo_root() -> Path:
    """The repo checkout this package was imported from
    (``src/repro_torch/analysis`` -> three levels up)."""
    return Path(__file__).resolve().parents[3]


@dataclass(frozen=True)
class Finding:
    """One invariant violation.

    ``symbol`` is the stable anchor (function / member / call target)
    the finding is about; the fingerprint hashes ``pass:file:symbol:
    detail`` so it survives line renumbering but changes when the
    violation itself changes."""

    pass_name: str
    file: str                   # path relative to the analyzed root
    line: int
    severity: str               # "error" | "warn"
    symbol: str
    message: str
    detail: str = ""            # extra fingerprint discriminator

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.pass_name}:{self.file}:{self.symbol}:{self.detail}"
            .encode()).hexdigest()
        return h[:12]

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.pass_name}] "
                f"{self.severity}: {self.message} "
                f"(fp={self.fingerprint})")


@dataclass
class Corpus:
    """Lazy, cached view of the files a run analyzes.

    Rooted at a repo checkout (the real tree or a test's tree with the
    same ``src/<package>`` / ``tests`` shape). ``package`` is the package
    the passes hold to their rules; ``tests`` the glob patterns, relative
    to ``root`` and never recursive, of the top-level files that count as
    its tests; ``extra_scopes`` the directories beside the package that
    the determinism and deprecation passes read too (the reference's
    analysis reads ``benchmarks``; the port's reads its package alone).
    With ``package="src/repro"``, ``tests=("tests/*.py",)`` and
    ``extra_scopes=("benchmarks",)`` a corpus is the reference's. Passes
    only ever go through these accessors, so test trees and the real tree
    are analyzed alike."""

    root: Path
    package: str = PORT_PACKAGE
    tests: tuple = PORT_TESTS
    extra_scopes: tuple = ()
    _cache: dict = field(default_factory=dict)

    def read(self, rel: str) -> str | None:
        """Source of ``root/rel``, or None if absent."""
        ent = self._entry(rel)
        return ent[0] if ent else None

    def tree(self, rel: str) -> ast.AST | None:
        """Parsed AST of ``root/rel``, or None if absent/unparsable."""
        ent = self._entry(rel)
        return ent[1] if ent else None

    def _entry(self, rel: str):
        if rel not in self._cache:
            p = self.root / rel
            if not p.is_file():
                self._cache[rel] = None
            else:
                src = p.read_text()
                try:
                    self._cache[rel] = (src, ast.parse(src, filename=rel))
                except SyntaxError:
                    self._cache[rel] = (src, None)
        return self._cache[rel]

    @property
    def files_read(self) -> int:
        """How many distinct files the passes have read so far."""
        return sum(ent is not None for ent in self._cache.values())

    def py_files(self, sub: str) -> list[str]:
        """Sorted relative paths of ``.py`` files under ``root/sub``."""
        base = self.root / sub
        if not base.is_dir():
            return []
        return sorted(str(p.relative_to(self.root))
                      for p in base.rglob("*.py"))

    def test_files(self) -> list[str]:
        """Sorted relative paths of the files matching ``tests``: a glob
        never descends, so the fixture trees below ``tests/fixtures``
        stay out of a real-tree run."""
        found = {str(p.relative_to(self.root))
                 for pattern in self.tests
                 for p in self.root.glob(pattern) if p.is_file()}
        return sorted(found)

    def named_in_tests(self, name: str) -> bool:
        """Whether ``name`` appears in the text of any test file."""
        return any(name in (self.read(rel) or "")
                   for rel in self.test_files())

    def pkg(self, rel: str) -> str:
        """``rel`` inside the package: ``pkg("core/faults.py")``."""
        return f"{self.package}/{rel}"


def run_passes(corpus: Corpus, passes=None) -> list[Finding]:
    from .passes import ALL_PASSES
    out: list[Finding] = []
    for mod in (passes if passes is not None else ALL_PASSES):
        out.extend(mod.run(corpus))
    return sorted(out, key=lambda f: (f.file, f.line, f.pass_name))


def load_baseline(path: Path = BASELINE_PATH) -> dict[str, dict]:
    if not path.is_file():
        return {}
    data = json.loads(path.read_text())
    return data.get("findings", {})


def write_baseline(findings: list[Finding],
                   path: Path = BASELINE_PATH,
                   justification: str = "") -> None:
    """Grandfather ``findings`` into the baseline. ``justification`` must
    be a real one-liner: an entry whose justification is blank or the
    placeholder fails strict runs (:func:`unjustified`), so writing one
    is refused."""
    just = str(justification).strip()
    if findings and (not just or just == PLACEHOLDER_JUSTIFICATION):
        raise ValueError(
            "baseline entries need a real justification; pass one via "
            "--justify (placeholder text is rejected)")
    data = {
        "comment": "Grandfathered findings. Every entry needs a one-line"
                   " justification; fix-and-remove beats justifying.",
        "findings": {
            f.fingerprint: {
                "pass": f.pass_name, "file": f.file, "symbol": f.symbol,
                "message": f.message,
                "justification": just,
            } for f in findings
        },
    }
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
