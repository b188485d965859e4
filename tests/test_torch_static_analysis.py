"""The port's static analysis (``src/repro_torch/analysis``) against the
reference's (``src/repro/analysis``), its own rules on seeded trees, and
the real tree clean under it.

Parity: on every fixture tree of ``tests/fixtures/analysis/`` (laid out as
``src/repro``), each of the port's six passes, given a corpus with the
reference's layout (``package="src/repro"``, every top-level
``tests/*.py``, ``benchmarks`` read beside the package), gives the
reference pass' findings line for line, fingerprints included. The
fixture trees are read, never written.

The port's own rules (env read or plain-version fallback in a kernel
module, torch's global generator) each fire once on a seeded tree under
``tmp_path`` laid out as ``src/repro_torch`` and never on its clean twin.

The crash-point registry twin names every declared point, so the
analysis' test-coverage rule holds over the port's own test files."""

import ast
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import Corpus as RefCorpus  # noqa: E402
from repro.analysis import Finding as RefFinding  # noqa: E402
from repro.analysis.passes import BY_NAME as REF_PASSES  # noqa: E402
from repro_torch.analysis import (PLACEHOLDER_JUSTIFICATION,  # noqa: E402
                                  Corpus, Finding, load_baseline, repo_root,
                                  run_passes, unjustified, write_baseline)
from repro_torch.analysis.passes import (ALL_PASSES, BY_NAME,  # noqa: E402
                                         determinism, kernel_hygiene)
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core.dpm_pool import DPMPool  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
# fixture tree -> the pass it seeds
SEEDED = {"purity": "plan-purity", "crashpoints": "crash-points",
          "fence_coverage": "fence-coverage", "determinism": "determinism",
          "kernels": "kernel-hygiene", "deprecations": "deprecations"}
# the analysis modules, which import the standard library alone
ANALYSIS_FILES = sorted((REPO / "src/repro_torch/analysis").rglob("*.py"))
STDLIB = {"__future__", "argparse", "ast", "dataclasses", "hashlib", "json",
          "pathlib", "sys"}


def reference_layout(root: Path) -> Corpus:
    """A port corpus that reads a tree as the reference's analysis does."""
    return Corpus(root, package="src/repro", tests=("tests/*.py",),
                  extra_scopes=("benchmarks",))


def rows(findings) -> list[tuple]:
    return [(f.pass_name, f.file, f.line, f.symbol, f.detail, f.fingerprint)
            for f in findings]


def expected_fp(pass_name, file, symbol, detail):
    """The fingerprint recipe, recomputed independently."""
    return hashlib.sha256(
        f"{pass_name}:{file}:{symbol}:{detail}".encode()).hexdigest()[:12]


def test_the_six_passes_are_the_references():
    assert [m.NAME for m in ALL_PASSES] == list(REF_PASSES)
    assert sorted(BY_NAME) == sorted(SEEDED.values())


@pytest.mark.parametrize("name", sorted(SEEDED.values()))
@pytest.mark.parametrize("case", sorted(SEEDED))
def test_pass_matches_the_reference_on_fixture(case, name):
    root = FIXTURES / case
    assert root.is_dir(), root
    want = rows(REF_PASSES[name].run(RefCorpus(root)))
    got = rows(BY_NAME[name].run(reference_layout(root)))
    assert got == want
    # the parity is not vacuous: each tree's own pass finds its seeds
    assert want or SEEDED[case] != name


def test_reference_layout_of_the_real_tree_is_clean_in_both():
    want = rows(f for name in REF_PASSES
                for f in REF_PASSES[name].run(RefCorpus(REPO)))
    assert want == []
    assert rows(run_passes(reference_layout(REPO))) == []


class TestFingerprint:
    def test_recipe_is_stable_and_line_independent(self):
        f1 = Finding("p", "f.py", 10, "error", "sym", "msg", "d")
        f2 = Finding("p", "f.py", 99, "error", "sym", "other msg", "d")
        assert f1.fingerprint == f2.fingerprint == \
            expected_fp("p", "f.py", "sym", "d")
        assert f1.fingerprint != \
            Finding("p", "f.py", 10, "error", "sym", "msg", "e").fingerprint

    def test_recipe_is_the_references(self):
        args = ("crash-points", "src/repro_torch/core/faults.py", 1, "error",
                "CRASH_POINTS.MERGE_POST_APPLY", "msg",
                "untested:merge.post_apply")
        assert Finding(*args).fingerprint == RefFinding(*args).fingerprint
        assert Finding(*args).render() == RefFinding(*args).render()


class TestUntestedApi:
    @staticmethod
    def _tree(tmp_path, tests: dict) -> Corpus:
        root = tmp_path / "tree"
        (root / "src/repro_torch/core").mkdir(parents=True)
        (root / "tests").mkdir()
        (root / "src/repro_torch/core/uses.py").write_text(
            (FIXTURES / "deprecations/src/repro/core/uses.py").read_text())
        for name, text in tests.items():
            (root / "tests" / name).write_text(text)
        return Corpus(root)

    def test_catches_untested_batched_api(self, tmp_path):
        corpus = self._tree(tmp_path, {"test_torch_cov.py": "# nothing\n"})
        fs = BY_NAME["deprecations"].run(corpus)
        untested = {f.symbol for f in fs
                    if f.detail.startswith("untested-api:")}
        assert untested == {"execute_batch", "insert_batch",
                            "log_write_batch", "apply_plan",
                            "apply_merge_plan", "merge_entries_batch",
                            "write_once"}
        shim = [f for f in fs if f.detail.startswith("deprecated:")]
        assert [f.file for f in shim] == ["src/repro_torch/core/uses.py"]

    def test_only_the_ports_test_files_count(self, tmp_path):
        names = " ".join(("execute_batch insert_batch log_write_batch "
                          "apply_plan apply_merge_plan merge_entries_batch "
                          "write_once").split())
        corpus = self._tree(tmp_path, {"test_cov.py": f"# {names}\n"})
        fs = BY_NAME["deprecations"].run(corpus)
        assert len([f for f in fs if f.detail.startswith("untested-api:")]) \
            == 7
        corpus = self._tree(tmp_path / "b",
                            {"torch_cov_cases.py": f"# {names}\n"})
        fs = BY_NAME["deprecations"].run(corpus)
        assert not [f for f in fs if f.detail.startswith("untested-api:")]


class TestBaselineJustification:
    def _findings(self):
        return [Finding("p", "f.py", 1, "error", "sym", "msg", "d1"),
                Finding("p", "g.py", 2, "error", "sym2", "msg2", "d2")]

    def test_write_baseline_rejects_placeholder_and_blank(self, tmp_path):
        out = tmp_path / "baseline.json"
        for bad in ("", "   ", PLACEHOLDER_JUSTIFICATION):
            with pytest.raises(ValueError, match="justification"):
                write_baseline(self._findings(), out, justification=bad)
            assert not out.exists()

    def test_write_baseline_stamps_real_justification(self, tmp_path):
        out = tmp_path / "baseline.json"
        write_baseline(self._findings(), out,
                       justification="vendored shim, kept for one release")
        data = json.loads(out.read_text())
        assert len(data["findings"]) == 2
        for entry in data["findings"].values():
            assert entry["justification"] == \
                "vendored shim, kept for one release"
            assert not unjustified(entry)

    def test_empty_findings_need_no_justification(self, tmp_path):
        out = tmp_path / "baseline.json"
        write_baseline([], out)
        assert json.loads(out.read_text())["findings"] == {}

    def test_unjustified_semantics(self):
        assert unjustified({})
        assert unjustified({"justification": ""})
        assert unjustified({"justification": "  "})
        assert unjustified({"justification": PLACEHOLDER_JUSTIFICATION})
        assert not unjustified({"justification": "real reason"})

    def test_cli_write_baseline_without_justify_errors(self, tmp_path,
                                                       capsys):
        # a seeded tree has findings; without --justify the CLI must
        # refuse (exit 2) before writing anything
        from repro_torch.analysis.__main__ import main
        root = _seeded(tmp_path, "core/draw.py",
                       "import torch\nx = torch.randn(4)\n")
        assert run_passes(Corpus(root))
        rc = main(["--root", str(root), "--write-baseline"])
        assert rc == 2
        assert "justification" in capsys.readouterr().err

    def test_strict_fails_unjustified_baselined_entry(self, tmp_path,
                                                      monkeypatch):
        # a baseline entry without a real justification does not shield
        # its finding from --strict
        import repro_torch.analysis.__main__ as cli
        root = _seeded(tmp_path, "core/draw.py",
                       "import torch\nx = torch.randn(4)\n")
        findings = run_passes(Corpus(root), [determinism])
        assert findings
        fake = {f.fingerprint: {"justification": ""} for f in findings}
        monkeypatch.setattr(cli, "load_baseline", lambda: fake)
        argv = ["--root", str(root), "--strict", "--pass", "determinism"]
        assert cli.main(argv) == 1
        for f in findings:
            fake[f.fingerprint]["justification"] = "known fixture"
        assert cli.main(argv) == 0


# ---------------------------------------------------------------------------
# the port's own rules, each seeded once in a tree under tmp_path
# ---------------------------------------------------------------------------
def _seeded(tmp_path, rel: str, text: str, extra: dict | None = None):
    """A tree with ``src/repro_torch/<rel>`` holding ``text`` (and the
    ``extra`` files, by the same kind of path), plus a port test file that
    names the kernel package ``toy``."""
    root = tmp_path / "tree"
    for name, body in {rel: text, **(extra or {})}.items():
        path = root / "src/repro_torch" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
    (root / "tests").mkdir(exist_ok=True)
    (root / "tests/test_torch_toy.py").write_text(
        "from repro_torch.kernels import toy\n")
    return root


TOY = {"kernels/toy/__init__.py": "", "kernels/toy/ref.py":
       "def toy_ref(x):\n    return x\n\n\ndef plain_toy(x):\n    return x\n"}
ENV_READS = {
    "os.environ.get": ("import os\n\n\ndef toy(x):\n"
                       "    if os.environ.get('TOY_PATH'):\n"
                       "        return x\n    return _launch(x)\n",
                       "env:os.environ"),
    "os.getenv": ("import os\n\n\ndef toy(x):\n"
                  "    return _launch(x, os.getenv('TOY_BLOCK'))\n",
                  "env:os.getenv"),
    "from os import environ": ("from os import environ\n\n\ndef toy(x):\n"
                               "    return _launch(x, 'TOY' in environ)\n",
                               "env:os.environ"),
}
FALLBACKS = {
    "ref function": ("from .ref import toy_ref\n\n\ndef toy(x):\n"
                     "    try:\n        return _launch(x)\n"
                     "    except RuntimeError:\n        return toy_ref(x)\n",
                     "fallback:toy_ref"),
    "ref module": ("from . import ref\n\n\ndef toy(x):\n"
                   "    try:\n        return _launch(x)\n"
                   "    except (OSError, RuntimeError):\n"
                   "        return ref.toy_ref(x)\n",
                   "fallback:ref.toy_ref"),
    "plain name": ("from .ref import plain_toy\n\n\ndef toy(x):\n"
                   "    try:\n        return _launch(x)\n"
                   "    except Exception:\n        return plain_toy(x)\n",
                   "fallback:plain_toy"),
}
# launches its kernel on the card, its plain version on the CPU, and lets
# a failed launch raise: what the port's wrappers do
CLEAN_WRAPPER = ("from . import ref\n\n\ndef toy(x, on_cuda):\n"
                 "    if not on_cuda:\n        return ref.toy_ref(x)\n"
                 "    try:\n        return _launch(x)\n"
                 "    except RuntimeError as e:\n"
                 "        raise RuntimeError('toy did not launch') from e\n")


def _only(findings, detail):
    assert [f.detail for f in findings] == [detail], \
        [f.render() for f in findings]
    return findings[0]


@pytest.mark.parametrize("case", sorted(ENV_READS))
def test_env_read_in_a_kernel_wrapper_fires_once(tmp_path, case):
    text, detail = ENV_READS[case]
    root = _seeded(tmp_path, "kernels/toy/ops.py", text, TOY)
    f = _only(kernel_hygiene.run(Corpus(root)), detail)
    assert f.file == "src/repro_torch/kernels/toy/ops.py"
    assert f.fingerprint == expected_fp("kernel-hygiene", f.file, f.symbol,
                                        detail)


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_to_the_plain_version_fires_once(tmp_path, case):
    text, detail = FALLBACKS[case]
    root = _seeded(tmp_path, "kernels/toy/ops.py", text, TOY)
    f = _only(kernel_hygiene.run(Corpus(root)), detail)
    assert f.line == len(text.splitlines())     # the handler's call


def test_clean_kernel_wrapper_fires_nothing(tmp_path):
    root = _seeded(tmp_path, "kernels/toy/ops.py", CLEAN_WRAPPER, TOY)
    assert kernel_hygiene.run(Corpus(root)) == []
    # the same tree outside the kernels is not the rule's business
    root = _seeded(tmp_path / "b", "core/toy.py", ENV_READS["os.getenv"][0])
    assert kernel_hygiene.run(Corpus(root)) == []


def test_kernel_package_without_ref_fires_once(tmp_path):
    root = _seeded(tmp_path, "kernels/toy/ops.py", CLEAN_WRAPPER,
                   {"kernels/toy/__init__.py": ""})
    f = _only(kernel_hygiene.run(Corpus(root)), "no-ref:toy")
    assert f.file == "src/repro_torch/kernels/toy/__init__.py"
    root = _seeded(tmp_path / "b", "kernels/toy/ops.py", CLEAN_WRAPPER, TOY)
    assert kernel_hygiene.run(Corpus(root)) == []


TORCH_RNG = {
    "torch.randn": ("import torch\n\n\ndef draw(n):\n"
                    "    return torch.randn(n)\n",
                    "import torch\n\n\ndef draw(n, gen):\n"
                    "    return torch.randn(n, generator=gen)\n",
                    "call:torch.randn"),
    "torch.randint": ("import torch\n\n\ndef draw(n):\n"
                      "    return torch.randint(0, 9, (n,))\n",
                      "import torch\n\n\ndef draw(n, gen):\n"
                      "    return torch.randint(0, 9, (n,), generator=gen)\n",
                      "call:torch.randint"),
    "torch.manual_seed": ("import torch\n\n\ndef draw(n):\n"
                          "    torch.manual_seed(0)\n"
                          "    return n\n",
                          "import torch\n\n\ndef draw(n):\n"
                          "    gen = torch.Generator().manual_seed(0)\n"
                          "    return torch.rand(n, generator=gen)\n",
                          "call:torch.manual_seed"),
}


@pytest.mark.parametrize("scope", ["core", "kernels/toy"])
@pytest.mark.parametrize("case", sorted(TORCH_RNG))
def test_torch_global_generator_fires_once(tmp_path, case, scope):
    seeded, clean, detail = TORCH_RNG[case]
    root = _seeded(tmp_path, f"{scope}/draw.py", seeded)
    f = _only(determinism.run(Corpus(root)), detail)
    assert f.symbol == case
    root = _seeded(tmp_path / "b", f"{scope}/draw.py", clean)
    assert determinism.run(Corpus(root)) == []


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------
class TestRealTree:
    def test_zero_findings_and_an_empty_baseline(self):
        findings = run_passes(Corpus(repo_root()))
        assert not findings, "\n".join(f.render() for f in findings)
        assert load_baseline() == {}
        assert repo_root() == REPO

    def test_cli_strict_exits_zero_without_jax_reference_or_torch(self):
        code = ("import runpy, sys; "
                "sys.modules.update(jax=None, repro=None, torch=None); "
                "sys.argv = ['repro_torch.analysis', '--strict']; "
                "runpy.run_module('repro_torch.analysis', "
                "run_name='__main__')")
        done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env={"PYTHONPATH": str(REPO / "src")},
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stdout + done.stderr
        assert done.stdout.strip().splitlines()[-1] == \
            "0 finding(s) from 6 pass(es); 0 new, 0 baselined"

    def test_the_ports_test_files_and_no_fixture(self):
        tests = Corpus(repo_root()).test_files()
        assert "tests/test_torch_static_analysis.py" in tests
        assert "tests/torch_multi_rank_paths_cases.py" in tests
        assert all(re.fullmatch(r"tests/(test_torch_\w+|torch_\w*cases)\.py",
                                t) for t in tests), tests

    @pytest.mark.parametrize("path", ANALYSIS_FILES,
                             ids=[p.name for p in ANALYSIS_FILES])
    def test_analysis_imports_the_standard_library_alone(self, path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= STDLIB
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] in STDLIB, node.module


# ---------------------------------------------------------------------------
# the crash-point registry, the twin of test_faultplane.py's
# ---------------------------------------------------------------------------
class TestCrashPointRegistry:
    """The port's CRASH_POINTS enum, the units its module documents and
    ROADMAP's "Fault model" table agree. Naming each point literally here
    also satisfies the analysis' test-coverage rule over the port's
    tests."""

    EXPECTED = {
        "log.pre_seal": "entries",
        "log.rotation": "events",
        "merge.mid_apply": "entries",
        "merge.post_apply": "events",
        "rep.post_cas": "events",
    }

    @staticmethod
    def _roadmap_fault_table():
        text = (REPO / "ROADMAP.md").read_text()
        section = text.split("## Fault model", 1)[1].split("\n## ", 1)[0]
        return {m.group(1): m.group(2).strip() for m in re.finditer(
            r"^\| `([a-z._]+)` \| ([^|]+) \|", section, re.M)}

    @staticmethod
    def _documented_units():
        return {m.group(1): m.group(2) for m in re.finditer(
            r"^  ([a-z]+\.[a-z_]+) +\[([a-z]+)\]", tf.__doc__, re.M)}

    def test_enum_matches_expected_surface(self):
        assert {p.value for p in tf.CRASH_POINTS} == set(self.EXPECTED)
        assert tuple(p.value for p in tf.ALL_POINTS) == tuple(self.EXPECTED)
        assert tuple(tf.ARMABLE_POINTS) == tuple(tf.ALL_POINTS)
        assert "rep.post_cas" in tf.ARMABLE_POINTS
        assert tuple(tf.LOG_MERGE_POINTS) == tuple(tf.ALL_POINTS[:4])

    def test_units_match_expected(self):
        assert self._documented_units() == self.EXPECTED

    def test_roadmap_table_matches_enum(self):
        assert self._roadmap_fault_table() == self.EXPECTED

    def test_members_are_str_interchangeable(self):
        p = tf.CRASH_POINTS.LOG_PRE_SEAL
        assert p == "log.pre_seal" and str(p) == "log.pre_seal"
        assert f"{p}" == "log.pre_seal"
        assert hash(p) == hash("log.pre_seal")
        assert {p: 1}["log.pre_seal"] == 1
        assert tf.CRASH_POINTS("log.pre_seal") is p

    def test_arming_undeclared_point_is_rejected(self):
        fp = tf.FaultPlane(seed=0)
        with pytest.raises(ValueError, match="unknown crash point"):
            fp.arm_crash("log.not_a_point")
        fp.arm_crash("rep.post_cas")
        fp.disarm()
        with pytest.raises(ValueError, match="unknown crash point"):
            fp.force_crash(DPMPool(device="cpu"), "kn1", "merge.not_a_point")

    def test_crash_log_records_plain_strings(self):
        fp = tf.FaultPlane(seed=0)
        fp.arm_crash(tf.CRASH_POINTS.LOG_PRE_SEAL, kn="kn1", after=0)
        assert fp.take_crash(tf.CRASH_POINTS.LOG_PRE_SEAL, "kn1", 4) == 0
        rec = fp.crash_log[-1]
        assert rec["point"] == "log.pre_seal"
        assert type(rec["point"]) is str
