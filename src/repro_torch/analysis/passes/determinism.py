"""determinism: sim paths may not consult wall clocks or global RNG.

Every simulated quantity must flow from the seeded generators and the
sim clock (``NetModel`` / ``TimedSimulation``): a (seed, workload) pair
must replay bit-identically, which is what makes the fault scenarios and
equivalence harnesses debuggable at all. Wall time is allowed only
through ``time.perf_counter`` (wall *measurement* of the host, never a
sim input).

Flagged in the package's ``core`` and ``kernels`` (and in the corpus'
extra scopes):

- ``time.time()`` / ``time.time_ns()`` and ``datetime`` "now" family
  (``now`` / ``utcnow`` / ``today``);
- module-global RNG: any ``random.<fn>()`` call on the stdlib module
  (seeded instances via ``random.Random(seed)`` are fine), and
  ``np.random.<fn>()`` global-state calls (``np.random.default_rng`` /
  ``np.random.Generator`` construction is fine);
- torch's global RNG: ``torch.manual_seed`` (and its ``torch.cuda``
  twins), and ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``normal`` / ``bernoulli`` / ``multinomial`` called with no
  ``generator=`` (a seeded ``torch.Generator`` is fine).
"""

from __future__ import annotations

import ast

from .. import Corpus, Finding

NAME = "determinism"

SCOPES = ("core", "kernels")

WALL_TIME = {"time": {"time", "time_ns"},
             "datetime": {"now", "utcnow", "today"}}
RANDOM_OK = {"Random", "SystemRandom"}          # explicit instances
NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                "Philox", "BitGenerator"}
TORCH_SEEDS = {"manual_seed", "manual_seed_all"}
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                  "bernoulli", "multinomial"}


def _flag(out, rel, node, symbol, msg):
    out.append(Finding(NAME, rel, node.lineno, "error", symbol, msg,
                       f"call:{symbol}"))


def _torch_chain(f: ast.Attribute) -> str | None:
    """``torch.x`` / ``torch.cuda.x`` as written, or None when the call
    is not on the torch module itself."""
    node = f.value
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name) and node.id == "torch":
        return ast.unparse(f)
    return None


def _check_call(out, rel, node: ast.Call) -> None:
    f = node.func
    if not isinstance(f, ast.Attribute):
        return
    # time.time() / datetime.now() / datetime.datetime.now()
    base = f.value
    if isinstance(base, ast.Name) and base.id == "time" \
            and f.attr in WALL_TIME["time"]:
        _flag(out, rel, node, f"time.{f.attr}",
              f"wall clock time.{f.attr}() in a sim path; use the sim "
              f"clock, or time.perf_counter for host measurement")
        return
    if f.attr in WALL_TIME["datetime"]:
        names = {n.id for n in ast.walk(f) if isinstance(n, ast.Name)}
        if "datetime" in names:
            _flag(out, rel, node, f"datetime.{f.attr}",
                  f"wall clock datetime.{f.attr}() in a sim path")
            return
    # random.<fn>() on the stdlib module (global hidden state)
    if isinstance(base, ast.Name) and base.id == "random" \
            and f.attr not in RANDOM_OK:
        _flag(out, rel, node, f"random.{f.attr}",
              f"global-state random.{f.attr}(); inject a seeded "
              f"random.Random(seed) instead")
        return
    # np.random.<fn>() / numpy.random.<fn>() global generator
    if isinstance(base, ast.Attribute) and base.attr == "random" and \
            isinstance(base.value, ast.Name) and \
            base.value.id in ("np", "numpy") and \
            f.attr not in NP_RANDOM_OK:
        _flag(out, rel, node, f"np.random.{f.attr}",
              f"global np.random.{f.attr}(); use an injected "
              f"np.random.default_rng(seed)")
        return
    # torch's global generator: seeding it, or sampling from it
    chain = _torch_chain(f)
    if chain is None:
        return
    if f.attr in TORCH_SEEDS:
        _flag(out, rel, node, chain,
              f"{chain}() seeds torch's global generator; draw from a "
              f"seeded torch.Generator passed as generator=")
    elif chain == f"torch.{f.attr}" and f.attr in TORCH_SAMPLERS and \
            not any(kw.arg == "generator" for kw in node.keywords):
        _flag(out, rel, node, chain,
              f"{chain}() with no generator= draws from torch's global "
              f"generator; pass a seeded torch.Generator")


def run(corpus: Corpus) -> list[Finding]:
    out: list[Finding] = []
    scopes = [corpus.pkg(s) for s in SCOPES] + list(corpus.extra_scopes)
    for scope in scopes:
        for rel in corpus.py_files(scope):
            tree = corpus.tree(rel)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    _check_call(out, rel, node)
    return out
