"""deprecations: shims stay dead, batched APIs stay tested.

Two rot vectors this pass closes:

- **Deprecated shims growing new callers.** ``NetModel.op_latency``
  survives only for external compatibility (the regression pin calls it
  under ``pytest.deprecated_call``); any *internal* caller would
  silently route latency through the superseded queue-factor heuristic.
  Flagged: every ``.op_latency`` access in the package (and the corpus'
  extra scopes) outside its defining module, ``core/netmodel.py``.

- **Batched public APIs losing their equivalence tests.** Every batched
  path is decision-for-decision identical to the scalar one, enforced by
  tests that call the API by name. A batched entry point no test names
  is one refactor away from rotting; each must appear in at least one
  test file of the corpus.
"""

from __future__ import annotations

import ast

from .. import Corpus, Finding

NAME = "deprecations"

DEPRECATED_ATTRS = {"op_latency": "core/netmodel.py"}

# batched public surface that must be named by >=1 test
BATCHED_APIS = ("execute_batch", "insert_batch", "log_write_batch",
                "apply_plan", "apply_merge_plan", "merge_entries_batch",
                "write_once")


def _def_site(corpus: Corpus, name: str) -> tuple[str, int]:
    """First definition of ``name`` in the package, for anchoring
    coverage findings."""
    for rel in corpus.py_files(corpus.package):
        tree = corpus.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return rel, node.lineno
    return corpus.package, 1


def run(corpus: Corpus) -> list[Finding]:
    out: list[Finding] = []
    homes = {a: corpus.pkg(rel) for a, rel in DEPRECATED_ATTRS.items()}
    for scope in (corpus.package, *corpus.extra_scopes):
        for rel in corpus.py_files(scope):
            tree = corpus.tree(rel)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and \
                        node.attr in homes and rel != homes[node.attr]:
                    out.append(Finding(
                        NAME, rel, node.lineno, "error", node.attr,
                        f"internal caller of deprecated .{node.attr}; use "
                        f"request_latency/service_time",
                        f"deprecated:{node.attr}:{ast.unparse(node)}"))

    for api in BATCHED_APIS:
        if not corpus.named_in_tests(api):
            rel, line = _def_site(corpus, api)
            out.append(Finding(
                NAME, rel, line, "error", api,
                f"batched public API {api!r} is not named by any test "
                f"file", f"untested-api:{api}"))
    return out
