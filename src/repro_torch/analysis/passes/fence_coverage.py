"""fence-coverage: every DPM mutation entry point is epoch-fenced.

The fencing plane only protects against zombie owners if no mutation
entry point forgets the fence: a single unchecked path lets a
stale-epoch writer corrupt handed-off state. This pass closes the
surface the way ``crash-points`` closes the fault surface:

- every declared entry point method on ``DPMPool`` accepts a ``token``
  parameter and calls ``self._check_fence(...)`` somewhere in its body
  (directly, or -- for thin wrappers -- by delegating to another
  declared entry point with the token forwarded);
- ``DinomoCluster._reconfigure`` publishes fence generations
  (``_publish_fences`` / ``publish_fences``) so handoffs bump them;
- ``FencedWrite`` (the machine-checkable no-op result) stays named in
  at least one test file of the corpus.
"""

from __future__ import annotations

import ast

from .. import Corpus, Finding

NAME = "fence-coverage"

DPM_FILE = "core/dpm_pool.py"
CLUSTER_FILE = "core/cluster.py"
POOL_CLASS = "DPMPool"

# DPM mutation entry points: each must carry a token and validate it
ENTRY_POINTS = (
    "fill_segments_batch",
    "log_write",
    "log_write_batch",
    "merge_entries_batch",
    "apply_merge_plan",
    "cas_indirect",
    "recover_kn",
)
CHECK_NAME = "_check_fence"
PUBLISH_NAMES = ("_publish_fences", "publish_fences")


def _class_methods(tree: ast.Module, cls: str) -> dict[str, ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {stmt.name: stmt for stmt in node.body
                    if isinstance(stmt, ast.FunctionDef)}
    return {}


def _has_param(fn: ast.FunctionDef, name: str) -> bool:
    args = fn.args
    return any(a.arg == name
               for a in args.posonlyargs + args.args + args.kwonlyargs)


def _called_methods(fn: ast.FunctionDef) -> dict[str, list[ast.Call]]:
    """self.<name>(...) calls inside ``fn``, grouped by method name."""
    out: dict[str, list[ast.Call]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "self":
            out.setdefault(node.func.attr, []).append(node)
    return out


def _forwards_token(calls: list[ast.Call]) -> bool:
    """Does any call pass a ``token`` keyword (or thread the local
    ``token`` name positionally)?"""
    for call in calls:
        if any(kw.arg == "token" for kw in call.keywords):
            return True
        if any(isinstance(a, ast.Name) and a.id == "token"
               for a in call.args):
            return True
    return False


def _pool_findings(corpus: Corpus) -> list[Finding]:
    dpm_file = corpus.pkg(DPM_FILE)
    tree = corpus.tree(dpm_file)
    if tree is None:
        return [Finding(NAME, dpm_file, 1, "error", POOL_CLASS,
                        f"{dpm_file} not found or unparsable",
                        "missing-pool")]
    methods = _class_methods(tree, POOL_CLASS)
    if not methods:
        return [Finding(NAME, dpm_file, 1, "error", POOL_CLASS,
                        f"no class {POOL_CLASS} in {dpm_file}",
                        "missing-pool-class")]
    out: list[Finding] = []
    if CHECK_NAME not in methods:
        out.append(Finding(NAME, dpm_file, 1, "error", CHECK_NAME,
                           f"{POOL_CLASS} has no {CHECK_NAME}() -- the "
                           "fence has no validator", "missing-check"))
    for ep in ENTRY_POINTS:
        fn = methods.get(ep)
        if fn is None:
            out.append(Finding(
                NAME, dpm_file, 1, "error", f"{POOL_CLASS}.{ep}",
                f"declared DPM mutation entry point {ep}() is missing "
                f"from {POOL_CLASS}", f"missing-entry:{ep}"))
            continue
        if not _has_param(fn, "token"):
            out.append(Finding(
                NAME, dpm_file, fn.lineno, "error", f"{POOL_CLASS}.{ep}",
                f"{ep}() takes no fence `token` parameter: stale-epoch "
                "callers cannot be rejected", f"no-token-param:{ep}"))
        calls = _called_methods(fn)
        # a thin wrapper may delegate: another declared entry point
        # called with the token forwarded inherits that callee's check
        delegated = any(_forwards_token(calls.get(other, []))
                        for other in ENTRY_POINTS if other != ep)
        if not calls.get(CHECK_NAME) and not delegated:
            out.append(Finding(
                NAME, dpm_file, fn.lineno, "error", f"{POOL_CLASS}.{ep}",
                f"{ep}() never calls {CHECK_NAME}() (and does not "
                "delegate to a fenced entry point with the token "
                "forwarded): a zombie owner's write would mutate pool "
                "state", f"unfenced:{ep}"))
    return out


def run(corpus: Corpus) -> list[Finding]:
    out = _pool_findings(corpus)
    if any(f.detail in ("missing-pool", "missing-pool-class") for f in out):
        return out

    cluster_file = corpus.pkg(CLUSTER_FILE)
    ctree = corpus.tree(cluster_file)
    if ctree is None:
        out.append(Finding(NAME, cluster_file, 1, "error", "DinomoCluster",
                           f"{cluster_file} not found or unparsable",
                           "missing-cluster"))
    else:
        reconf = _class_methods(ctree, "DinomoCluster").get("_reconfigure")
        if reconf is None:
            out.append(Finding(
                NAME, cluster_file, 1, "error", "DinomoCluster._reconfigure",
                "no _reconfigure method found", "missing-reconfigure"))
        elif not any(n in _called_methods(reconf) for n in PUBLISH_NAMES):
            out.append(Finding(
                NAME, cluster_file, reconf.lineno, "error",
                "DinomoCluster._reconfigure",
                "_reconfigure() never publishes fence generations "
                f"({' / '.join(PUBLISH_NAMES)}): handoffs would not bump "
                "the fence and zombie writes would validate", "no-publish"))

    # test coverage: the no-op result type must stay named in a test
    if not corpus.named_in_tests("FencedWrite"):
        out.append(Finding(
            NAME, corpus.pkg(DPM_FILE), 1, "error", "FencedWrite",
            "FencedWrite is not exercised by name in any test file",
            "untested:FencedWrite"))
    return out
