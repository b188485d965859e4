"""plan-purity: planning halves of the plan/apply split must be pure.

The batched engine trusts that ``plan_*`` / ``*_plan`` functions in
``core/transition.py`` and ``core/clht.py`` only *read* engine state
(cache vectors, CLHT tables, pool heaps) and build a plan object; all
mutation happens in the paired ``apply_*`` half. A mutation that sneaks
into a planner corrupts live state on the speculative path -- plans are
sometimes discarded (self-truncation) and replayed scalar.

Rules, per matched function (``plan_*`` or ``*_plan``, excluding the
``apply*`` family):

- no calls to known mutating methods (``apply_*``, inserts, log
  writes, merges, cache fills/invalidation, CAS) on *any* receiver;
- no subscript/attribute assignment (or aug-assignment, or ``del``)
  whose root object is a function parameter, nor through a local alias
  bound to a bare parameter attribute chain (``kind = cache.kind`` then
  ``kind[i] = 0`` is still a mutation of engine state -- attribute
  chains alias, only calls/subscripts copy).

Locally constructed objects (the plan being built) stay freely mutable.
"""

from __future__ import annotations

import ast

from .. import Corpus, Finding

NAME = "plan-purity"

PLAN_FILES = ("core/transition.py", "core/clht.py")

MUTATING_CALLS = frozenset({
    "insert", "insert_batch", "delete", "log_write", "log_write_batch",
    "write_once", "merge_entries_batch", "merge_all", "merge_budget",
    "cas_indirect", "install_indirect", "remove_indirect",
    "register_reqs", "fill", "fill_after_write", "fill_after_miss",
    "invalidate", "update_pointer", "demote_to_shortcut", "clear",
    "note_miss_rts", "bulk_value_hits", "recover_kn",
})


def _is_plan_fn(name: str) -> bool:
    if name.startswith("apply"):
        return False
    return name.startswith("plan_") or name.endswith("_plan")


def _root_name(node: ast.AST) -> str | None:
    """The base Name of an attribute/subscript chain, or None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _attr_chain_root(node: ast.AST) -> str | None:
    """Like _root_name, but only for *pure attribute* chains (these alias
    the parameter's state; any call/subscript on the way makes an
    independent value)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _check_fn(fn: ast.FunctionDef, rel: str) -> list[Finding]:
    out: list[Finding] = []
    params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                              + fn.args.kwonlyargs)}
    if fn.args.vararg:
        params.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        params.add(fn.args.kwarg.arg)

    # local names aliasing engine state through a bare attribute chain
    aliases: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Attribute):
            root = _attr_chain_root(node.value)
            if root in params:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
    tainted = params | aliases

    def flag(node, symbol, message, detail):
        out.append(Finding(NAME, rel, node.lineno, "error",
                           f"{fn.name}.{symbol}", message, detail))

    def stores(targets):
        for t in targets:
            if isinstance(t, (ast.Subscript, ast.Attribute)):
                root = _root_name(t)
                if root in tainted:
                    yield t, root

    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            m = node.func.attr
            if m in MUTATING_CALLS or m.startswith("apply_"):
                flag(node, m,
                     f"plan function {fn.name!r} calls mutating method "
                     f".{m}(); planning halves must be pure",
                     f"call:{m}")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t, root in stores(targets):
                kind = "subscript" if isinstance(t, ast.Subscript) \
                    else "attribute"
                flag(t, root,
                     f"plan function {fn.name!r} assigns into {kind} of "
                     f"{root!r} (engine-owned state)",
                     f"store:{root}:{ast.unparse(t)}")
        elif isinstance(node, ast.Delete):
            for t, root in stores(node.targets):
                flag(t, root,
                     f"plan function {fn.name!r} deletes from {root!r} "
                     f"(engine-owned state)",
                     f"del:{root}:{ast.unparse(t)}")
    return out


def run(corpus: Corpus) -> list[Finding]:
    out: list[Finding] = []
    for rel in map(corpus.pkg, PLAN_FILES):
        tree = corpus.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _is_plan_fn(node.name):
                out.extend(_check_fn(node, rel))
    return out
