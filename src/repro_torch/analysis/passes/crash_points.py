"""crash-points: the fault surface is closed and fully wired.

``core/faults.py`` declares the canonical ``CRASH_POINTS`` enum; the
fault model is only trustworthy if (a) every injection site names a
declared point, (b) every declared point is reachable from some hook
site, (c) every declared point is exercised by name in at least one test
file, and (d) hooks only live inside the write/merge paths the ROADMAP
fault table documents (a crash hook on, say, the read path would inject
states recovery was never designed for).

Checked:

- every string literal / ``CRASH_POINTS.X`` member passed to
  ``take_crash`` / ``arm_crash`` / ``force_crash`` resolves to a
  declared member;
- every declared point is referenced by at least one hook site in the
  package outside the enum declaration itself;
- every declared point's wire name appears in at least one test file of
  the corpus;
- ``take_crash`` hook sites appear only in the package's
  ``core/{faults,dpm_pool,cluster}.py``.
"""

from __future__ import annotations

import ast

from .. import Corpus, Finding

NAME = "crash-points"

FAULTS_FILE = "core/faults.py"
ENUM_NAME = "CRASH_POINTS"
INJECTORS = {"take_crash": 0, "arm_crash": 0, "force_crash": 2}
# files whose take_crash hooks are legitimate: the staged write plane and
# the merge plane (plus faults.py, which implements the injector)
HOOK_ALLOWLIST = ("core/faults.py", "core/dpm_pool.py", "core/cluster.py")


def declared_points(corpus: Corpus) -> dict[str, str]:
    """Member name -> wire value from the CRASH_POINTS enum."""
    tree = corpus.tree(corpus.pkg(FAULTS_FILE))
    if tree is None:
        return {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == ENUM_NAME:
            members = {}
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Constant) and \
                        isinstance(stmt.value.value, str):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            members[t.id] = stmt.value.value
            return members
    return {}


def _point_arg(call: ast.Call, fn: str):
    idx = INJECTORS[fn]
    for kw in call.keywords:
        if kw.arg == "point":
            return kw.value
    if len(call.args) > idx:
        return call.args[idx]
    return None


def _call_name(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return call.func.id if isinstance(call.func, ast.Name) else None


def run(corpus: Corpus) -> list[Finding]:
    out: list[Finding] = []
    faults_file = corpus.pkg(FAULTS_FILE)
    allowed = frozenset(map(corpus.pkg, HOOK_ALLOWLIST))
    members = declared_points(corpus)
    values = set(members.values())
    if not members:
        out.append(Finding(NAME, faults_file, 1, "error", ENUM_NAME,
                           f"no {ENUM_NAME} enum with string members "
                           f"found in {faults_file}", "missing-enum"))
        return out

    hooked: set[str] = set()        # member names seen at hook sites
    for rel in corpus.py_files(corpus.package):
        tree = corpus.tree(rel)
        if tree is None:
            continue
        in_enum_lines: set[int] = set()
        if rel == faults_file:
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef) and \
                        node.name == ENUM_NAME:
                    in_enum_lines = set(range(node.lineno,
                                              node.end_lineno + 1))
        for node in ast.walk(tree):
            # member references anywhere in the package count as wiring
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == ENUM_NAME and \
                    node.attr in members and \
                    node.lineno not in in_enum_lines:
                hooked.add(node.attr)
            if not isinstance(node, ast.Call):
                continue
            fn = _call_name(node)
            if fn not in INJECTORS:
                continue
            if fn == "take_crash" and rel not in allowed:
                out.append(Finding(
                    NAME, rel, node.lineno, "error", fn,
                    f"take_crash hook outside the write/merge paths "
                    f"({rel}); allowed: {sorted(allowed)}",
                    f"hook-location:{rel}"))
            arg = _point_arg(node, fn)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value not in values:
                    out.append(Finding(
                        NAME, rel, node.lineno, "error", fn,
                        f"{fn}() names undeclared crash point "
                        f"{arg.value!r}; declare it in {ENUM_NAME}",
                        f"undeclared:{arg.value}"))
                else:
                    hooked.add(next(k for k, v in members.items()
                                    if v == arg.value))
            elif isinstance(arg, ast.Attribute) and \
                    isinstance(arg.value, ast.Name) and \
                    arg.value.id == ENUM_NAME and arg.attr not in members:
                out.append(Finding(
                    NAME, rel, node.lineno, "error", fn,
                    f"{fn}() references undeclared member "
                    f"{ENUM_NAME}.{arg.attr}",
                    f"undeclared-member:{arg.attr}"))
            # non-literal point expressions are dynamic -- runtime
            # normalization (_as_point) covers those

    for mname, value in members.items():
        if mname not in hooked:
            out.append(Finding(
                NAME, faults_file, 1, "error", f"{ENUM_NAME}.{mname}",
                f"declared crash point {value!r} has no hook site in "
                f"{corpus.package}", f"unhooked:{value}"))

    # test coverage: the wire name must appear in some test file
    for mname, value in members.items():
        if not corpus.named_in_tests(value):
            out.append(Finding(
                NAME, faults_file, 1, "error", f"{ENUM_NAME}.{mname}",
                f"declared crash point {value!r} is not exercised by "
                f"name in any test file ({', '.join(corpus.tests)})",
                f"untested:{value}"))
    return out
