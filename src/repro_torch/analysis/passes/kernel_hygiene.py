"""kernel-hygiene: every kernel package has a plain version and a test,
and a wrapper launches its kernel or raises.

The port's rule (ROADMAP, "Rules of the port") is that every kernel
package ships a ``ref.py`` of plain versions that a parity test holds
the kernel to, and that a wrapper chooses its path from its tensors'
device alone: on the CPU the plain version, on the card the kernel or an
error. Two things would break that quietly:

- a switch read from the process environment, which makes the path a
  deployment setting instead of the tensors' device;
- a ``try`` whose ``except`` calls the plain version: a kernel that
  fails to build or launch then runs the plain version on the card and
  nobody sees it.

Checked over the package's ``kernels``:

- each kernel package directory (one with ``__init__.py``) ships
  ``ref.py``;
- each kernel package is named in a test file of the corpus;
- no read of an ``os`` attribute whose name holds ``env`` (the
  environment mapping and its getters), nor such a name imported from
  ``os``;
- no ``except`` handler calls a function of the package's ``ref``
  module or a function whose name starts with ``plain``;
- the reference's interpret rules, keyed to the ``interpret`` parameter
  as there: no parameter named ``interpret`` defaults to a boolean
  constant, and no call passes ``interpret=True`` / ``False`` as a
  constant keyword. The port has no interpret switch, so these fire only
  on a package that has one.
"""

from __future__ import annotations

import ast

from .. import Corpus, Finding

NAME = "kernel-hygiene"

KERNELS_DIR = "kernels"
ROUTER_FILE = "kernels/interpret.py"
ENV_MARK = "env"
PLAIN_PREFIX = "plain"


def _kernel_packages(corpus: Corpus) -> list[str]:
    base = corpus.root / corpus.pkg(KERNELS_DIR)
    if not base.is_dir():
        return []
    return sorted(p.name for p in base.iterdir()
                  if p.is_dir() and (p / "__init__.py").is_file())


def _ref_bindings(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(names bound to functions of a ``ref`` module, names bound to a
    ``ref`` module itself) by the file's imports."""
    funcs: set[str] = set()
    modules: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            from_ref = (node.module or "").split(".")[-1] == "ref"
            for a in node.names:
                if from_ref:
                    funcs.add(a.asname or a.name)
                elif a.name == "ref":
                    modules.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] == "ref" and a.asname:
                    modules.add(a.asname)
    return funcs, modules


def _is_fallback(func: ast.AST, funcs: set[str], modules: set[str]) -> bool:
    if isinstance(func, ast.Name):
        return func.id in funcs or func.id.startswith(PLAIN_PREFIX)
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr.startswith(PLAIN_PREFIX):
        return True
    owner = func.value
    return (isinstance(owner, ast.Name) and owner.id in modules) or \
        (isinstance(owner, ast.Attribute) and owner.attr == "ref")


def _wrapper_findings(rel: str, tree: ast.AST) -> list[Finding]:
    """The port's two rules: no environment switch, no quiet fallback."""
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "os" and ENV_MARK in node.attr:
            sym = f"os.{node.attr}"
            out.append(Finding(
                NAME, rel, node.lineno, "error", sym,
                f"{sym} read in a kernel module: a wrapper's path follows "
                f"its tensors' device, never a process setting",
                f"env:{sym}"))
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if ENV_MARK in a.name:
                    sym = f"os.{a.name}"
                    out.append(Finding(
                        NAME, rel, node.lineno, "error", sym,
                        f"{sym} imported in a kernel module: a wrapper's "
                        f"path follows its tensors' device, never a "
                        f"process setting", f"env:{sym}"))
    funcs, modules = _ref_bindings(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            for call in ast.walk(handler):
                if isinstance(call, ast.Call) and \
                        _is_fallback(call.func, funcs, modules):
                    tgt = ast.unparse(call.func)
                    out.append(Finding(
                        NAME, rel, call.lineno, "error", tgt,
                        f"except handler falls back to the plain version "
                        f"{tgt}(); on the card a wrapper launches its "
                        f"kernel or raises", f"fallback:{tgt}"))
    return out


def _interpret_findings(rel: str, tree: ast.AST) -> list[Finding]:
    """The reference's rules on a hardcoded ``interpret`` flag."""
    out: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = (node.args.posonlyargs + node.args.args
                    + node.args.kwonlyargs)
            defaults = ([None] * (len(node.args.posonlyargs + node.args.args)
                                  - len(node.args.defaults))
                        + list(node.args.defaults)
                        + list(node.args.kw_defaults))
            for a, d in zip(args, defaults):
                if a.arg == "interpret" and isinstance(d, ast.Constant) \
                        and isinstance(d.value, bool):
                    out.append(Finding(
                        NAME, rel, node.lineno, "error", node.name,
                        f"{node.name}() hardcodes interpret={d.value}; "
                        f"default to None and route through "
                        f"resolve_interpret",
                        f"hardcoded-default:{node.name}"))
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "interpret" and \
                        isinstance(kw.value, ast.Constant) and \
                        isinstance(kw.value.value, bool):
                    tgt = ast.unparse(node.func)
                    out.append(Finding(
                        NAME, rel, node.lineno, "error", tgt,
                        f"call to {tgt} pins interpret={kw.value.value}; "
                        f"route through resolve_interpret",
                        f"hardcoded-kw:{tgt}"))
    return out


def run(corpus: Corpus) -> list[Finding]:
    out: list[Finding] = []
    kernels = corpus.pkg(KERNELS_DIR)
    for pkg in _kernel_packages(corpus):
        pkg_rel = f"{kernels}/{pkg}"
        if corpus.read(f"{pkg_rel}/ref.py") is None:
            out.append(Finding(
                NAME, f"{pkg_rel}/__init__.py", 1, "error", pkg,
                f"kernel package {pkg!r} ships no ref.py of plain "
                f"versions", f"no-ref:{pkg}"))
        if not corpus.named_in_tests(pkg):
            out.append(Finding(
                NAME, f"{pkg_rel}/__init__.py", 1, "error", pkg,
                f"kernel package {pkg!r} is named in no test file",
                f"untested:{pkg}"))

    router = corpus.pkg(ROUTER_FILE)
    for rel in corpus.py_files(kernels):
        if rel == router:
            continue
        tree = corpus.tree(rel)
        if tree is None:
            continue
        out.extend(_interpret_findings(rel, tree))
        out.extend(_wrapper_findings(rel, tree))
    return out
