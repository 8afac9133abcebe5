"""AST lint of the port: no JAX and nothing of the JAX package.

Counterpart of `repro.analysis.lint`, an AST scan (comments and
docstrings are exempt by construction; string constants are not). It is
the static twin of tests/test_torch_import.py, over the port's package
(`src/repro_torch`), ``chip_smoke.py`` and the port's scripts
(``scripts/*.py`` but `JAX_SIDE`, which make the JAX package's expected
constants on the CPU). Rules:

* **imports** -- an ``import`` or ``from ... import`` of ``jax`` or
  ``repro`` (or a submodule), at any depth of the file, or an
  ``importlib.import_module`` / ``__import__`` of one by a constant
  name: the port runs where neither exists;
* the **REPRO_AZURE_NPZ** env var (a string constant that is not a
  docstring), superseded by `NpzTrace`, as in the JAX package;
* the **Python event engine** driven from the scripts or the smoke
  (``repro_torch.core.simulator`` / ``from repro_torch.core import
  simulate``): the JAX package's benchmark rule, on the port's surface --
  a figure runs through `repro_torch.api`.

The JAX package's ``jax_engine.sweep`` rule has no surface in the port
(it has no ``sweep`` shim) and is listed in the report as not applicable.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, List, Tuple

# scripts that run the JAX package on the CPU to make the constants the
# card's checks read (scripts/*_expected.json), and the trace preparer
# that predates the port
JAX_SIDE = ("cluster_expected.py", "k0_expected.py", "telemetry_expected.py",
            "train_expected.py", "model_parity_expected.py",
            "prepare_azure_trace.py")
_BANNED_ROOTS = ("jax", "repro")
# the retired env var, spelled in parts: the JAX package's lint scans src/
# too, and would read a constant holding the whole name as a use of it
_AZURE_ENV = "_".join(("REPRO", "AZURE", "NPZ"))
_PY_ENGINE = "repro_torch.core.simulator"
NOT_APPLICABLE = {
    "jax_engine.sweep": "the port has no sweep() shim: every script goes "
                        "through repro_torch.api",
}


def _banned(mod: str) -> bool:
    root = mod.split(".")[0]
    return root in _BANNED_ROOTS


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def lint_source(text: str, *, is_script: bool = False
                ) -> List[Tuple[int, str]]:
    """(lineno, reason) findings for one file; ``is_script`` (a script or
    the smoke) adds the Python-event-engine rule."""
    tree = ast.parse(text)
    out: List[Tuple[int, str]] = []
    doc_ids = {id(node.value) for node in ast.walk(tree)
               if isinstance(node, ast.Expr)
               and isinstance(node.value, ast.Constant)
               and isinstance(node.value.value, str)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if _banned(a.name):
                    out.append((node.lineno, f"imports {a.name}"))
                if is_script and (a.name == _PY_ENGINE
                                  or a.name.startswith(_PY_ENGINE + ".")):
                    out.append((node.lineno, "drives the Python event "
                                "engine (use repro_torch.api)"))
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            names = {a.name for a in node.names}
            if _banned(mod):
                out.append((node.lineno, f"imports from {mod}"))
            if is_script and (mod == _PY_ENGINE
                              or mod.startswith(_PY_ENGINE + ".")
                              or (mod == "repro_torch.core"
                                  and names & {"simulate", "simulator"})):
                out.append((node.lineno, "drives the Python event engine "
                            "(use repro_torch.api)"))
        elif isinstance(node, ast.Call):
            fn = _dotted(node.func)
            if (fn.endswith("import_module") or fn == "__import__") and (
                    node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _banned(node.args[0].value)):
                out.append((node.lineno,
                            f"imports {node.args[0].value} by name"))
        elif isinstance(node, ast.Constant):
            if (isinstance(node.value, str) and _AZURE_ENV in node.value
                    and id(node) not in doc_ids):
                out.append((node.lineno, f"reads the {_AZURE_ENV} env var "
                            "(use NpzTrace)"))
    return sorted(set(out))


def repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def scanned_files(root: str) -> Iterator[Tuple[str, bool]]:
    """(path relative to ``root``, is_script) of every file the lint
    reads."""
    pkg = os.path.join(root, "src", "repro_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), root), False
    if os.path.exists(os.path.join(root, "chip_smoke.py")):
        yield "chip_smoke.py", True
    scripts = os.path.join(root, "scripts")
    if os.path.isdir(scripts):
        for f in sorted(os.listdir(scripts)):
            if f.endswith(".py") and f not in JAX_SIDE:
                yield os.path.join("scripts", f), True


def iter_findings(root: str) -> Iterator[Tuple[str, int, str]]:
    for rel, script in scanned_files(root):
        with open(os.path.join(root, rel)) as fh:
            text = fh.read()
        try:
            findings = lint_source(text, is_script=script)
        except SyntaxError as e:
            findings = [(e.lineno or 0, f"does not parse: {e.msg}")]
        for lineno, reason in findings:
            yield rel, lineno, reason


def audit_lint(root: str = None) -> dict:
    """The gate's entry for the tree at ``root`` (this checkout)."""
    root = root or repo_root()
    files = list(scanned_files(root))
    findings = [f"{rel}:{lineno} {reason}"
                for rel, lineno, reason in iter_findings(root)]
    problems = list(findings)
    if not any(rel.startswith(os.path.join("src", "repro_torch"))
               for rel, _ in files):
        problems.append(f"{root}: no file of src/repro_torch to scan")
    return dict(entry="port_tree", passed=not problems, files=len(files),
                findings=len(findings), not_applicable=NOT_APPLICABLE,
                problems=problems)
