"""Generated refusal matrix of the port: every ``raise
NotImplementedError`` in ``theanompi_tpu_torch/``, inventoried into
``theanompi_tpu_torch/analysis/REFUSALS.md`` (the JAX package's
``analysis/refusals.py`` for the port).

A hand-maintained table drifts the first time a refusal is added or
removed.  ``python -m theanompi_tpu_torch.analysis --write-refusals``
regenerates the file, and ``tests/test_torch_tmcheck_core.py`` fails
whenever the code and the file disagree.

Two populations, split by intent:

- **Declared refusals** — ``raise NotImplementedError("...")`` with a
  message: a combination the code explicitly refuses (MoE×zero1,
  serving beyond tp, …): a design boundary of the JAX package kept
  by the port, or an open work item.
- **Abstract interface slots** — bare ``raise NotImplementedError``:
  a subclass hook, not a refusal.  Listed separately so the refusal
  count is honest.

Entries are keyed on (module, qualname, message) — NOT line numbers —
so unrelated edits don't churn the file.
"""

from __future__ import annotations

import ast
from pathlib import Path

PACKAGE = "theanompi_tpu_torch"
DOC_REL = f"{PACKAGE}/analysis/REFUSALS.md"

_HEADER = """\
# REFUSALS — the port's NotImplementedError matrix

> **Generated** by `python -m theanompi_tpu_torch.analysis
> --write-refusals` (`theanompi_tpu_torch/analysis/refusals.py`). Do
> not edit by hand: `tests/test_torch_tmcheck_core.py` fails when this
> file and the code drift.

Every `raise NotImplementedError` in `theanompi_tpu_torch/`, split into
**declared refusals** (a messaged raise: a combination the code
refuses on purpose — each one is an open work item or a documented
design boundary) and **abstract interface slots** (bare raises:
subclass hooks, not refusals).
"""


def _message_of(node: ast.Raise) -> str | None:
    """Render the raise's message arg, stable across edits: string
    constants verbatim, f-string holes as ``{…}``, anything else as
    unparsed source."""
    exc = node.exc
    if isinstance(exc, ast.Name):
        return None                      # bare: abstract slot
    if not isinstance(exc, ast.Call) or not exc.args:
        return "" if isinstance(exc, ast.Call) else None
    parts = []
    for a in exc.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            parts.append(a.value)
        elif isinstance(a, ast.JoinedStr):
            for v in a.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                else:
                    parts.append("{…}")
        else:
            try:
                parts.append(ast.unparse(a))
            except Exception:
                parts.append("…")
    return " ".join(" ".join(parts).split())


def collect(root: Path, package: str = PACKAGE) -> list[dict]:
    """All NotImplementedError raises under the package, sorted."""
    entries = []
    for path in sorted((root / package).rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = str(path.relative_to(root))
        try:
            tree = ast.parse(path.read_text(), filename=rel)
        except SyntaxError:
            continue
        def visit(node: ast.AST, q: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    visit(child, f"{q}.{child.name}" if q
                          else child.name)
                else:
                    if isinstance(child, ast.Raise):
                        name = _exc_name(child)
                        if name == "NotImplementedError":
                            entries.append({
                                "module": rel,
                                "where": q or "<module>",
                                "message": _message_of(child),
                            })
                    visit(child, q)

        visit(tree, "")
    entries.sort(key=lambda e: (e["module"], e["where"],
                                e["message"] or ""))
    return entries


def _exc_name(node: ast.Raise) -> str | None:
    exc = node.exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    if isinstance(exc, ast.Name):
        return exc.id
    if isinstance(exc, ast.Attribute):
        return exc.attr
    return None


def render(entries: list[dict]) -> str:
    refusals = [e for e in entries if e["message"] is not None]
    abstract = [e for e in entries if e["message"] is None]
    lines = [_HEADER]
    lines.append(f"## Declared refusals ({len(refusals)})\n")
    lines.append("| module | where | refuses |")
    lines.append("|---|---|---|")
    for e in refusals:
        msg = (e["message"] or "(no message)").replace("|", "\\|")
        lines.append(f"| `{e['module']}` | `{e['where']}` | {msg} |")
    lines.append("")
    lines.append(f"## Abstract interface slots ({len(abstract)})\n")
    lines.append("| module | where |")
    lines.append("|---|---|")
    for e in abstract:
        lines.append(f"| `{e['module']}` | `{e['where']}` |")
    lines.append("")
    return "\n".join(lines)


def write(root: Path) -> Path:
    out = root / DOC_REL
    out.write_text(render(collect(root)))
    return out
