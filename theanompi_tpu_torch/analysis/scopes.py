"""tmcheck rule family 5: profiler-range registration (TM107), the
JAX package's ``analysis/scopes.py`` for torch's ranges.

The step-phase profiler (``obs/profiler.py``) files a kernel under the
leg of the innermost range open at its launch, but only for labels it
knows (``registry.PROFILE_SCOPES`` exact labels and
``registry.PROFILE_SCOPE_PREFIXES`` indexed families).  A range whose
label is not registered LOOKS instrumented, yet its work lands in the
profiler's "compute" leg and the label measures nothing.

TM107 therefore fires on any ``record_function(...)`` (``torch.
profiler.record_function``) or ``scope(...)`` (``obs.profiler.scope``)
call site whose label does not resolve:

- a literal label must be a key of ``PROFILE_SCOPES`` or start with a
  ``PROFILE_SCOPE_PREFIXES`` prefix;
- an f-string label resolves through its leading LITERAL fragment,
  which must carry a whole registered prefix (``f"exchange_b{i}"``);
- a non-literal label (a variable, a call) cannot be checked against
  the registry and is flagged too.

``test_*`` functions are not exempt: a range opened inside a test
exercises the same attribution path.
"""

from __future__ import annotations

import ast

from theanompi_tpu_torch.analysis.core import Finding, SourceFile
from theanompi_tpu_torch.analysis.registry import (
    PROFILE_SCOPE_PREFIXES,
    PROFILE_SCOPES,
)

RULE = "TM107"
#: the calls that open a profiler range
RANGE_CALLS = frozenset({"record_function", "scope"})


def label_registered(label: str) -> bool:
    """Whether a LITERAL range label resolves in the registry."""
    if label in PROFILE_SCOPES:
        return True
    return any(label.startswith(p) for p in PROFILE_SCOPE_PREFIXES)


def _is_range_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr in RANGE_CALLS
    if isinstance(f, ast.Name):
        return f.id in RANGE_CALLS
    return False


def _literal_head(arg: ast.AST) -> tuple[str | None, bool]:
    """``(label_or_head, is_full_literal)`` of the first argument: a
    string constant whole, an f-string's leading literal fragment (only
    a prefix is checkable), else ``(None, False)``."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, True
    if isinstance(arg, ast.JoinedStr) and arg.values:
        head = arg.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value, False
    return None, False


def check_file(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and _is_range_call(node)
                and node.args):
            continue
        label, full = _literal_head(node.args[0])
        if label is None:
            out.append(Finding(
                sf.rel, node.lineno, RULE,
                "profiler range label is not a (f-)string literal — the "
                "profiler cannot attribute a dynamic range; use a "
                "registered label or a registered-prefix f-string "
                "(analysis/registry.py PROFILE_SCOPES)",
            ))
            continue
        if full and label_registered(label):
            continue
        if not full and any(label.startswith(p)
                            for p in PROFILE_SCOPE_PREFIXES):
            continue
        out.append(Finding(
            sf.rel, node.lineno, RULE,
            f"profiler range label {label!r} is not registered in "
            f"analysis/registry.py (PROFILE_SCOPES/PROFILE_SCOPE_PREFIXES)"
            f" — its work silently falls into the profiler's compute leg",
        ))
    return out
