"""tmcheck rule family 4: the hot-path sanitizer (TM104) for torch, the
JAX package's ``analysis/hotpath.py`` for eager PyTorch on a card.

Functions seeded by name (``registry.HOT_EXACT``/``HOT_SUBSTR``: the
decode/prefill/step family and ``train_chunk``) or marked ``# tmcheck:
hot`` drive the card from Python.  The discipline: launches stay
asynchronous; at most ONE host sync a call, after the loop.  So TM104
fires, inside a loop of a hot function, on:

- ``.item()``, ``.tolist()`` and ``.cpu()``: each copies a device value
  to the host and waits for the stream;
- ``int()``/``float()``/``bool()`` of a tensor-derived value, and
  ``np.asarray``/``np.array`` of one (the same copy and wait, spelled
  as a conversion);

and anywhere in a hot function on ``torch.cuda.synchronize()`` and
``.synchronize()`` of an event or a stream: a barrier by definition.

A value is "tensor-derived" when it flows (intra-function) from a call
rooted at ``torch`` or ``F`` (``torch.nn.functional``), or from a
method call on such a value.  A comprehension is a loop; the iterable
of a ``for`` is evaluated once, before it.  Nested function bodies are
their own scopes, judged by their own names.  Functions named
``test_*`` are exempt (tests fence deliberately to assert values).

The JAX package's TM105 (a host-value-dependent shape recompiles) and
TM106 (a wall-clock or RNG call baked into a traced body) are about
traced bodies, which eager torch has none of; they return with a
capture that bakes host values in (a CUDA graph).
"""

from __future__ import annotations

import ast
import re

from theanompi_tpu_torch.analysis.core import Finding, SourceFile
from theanompi_tpu_torch.analysis.registry import HOT_EXACT, HOT_SUBSTR

_TENSOR_ROOT_RE = re.compile(r"^(torch|F)\b")
#: method calls that read a device value back to the host
_READBACKS = frozenset({"item", "tolist", "cpu"})
_FN_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _leaf(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_hot_name(name: str) -> bool:
    if name.startswith("test_"):
        return False
    low = name.lower()
    return name in HOT_EXACT or any(s in low for s in HOT_SUBSTR)


def _walk_pruned(node: ast.AST):
    """Descendants of ``node``, not entering nested function or lambda
    scopes (their bodies have their own verdicts)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, _FN_DEFS + (ast.Lambda,)):
            continue
        yield child
        yield from _walk_pruned(child)


def _nested_defs(fn: ast.AST):
    """Function defs whose nearest enclosing function is ``fn``."""
    out = []

    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FN_DEFS):
                out.append(child)
            else:
                rec(child)

    rec(fn)
    return out


def check_file(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []

    def visit(fn) -> None:
        if _is_hot_name(fn.name) or sf.hot_marked(fn.lineno):
            findings.extend(_check_host_hot(sf, fn))
        for nested in _nested_defs(fn):
            visit(nested)

    def toplevel(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FN_DEFS):
                yield child
            elif isinstance(child, ast.ClassDef):
                yield from toplevel(child)

    for fn in toplevel(sf.tree):
        visit(fn)
    return findings


def _is_tensor_call(sf: SourceFile, call: ast.Call) -> bool:
    """A call whose result is a tensor: rooted at ``torch``/``F``."""
    return bool(_TENSOR_ROOT_RE.match(sf.src(call.func)))


def _expr_tainted(sf: SourceFile, expr: ast.AST, tainted: set) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and _is_tensor_call(sf, node):
            return True
        if isinstance(node, ast.Name) and node.id in tainted:
            return True
    return False


def _taint_pass(sf: SourceFile, fn) -> set:
    """Tensor-tainted names; two passes so loop-carried flows settle.
    Nested scopes are pruned."""
    tainted: set[str] = set()
    for _ in range(2):
        for node in _walk_pruned(fn):
            if isinstance(node, (ast.For, ast.comprehension)):
                pairs = [(node.target, node.iter)]
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)) and node.value is not None:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                pairs = [(t, node.value) for t in targets]
            else:
                continue
            for target, value in pairs:
                if _expr_tainted(sf, value, tainted):
                    tainted |= {sub.id for sub in ast.walk(target)
                                if isinstance(sub, ast.Name)}
    return tainted


def _check_host_hot(sf: SourceFile, fn) -> list[Finding]:
    out: list[Finding] = []
    tainted = _taint_pass(sf, fn)
    where = f"{fn.name} (hot path)"

    def check_call(call: ast.Call, loop_depth: int) -> None:
        f = call.func
        leaf = _leaf(f)
        if leaf == "synchronize":
            out.append(Finding(
                sf.rel, call.lineno, "TM104",
                f"{where}: {sf.src(f)}() waits for the card inside a hot "
                f"path — it barriers every launch in flight",
            ))
        if loop_depth == 0:
            return
        if leaf in _READBACKS and isinstance(f, ast.Attribute):
            out.append(Finding(
                sf.rel, call.lineno, "TM104",
                f"{where}: per-iteration .{leaf}() copies a device value "
                f"to the host and waits — read once after the loop, or "
                f"keep the value on the device",
            ))
        elif leaf in ("int", "float", "bool") and isinstance(f, ast.Name):
            if call.args and _expr_tainted(sf, call.args[0], tainted):
                out.append(Finding(
                    sf.rel, call.lineno, "TM104",
                    f"{where}: per-iteration {leaf}() of a tensor — every "
                    f"loop pass waits for the card, serializing the "
                    f"launches; hoist the ONE sync past the loop",
                ))
        elif leaf in ("asarray", "array") and isinstance(f, ast.Attribute) \
                and isinstance(f.value, ast.Name) \
                and f.value.id in ("np", "numpy"):
            if call.args and _expr_tainted(sf, call.args[0], tainted):
                out.append(Finding(
                    sf.rel, call.lineno, "TM104",
                    f"{where}: per-iteration np.{leaf}() of a tensor — a "
                    f"blocking device-to-host copy every loop pass",
                ))

    def walk(node: ast.AST, loop_depth: int) -> None:
        if isinstance(node, _FN_DEFS + (ast.Lambda,)):
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # the iterable is evaluated once, before the first pass
            walk(node.iter, loop_depth)
            for child in (node.target, *node.body, *node.orelse):
                walk(child, loop_depth + 1)
            return
        if isinstance(node, (ast.While, ast.ListComp, ast.SetComp,
                             ast.DictComp, ast.GeneratorExp)):
            for child in ast.iter_child_nodes(node):
                walk(child, loop_depth + 1)
            return
        if isinstance(node, ast.Call):
            check_call(node, loop_depth)
        for child in ast.iter_child_nodes(node):
            walk(child, loop_depth)

    for stmt in fn.body:
        walk(stmt, 0)
    return out
