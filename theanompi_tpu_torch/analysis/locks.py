"""tmcheck rule families 1–3: lock discipline, lock order, held-lock
side effects (a copy of ``theanompi_tpu/analysis/locks.py``).

All three share one lexical lock model: a lock is held inside a
``with self._lock:`` block (any ``self`` attribute that is assigned
``threading.Lock()``/``RLock()`` in the class, or whose name contains
``lock``; plus local ``with some_lock:`` names), inside a method whose
name ends in ``_locked`` (the repo's called-with-lock-held suffix
convention), or inside a method whose ``def`` line carries a
``# tmcheck: holds=_lock`` marker.  Nested ``def``/``lambda`` bodies
run LATER, possibly without the lock — they are analyzed lock-free
(a closure touching guarded state is exactly the deferred-callback
bug class).  Comprehensions and generator expressions evaluate
inline and keep the held set.

**TM101 (lock discipline).**  Attributes registered as guarded —
``registry.GUARDED_BY`` seeds the control-plane classes; a
``# guarded-by: _lock`` comment on the ``self.attr = ...`` line
extends the set per class — may only be read or written with the
class's guard lock held.  ``__init__`` is exempt (single-threaded
construction).

**TM102 (ABBA / lock order).**  Builds the inter-class lock
acquisition graph: holding lock A and entering ``with self._other``
adds A→other; holding A and calling a method that (transitively,
across classes, resolved by method name + receiver hint) acquires B
adds A→B.  Any cycle — including a plain-``Lock`` self-cycle, which
is an immediate self-deadlock — fails.  RLock self-edges are legal
re-entrancy and ignored.

**TM103 (held-lock side effects).**  A deny list of operations that
must never run under a held lock (``registry.DENY_UNDER_LOCK``):
future resolution (``._set``), ``add_done_callback`` (fires inline on
a resolved future), socket sends without ``timeout_s``, blocking
``.result()``/queue ``.get()``/thread ``.join()``, and
``time.sleep``.  Calls to same-class methods that LEXICALLY perform a
deny op outside any lock of their own are propagated (transitively):
``self._shed(...)`` under the lock is flagged at the call site,
pointing at the future resolution inside ``_shed``.  A deny op whose
own line carries a ``tmcheck: disable=TM103`` suppression is a
documented exception and does not propagate.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from theanompi_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    is_suppressed_op,
)
from theanompi_tpu_torch.analysis.registry import (
    DENY_UNDER_LOCK,
    GUARDED_BY,
    RECEIVER_HINTS,
)

# ---------------------------------------------------------------------------
# class / method model
# ---------------------------------------------------------------------------


@dataclass
class _Method:
    name: str
    node: ast.FunctionDef
    accesses: list = field(default_factory=list)   # (attr, line, held)
    calls: list = field(default_factory=list)      # _CallSite
    acquire_direct: set = field(default_factory=set)   # lock attr names
    nested: list = field(default_factory=list)     # (outer, inner, line)
    deny_free: list = field(default_factory=list)  # (opid, line) held==∅
    deny_held: list = field(default_factory=list)  # (opid, line, held, msg)


@dataclass
class _CallSite:
    callee: str
    hint: str | None      # receiver's last name token; None for self
    is_self: bool
    line: int
    held: frozenset


@dataclass
class _Class:
    name: str
    sf: SourceFile
    node: ast.ClassDef
    locks: dict            # lock attr -> "Lock" | "RLock"
    methods: dict          # name -> _Method
    guard_lock: str | None
    guarded: frozenset


def _lock_kind(value: ast.AST) -> str | None:
    """``threading.Lock()`` / ``threading.RLock()`` (or bare
    ``Lock()``/``RLock()``) on the RHS of an assignment."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None
    )
    return name if name in ("Lock", "RLock") else None


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_token(expr: ast.AST, cls_locks: dict) -> str | None:
    """The held-set token a ``with`` context expression acquires:
    ``self.<attr>`` for known/lock-named attrs, ``<name>`` for
    lock-named locals.  None = not a lock acquisition."""
    attr = _self_attr(expr)
    if attr is not None:
        if attr in cls_locks or "lock" in attr.lower():
            return attr
        return None
    if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
        return f"(local){expr.id}"
    return None


def _receiver_hint(func: ast.Attribute) -> str | None:
    """Last name token of the receiver expression (``self.engine.submit``
    → ``engine``; ``member.replica.load`` → ``replica``)."""
    v = func.value
    if isinstance(v, ast.Attribute):
        return v.attr
    if isinstance(v, ast.Name):
        return v.id
    if isinstance(v, ast.Subscript):
        return _receiver_hint(ast.Attribute(value=v.value, attr="",
                                            ctx=ast.Load())) or None
    if isinstance(v, ast.Call) and isinstance(v.func, (ast.Attribute,
                                                       ast.Name)):
        return (v.func.attr if isinstance(v.func, ast.Attribute)
                else v.func.id)
    return None


def _deny_op(sf: SourceFile, call: ast.Call) -> tuple[str, str] | None:
    """Classify a call as a TM103 deny-list op -> (op id, detail)."""
    f = call.func
    kwnames = {k.arg for k in call.keywords}
    _TRACE_EXPORT = ("chrome_trace", "write_chrome_trace",
                     "critical_path", "collect_spans")
    if isinstance(f, ast.Name):
        if f.id == "send_frame" and "timeout_s" not in kwnames:
            return ("unbounded-send",
                    "send_frame(...) without timeout_s")
        if f.id in _TRACE_EXPORT:
            return ("trace-export",
                    f"{f.id}(...) exports a span ring under a lock")
        return None
    if not isinstance(f, ast.Attribute):
        return None
    recv = sf.src(f.value).lower()
    if f.attr in _TRACE_EXPORT:
        return ("trace-export",
                f".{f.attr}(...) exports a span ring under a lock")
    if f.attr == "_set":
        return ("future-resolve", f"{sf.src(f)}() resolves a future")
    if f.attr == "add_done_callback":
        return ("done-callback",
                "add_done_callback() fires inline on a resolved future")
    if f.attr == "sendall":
        return ("unbounded-send", "raw .sendall() (no deadline)")
    if f.attr == "send_frame" and "timeout_s" not in kwnames:
        return ("unbounded-send", "send_frame(...) without timeout_s")
    if (f.attr == "sleep" and isinstance(f.value, ast.Name)
            and f.value.id == "time"):
        return ("sleep", "time.sleep() while holding a lock")
    if (f.attr == "result" and not call.args
            and "timeout" not in kwnames and "fut" in recv):
        return ("blocking-wait", "unbounded future .result() wait")
    if (f.attr == "get" and "queue" in recv and not call.args
            and not kwnames):
        return ("blocking-wait", "blocking queue .get()")
    if f.attr == "join" and "thread" in recv:
        return ("blocking-wait", "thread .join() while holding a lock")
    return None


# ---------------------------------------------------------------------------
# the lexical walker
# ---------------------------------------------------------------------------


def _scan_method(sf: SourceFile, cls: "_Class",
                 fn: ast.FunctionDef) -> _Method:
    m = _Method(fn.name, fn)
    held0: frozenset = frozenset()
    marker = sf.holds(fn.lineno)
    if marker is not None:
        held0 = frozenset({marker})
    elif fn.name.endswith("_locked"):
        lock = cls.guard_lock or (sorted(cls.locks)[0] if cls.locks
                                  else None)
        if lock is not None:
            held0 = frozenset({lock})

    def walk(node: ast.AST, held: frozenset,
             deferred: bool = False) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # deferred execution: the lock is NOT held when this
            # runs, and its calls/ops do NOT run when the enclosing
            # method does (so they feed neither the latent-deny
            # propagation nor the direct TM103 check) — but guarded-
            # attribute accesses still matter: a closure touching
            # guarded state lock-free is the deferred-callback bug
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                walk(child, frozenset(), deferred=True)
            return
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                tok = _lock_token(item.context_expr, cls.locks)
                if tok is not None:
                    acquired.append((tok, item.context_expr.lineno))
                else:
                    walk(item.context_expr, held, deferred)
            for tok, line in acquired:
                if not tok.startswith("(local)") and not deferred:
                    m.acquire_direct.add(tok)
                for h in held:
                    m.nested.append((h, tok, line))
            inner = held | {tok for tok, _ in acquired}
            for child in node.body:
                walk(child, inner, deferred)
            return
        if isinstance(node, ast.Call):
            if not deferred:
                op = _deny_op(sf, node)
                if op is not None:
                    if held:
                        m.deny_held.append(
                            (op[0], node.lineno, held, op[1])
                        )
                    else:
                        m.deny_free.append((op[0], node.lineno, op[1]))
                f = node.func
                if isinstance(f, ast.Attribute):
                    if isinstance(f.value, ast.Name) \
                            and f.value.id == "self":
                        m.calls.append(_CallSite(f.attr, None, True,
                                                 node.lineno, held))
                    else:
                        m.calls.append(_CallSite(
                            f.attr, _receiver_hint(f), False,
                            node.lineno, held,
                        ))
            for child in ast.iter_child_nodes(node):
                walk(child, held, deferred)
            return
        attr = _self_attr(node)
        if attr is not None:
            m.accesses.append((attr, node.lineno, held))
            walk(node.value, held, deferred)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held, deferred)

    for stmt in fn.body:
        walk(stmt, held0)
    return m


def _classes_of(sf: SourceFile) -> list[_Class]:
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        fns = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        locks: dict[str, str] = {}
        guarded_extra: set[str] = set()
        comment_lock: str | None = None
        for fn in fns.values():
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign):
                    targets, value = sub.targets, sub.value
                elif isinstance(sub, ast.AnnAssign) and \
                        sub.value is not None:
                    targets, value = [sub.target], sub.value
                else:
                    continue
                kind = _lock_kind(value)
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    if kind is not None:
                        locks[attr] = kind
                    g = sf.guarded_comment(sub.lineno)
                    if g is not None:
                        guarded_extra.add(attr)
                        comment_lock = g
        reg = GUARDED_BY.get(node.name)
        guard_lock = (reg[0] if reg else None) or comment_lock
        guarded = frozenset((reg[1] if reg else frozenset())
                            | guarded_extra)
        cls = _Class(node.name, sf, node, locks, {}, guard_lock, guarded)
        cls.methods = {
            name: _scan_method(sf, cls, fn) for name, fn in fns.items()
        }
        out.append(cls)
    return out


# ---------------------------------------------------------------------------
# TM101 + TM103 (per file)
# ---------------------------------------------------------------------------


def check_file(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for cls in _classes_of(sf):
        findings.extend(_check_guarded(sf, cls))
        findings.extend(_check_held_effects(sf, cls))
    return findings


def _check_guarded(sf: SourceFile, cls: _Class) -> list[Finding]:
    if not cls.guarded or cls.guard_lock is None:
        return []
    out = []
    for m in cls.methods.values():
        if m.name in ("__init__", "__del__", "__post_init__"):
            continue
        for attr, line, held in m.accesses:
            if attr in cls.guarded and cls.guard_lock not in held:
                out.append(Finding(
                    sf.rel, line, "TM101",
                    f"{cls.name}.{m.name}: self.{attr} accessed "
                    f"without holding self.{cls.guard_lock} "
                    f"(guarded attribute)",
                ))
    return out


def _latent_deny(cls: _Class) -> dict[str, list]:
    """Per-method transitive deny ops reachable OUTSIDE any lock of
    its own — what a caller holding a lock would execute under it.
    Suppressed ops (documented exceptions) do not propagate."""
    sf = cls.sf
    base: dict[str, list] = {}
    for name, m in cls.methods.items():
        ops = []
        for op, line, detail in m.deny_free:
            if is_suppressed_op(sf, line, "TM103"):
                sf.used_suppressions.add((line, "TM103"))
            else:
                ops.append((op, line, detail))
        base[name] = ops
    latent = {name: list(ops) for name, ops in base.items()}
    for _ in range(len(cls.methods) + 1):
        changed = False
        for name, m in cls.methods.items():
            for c in m.calls:
                if not c.is_self or c.held or c.callee not in latent:
                    continue
                if is_suppressed_op(sf, c.line, "TM103"):
                    if latent[c.callee]:
                        sf.used_suppressions.add((c.line, "TM103"))
                    continue
                for op in latent[c.callee]:
                    if op not in latent[name]:
                        latent[name].append(op)
                        changed = True
        if not changed:
            break
    return latent


def _check_held_effects(sf: SourceFile, cls: _Class) -> list[Finding]:
    out = []
    for m in cls.methods.values():
        for op, line, held, detail in m.deny_held:
            locks = ", ".join(sorted(held))
            out.append(Finding(
                sf.rel, line, "TM103",
                f"{cls.name}.{m.name}: {detail} while holding "
                f"{locks} — {DENY_UNDER_LOCK[op]}",
            ))
    latent = _latent_deny(cls)
    for m in cls.methods.values():
        for c in m.calls:
            if not c.is_self or not c.held:
                continue
            for op, line, detail in latent.get(c.callee, []):
                locks = ", ".join(sorted(c.held))
                out.append(Finding(
                    sf.rel, c.line, "TM103",
                    f"{cls.name}.{m.name}: call to self.{c.callee}() "
                    f"while holding {locks} reaches a forbidden op "
                    f"({detail}, line {line}) — "
                    f"{DENY_UNDER_LOCK[op]}",
                ))
    return out


# ---------------------------------------------------------------------------
# TM102 (cross-file)
# ---------------------------------------------------------------------------


def _resolve(classes: list[_Class], cur: _Class,
             site: _CallSite) -> list[tuple[_Class, str]]:
    if site.is_self:
        return [(cur, site.callee)] if site.callee in cur.methods else []
    cands = [c for c in classes if site.callee in c.methods]
    if not cands:
        return []
    hint = (site.hint or "").lstrip("_").lower()
    kw = RECEIVER_HINTS.get(hint, hint if len(hint) > 2 else None)
    if kw:
        matched = [c for c in cands if kw in c.name.lower()]
        if matched:
            return [(c, site.callee) for c in matched]
    # unhinted fallback: everything defining the method, except the
    # calling class itself (a non-self receiver of the same class is
    # rare; assuming it manufactures self-cycles)
    return [(c, site.callee) for c in cands if c is not cur]


def check_lock_order(files: list[SourceFile]) -> list[Finding]:
    classes = [c for sf in files for c in _classes_of(sf)]
    by_id = {(c.name, name): (c, m)
             for c in classes for name, m in c.methods.items()}

    # transitive lock-acquisition sets per method
    acq: dict[tuple, set] = {
        key: {(c.name, a) for a in m.acquire_direct}
        for key, (c, m) in by_id.items()
    }
    for _ in range(len(by_id) + 1):
        changed = False
        for key, (c, m) in by_id.items():
            for site in m.calls:
                for d, name in _resolve(classes, c, site):
                    extra = acq.get((d.name, name), set())
                    if not extra <= acq[key]:
                        acq[key] |= extra
                        changed = True
        if not changed:
            break

    # the edge set, each with one witness
    edges: dict[tuple, tuple] = {}   # (A, B) -> (rel, line, why)

    def add_edge(a: tuple, b: tuple, rel: str, line: int,
                 why: str) -> None:
        if a == b:
            owner = next((c for c in classes if c.name == a[0]), None)
            if owner is not None and owner.locks.get(a[1]) == "RLock":
                return        # legal re-entrancy
        if (a, b) not in edges:
            edges[(a, b)] = (rel, line, why)

    for c in classes:
        for m in c.methods.values():
            for outer, inner, line in m.nested:
                if outer.startswith("(local)") or \
                        inner.startswith("(local)"):
                    continue
                add_edge((c.name, outer), (c.name, inner), c.sf.rel,
                         line, f"{c.name}.{m.name} nests the locks")
            for site in m.calls:
                held = [h for h in site.held
                        if not h.startswith("(local)")]
                if not held:
                    continue
                targets: set = set()
                for d, name in _resolve(classes, c, site):
                    targets |= acq.get((d.name, name), set())
                for h in held:
                    for t in sorted(targets):
                        add_edge(
                            (c.name, h), t, c.sf.rel, site.line,
                            f"{c.name}.{m.name} calls "
                            f".{site.callee}() under {h}",
                        )

    return _cycles_to_findings(edges)


def _cycles_to_findings(edges: dict) -> list[Finding]:
    graph: dict[tuple, set] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    # Tarjan SCC, iterative
    index: dict[tuple, int] = {}
    low: dict[tuple, int] = {}
    on: set = set()
    stack: list = []
    sccs: list[list] = []
    counter = [0]

    def strongconnect(v: tuple) -> None:
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    findings = []
    for scc in sccs:
        nodes = set(scc)
        cyclic = len(scc) > 1 or any(
            (v, v) in edges for v in scc
        )
        if not cyclic:
            continue
        involved = sorted(
            (a, b) for (a, b) in edges if a in nodes and b in nodes
        )
        rel, line, why = edges[involved[0]]
        path = " -> ".join(f"{c}.{l}" for c, l in sorted(nodes))
        details = "; ".join(
            f"{edges[e][2]} ({edges[e][0]}:{edges[e][1]})"
            for e in involved
        )
        findings.append(Finding(
            rel, line, "TM102",
            f"lock-order cycle: {path} — {details}",
        ))
    return findings
