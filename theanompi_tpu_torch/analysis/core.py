"""tmcheck core: findings, suppressions, and the source-file model (a
copy of ``theanompi_tpu/analysis/core.py`` with the port's rule
catalog).

The checker suite (``python -m theanompi_tpu_torch.analysis``) is
AST-based and import-free: every target file is parsed, never
executed, so the gate runs in milliseconds and cannot be wedged by
import-time side effects.  This module owns the pieces every rule
family shares:

- :class:`Finding` — one diagnostic, ``file:line: RULE message``.
- :class:`SourceFile` — a parsed file plus its tmcheck annotations:

  - ``# tmcheck: disable=TM103`` (comma-separated rule ids) on the
    finding's line suppresses it.  Suppressions are TRACKED: one that
    matches no finding is itself a finding (``TM201`` stale
    suppression), so dead annotations cannot accumulate.
  - ``# tmcheck: holds=_lock`` on a ``def`` line declares the method
    is only called with that lock already held (the repo's
    ``*_locked`` suffix convention, made explicit for helpers whose
    names predate it).
  - ``# tmcheck: hot`` on a ``def`` line adds the function to the
    hot-path sanitizer's seed set (``hotpath.py``).
  - ``# guarded-by: _lock`` on a ``self.attr = ...`` line registers
    the attribute for the lock-discipline rule, extending the seeded
    per-class registry (``registry.py``).

- :func:`collect` — run rule families over files, apply suppressions,
  emit ``TM201`` for the stale ones, and return the active findings
  sorted for deterministic output.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path

#: rule catalog of the port's suite (TM105 and TM106, rules of traced
#: JAX bodies, have no eager torch counterpart)
RULES = {
    "TM101": "guarded attribute accessed outside its lock",
    "TM102": "lock-order (ABBA) cycle across classes",
    "TM103": "forbidden side effect under a held lock",
    "TM104": "host-sync fence in a hot path",
    "TM107": "profiler range label not registered for attribution",
    "TM201": "stale tmcheck suppression (matches no finding)",
}


@dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic, ordered for deterministic reporting."""

    path: str      # repo-relative, or the fixture's virtual name
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


_SUPPRESS_RE = re.compile(r"#\s*tmcheck:\s*disable=([A-Z0-9,\s]+)")
_HOLDS_RE = re.compile(r"#\s*tmcheck:\s*holds=(\w+)")
_HOT_RE = re.compile(r"#\s*tmcheck:\s*hot\b")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")


class SourceFile:
    """A parsed target file + its tmcheck annotations."""

    def __init__(self, text: str, rel: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        #: line -> comment text (REAL comments via tokenize — a
        #: docstring QUOTING an annotation must not activate it)
        self.comments: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(text).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            pass
        #: (line, rule) pairs a rule module consumed semantically
        #: without emitting a finding (e.g. a suppressed deny-op that
        #: therefore didn't propagate) — counted as used by TM201
        self.used_suppressions: set[tuple[int, str]] = set()
        #: line -> set of rule ids disabled on that line
        self.suppressions: dict[int, set[str]] = {}
        for i, comment in self.comments.items():
            m = _SUPPRESS_RE.search(comment)
            if m:
                self.suppressions[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }

    @classmethod
    def read(cls, path: Path, rel: str) -> "SourceFile":
        return cls(path.read_text(), rel)

    def holds(self, lineno: int) -> str | None:
        """Lock named by a ``holds=`` marker on this line (def line)."""
        m = _HOLDS_RE.search(self.comments.get(lineno, ""))
        return m.group(1) if m else None

    def hot_marked(self, lineno: int) -> bool:
        return bool(_HOT_RE.search(self.comments.get(lineno, "")))

    def guarded_comment(self, lineno: int) -> str | None:
        """Lock named by a ``# guarded-by:`` comment on this line."""
        m = _GUARDED_RE.search(self.comments.get(lineno, ""))
        return m.group(1) if m else None

    def src(self, node: ast.AST) -> str:
        """Source text of a node (best-effort; '' when unavailable)."""
        try:
            return ast.get_source_segment(self.text, node) or ""
        except Exception:
            return ""


def iter_source_files(root: Path, targets) -> list[SourceFile]:
    """Parse every ``*.py`` under the target dirs/files (skipping
    ``__pycache__``), sorted for deterministic runs.  A file that
    does not parse is the LINT gate's finding, not ours — skip it."""
    out = []
    for target in targets:
        p = (root / target) if not Path(target).is_absolute() else Path(target)
        files = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
        for f in files:
            if "__pycache__" in f.parts or not f.is_file():
                continue
            try:
                rel = str(f.relative_to(root))
            except ValueError:
                rel = str(f)          # outside the repo: full path
            try:
                out.append(SourceFile.read(f, rel))
            except (SyntaxError, ValueError):
                continue
    return out


#: rules whose findings need the WHOLE tree (edges may live in other
#: files) — their suppressions are exempt from TM201 staleness in a
#: partial (changed-only) run
CROSS_FILE_RULES = frozenset({"TM102"})


def collect(files, rule_fns, cross_fns=(),
            partial: bool = False) -> list[Finding]:
    """Run per-file rules + cross-file rules, apply suppressions, and
    append TM201 for every suppression that matched nothing.
    ``partial=True`` = the file set is a subset of the tree: cross-
    file-rule suppressions are not reported stale (their finding may
    depend on files outside the subset)."""
    raw: list[Finding] = []
    for sf in files:
        for fn in rule_fns:
            raw.extend(fn(sf))
    for fn in cross_fns:
        raw.extend(fn(files))

    by_rel = {sf.rel: sf for sf in files}
    active: list[Finding] = []
    used: set[tuple[str, int, str]] = set()
    for sf in files:
        used |= {(sf.rel, ln, r) for ln, r in sf.used_suppressions}
    for f in raw:
        sf = by_rel.get(f.path)
        sup = sf.suppressions.get(f.line, set()) if sf else set()
        if f.rule in sup:
            used.add((f.path, f.line, f.rule))
        else:
            active.append(f)
    for sf in files:
        for line, rules in sorted(sf.suppressions.items()):
            for rule in sorted(rules):
                if rule not in RULES:
                    active.append(Finding(
                        sf.rel, line, "TM201",
                        f"unknown rule id {rule!r} in suppression",
                    ))
                elif (sf.rel, line, rule) not in used:
                    if partial and rule in CROSS_FILE_RULES:
                        continue
                    active.append(Finding(
                        sf.rel, line, "TM201",
                        f"suppression of {rule} matches no finding "
                        f"— remove it",
                    ))
    return sorted(active)


def is_suppressed_op(sf: SourceFile, lineno: int, rule: str) -> bool:
    """Whether a would-be finding at this line carries a suppression
    (used by locks.py so suppressed deny-ops don't propagate through
    the call graph — a documented exception is not a latent hazard)."""
    return rule in sf.suppressions.get(lineno, set())
