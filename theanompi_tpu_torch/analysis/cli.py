"""``python -m theanompi_tpu_torch.analysis`` — run the port's
static-analysis suite (tmcheck: lock discipline, lock order, held-lock
side effects, the torch hot-path sanitizer, profiler-range
registration) over ``theanompi_tpu_torch/`` (or the targets given).

Exit codes: 0 clean, 1 findings, 2 could not run.

``--changed-only`` restricts the per-file rule families to files
changed against HEAD (plus untracked ones).  The cross-file lock-order
rule (TM102) sees only those files too: fewer files can only drop
edges, and suppressions of cross-file rules are exempt from TM201
staleness in this mode, so it never reports what a full run would
not; the full run remains the source of truth.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from theanompi_tpu_torch.analysis import (
    core,
    hotpath,
    locks,
    refusals,
    scopes,
)

DEFAULT_TARGETS = ("theanompi_tpu_torch",)


def _repo_root() -> Path:
    """The tree to check: the git toplevel when the working directory is
    a checkout carrying the package, else the package's own parent."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0:
            top = Path(out.stdout.strip())
            if (top / DEFAULT_TARGETS[0]).exists():
                return top
    except (OSError, subprocess.TimeoutExpired):
        pass
    return Path(__file__).resolve().parent.parent.parent


def _changed_files(root: Path) -> list[str] | None:
    """Repo-relative changed + untracked .py files under the default
    targets, None when git is unavailable (the caller runs in full)."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "--diff-filter=d", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=30,
        )
        if out.returncode != 0:
            return None
        others = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    names = out.stdout.split() + (
        others.stdout.split() if others.returncode == 0 else []
    )
    return sorted({
        n for n in names
        if n.endswith(".py")
        and any(n == t or n.startswith(t + "/") for t in DEFAULT_TARGETS)
    })


def run_suite(root: Path, targets,
              partial: bool = False) -> list[core.Finding]:
    """Every rule family over ``targets`` (under ``root``).
    ``partial=True`` (changed-only): suppressions of cross-file rules
    are not reported stale."""
    files = core.iter_source_files(root, targets)
    return core.collect(
        files,
        rule_fns=(locks.check_file, hotpath.check_file, scopes.check_file),
        cross_fns=(locks.check_lock_order,),
        partial=partial,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m theanompi_tpu_torch.analysis",
        description="the port's static-analysis suite (lock discipline, "
                    "lock order, held-lock side effects, the hot-path "
                    "sanitizer, profiler-range registration)",
    )
    ap.add_argument("targets", nargs="*",
                    help=f"files/dirs to check (default: "
                         f"{' '.join(DEFAULT_TARGETS)})")
    ap.add_argument("--changed-only", action="store_true",
                    help="check only files changed vs HEAD")
    ap.add_argument("--write-refusals", action="store_true",
                    help=f"regenerate {refusals.DOC_REL} and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    root = _repo_root()
    if args.list_rules:
        for rule, desc in sorted(core.RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    if args.write_refusals:
        out = refusals.write(root)
        print(f"tmcheck: wrote {out.relative_to(root)}")
        return 0

    partial = False
    if args.targets:
        targets = args.targets
        missing = [t for t in targets
                   if not (Path(t) if Path(t).is_absolute()
                           else root / t).exists()]
        if missing:
            # a typo'd target must not read as "clean"
            print(f"tmcheck: no such target(s): {', '.join(missing)}",
                  file=sys.stderr)
            return 2
    else:
        targets = [t for t in DEFAULT_TARGETS if (root / t).exists()]
        if not targets:
            print(f"tmcheck: {'/'.join(DEFAULT_TARGETS)} does not exist "
                  f"under {root}", file=sys.stderr)
            return 2
        if args.changed_only:
            changed = _changed_files(root)
            if changed is not None:
                if not changed:
                    print("tmcheck: no changed files", file=sys.stderr)
                    return 0
                targets = changed
                partial = True

    try:
        findings = run_suite(root, targets, partial=partial)
    except OSError as e:
        print(f"tmcheck: cannot run: {e}", file=sys.stderr)
        return 2
    for f in findings:
        print(f)
    if findings:
        print(f"tmcheck: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0
