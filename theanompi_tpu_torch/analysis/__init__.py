"""tmcheck for the port: AST checkers for the bug classes of threaded
control planes and of hot loops that drive the card.

- ``locks.py`` — TM101 lock discipline, TM102 lock-order cycles, TM103
  held-lock side effects (a copy of the JAX package's).
- ``hotpath.py`` — TM104, the host syncs of torch in a hot path.
- ``scopes.py`` — TM107, profiler range labels resolve in
  ``registry.py``.
- ``refusals.py`` — the generated ``REFUSALS.md`` NotImplementedError
  matrix of the port.
- ``core.py`` — findings, ``# tmcheck:`` annotations, suppression
  tracking (TM201 stale suppression).

Run it: ``python -m theanompi_tpu_torch.analysis`` (``cli.py``).
"""

from theanompi_tpu_torch.analysis.core import (
    RULES,
    Finding,
    SourceFile,
    collect,
    iter_source_files,
)

__all__ = [
    "RULES", "Finding", "SourceFile", "collect", "iter_source_files",
]
