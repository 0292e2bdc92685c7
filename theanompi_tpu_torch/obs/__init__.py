"""Observability of the port: span tracing (the bounded flight
recorder), its Chrome-trace/Perfetto export with critical-path
attribution, and Prometheus-style metrics text — copies of the JAX
package's ``obs/tracer.py``, ``obs/export.py`` and ``obs/metrics.py``
(stdlib and json only).  The JAX package's step profiler reads XLA's
HLO and has no counterpart here yet (ROADMAP A13)."""

from theanompi_tpu_torch.obs.export import (
    chrome_trace,
    critical_path,
    format_critical_path,
    span_tree,
    write_chrome_trace,
)
from theanompi_tpu_torch.obs.metrics import quantile_samples, render_metrics
from theanompi_tpu_torch.obs.tracer import (
    DEFAULT_TRACE_SAMPLE,
    Tracer,
    child_context,
    force_sample,
    make_context,
)

__all__ = [
    "DEFAULT_TRACE_SAMPLE",
    "Tracer",
    "child_context",
    "chrome_trace",
    "critical_path",
    "force_sample",
    "format_critical_path",
    "make_context",
    "quantile_samples",
    "render_metrics",
    "span_tree",
    "write_chrome_trace",
]
