"""Observability of the port: span tracing (the bounded flight
recorder), its Chrome-trace/Perfetto export with critical-path
attribution, and Prometheus-style metrics text — copies of the JAX
package's ``obs/tracer.py``, ``obs/export.py`` and ``obs/metrics.py``
(stdlib and json only); the step-phase profiler (``obs/profiler.py``,
over ``torch.profiler`` and ``utils/trace_comm``) and the bench
trajectory judge (``obs/regress.py``, a copy)."""

from theanompi_tpu_torch.obs.export import (
    chrome_trace,
    critical_path,
    format_critical_path,
    span_tree,
    write_chrome_trace,
)
from theanompi_tpu_torch.obs.metrics import quantile_samples, render_metrics
from theanompi_tpu_torch.obs.profiler import (
    StepProfile,
    format_profile,
    gap_attribution,
    profile_scope_sets,
    scope,
    step_profile,
)
from theanompi_tpu_torch.obs.tracer import (
    DEFAULT_TRACE_SAMPLE,
    Tracer,
    child_context,
    force_sample,
    make_context,
)

__all__ = [
    "DEFAULT_TRACE_SAMPLE",
    "StepProfile",
    "Tracer",
    "child_context",
    "chrome_trace",
    "critical_path",
    "force_sample",
    "format_critical_path",
    "format_profile",
    "gap_attribution",
    "make_context",
    "profile_scope_sets",
    "quantile_samples",
    "render_metrics",
    "scope",
    "span_tree",
    "step_profile",
    "write_chrome_trace",
]
