"""The registries of the JAX package's ``analysis/registry.py`` that
the port reads: the profiler's range labels and the legs they file
under (a copy of ``PROFILE_SCOPES`` and ``PROFILE_SCOPE_PREFIXES``; the
port's ranges are ``torch.profiler.record_function`` labels where the
JAX package has ``jax.named_scope`` labels)."""

from __future__ import annotations


#: profiler-range registry (consumed by ``obs/profiler.py``).  Exact
#: ``torch.profiler.record_function`` label -> the StepProfile leg the
#: work under it is attributed to.  A label absent from BOTH tables is
#: a range the profiler would silently file under "compute".
PROFILE_SCOPES: dict[str, str] = {
    # compressed-exchange codec halves (parallel/exchange.py)
    "quantize_wire": "quantize",
    "dequantize_wire": "quantize",
    # optimizer update (models/base.py, scatter_update_gather's
    # per-bucket update)
    "opt_update": "optimizer",
    # serving decode attribution (serving/decoder.py)
    "serving_sample": "sample",
    "paged_attend": "attend",
    "kv_write": "kv_write",
    # host→device batch staging (data/pipeline.py HostStager): the
    # residual feed cost the streaming loader can't hide
    "host_load": "host_load",
}

#: label PREFIX -> leg family: labels carrying a per-instance index
#: (``exchange_b{i}`` — one leg per exchange bucket).  The profiler
#: keeps the full label as the leg name; a literal label (or an
#: f-string's literal head) starting with a prefix is registered.
PROFILE_SCOPE_PREFIXES: dict[str, str] = {
    "exchange_b": "exchange",
}
