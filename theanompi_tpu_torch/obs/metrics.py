"""Prometheus-style text exposition (a copy of
``theanompi_tpu/obs/metrics.py``; no HTTP dependency — the text
rides the repo's existing transports: a ``metrics`` frame on the
replica TCP wire, ``Router.metrics_txt()`` on demand, or a plain
file dump).

One renderer so every producer (``ServingRecorder``,
``FleetRecorder``, ``Autoscaler``) emits the same dialect: the
``# TYPE`` header per family, ``name{label="v"} value`` samples,
stable snake_case names under the ``tm_`` prefix.  Percentiles are
exposed as Prometheus summary quantiles (``tm_serving_ttft_seconds
{quantile="0.95"}``), counters end in ``_total``, and None values
are simply omitted (absent series, not NaN noise)."""

from __future__ import annotations


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(float(v))
    return str(int(v))


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


def render_metrics(families) -> str:
    """``families`` is an iterable of ``(name, mtype, samples)``
    where ``mtype`` is ``counter``/``gauge``/``summary`` and
    ``samples`` a list of ``(labels_dict_or_None, value)``.  Samples
    with value None are dropped; families with no surviving samples
    are dropped whole."""
    out = []
    for name, mtype, samples in families:
        kept = [(lb, v) for lb, v in samples if v is not None]
        if not kept:
            continue
        out.append(f"# TYPE {name} {mtype}")
        for labels, value in kept:
            out.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(out) + ("\n" if out else "")


def quantile_samples(by_quantile: dict, extra_labels: dict | None = None
                     ) -> list:
    """Summary-quantile samples from ``{"0.5": v, "0.95": v}``."""
    return [
        ({**(extra_labels or {}), "quantile": q}, v)
        for q, v in by_quantile.items()
    ]
