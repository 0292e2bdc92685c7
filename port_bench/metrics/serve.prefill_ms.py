"""``serve.prefill_ms``: the mean duration of the engine's own
``prefill`` spans (``obs/tracer.py``: admission to the first token, its
chunks between decode steps) over the window's completed requests."""


def read(rec):
    spans = rec.get("prefill_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
