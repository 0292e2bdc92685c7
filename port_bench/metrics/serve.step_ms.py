"""``serve.step_ms``: the mean wall time of ``Engine.step()`` (with the
submission of the requests due before it) over the window, from the
driver's own stamps around each call."""


def read(rec):
    steps = rec.get("step_s")
    return 1e3 * sum(steps) / len(steps) if steps else None
