"""``serve.decode_device_ms``: device milliseconds a decode step: the
card's busy time under the driver's ``bench.decode`` range (around the
engine's call of the decoder's ``decode``) over the traced calls."""


def read(rec):
    work = rec.get("work")
    n = (rec.get("calls") or {}).get("decode")
    if work is None or not n:
        return None
    ops = work.select(label="bench.decode")
    return 1e3 * work.busy_s(ops) / n if ops else None
