"""``train.compute_ms``: device milliseconds a traced step outside the
port's ``opt_update`` and ``exchange_b*`` ranges (the forward, the
backward and the head), each op filed under the ranges open where it
was launched."""


def read(rec):
    work = rec.get("work")
    if work is None or "steps" not in rec:
        return None
    ops = [op for op in work.ops
           if "opt_update" not in op[3]
           and not any(x.startswith("exchange_b") for x in op[3])]
    return 1e3 * work.busy_s(ops) / rec["steps"]
