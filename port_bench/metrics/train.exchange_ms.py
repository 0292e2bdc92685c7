"""``train.exchange_ms``: device milliseconds a traced step under the
port's ``exchange_b*`` ranges (at one rank the flat pack and the mean
of the gradients)."""


def read(rec):
    work = rec.get("work")
    if work is None or "steps" not in rec:
        return None
    ops = [op for op in work.select(label_prefix="exchange_b")
           if "opt_update" not in op[3]]
    return 1e3 * work.busy_s(ops) / rec["steps"] if ops else None
