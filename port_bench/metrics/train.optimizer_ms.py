"""``train.optimizer_ms``: device milliseconds a traced step under the
port's ``opt_update`` range (the optimizer's update of every leaf)."""


def read(rec):
    work = rec.get("work")
    if work is None or "steps" not in rec:
        return None
    ops = work.select(label="opt_update")
    return 1e3 * work.busy_s(ops) / rec["steps"] if ops else None
