"""``train.idle``: the share of the traced window in which no op ran on
the card, in percent."""


def read(rec):
    work = rec.get("work")
    if work is None or "steps" not in rec or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - work.busy_s() / rec["window_s"])
