"""``serve.idle``: the share of the profiled steps' window (the steps
after the run's window) in which no op ran on the card, in percent.
The profiler's own host cost lengthens those steps (about four times,
NVIDIA H100, PR 24), so this reads higher than the unprofiled loop's
idle share; it compares like with like between runs."""


def read(rec):
    work = rec.get("work")
    if work is None or "calls" not in rec or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - work.busy_s() / rec["window_s"])
