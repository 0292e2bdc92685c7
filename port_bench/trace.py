"""Profiler traces of a run, read into the records the per-layer
metrics take.

The attribution is that of the port's ``utils/trace_comm.py``, copied:
a device event (kernel, memcpy, memset) belongs to the ranges open on
the host thread that launched it, found through the event's
correlation id and its launch call; every stream of the card is one
timeline.  ``Capture`` runs ``torch.profiler`` over part of a run and
writes its Chrome trace under the temporary directory the environment
names, then deletes it once read.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

#: trace event categories of device work, and of the host calls that
#: launch it
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _ns(us) -> int:
    return int(round(float(us) * 1000))


def merge(iv: list) -> list:
    """Sorted, merged ``(start, end)`` intervals."""
    if not iv:
        return []
    iv = sorted(iv)
    out = [iv[0]]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def span(iv) -> int:
    return sum(e - s for s, e in iv)


class _Ranges:
    """One thread's ``record_function`` ranges: the labels open at a
    time, outermost first."""

    def __init__(self, ranges: list):
        self._r = sorted(ranges)
        self._starts = [s for s, _, _ in self._r]

    def stack(self, t: int) -> list:
        hi = bisect.bisect_right(self._starts, t)
        return [name for s, e, name in self._r[:hi] if s <= t < e]


class DeviceWork:
    """A trace read into device events with the host ranges that
    launched them.

    ``ops``: ``[(name, start ns, end ns, stack)]``; ``host``: the
    profiled thread's ranges (to name what the host did while the card
    sat idle)."""

    def __init__(self, doc: dict, main_tid: int | None = None):
        evs = [e for e in doc.get("traceEvents", ())
               if e.get("ph") == "X" and "ts" in e]
        by_thread: dict = {}
        for e in evs:
            if e.get("cat") == "user_annotation":
                s = _ns(e["ts"])
                by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (s, s + _ns(e.get("dur", 0)), e["name"]))
        ranges = {k: _Ranges(v) for k, v in by_thread.items()}
        launch = {}
        for e in evs:
            if e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = (e.get("pid"), e.get("tid"),
                                    _ns(e["ts"]))
        self.ops = []
        for e in evs:
            if e.get("cat") not in DEVICE_CATEGORIES:
                continue
            at = launch.get((e.get("args") or {}).get("correlation"))
            stack = (ranges[at[:2]].stack(at[2])
                     if at is not None and at[:2] in ranges else [])
            s = _ns(e["ts"])
            self.ops.append((e["name"], s, s + _ns(e.get("dur", 0)), stack))
        self.host = None
        if main_tid is not None:
            for (pid, tid), r in ranges.items():
                if tid == main_tid:
                    self.host = r

    def select(self, name_part: str | None = None, label: str | None = None,
               label_prefix: str | None = None) -> list:
        """The ops whose name holds ``name_part`` and whose stack holds
        ``label`` (or a label starting with ``label_prefix``)."""
        out = []
        for op in self.ops:
            if name_part is not None and name_part not in op[0]:
                continue
            if label is not None and label not in op[3]:
                continue
            if label_prefix is not None and not any(
                    x.startswith(label_prefix) for x in op[3]):
                continue
            out.append(op)
        return out

    def busy_s(self, ops=None) -> float:
        """Seconds in which any of ``ops`` (default: all) ran."""
        ops = self.ops if ops is None else ops
        return span(merge([(s, e) for _, s, e, _ in ops if e > s])) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e, _ in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The card's idle time between its first and last op, summed
        by the innermost host range open where each gap starts (the
        profiled thread's; ``host`` where none is open)."""
        iv = merge([(s, e) for _, s, e, _ in self.ops if e > s])
        by: dict = {}
        for (_, e0), (s1, _) in zip(iv, iv[1:]):
            st = self.host.stack(e0) if self.host is not None else []
            key = st[-1] if st else "host"
            by[key] = by.get(key, 0) + (s1 - e0)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Capture:
    """``torch.profiler`` over part of a run: ``start()``, the work,
    ``stop()``; then ``work()`` reads the trace (once) and removes it.
    ``window_s`` is the host's time from start to stop, both taken after
    the card has finished what was queued."""

    def __init__(self):
        self._prof = None
        self.window_s = None
        self._t0 = None

    def start(self) -> None:
        import threading

        import torch
        from torch.profiler import ProfilerActivity, profile

        self._tid = threading.get_native_id()
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        self._prof = profile(activities=acts)
        if cuda:
            torch.cuda.synchronize()
        self._prof.__enter__()
        self._t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.monotonic() - self._t0
        self._prof.__exit__(None, None, None)

    def work(self) -> DeviceWork:
        with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as td:
            path = os.path.join(td, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            with open(path) as f:
                doc = json.load(f)
        return DeviceWork(doc, main_tid=self._tid)
