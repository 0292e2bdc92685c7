"""Profiler-trace comm/compute attribution (port of
``theanompi_tpu/utils/trace_comm.py`` onto ``torch.profiler``).

Wall-clock fencing around host calls cannot split a step's device time
into its exchange and its compute, so the split comes from a trace:
``capture_trace`` runs a function under ``torch.profiler.profile``
(CPU and, on a card, CUDA activities) and writes the Chrome trace;
``comm_report`` reads it back and classifies each piece of device work
as collective (NCCL kernels; gloo's collectives on the CPU) or
compute, per device, OVERLAP-AWARE as the JAX report is: collective
time running while compute runs on the same device is "hidden", the
rest "exposed".

Where the work happens:

- **On a card** the device's work is the trace's kernel, memcpy and
  memset events, every stream of one device counted as one timeline
  (one "core"; a copy stream's transfer under a kernel is not counted
  twice).  A kernel belongs to the innermost registered range that
  LAUNCHED it: the kernel's correlation id names its launch
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ... on the host thread),
  and the ranges open on that thread at the launch's time are its
  stack.  The correlation id is exact where the device-side
  projections of the ranges (kineto's ``gpu_user_annotation``, the
  first to the last kernel of a range) would also claim another
  stream's kernels that ran between them.
- **On the CPU** there is no device timeline.  The report takes the
  profiled thread's top-level aten ops as the device's work, and the
  process group's collectives (gloo's ``gloo:*`` ranges on its worker
  threads, ``c10d::*`` ops) as its collective work, as the JAX report
  reads XLA:CPU's thread lanes; each op's stack is the profiled
  thread's ranges open at its start.

``scopes`` (``obs/profiler.profile_scope_sets``) maps legs to range
labels; an op goes to the leg of the innermost label of its stack
that any leg holds, so ``exchange_b0/quantize_wire`` work counts as
``quantize``.  ``range_labels`` lists the labels a trace holds.

The HLO and xplane readers of the JAX module (``compiled_hlo_text``,
``scope_op_names``, ``hlo_instruction_names``, ``quant_op_names``) have
no counterpart: the labels are the trace's own.

    python -m theanompi_tpu_torch.utils.trace_comm <trace_dir>

prints the report of the newest trace under ``trace_dir``.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import threading
import time
from typing import Any, Callable, Iterable

#: kernel/op name prefixes of collective work (lower case): NCCL's
#: device kernels, gloo's worker-thread ranges and the c10d ops
COLLECTIVE_PREFIXES = ("nccl", "gloo:", "c10d::", "record_param_comms")

#: trace event categories of device work on a card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: host-side launch categories whose correlation ids name device work
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

#: the top-level key ``capture_trace`` adds to the trace it writes
CAPTURE_KEY = "tm_capture"


def capture_trace(fn: Callable[[], Any], trace_dir: str) -> Any:
    """Run ``fn`` under ``torch.profiler.profile`` and write its Chrome
    trace under ``trace_dir``; returns ``fn``'s result.  The card is
    traced too when one is available, and synchronized before the
    profiler stops.  The trace carries
    ``{"tm_capture": {"tid": <this thread>, "cuda": bool}}``: the
    profiled thread (the CPU's lane) and whether a device timeline is
    expected."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc[CAPTURE_KEY] = {"tid": threading.get_native_id(), "cuda": cuda}
    with open(path, "w") as f:
        json.dump(doc, f)
    return out


def report_of(fn: Callable[[], Any], top_n: int = 15,
              quant_ops: set | None = None,
              scopes: dict | None = None) -> dict:
    """Capture ``fn`` into a temp dir and return its ``comm_report``
    (``fn`` must fence its own device work, e.g. by a value read)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        capture_trace(fn, td)
        return comm_report(td, top_n=top_n, quant_ops=quant_ops,
                           scopes=scopes)


def _latest_trace(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    if not files:
        raise FileNotFoundError(
            f"no Chrome trace (*.json) under {trace_dir!r}")
    return max(files, key=os.path.getmtime)


def _load(trace_dir: str) -> dict:
    with open(_latest_trace(trace_dir)) as f:
        return json.load(f)


def range_labels(trace_dir: str) -> set[str]:
    """Every ``record_function`` label in the newest trace under
    ``trace_dir`` (its host-side ``user_annotation`` events)."""
    return {
        e["name"] for e in _load(trace_dir).get("traceEvents", ())
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
    }


def is_collective(op_name: str) -> bool:
    """NCCL kernels (``ncclDevKernel_AllReduce_...``,
    ``ncclKernel_...``), gloo's ``gloo:*`` ranges and the c10d ops."""
    return op_name.lower().startswith(COLLECTIVE_PREFIXES)


def _merge_intervals(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    if not iv:
        return []
    iv.sort()
    out = [iv[0]]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _span(iv: Iterable[tuple[int, int]]) -> int:
    return sum(e - s for s, e in iv)


def _subtract(a: list[tuple[int, int]],
              b: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Interval-set difference a - b (both merged/sorted)."""
    out = []
    bi = 0
    for s, e in a:
        cur = s
        while bi < len(b) and b[bi][1] <= cur:
            bi += 1
        j = bi
        while cur < e:
            if j >= len(b) or b[j][0] >= e:
                out.append((cur, e))
                break
            bs, be = b[j]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            j += 1
    return out


def _ns(us) -> int:
    """A Chrome-trace time (microseconds, fractional) in integer ns."""
    return int(round(float(us) * 1000))


class _Ranges:
    """One thread's ``record_function`` ranges: the labels open at a
    time, outermost first (a range contains the times in [start, end))."""

    def __init__(self, ranges: list[tuple[int, int, str]]):
        self._r = sorted(ranges)
        self._starts = [s for s, _, _ in self._r]

    def stack(self, t: int) -> list[str]:
        hi = bisect.bisect_right(self._starts, t)
        return [name for s, e, name in self._r[:hi] if s <= t < e]


def _events(doc: dict) -> list[dict]:
    return [e for e in doc.get("traceEvents", ())
            if e.get("ph") == "X" and "ts" in e]


def _cpu_lane_tid(doc: dict, evs: list[dict]):
    """The profiled thread: the capture's stamp, else the thread with
    the most top-level op time."""
    stamp = doc.get(CAPTURE_KEY) or {}
    if stamp.get("tid") is not None:
        return stamp["tid"]
    busy: dict = {}
    for e in evs:
        if e.get("cat") == "cpu_op":
            busy[e.get("tid")] = busy.get(e.get("tid"), 0.0) + float(
                e.get("dur", 0))
    return max(busy, key=busy.get) if busy else None


def _top_level(evs: list[dict]) -> list[dict]:
    """The ops no other op of the list contains (same thread)."""
    out, end = [], -1
    for e in sorted(evs, key=lambda e: (_ns(e["ts"]), -_ns(e["dur"]))):
        s = _ns(e["ts"])
        if s >= end:
            out.append(e)
            end = s + _ns(e["dur"])
    return out


def _device_work(doc: dict, evs: list[dict], ranges: dict):
    """``[(core key, op name, start ns, end ns, stack)]`` of the trace's
    device work (module docstring)."""
    dev = [e for e in evs if e.get("cat") in DEVICE_CATEGORIES]
    stamp = doc.get(CAPTURE_KEY) or {}
    if dev:
        launch = {}
        for e in evs:
            if e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = (e.get("pid"), e.get("tid"), _ns(e["ts"]))
        out = []
        for e in dev:
            args = e.get("args") or {}
            at = launch.get(args.get("correlation"))
            stack = (ranges[at[:2]].stack(at[2])
                     if at is not None and at[:2] in ranges else [])
            s = _ns(e["ts"])
            out.append((("device", e.get("pid"), args.get("device")),
                        e["name"], s, s + _ns(e.get("dur", 0)), stack))
        return out
    if stamp.get("cuda"):
        raise RuntimeError(
            "the trace of a card run holds no device events (kernel, "
            "memcpy, memset): CUPTI tracing did not record the card")
    tid = _cpu_lane_tid(doc, evs)
    pid = next((e.get("pid") for e in evs if e.get("tid") == tid), None)
    lane = ranges.get((pid, tid), _Ranges([]))
    ops = _top_level([e for e in evs if e.get("cat") == "cpu_op"
                      and e.get("tid") == tid])
    ops += [e for e in evs if e.get("tid") != tid
            and is_collective(e["name"])]
    out = []
    for e in ops:
        s = _ns(e["ts"])
        out.append((("cpu", pid, tid), e["name"], s,
                    s + _ns(e.get("dur", 0)), lane.stack(s)))
    return out


def comm_report(trace_dir: str, top_n: int = 15,
                quant_ops: set | None = None,
                scopes: dict | None = None) -> dict:
    """Parse the newest trace under ``trace_dir`` into an overlap-aware
    comm/compute attribution, the JAX report's keys and meanings::

        {"device_busy_s", "collective_s", "exposed_comm_s",
         "exposed_comm_frac", "hidden_comm_s", "comm_frac",
         "overlapped_comm_s", "overlapped_comm_frac",
         "quant_s", "quant_frac", "n_cores", "scope_s", "scope_comm_s",
         "top_collectives": [(name, seconds), ...], "top_ops": [...]}

    Times are core-seconds (``n_cores`` timelines: devices on a card,
    the profiled thread on the CPU).  ``overlapped_comm_s`` (==
    ``hidden_comm_s``) is collective time running while compute runs
    on the same timeline; ``overlapped_comm_frac`` its share of the
    collective time.

    ``quant_ops``: range labels whose work is summed as ``quant_s``
    (still compute in the hidden/exposed split).  ``scopes``: an ordered
    ``{leg: set(range labels)}``; an op goes to the leg holding the
    innermost label of its stack (module docstring); ``scope_s`` is the
    union of a leg's ops on each timeline (summed over the timelines)
    and ``scope_comm_s`` that of its collectives.

    Raises ``FileNotFoundError`` without a trace and ``RuntimeError``
    when a card run's trace holds no device events."""
    doc = _load(trace_dir)
    evs = _events(doc)
    by_thread: dict = {}
    for e in evs:
        if e.get("cat") == "user_annotation":
            s = _ns(e["ts"])
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (s, s + _ns(e.get("dur", 0)), e["name"]))
    ranges = {k: _Ranges(v) for k, v in by_thread.items()}

    quant_ops = set(quant_ops or ())
    scopes = scopes or {}
    leg_of = {}
    for leg, labels in scopes.items():
        for label in labels:
            leg_of.setdefault(label, leg)
    # a leg's intervals by timeline: its time is their union, so work
    # that overlaps on one timeline (gloo's lane under the c10d op that
    # launched it, a copy stream under a kernel) counts once
    leg_iv = {name: {} for name in scopes}
    cores: dict = {}
    per_op: dict[str, int] = {}
    per_op_all: dict[str, int] = {}
    quant_ns = 0
    for core_key, op, s, e, stack in _device_work(doc, evs, ranges):
        if e <= s:
            continue
        core = cores.setdefault(core_key, {"comm": [], "compute": []})
        comm = is_collective(op)
        per_op_all[op] = per_op_all.get(op, 0) + (e - s)
        leg = next((leg_of[x] for x in reversed(stack) if x in leg_of),
                   None)
        if leg is not None:
            iv = leg_iv[leg].setdefault(core_key, {"all": [], "comm": []})
            iv["all"].append((s, e))
            if comm:
                iv["comm"].append((s, e))
        if comm:
            core["comm"].append((s, e))
            per_op[op] = per_op.get(op, 0) + (e - s)
        else:
            core["compute"].append((s, e))
            if quant_ops.intersection(stack):
                quant_ns += e - s

    busy_ns = comm_ns = exposed_ns = 0
    for core in cores.values():
        comm_m = _merge_intervals(core["comm"])
        compute_m = _merge_intervals(core["compute"])
        busy_m = _merge_intervals(comm_m + compute_m)
        exposed = _subtract(comm_m, compute_m)
        busy_ns += _span(busy_m)
        comm_ns += _span(comm_m)
        exposed_ns += _span(exposed)

    scope_ns = {leg: sum(_span(_merge_intervals(iv["all"]))
                         for iv in by_core.values())
                for leg, by_core in leg_iv.items()}
    scope_comm_ns = {leg: sum(_span(_merge_intervals(iv["comm"]))
                              for iv in by_core.values())
                     for leg, by_core in leg_iv.items()}
    ns = 1e-9
    busy_s = busy_ns * ns
    comm_s = comm_ns * ns
    exposed_s = exposed_ns * ns
    quant_s = quant_ns * ns
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_busy_s": busy_s,
        "collective_s": comm_s,
        "exposed_comm_s": exposed_s,
        "hidden_comm_s": comm_s - exposed_s,
        "overlapped_comm_s": comm_s - exposed_s,
        "quant_s": quant_s,
        "quant_frac": (quant_s / busy_s) if busy_s else 0.0,
        "comm_frac": (comm_s / busy_s) if busy_s else 0.0,
        "exposed_comm_frac": (exposed_s / busy_s) if busy_s else 0.0,
        "overlapped_comm_frac": (
            (comm_s - exposed_s) / comm_s if comm_s else 0.0
        ),
        "n_cores": len(cores),
        "scope_s": {k: v * ns for k, v in scope_ns.items()},
        "scope_comm_s": {k: v * ns for k, v in scope_comm_ns.items()},
        "top_collectives": [(k, v * ns) for k, v in top],
        "top_ops": [
            (k, v * ns)
            for k, v in sorted(
                per_op_all.items(), key=lambda kv: -kv[1]
            )[:top_n]
        ],
    }


def _main(argv) -> int:
    """CLI: ``python -m theanompi_tpu_torch.utils.trace_comm
    <trace_dir>`` — print the overlap-aware comm/compute attribution
    and top ops of the newest trace under ``trace_dir``."""
    if len(argv) != 1:
        print("usage: python -m theanompi_tpu_torch.utils.trace_comm "
              "<trace_dir>")
        return 2
    rep = comm_report(argv[0])
    print(f"device busy       {rep['device_busy_s']:.4f} core-seconds "
          f"({rep['n_cores']} op timelines)")
    print(f"collective        {rep['collective_s']:.4f}s "
          f"({rep['comm_frac']:.1%} of busy)")
    print(f"  exposed         {rep['exposed_comm_s']:.4f}s "
          f"({rep['exposed_comm_frac']:.1%} of busy)")
    print(f"  overlapped      {rep['overlapped_comm_s']:.4f}s "
          f"({rep['overlapped_comm_frac']:.1%} of collective time "
          f"hidden under compute)")
    if rep["top_collectives"]:
        print("top collectives:")
        for name, sec in rep["top_collectives"]:
            print(f"  {sec * 1e3:9.2f} ms  {name[:70]}")
    print("top ops:")
    busy = rep["device_busy_s"] or 1.0
    for name, sec in rep["top_ops"]:
        print(f"  {sec / busy:6.1%} {sec * 1e3:9.2f} ms  {name[:70]}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    raise SystemExit(_main(sys.argv[1:]))
