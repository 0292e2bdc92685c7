"""Trace exporters: Chrome-trace/Perfetto JSON and critical-path
attribution (a copy of ``theanompi_tpu/obs/export.py``, json only).

``chrome_trace`` renders span dicts (from one tracer or many — the
router's ring after it ingested every replica's flight records) as
the Chrome trace-event JSON Perfetto opens directly
(https://ui.perfetto.dev → "Open trace file"): one process lane per
``span["process"]`` (router, each replica by name, autoscaler,
supervisor, the BSP worker), one thread lane per ``span["lane"]``
(a replica's role), complete ("X") events in microseconds.

``counters=`` adds Chrome COUNTER tracks ("ph": "C") to the same
view: each sample is ``{"process", "name", "t", "values": {series:
number}}`` — the StepProfile's per-phase/MFU gauges
(``StepProfile.counter_tracks``), the serving recorder's queue-depth
/ blocks-in-use series (``ServingRecorder.counter_tracks``), and the
autoscaler's pressure samples (``Autoscaler.counter_tracks``) all
render as stacked counter lanes under their process, so a bench
run's profile and its request traces open as ONE timeline.

``critical_path`` answers "why was this request slow": the longest
SERIAL chain through one trace's span tree.  Walking BACKWARD from
the root's end, each step follows the child whose completion gated
progress (the last-finishing child overlapping the cursor); time no
child covers is the parent's own ("<name>:self" — the router's
self-time IS the queue/wire gap).  Every second of the root interval
lands in exactly one named leg, so the report's coverage is ~1.0 by
construction (cross-process clock skew is clamped at parent bounds;
the acceptance bar is >= 95%).
"""

from __future__ import annotations

import json

#: ignore sub-microsecond slivers when walking the chain (floats)
_EPS = 1e-7


def _span_sort_key(s: dict):
    return (s["t0"], s["t1"], s["span_id"])


def chrome_trace(spans, *, trace_id: int | None = None,
                 counters=None) -> dict:
    """Chrome trace-event JSON (a dict; ``json.dumps`` it to a file
    and open in Perfetto).  ``trace_id`` filters the SPANS to one
    tree; ``counters`` (see module doc) always export whole — a
    gauge series has no trace id."""
    spans = [
        s for s in spans
        if trace_id is None or s["trace_id"] == trace_id
    ]
    procs: dict[str, int] = {}
    lanes: dict[tuple, int] = {}
    events = []
    for s in sorted(spans, key=_span_sort_key):
        pid = procs.setdefault(s["process"], len(procs) + 1)
        lane_key = (s["process"], s.get("lane") or s["process"])
        tid = lanes.setdefault(lane_key, len(lanes) + 1)
        events.append({
            "ph": "X", "name": s["name"],
            "pid": pid, "tid": tid,
            "ts": s["t0"] * 1e6,
            "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
            "args": {
                "trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s["parent_id"], **(s.get("attrs") or {}),
            },
        })
    for c in sorted(counters or (),
                    key=lambda c: (c["process"], c["name"], c["t"])):
        pid = procs.setdefault(c["process"], len(procs) + 1)
        events.append({
            "ph": "C", "name": c["name"], "pid": pid,
            "ts": float(c["t"]) * 1e6,
            "args": {
                k: v for k, v in c["values"].items() if v is not None
            },
        })
    meta = []
    for name, pid in procs.items():
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "args": {"name": name}})
    for (proc, lane), tid in lanes.items():
        meta.append({"ph": "M", "name": "thread_name",
                     "pid": procs[proc], "tid": tid,
                     "args": {"name": lane}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans, path, *, trace_id: int | None = None,
                       counters=None) -> str:
    """Dump ``chrome_trace`` to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(
            chrome_trace(spans, trace_id=trace_id, counters=counters),
            f,
        )
    return str(path)


# ---------------------------------------------------------------------------
# span-tree structure checks (the fault drills' integrity assertions)
# ---------------------------------------------------------------------------


def span_tree(spans, trace_id: int) -> dict:
    """Structure report for one trace: roots, orphans (a parent_id
    that resolves to no span in the trace), and connectivity.  A
    trace whose spans all reach one root is what the kill drills
    assert survives replica death."""
    tr = [s for s in spans if s["trace_id"] == trace_id]
    by_id = {s["span_id"]: s for s in tr}
    roots = [s for s in tr if s["parent_id"] is None]
    orphans = [
        s for s in tr
        if s["parent_id"] is not None and s["parent_id"] not in by_id
    ]
    connected = len(tr) > 0 and len(roots) == 1 and not orphans
    return {
        "trace_id": trace_id, "n_spans": len(tr),
        "roots": [s["span_id"] for s in roots],
        "root_name": roots[0]["name"] if len(roots) == 1 else None,
        "orphans": [s["span_id"] for s in orphans],
        "connected": connected,
        "processes": sorted({s["process"] for s in tr}),
    }


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------


def critical_path(spans, trace_id: int | None = None) -> dict:
    """Longest serial chain through one trace (see module doc).

    Returns ``{"trace_id", "root", "total_s", "legs": [{"name",
    "process", "span", "t0", "t1", "dur_s"}...], "attributed_s",
    "coverage"}`` — legs ordered in time, ``coverage`` the attributed
    share of the root interval (≈1.0; the acceptance floor is
    0.95)."""
    if trace_id is None:
        tids = {s["trace_id"] for s in spans}
        if len(tids) != 1:
            raise ValueError(
                f"critical_path needs one trace_id, ring holds "
                f"{len(tids)}"
            )
        trace_id = tids.pop()
    tr = [s for s in spans if s["trace_id"] == trace_id]
    if not tr:
        raise ValueError(f"no spans for trace {trace_id}")
    by_id = {s["span_id"]: s for s in tr}
    children: dict[int, list] = {}
    roots = []
    for s in tr:
        pid = s["parent_id"]
        if pid is None or pid not in by_id:
            roots.append(s)     # orphans walk as their own roots
        else:
            children.setdefault(pid, []).append(s)
    # the tree root: prefer the span literally named "request" (the
    # router's), else the earliest-starting root
    root = next(
        (s for s in roots if s["name"] == "request"),
        min(roots, key=_span_sort_key),
    )
    legs: list[dict] = []

    def leg(span: dict, lo: float, hi: float, is_self: bool) -> None:
        if hi - lo <= _EPS:
            return
        legs.append({
            "name": span["name"] + (":self" if is_self else ""),
            "process": span["process"],
            "span": span["span_id"],
            "t0": lo, "t1": hi, "dur_s": hi - lo,
        })

    def walk(span: dict, lo: float, hi: float) -> None:
        kids = children.get(span["span_id"], ())
        cur = hi
        while cur - lo > _EPS:
            cands = [
                c for c in kids
                if c["t0"] < cur - _EPS and min(c["t1"], cur) > lo + _EPS
            ]
            if not cands:
                leg(span, lo, cur, bool(kids))
                return
            c = max(cands, key=lambda s: (min(s["t1"], cur),
                                          -s["t0"], s["span_id"]))
            ce = min(c["t1"], cur)
            leg(span, ce, cur, True)          # gap above the child
            c_lo = max(c["t0"], lo)
            walk(c, c_lo, ce)
            cur = c_lo

    walk(root, root["t0"], root["t1"])
    legs.sort(key=lambda leg_: leg_["t0"])
    total = root["t1"] - root["t0"]
    attributed = sum(leg_["dur_s"] for leg_ in legs)
    return {
        "trace_id": trace_id,
        "root": root["name"],
        "total_s": total,
        "legs": legs,
        "attributed_s": attributed,
        "coverage": attributed / total if total > 0 else 1.0,
    }


def format_critical_path(report: dict) -> str:
    """Human-readable one-leg-per-line rendering of a
    ``critical_path`` report."""
    lines = [
        f"critical path of trace {report['trace_id']} "
        f"(root {report['root']}, {report['total_s'] * 1e3:.2f} ms, "
        f"coverage {report['coverage']:.3f}):"
    ]
    for leg_ in report["legs"]:
        lines.append(
            f"  {leg_['dur_s'] * 1e3:9.3f} ms  "
            f"{leg_['process']}:{leg_['name']}"
        )
    return "\n".join(lines)
