"""Span flight-recorder: bounded, host-side distributed tracing (a copy
of ``theanompi_tpu/obs/tracer.py``, stdlib only).

Theano-MPI's recorder made per-PHASE time visible (train vs exchange
vs wait); the rebuild's topology — router dispatch, disaggregated
prefill→KV-handoff→decode across TCP processes, speculative verify
windows, autoscaler drains, supervised restarts — needs per-REQUEST
time: when a TTFT p95 regresses, which leg of which request paid?
This module is the substrate every layer instruments against
(``serving/engine.py``, ``serving/router.py``, ``serving/replica.py``,
``serving/autoscaler.py``, ``utils/supervisor.py``, the BSP worker's
iteration boundary via ``utils/recorder.Recorder``).

**Span model.**  A span is one named wall-clock interval with an
explicit context: ``trace_id`` groups every span of one request (or
one training iteration, one autoscaler action, one supervised run),
``span_id`` identifies it, ``parent_id`` links the tree.  Spans are
plain JSON-able dicts so they cross the center-server pickle frames
unchanged — a request's replica-side spans ride its ``Result`` back
to the router, where the prefill leg from replica A and the decode
leg from replica B stitch into ONE connected tree (the flight-
recorder property the fault drills assert: the tree survives the
replica that produced it).

**Clocks.**  Stamps are HOST-side only: ``time.monotonic`` for
duration truth, shifted once per process by a wall-clock offset
captured at tracer construction so spans from different processes on
one host share a timeline (good to ~ms — fine for ms-scale legs; the
skew never corrupts a DURATION).  No device value is ever read to
stamp a span — the tracer must be tmcheck-TM104 clean in hot loops
(``Tracer.span``/``start_span``/``end_span`` are seeded hot names:
their bodies, and any device fence smuggled into span attrs, are
flagged by the gate).

**Bounding.**  The ring holds at most ``capacity`` spans.  Overflow
evicts the OLDEST WHOLE TRACE — never individual spans, so the ring
never holds a partial tree — and remembers evicted trace ids so a
straggler span of a dropped trace is dropped too instead of
resurrecting a fragment.  The trace currently being appended is never
evicted (a single trace larger than the ring is kept whole and the
cap is soft for exactly that pathological case).

**Sampling.**  ``sample=N`` records every Nth trace (``new_context``
counts).  The sampled bit travels WITH the context — through
``Request.trace``, the TCP frames, and the handoff record — so one
decision at the root governs every process the request touches.
Forcing (``force_sample``) flips a live context to sampled
mid-flight: the router applies it on shed/failover/SLO-miss, so the
interesting tail is captured even at 1/N rates (spans that already
ended unsampled are gone; everything that ends after the force is
kept — documented tail-sampling semantics).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager

#: default 1/N trace sampling rate (the bench's traced A/B arm runs
#: at this rate; shed/failover/SLO-miss force-sample regardless)
DEFAULT_TRACE_SAMPLE = 16


def make_context(trace_id: int, parent_id: int | None = None,
                 sampled: bool = True) -> dict:
    """A span context as the plain dict that rides ``Request.trace``,
    the TCP submit frames, and the KV handoff record."""
    return {"trace_id": int(trace_id),
            "parent_id": None if parent_id is None else int(parent_id),
            "sampled": bool(sampled)}


def child_context(ctx: dict, parent_id: int) -> dict:
    """The same trace, re-parented under ``parent_id`` — what a
    dispatch hop attaches to the Request it forwards."""
    return make_context(ctx["trace_id"], parent_id, ctx["sampled"])


def force_sample(ctx: dict | None) -> None:
    """Flip a live context to sampled (shed/failover/SLO-miss):
    spans ending after this record; the bit propagates to every
    subsequent dispatch that copies the context."""
    if ctx is not None:
        ctx["sampled"] = True


class Tracer:
    """Thread-safe bounded span store for ONE process/component.

    ``process`` names the Perfetto process lane, ``lane`` the default
    thread lane within it (a replica passes its role).  ``clock`` is
    the duration clock (monotonic); every stamp is shifted by the
    wall offset captured HERE so cross-process spans share a
    timeline.
    """

    def __init__(self, process: str = "main", *,
                 capacity: int = 8192, sample: int = 1,
                 lane: str | None = None, clock=time.monotonic):
        self.process = str(process)
        self.lane = str(lane) if lane is not None else self.process
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sample = max(1, int(sample))
        self.clock = clock
        # one offset per tracer: monotonic + offset == wall clock at
        # construction time; constant, so durations stay exact
        self._wall_offset = time.time() - clock()
        self._lock = threading.Lock()
        self._traces: OrderedDict[int, list] = OrderedDict()  # guarded-by: _lock
        self._seen: dict[int, set] = {}     # guarded-by: _lock (ingest dedup)
        self._n_spans = 0                   # guarded-by: _lock
        # (pid, tracer-instance)-tagged ids: unique across the
        # processes AND the tracers of one fleet without coordination
        # — in-process replicas each carry their own tracer in the
        # router's pid, and their span ids must never collide when
        # the rings stitch (ingest dedups on span id)
        self._tag = (
            ((os.getpid() & 0xFFFF) << 44)
            | ((next(Tracer._instance_n) & 0xFFF) << 32)
        )
        self._ids = itertools.count(1)
        self._trace_n = itertools.count()
        # evicted trace ids: a straggler span of a dropped trace is
        # dropped too — the ring never holds a partial tree
        self._dropped: deque = deque(maxlen=4096)  # guarded-by: _lock
        self._dropped_set: set = set()      # guarded-by: _lock
        # OPEN span handles (started, not yet ended), keyed by span
        # id: ``spans()`` snapshots them as truncated spans so a
        # salvaged ring (the owner died mid-span) still yields a
        # CONNECTED tree — the children of an open span must never
        # orphan.  A later real end replaces the snapshot (ingest
        # prefers closed over open on the same id).
        self._open: dict[int, dict] = {}    # guarded-by: _lock
        self.n_dropped_traces = 0
        self.n_dropped_spans = 0

    # -- ids / contexts ----------------------------------------------------

    #: class-level tracer-instance counter (id-tag uniqueness)
    _instance_n = itertools.count()

    def _new_id(self) -> int:
        return self._tag | (next(self._ids) & 0xFFFFFFFF)

    def new_context(self, *, force: bool = False) -> dict:
        """Root a new trace; the 1/N sampling decision happens HERE
        (``force=True`` bypasses it — always-sample events)."""
        n = next(self._trace_n)
        return make_context(
            self._new_id(), None, force or (n % self.sample == 0)
        )

    # -- span recording ----------------------------------------------------

    def start_span(self, ctx: dict | None, name: str, *,
                   parent_id: int | None = None, **attrs) -> dict | None:
        """Open a span.  ALWAYS returns a handle when a context
        exists (even unsampled — the id must be stable so children
        can parent to it, and a mid-flight ``force_sample`` makes
        the still-open span recordable); the record/drop decision is
        taken at ``end_span`` time.  Host stamps only."""
        if ctx is None:
            return None
        handle = {
            "ctx": ctx, "name": str(name), "t0": self.clock(),
            "span_id": self._new_id(),
            "parent_id": (parent_id if parent_id is not None
                          else ctx.get("parent_id")),
            "attrs": dict(attrs) if attrs else {},
        }
        with self._lock:
            self._open[handle["span_id"]] = handle
        return handle

    def end_span(self, handle: dict | None, *, force: bool = False,
                 lane: str | None = None, **attrs) -> int | None:
        """Close a span and record it if its context is sampled (or
        ``force``).  Returns the span id (None when dropped)."""
        if handle is None:
            return None
        with self._lock:
            self._open.pop(handle["span_id"], None)
        ctx = handle["ctx"]
        if not (ctx.get("sampled") or force):
            return None
        if attrs:
            handle["attrs"].update(attrs)
        return self._record(
            ctx["trace_id"], handle["span_id"], handle["parent_id"],
            handle["name"], handle["t0"], self.clock(),
            handle["attrs"], lane,
        )

    def record_span(self, ctx: dict | None, name: str,
                    t0: float, t1: float, *,
                    parent_id: int | None = None, force: bool = False,
                    lane: str | None = None, **attrs) -> int | None:
        """Record a completed span from explicit stamps (in THIS
        tracer's clock) — the retroactive path: the router records a
        shed request's root span at terminal time from the submit
        stamp it always kept, whether or not sampling was on."""
        if ctx is None or not (ctx.get("sampled") or force):
            return None
        return self._record(
            ctx["trace_id"], self._new_id(),
            parent_id if parent_id is not None else ctx.get("parent_id"),
            str(name), t0, t1, dict(attrs) if attrs else {}, lane,
        )

    @contextmanager
    def span(self, ctx: dict | None, name: str, *,
             parent_id: int | None = None, lane: str | None = None,
             **attrs):
        """``with tracer.span(ctx, "prefill_chunk", ...):`` — yields
        the open handle (attrs may be added to it in the body; they
        must be HOST values: the gate's hot-path sanitizer flags a
        device fence captured into a span)."""
        handle = self.start_span(ctx, name, parent_id=parent_id,
                                 **attrs)
        try:
            yield handle
        finally:
            self.end_span(handle, lane=lane)

    def _record(self, trace_id, span_id, parent_id, name, t0, t1,
                attrs, lane) -> int | None:
        span = {
            "trace_id": int(trace_id), "span_id": int(span_id),
            "parent_id": None if parent_id is None else int(parent_id),
            "name": name,
            "t0": float(t0) + self._wall_offset,
            "t1": float(t1) + self._wall_offset,
            "process": self.process,
            "lane": str(lane) if lane is not None else self.lane,
            "attrs": attrs,
        }
        with self._lock:
            # TM102 resolves the dicts' .get under _append_locked by name
            # to KVStore.get, whose torch store's .wait to the launcher's
            # LaunchHandle.wait, which reaches the supervisor's tracer:
            # no lock is taken on that path
            self._append_locked(span)  # tmcheck: disable=TM102
        return span["span_id"]

    # -- ring discipline ---------------------------------------------------

    def _append_locked(self, span: dict) -> None:  # tmcheck: holds=_lock
        tid = span["trace_id"]
        if tid in self._dropped_set:
            # its tree was evicted whole; a late fragment must not
            # resurrect a partial one
            self.n_dropped_spans += 1
            return
        spans = self._traces.get(tid)
        if spans is None:
            self._traces[tid] = spans = []
            self._seen[tid] = set()
        if span["span_id"] in self._seen[tid]:
            # ingest dedup (salvage races a late result delivery); a
            # CLOSED span upgrades its own truncated open snapshot
            if not (span.get("attrs") or {}).get("open"):
                for i, old in enumerate(spans):
                    if old["span_id"] == span["span_id"] \
                            and (old.get("attrs") or {}).get("open"):
                        spans[i] = span
                        break
            return
        spans.append(span)
        self._seen[tid].add(span["span_id"])
        self._n_spans += 1
        while self._n_spans > self.capacity and len(self._traces) > 1:
            victim = next(
                (k for k in self._traces if k != tid), None
            )
            if victim is None:
                break
            dropped = self._traces.pop(victim)
            self._seen.pop(victim, None)
            self._n_spans -= len(dropped)
            self.n_dropped_traces += 1
            self.n_dropped_spans += len(dropped)
            if len(self._dropped) == self._dropped.maxlen:
                self._dropped_set.discard(self._dropped[0])
            self._dropped.append(victim)
            self._dropped_set.add(victim)

    def ingest(self, spans) -> int:
        """Adopt foreign span dicts (a Result's flight record, a
        failed replica's salvaged ring) — deduplicated on span id, so
        salvage + late result delivery never double-count.  Returns
        how many were new."""
        with self._lock:
            before = self._n_spans
            for s in spans or ():
                self._append_locked(dict(s))
            return self._n_spans - before

    # -- reads -------------------------------------------------------------

    def spans(self, trace_id: int | None = None) -> list:
        """Copies of the ring's spans (one trace, or everything),
        plus snapshots of still-OPEN sampled spans stamped
        ``t1=now, open=True`` — so a ring pulled mid-flight (or
        salvaged from a dead owner) always yields connected trees;
        the real end, if it ever lands, replaces the snapshot."""
        now = self.clock() + self._wall_offset
        with self._lock:
            if trace_id is not None:
                out = [dict(s) for s in self._traces.get(trace_id, ())]
            else:
                out = [
                    dict(s) for spans in self._traces.values()
                    for s in spans
                ]
            for h in self._open.values():
                ctx = h["ctx"]
                tid = ctx["trace_id"]
                if not ctx.get("sampled") or tid in self._dropped_set:
                    continue
                if trace_id is not None and tid != trace_id:
                    continue
                out.append({
                    "trace_id": tid, "span_id": h["span_id"],
                    "parent_id": h["parent_id"], "name": h["name"],
                    "t0": h["t0"] + self._wall_offset, "t1": now,
                    "process": self.process, "lane": self.lane,
                    "attrs": {**h["attrs"], "open": True},
                })
        return out

    def trace_ids(self) -> list:
        with self._lock:
            return list(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._seen.clear()
            self._dropped.clear()
            self._dropped_set.clear()
            self._n_spans = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "process": self.process,
                "n_traces": len(self._traces),
                "n_spans": self._n_spans,
                "capacity": self.capacity,
                "sample": self.sample,
                "n_dropped_traces": self.n_dropped_traces,
                "n_dropped_spans": self.n_dropped_spans,
            }
