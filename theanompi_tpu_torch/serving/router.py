"""Fleet-scale serving: a front-end router over N engine replicas.

Port of ``theanompi_tpu/serving/router.py``: pure Python over the
replica protocol, copied with the port's imports.  Every replica's
engine drives its own ``PagedLlamaDecoder`` (kernel K4 and the RMS
norm kernel on the card); the router itself never touches a tensor.

One ``Engine`` is one card; heavy traffic needs many.  The
:class:`Router` spreads requests over replicas (in-process or TCP —
``serving/replica.py``) with three pluggable dispatch policies,
health-checked membership, and in-flight failover:

**Policies** (``policy=``):

- ``"round_robin"`` — cycle the healthy members (the baseline).
- ``"least_loaded"`` — min ``replica.load()`` (queue depth + slot
  occupancy, the ``ServingRecorder``-visible load scalar), ties
  broken DETERMINISTICALLY to the lowest member index.
- ``"prefix_affinity"`` — consistent hash on the prompt's
  BLOCK-ALIGNED prefix (``len(prompt) // affinity_block *
  affinity_block`` tokens, at least one block's worth): requests
  sharing a system prompt land on the SAME replica, so its radix
  prefix cache serves them all from one prefill.  The hash
  ring holds every member and the lookup walks it skipping
  unhealthy/backpressured ones, so membership changes only remap
  the keys of the changed member — the consistent-hash stability
  property under test.

**Membership** (supervisor-style, ``utils/supervisor.py`` semantics):
a monitor thread watches each replica's heartbeat; liveness is a
FRESH stamp (never a progress comparison), with ``startup_grace_s``
before the first beat and ``stall_timeout_s`` after.  Stamps land at
engine-ITERATION boundaries, so ``stall_timeout_s`` must exceed the
longest single dispatch a healthy replica performs — in practice the
first call that builds the port's kernels (``nvcc``, seconds a
source): warm a replica before registering it, or keep the default
generous.  A
too-tight timeout is SAFE but wasteful: the "stalled" replica's
requests are requeued (duplicated work, first completion wins) and
it rejoins on its next fresh beat.  A stalled or
dead replica goes UNHEALTHY: its queued and in-flight requests are
requeued to healthy members (dedup on request id + dispatch
generation — a late result from the "dead" replica can never double-
resolve a future, and a requeued duplicate's first completion wins).
Fresh beats from a recovered or relaunched replica REJOIN it
automatically.

**Admission** generalizes the per-request deadline machinery
fleet-wide: ``fleet_queue_cap`` bounds incomplete admitted requests
(shed ``"queue_full"`` at submit past it), ``replica_queue_cap`` is
per-replica backpressure (a saturated member is skipped; if every
member is saturated the request waits at the ROUTER and its deadline
keeps running), and a request whose deadline expires undelivered —
including across requeues, each redispatch carries the REMAINING
budget — sheds ``"deadline"``.  ``max_requeues`` bounds failover
bouncing (then ``"failover"``).  Every ``submit()`` future resolves
with a terminal ``finish_reason``; the engine-level "never hangs"
guarantee extends to the fleet.

**Roles** (``serving/kv_transfer.py``): members declare
``"unified"`` / ``"prefill"`` / ``"decode"``.  When a prefill
specialist AND a decode-capable member are both healthy, a request
dispatches in two phases — the prompt to a prefiller
(``prefill_only``), the returned KV handoff record to the owning
decoder — removing prefill-chunk interference from decode TPOT
(DistServe/Splitwise's split).  Role purity yields to availability:
no healthy specialist → unified members serve end-to-end; a failed
handoff (geometry mismatch, dry pool) drops the record and requeues
the full prompt.  The fleet TTFT for a disaggregated request is the
PREFILL side's (the first token exists at handoff time).

**Scaling** (``serving/autoscaler.py``): ``add_replica`` /
``drain_replica`` / ``remove_replica`` are the control plane's
membership verbs — a drained member takes no new work and its
in-flight requests requeue (uncharged) through the same failover
path, so scale-down never drops a request.

**Observability**: a ``utils.recorder.FleetRecorder`` records every
terminal result router-side (fleet TTFT/TPOT percentiles survive
replica death) plus requeue/failover/rejoin/handoff counters and the
spawn/retire event log (replica-seconds — the autoscaler's cost
metric), and merges per-replica ``ServingRecorder`` states for
occupancy/hit-rate/rate breakdowns (``Router.fleet_summary``).
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from theanompi_tpu_torch.obs.tracer import Tracer, child_context, force_sample
from theanompi_tpu_torch.serving.engine import (
    Request,
    Result,
    ServingFuture,
)
from theanompi_tpu_torch.utils.recorder import FleetRecorder

#: replica-side shed reasons that mean "this replica abandoned the
#: request without serving it" — the router REQUEUES these instead of
#: propagating them: restart() sheds a dead loop's engine futures, a
#: TCP submit into a dying socket resolves "replica_dead", a stopping
#: replica sheds "shutdown", and an engine whose own queue filled
#: between the router's load probe and the submit sheds "queue_full"
#: (another member probably has room; ``max_requeues`` bounds the
#: bounce either way, ending in a terminal "failover" shed)
_REQUEUE_REASONS = frozenset(
    {"restart", "replica_dead", "shutdown", "queue_full"}
)

POLICIES = ("round_robin", "least_loaded", "prefix_affinity")


def prefix_affinity_key(prompt, block: int) -> bytes:
    """Stable digest of the prompt's block-aligned prefix.  Aligning
    DOWN to the block grid means prompts differing only inside their
    final partial block still share a key — exactly the tokens the
    radix cache can share (block-granularity adoption); prompts
    shorter than one block key on their full length.  sha1, not
    ``hash()``: the mapping must agree across processes and runs."""
    n = len(prompt)
    aligned = max(min(n, block), n // block * block)
    # one buffer, one update — '<i8' pins the byte stream (8-byte
    # little-endian signed, the cross-process contract) regardless
    # of host endianness
    buf = np.asarray(
        list(itertools.islice(prompt, aligned)), dtype="<i8"
    ).tobytes()
    return hashlib.sha1(buf).digest()


class ConsistentHashRing:
    """Classic consistent hashing: each node owns ``n_vnodes``
    pseudo-random points on a 64-bit ring; a key maps to the first
    node point at or after its digest (wrapping).  Removing a node
    only remaps keys that mapped to ITS points; ``lookup`` takes a
    skip-predicate so unhealthy/backpressured nodes are walked past
    without mutating the ring (their keys come back when they do)."""

    def __init__(self, n_vnodes: int = 64):
        self.n_vnodes = int(n_vnodes)
        self._points: list[tuple[int, str]] = []

    def add(self, node: str) -> None:
        for v in range(self.n_vnodes):
            digest = hashlib.sha1(
                f"{node}#{v}".encode()
            ).digest()[:8]
            self._points.append(
                (int.from_bytes(digest, "big"), str(node))
            )
        self._points.sort()

    def remove(self, node: str) -> None:
        self._points = [
            p for p in self._points if p[1] != str(node)
        ]

    def nodes(self) -> set:
        return {n for _, n in self._points}

    def lookup(self, key: bytes, skip=None) -> str | None:
        """First acceptable node clockwise of ``key``'s point (None
        when the ring is empty or everything is skipped)."""
        if not self._points:
            return None
        h = int.from_bytes(hashlib.sha1(key).digest()[:8], "big")
        i = bisect.bisect_left(self._points, (h, ""))
        seen: set = set()
        for off in range(len(self._points)):
            _, node = self._points[(i + off) % len(self._points)]
            if node in seen:
                continue
            seen.add(node)
            if skip is None or not skip(node):
                return node
        return None


@dataclass
class _Member:
    """One replica's membership record.  ``role`` drives the
    disaggregated dispatch; ``draining`` marks a
    scale-down victim — it takes no new work while its in-flight
    requests are requeued, and ``remove_replica`` retires it."""

    replica: object
    name: str
    index: int
    role: str = "unified"
    role_pinned: bool = False   # caller-set role: watchdog keeps out
    healthy: bool = True
    draining: bool = False
    seen_beat: bool = False
    last_hb_time: float = 0.0       # the replica's own stamp clock
    last_beat: float = field(default_factory=time.monotonic)


class _FleetEntry:
    __slots__ = (
        "rid", "request", "future", "submit_t", "deadline_s",
        "member", "gen", "n_requeues", "affinity_key", "dispatch_t",
        "handoff", "ttft_prefill", "disagg_ok",
        "ctx", "root", "dspan", "qspan",
    )

    def __init__(self, rid: int, request: Request,
                 deadline_s: float, affinity_key: bytes):
        self.rid = rid
        self.request = request
        self.future = ServingFuture()
        self.submit_t = time.monotonic()
        self.deadline_s = deadline_s
        self.member: _Member | None = None
        self.gen = 0            # dispatch generation (stale-result guard)
        self.n_requeues = 0
        self.affinity_key = affinity_key
        self.dispatch_t: float | None = None
        # disaggregation: the prefill phase's KV record + honest TTFT
        # (the first token exists when PREFILL finishes — the decode
        # replica's own ttft stamp is just its admission time)
        self.handoff: dict | None = None
        self.ttft_prefill: float | None = None
        self.disagg_ok = True   # cleared after a failed handoff
        # tracing (obs/tracer.py): span context, root "request" span,
        # open dispatch-hop span, open router-queue span
        self.ctx: dict | None = None
        self.root: dict | None = None
        self.dspan: dict | None = None
        self.qspan: dict | None = None


class Router:
    """Thread-safe multi-replica front-end; see module docstring."""

    def __init__(
        self,
        replicas=(),
        *,
        policy: str = "least_loaded",
        fleet_queue_cap: int = 256,
        default_deadline_s: float = 60.0,
        replica_queue_cap: int | None = 32,
        stall_timeout_s: float = 30.0,
        startup_grace_s: float = 120.0,
        health_interval_s: float = 0.02,
        affinity_block: int = 16,
        n_vnodes: int = 64,
        max_requeues: int = 3,
        recorder: FleetRecorder | None = None,
        tracer: Tracer | None = None,
        trace_sample: int = 0,
        trace_slo_ttft_s: float | None = None,
        trace_slo_e2e_s: float | None = None,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        self.policy = policy
        self.fleet_queue_cap = int(fleet_queue_cap)
        self.default_deadline_s = float(default_deadline_s)
        self.replica_queue_cap = (
            None if replica_queue_cap is None else int(replica_queue_cap)
        )
        self.stall_timeout_s = float(stall_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.health_interval_s = float(health_interval_s)
        self.affinity_block = int(affinity_block)
        self.max_requeues = int(max_requeues)
        self.recorder = recorder or FleetRecorder()
        # span tracing (obs/tracer.py): the router owns each
        # request's ROOT span and the per-generation dispatch spans;
        # every Result's replica-side flight record is ingested here,
        # so one connected tree per request survives replica death.
        # Shed / failover / SLO-miss force-sample their traces.
        if tracer is None and int(trace_sample) > 0:
            tracer = Tracer(process="router", sample=int(trace_sample))
        self.tracer = tracer
        self.trace_slo_ttft_s = trace_slo_ttft_s
        self.trace_slo_e2e_s = trace_slo_e2e_s

        self._lock = threading.RLock()
        self._members: list[_Member] = []
        self._ring = ConsistentHashRing(n_vnodes)
        self._pending: dict[int, _FleetEntry] = {}
        self._queue: deque[int] = deque()    # rids awaiting dispatch
        self._rid = itertools.count()
        self._rr = 0
        self._stopping = False
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        for r in replicas:
            self.add_replica(r)

    # -- membership --------------------------------------------------------

    def add_replica(self, replica, name: str | None = None,
                    role: str | None = None) -> str:
        """Register a replica (joins healthy; the watchdog takes it
        from there).  Also the REJOIN path for a replica object the
        caller relaunched under a new identity, and the autoscaler's
        scale-UP hook.  ``role`` defaults to the replica's own
        ``.role`` attribute ("unified" when absent)."""
        with self._lock:
            name = str(
                name if name is not None
                else getattr(replica, "name", f"replica{len(self._members)}")
            )
            if any(m.name == name for m in self._members):
                raise ValueError(f"duplicate replica name {name!r}")
            pinned = role is not None
            role = str(
                role if pinned
                else getattr(replica, "role", "unified")
            )
            self._members.append(
                _Member(replica=replica, name=name,
                        index=len(self._members), role=role,
                        role_pinned=pinned)
            )
            self._ring.add(name)
            self._pump_locked()   # router-held work may fit NOW
            return name

    def drain_replica(self, name: str) -> int:
        """Scale-down drain: the member takes NO new dispatches, and
        its queued + in-flight requests requeue to the rest of the
        fleet through the ordinary failover/dedup path — first
        completion wins, late results from the victim are dropped by
        the generation guard, nothing is lost.  The drain does NOT
        charge the requests' failover budget (being a scale-down
        victim is the fleet's choice, not the request's bad luck).
        Returns how many requests were requeued."""
        with self._lock:
            _, n = self._drain_locked(name)
            self._pump_locked()
            return n

    def _drain_locked(self, name: str) -> tuple[_Member, int]:
        """The ONE copy of drain semantics (shared by drain_replica
        and remove_replica): mark draining, requeue the member's
        pending work uncharged."""
        m = self._member_named(name)
        m.draining = True
        affected = [
            e for e in self._pending.values() if e.member is m
        ]
        self._requeue_locked(affected, charge=False)
        return m, len(affected)

    def remove_replica(self, name: str) -> None:
        """Retire a member (the scale-down endgame, after
        ``drain_replica``): pull its final recorder snapshot into the
        fleet recorder — merged telemetry must conserve its request
        counts after the membership change — then drop it from the
        member list and the hash ring.  Any stragglers still pinned
        to it requeue first (uncharged), so calling this without a
        prior drain is safe too."""
        with self._lock:
            m, _ = self._drain_locked(name)
        try:
            state = m.replica.recorder_state()
            paging = m.replica.paging_stats()
        except Exception:
            pass      # dead/unreachable: keep the last snapshot
        else:
            self.recorder.attach_replica(m.name, state, paging)
        self._salvage_trace(m)   # retired members keep no spans
        with self._lock:
            self._members = [x for x in self._members if x is not m]
            self._ring.remove(name)
            self._pump_locked()

    def _member_named(self, name: str) -> _Member:  # tmcheck: holds=_lock
        m = next(
            (m for m in self._members if m.name == str(name)), None
        )
        if m is None:
            raise KeyError(f"no replica named {name!r}")
        return m

    def members(self) -> dict:
        with self._lock:
            return {
                m.name: {"healthy": m.healthy,
                         "alive": m.replica.alive(),
                         "role": m.role,
                         "draining": m.draining}
                for m in self._members
            }

    def _healthy(self) -> list[_Member]:  # tmcheck: holds=_lock
        return [m for m in self._members if m.healthy]

    def _dispatchable(self) -> list[_Member]:  # tmcheck: holds=_lock
        return [
            m for m in self._members if m.healthy and not m.draining
        ]

    # -- admission (any thread) --------------------------------------------

    def submit(self, prompt, **kw) -> ServingFuture:
        """Queue one request on the fleet; the future ALWAYS resolves
        (served by some replica, or shed with a reason)."""
        if isinstance(prompt, Request):
            if kw:
                raise TypeError(
                    f"submit(Request, ...) does not accept keyword "
                    f"overrides {sorted(kw)} — set them on the "
                    f"Request itself"
                )
            req = prompt
        else:
            req = Request(prompt=list(prompt), **kw)
        deadline = (
            req.deadline_s if req.deadline_s is not None
            else self.default_deadline_s
        )
        entry = _FleetEntry(
            next(self._rid), req, deadline,
            # only the affinity policy reads the key — don't pay a
            # sha1 over a 2k-token prompt on every least_loaded/
            # round_robin submit
            prefix_affinity_key(req.prompt, self.affinity_block)
            if self.policy == "prefix_affinity" else b"",
        )
        if self.tracer is not None:
            entry.ctx = self.tracer.new_context()
            entry.root = self.tracer.start_span(
                entry.ctx, "request", n_prompt=len(req.prompt)
            )
            # callers (and the critical_path report) find the trace
            # through the future they already hold
            entry.future.trace_id = entry.ctx["trace_id"]
        with self._lock:
            if self._stopping:
                reason = "shutdown"
            elif len(self._pending) >= self.fleet_queue_cap:
                reason = "queue_full"
            else:
                reason = None
                self._pending[entry.rid] = entry
                if self._queue:
                    # FIFO fairness: older router-held requests (back-
                    # pressured or failover-requeued) get first claim
                    # on any freed capacity — a fresh submit must not
                    # race past them to a slot and starve them to
                    # "deadline"
                    self._enqueue_locked(entry)
                    self._pump_locked()
                elif not self._try_dispatch(entry):
                    self._enqueue_locked(entry)
        if reason is not None:
            # admission sheds resolve OUTSIDE the lock (same shape as
            # Engine.submit): the entry was never published, so only
            # this thread can resolve it, and the caller's future
            # callbacks never run under the router lock
            return self._shed(entry, reason)
        return entry.future

    def _root_id(self, entry: _FleetEntry) -> int | None:
        return entry.root["span_id"] if entry.root is not None else None

    def _enqueue_locked(self, entry: _FleetEntry) -> None:  # tmcheck: holds=_lock
        """Queue a router-held entry, opening its router_queue span
        (the named leg the critical path shows for backpressure)."""
        if (self.tracer is not None and entry.ctx is not None
                and entry.qspan is None):
            entry.qspan = self.tracer.start_span(
                entry.ctx, "router_queue",
                parent_id=self._root_id(entry),
            )
        self._queue.append(entry.rid)

    def _shed(self, entry: _FleetEntry, reason: str) -> ServingFuture:
        now = time.monotonic()
        if self.tracer is not None and entry.ctx is not None:
            # a shed is exactly the tail 1/N sampling must not lose
            force_sample(entry.ctx)
            self.tracer.end_span(entry.qspan, reason=reason)
            self.tracer.end_span(entry.dspan, outcome=reason)
            entry.qspan = entry.dspan = None
            self.tracer.end_span(entry.root, status="shed",
                                 finish_reason=reason)
            entry.root = None
        entry.future._set(Result(
            status="shed", finish_reason=reason,
            queued_s=now - entry.submit_t,
        ))
        self.recorder.record_request(
            status="shed", finish_reason=reason,
            n_prompt=len(entry.request.prompt), n_generated=0,
            queued_s=now - entry.submit_t,
        )
        return entry.future

    # -- dispatch (lock held) ----------------------------------------------

    def _over_cap(self, m: _Member) -> bool:
        return (
            self.replica_queue_cap is not None
            and m.replica.load() >= self.replica_queue_cap
        )

    def _candidates(  # tmcheck: holds=_lock
        self, entry: _FleetEntry
    ) -> tuple[list[_Member], str]:
        """Role-aware candidate set + dispatch mode for one entry.
        Modes: ``"prefill"`` (send the prompt to a prefill specialist,
        expect a handoff back), ``"decode"`` (carry the handoff to a
        decode-capable member), ``"unified"``
        (serve end-to-end).  Role purity yields to availability at
        every step — when no specialist is healthy the request falls
        back to unified members, and when ONLY specialists are
        healthy they serve outside their specialty rather than
        starve the request."""
        avail = self._dispatchable()
        if not avail:
            return [], "unified"
        pre = [m for m in avail if m.role == "prefill"]
        dec = [m for m in avail if m.role == "decode"]
        uni = [m for m in avail if m.role == "unified"]
        if entry.handoff is not None:
            return (dec or uni or avail), "decode"
        if (pre and (dec or uni) and entry.disagg_ok
                and entry.request.max_tokens > 1):
            # disaggregate: prefill somewhere that can hand off, and
            # someone else can decode.  max_tokens<=1 requests have
            # nothing to decode — a handoff would be pure overhead.
            return pre, "prefill"
        return (uni or avail), "unified"

    def _choose(self, entry: _FleetEntry,  # tmcheck: holds=_lock
                healthy: list[_Member]) -> _Member | None:
        if not healthy:
            return None
        if self.policy == "prefix_affinity":
            by_name = {m.name: m for m in healthy}
            name = self._ring.lookup(
                entry.affinity_key,
                skip=lambda n: (
                    n not in by_name or self._over_cap(by_name[n])
                ),
            )
            return by_name.get(name) if name is not None else None
        if self.policy == "least_loaded":
            # one load() probe per member: a consistent snapshot for
            # both the cap filter and the pick (load() is a lock +
            # possibly a wire-cache read on TCP replicas)
            loads = [(m.replica.load(), m.index, m) for m in healthy]
            free = [
                t for t in loads
                if self.replica_queue_cap is None
                or t[0] < self.replica_queue_cap
            ]
            if not free:
                return None
            # deterministic tie-break: (load, member index)
            return min(free, key=lambda t: t[:2])[2]
        # round_robin: advance the cursor past unhealthy/saturated
        for _ in range(len(healthy)):
            m = healthy[self._rr % len(healthy)]
            self._rr += 1
            if not self._over_cap(m):
                return m
        return None

    def _try_dispatch(self, entry: _FleetEntry) -> bool:  # tmcheck: holds=_lock
        """Dispatch one pending entry if a member will take it; the
        caller holds the lock.  Expired entries shed here (the
        deadline generalizes across requeues: each redispatch carries
        only the REMAINING budget)."""
        now = time.monotonic()
        remaining = entry.deadline_s - (now - entry.submit_t)
        if remaining <= 0:
            del self._pending[entry.rid]
            # deliberate resolve-under-RLock: deadline expiry is
            # found mid-dispatch, and deferring it would let the dead
            # entry be re-dispatched first.  User callbacks run under
            # the router RLock (re-entry is safe; callbacks must not
            # take foreign locks).
            self._shed(entry, "deadline")  # tmcheck: disable=TM103
            return True      # terminal — no longer queued
        candidates, mode = self._candidates(entry)
        member = self._choose(entry, candidates)
        if member is None and mode != "unified":
            # role purity yields to availability for LOAD too, not
            # just health: a saturated/backpressured specialist pool
            # must not hold a request at the router while non-
            # specialist members sit idle — a prefill-phase request
            # serves end-to-end instead, a decode-phase handoff goes
            # to any member (the engine underneath is identical)
            rest = [
                m for m in self._dispatchable()
                if m not in candidates
            ]
            member = self._choose(entry, rest)
            if member is not None and mode == "prefill":
                mode = "unified"
        if member is None:
            return False
        entry.gen += 1
        entry.member = member
        entry.dispatch_t = now
        gen = entry.gen
        req = entry.request
        trace_ctx = None
        if self.tracer is not None and entry.ctx is not None:
            self.tracer.end_span(entry.qspan)
            entry.qspan = None
            entry.dspan = self.tracer.start_span(
                entry.ctx, "dispatch", parent_id=self._root_id(entry),
                member=member.name, mode=mode, gen=gen,
            )
            # the replica's spans parent under THIS dispatch hop —
            # the context (incl. the sampled bit) rides the Request
            # across the TCP frames unchanged
            trace_ctx = child_context(
                entry.ctx, entry.dspan["span_id"]
            )
        efut = member.replica.submit(Request(
            prompt=list(req.prompt), max_tokens=req.max_tokens,
            temperature=req.temperature, deadline_s=remaining,
            seed=req.seed,
            prefill_only=(mode == "prefill"),
            handoff=entry.handoff,
            trace=trace_ctx,
        ))
        self.recorder.record_dispatch(member.name)
        # deliberate register-under-RLock: an already-resolved efut
        # fires _on_result inline on THIS thread, which re-enters the
        # RLock; registering outside the lock would open a window
        # where a racing requeue misses the generation bump.
        efut.add_done_callback(  # tmcheck: disable=TM103
            lambda res, rid=entry.rid, gen=gen:
                self._on_result(rid, gen, res)
        )
        return True

    # -- completion (replica threads) --------------------------------------

    def _on_result(self, rid: int, gen: int, res: Result) -> None:
        if self.tracer is not None and res.spans:
            # the replica-side flight record — ingested for EVERY
            # delivery (stale/duplicate results are real duplicated
            # work on the same tree; span-id dedup handles replays)
            self.tracer.ingest(res.spans)
        with self._lock:
            entry = self._pending.get(rid)
            if entry is None or entry.gen != gen:
                return    # stale: requeued elsewhere / double-resolve
            if (
                res.status == "ok"
                and res.finish_reason == "prefilled"
                and res.handoff is not None
            ):
                # phase boundary: the prefill specialist
                # returned the KV record — carry it to a decode
                # member.  NOT a terminal result: the user future
                # stays pending and nothing is recorded yet.  The
                # honest fleet TTFT is the PREFILL side's (the first
                # token exists now).
                shift = (
                    entry.dispatch_t - entry.submit_t
                    if entry.dispatch_t is not None else 0.0
                )
                entry.handoff = res.handoff
                if res.ttft_s is not None:
                    entry.ttft_prefill = res.ttft_s + shift
                entry.gen += 1        # invalidate the prefill hop
                entry.member = None
                self.recorder.record_handoff()
                if self.tracer is not None and entry.ctx is not None:
                    self.tracer.end_span(entry.dspan,
                                         outcome="prefilled")
                    entry.dspan = None
                    t = self.tracer.clock()
                    self.tracer.record_span(
                        entry.ctx, "handoff", t, t,
                        parent_id=self._root_id(entry),
                        n_blocks=res.handoff.get("n_blocks"),
                    )
                if self._queue:
                    # FIFO fairness, same as submit()
                    self._enqueue_locked(entry)
                    self._pump_locked()
                elif not self._try_dispatch(entry):
                    self._enqueue_locked(entry)
                return
            if (
                res.status == "shed"
                and entry.handoff is not None
                and res.finish_reason in ("handoff_failed", "no_blocks")
            ):
                # the receiver couldn't take the handoff (geometry
                # mismatch, dry pool): drop the record and retry the
                # FULL prompt end-to-end — the transfer is an
                # optimization, the request must never die with it
                # (disagg_ok stops the retry from re-disaggregating
                # into the same failure)
                entry.handoff = None
                entry.ttft_prefill = None
                entry.disagg_ok = False
                self._requeue_locked([entry])
                return
            if (
                res.status == "shed"
                and res.finish_reason in _REQUEUE_REASONS
            ):
                # the replica abandoned it without serving: failover
                self._requeue_locked([entry])
                return
            del self._pending[rid]
            if rid in self._queue:      # paranoia; dispatched rids
                self._queue.remove(rid)  # are not queued
        # re-base the latency fields on the ROUTER submit time — the
        # replica measured from ITS OWN admission, which for a
        # requeued or router-held request understates the wait
        shift = (
            entry.dispatch_t - entry.submit_t
            if entry.dispatch_t is not None else 0.0
        )
        ttft = (
            entry.ttft_prefill if entry.ttft_prefill is not None
            else res.ttft_s + shift if res.ttft_s is not None
            else None
        )
        out = Result(
            status=res.status, finish_reason=res.finish_reason,
            tokens=list(res.tokens),
            ttft_s=ttft,
            tpot_s=res.tpot_s,
            queued_s=(
                res.queued_s + shift
                if res.queued_s is not None else shift
            ),
            e2e_s=(
                res.e2e_s + shift if res.e2e_s is not None else None
            ),
        )
        if self.tracer is not None and entry.ctx is not None:
            slo_miss = (
                (self.trace_slo_ttft_s is not None
                 and out.ttft_s is not None
                 and out.ttft_s > self.trace_slo_ttft_s)
                or (self.trace_slo_e2e_s is not None
                    and out.e2e_s is not None
                    and out.e2e_s > self.trace_slo_e2e_s)
            )
            if out.status == "shed" or slo_miss:
                # keep the interesting tail — forced BEFORE the
                # still-open dispatch span ends, so the kept trace
                # carries its member/mode leg, not just the root
                force_sample(entry.ctx)
            self.tracer.end_span(entry.dspan,
                                 outcome=out.finish_reason)
            entry.dspan = None
            self.tracer.end_span(
                entry.root, status=out.status,
                finish_reason=out.finish_reason, slo_miss=slo_miss,
            )
            entry.root = None
        entry.future._set(out)
        self.recorder.record_request(
            status=out.status, finish_reason=out.finish_reason,
            n_prompt=len(entry.request.prompt),
            n_generated=len(out.tokens),
            ttft_s=out.ttft_s, tpot_s=out.tpot_s,
            queued_s=out.queued_s, e2e_s=out.e2e_s,
        )

    # -- failover ----------------------------------------------------------

    def _requeue_locked(self, entries: list, charge: bool = True) -> None:
        """``charge=False`` (scale-down drains) requeues without
        spending the entries' failover budget: the fleet chose to
        move them, so bouncing between drained victims must never
        shed a request "failover"."""
        n = 0
        for entry in entries:
            entry.gen += 1        # invalidate in-flight callbacks
            entry.member = None
            if self.tracer is not None and entry.ctx is not None:
                # failover is an always-sample event: the forced bit
                # rides every later dispatch, so the retry legs are
                # fully traced even at 1/N
                force_sample(entry.ctx)
                self.tracer.end_span(entry.dspan, outcome="requeue")
                entry.dspan = None
                t = self.tracer.clock()
                self.tracer.record_span(
                    entry.ctx, "requeue", t, t,
                    parent_id=self._root_id(entry),
                    gen=entry.gen, charged=charge,
                )
            if charge:
                if entry.n_requeues >= self.max_requeues:
                    del self._pending[entry.rid]
                    # deliberate resolve-under-RLock: the failover
                    # budget is spent mid-sweep; see _try_dispatch's
                    # deadline shed for the rationale
                    self._shed(entry, "failover")  # tmcheck: disable=TM103
                    continue
                entry.n_requeues += 1
            self._enqueue_locked(entry)
            n += 1
        if n:
            self.recorder.record_requeue(n)

    def _fail_member(self, member: _Member, cause: str) -> None:
        with self._lock:
            if not member.healthy:
                return
            member.healthy = False
            self.recorder.record_failover(member.name)
            affected = [
                e for e in self._pending.values()
                if e.member is member
            ]
            self._requeue_locked(affected)
        # pull the flight recorder from the wreck: a replica whose
        # LOOP died (fault drill, crash) often still answers its
        # wire/object, so the spans of the requests it was serving —
        # which never got a Result to ride — survive into the
        # router's ring.  Best-effort, OUTSIDE the lock (wire call).
        self._salvage_trace(member)

    def _salvage_trace(self, member: _Member) -> None:
        if self.tracer is None:
            return
        fn = getattr(member.replica, "trace_state", None)
        if fn is None:
            return
        try:
            spans = fn()
        except Exception:
            return      # truly gone: its unsent spans die with it
        if spans:
            self.tracer.ingest(spans)

    # -- health monitor ----------------------------------------------------

    def start(self) -> "Router":
        if self._monitor is not None:
            raise RuntimeError("router already started")
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="tm-fleet-monitor",
            daemon=True,
        )
        self._monitor.start()
        return self

    def check_health(self) -> None:
        """One watchdog pass (the monitor thread calls this every
        ``health_interval_s``; tests may call it directly).
        Liveness = a FRESH heartbeat stamp — supervisor semantics:
        progress counters rewind on restart, fresh writes don't."""
        now = time.monotonic()
        with self._lock:
            members = list(self._members)
        for m in members:
            hb = m.replica.heartbeat()
            alive = m.replica.alive()
            # converge the dispatch role with the replica's own: a
            # TCP client registered before its first pong reported
            # the caller's default, and the pong's correction must
            # reach _candidates(), not just the client object.  A
            # role the caller EXPLICITLY passed to add_replica is
            # pinned — the watchdog must not revert that override.
            role = getattr(m.replica, "role", None)
            if not m.role_pinned and role is not None \
                    and role != m.role:
                m.role = role
            if hb.get("time", 0.0) > m.last_hb_time and alive:
                m.last_hb_time = hb["time"]
                m.last_beat = now
                m.seen_beat = True
                if not m.healthy:
                    with self._lock:
                        m.healthy = True
                    self.recorder.record_rejoin(m.name)
            if not m.healthy:
                continue
            limit = (
                self.stall_timeout_s if m.seen_beat
                else self.startup_grace_s
            )
            if not alive:
                self._fail_member(m, "dead")
            elif now - m.last_beat > limit:
                self._fail_member(m, "stall")

    def _pump_queue(self) -> None:
        """Retry dispatch for router-held requests (backpressure
        cleared, a member rejoined, or a deadline expired)."""
        with self._lock:
            self._pump_locked()

    def _pump_locked(self) -> None:
        rids = list(self._queue)
        self._queue.clear()
        for rid in rids:
            entry = self._pending.get(rid)
            if entry is None:
                continue
            if not self._try_dispatch(entry):
                self._queue.append(rid)

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            self.check_health()
            self._pump_queue()
            time.sleep(self.health_interval_s)

    # -- shutdown / observability ------------------------------------------

    def drain(self, timeout: float = 300.0) -> bool:
        """Block until every admitted request has resolved (True) or
        the timeout passes (False) — the closed-loop bench idiom."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return True
            if self._monitor is None:
                # inline mode: no monitor thread pumping for us
                self.check_health()
                self._pump_queue()
            time.sleep(self.health_interval_s)
        with self._lock:
            return not self._pending

    def stop(self, drain_s: float = 30.0) -> None:
        """Refuse new admissions, give in-flight work ``drain_s`` to
        finish, then shed the stragglers ("shutdown") — every future
        still resolves.  Replica lifecycles belong to the caller."""
        with self._lock:
            self._stopping = True
        self.drain(timeout=drain_s)
        with self._lock:
            leftovers = list(self._pending.values())
            self._pending.clear()
            self._queue.clear()
        for entry in leftovers:
            entry.gen += 1   # silence any late replica callbacks
            self._shed(entry, "shutdown")
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=30.0)
            self._monitor = None

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def fleet_capacity(self, default_slots: int = 1) -> int:
        """Total decode-slot capacity of the dispatchable (healthy,
        non-draining) members — the autoscaler's pressure
        denominator.  Replicas without a ``slots()`` probe count as
        ``default_slots``."""
        with self._lock:
            members = self._dispatchable()
        total = 0
        for m in members:
            fn = getattr(m.replica, "slots", None)
            total += int(fn()) if callable(fn) else int(default_slots)
        return total

    def member_loads(self) -> dict:
        """Per-member ``load()`` snapshot of dispatchable members —
        the autoscaler's victim-selection input."""
        with self._lock:
            members = self._dispatchable()
        return {m.name: m.replica.load() for m in members}

    def replica_named(self, name: str):
        """The replica object behind a member (the autoscaler's
        retire hook needs it after ``remove_replica`` forgets it)."""
        with self._lock:
            return self._member_named(name).replica

    def refresh_replica_stats(self) -> None:
        """Pull each reachable replica's recorder state (and paging
        stats) into the fleet recorder — call before
        ``fleet_summary`` (unreachable replicas keep their last
        attached snapshot; their completions were recorded
        router-side anyway)."""
        with self._lock:
            members = list(self._members)
        for m in members:
            try:
                state = m.replica.recorder_state()
                paging = m.replica.paging_stats()
            except Exception:
                continue   # dead/unreachable: keep the last snapshot
            self.recorder.attach_replica(m.name, state, paging)

    def fleet_summary(self) -> dict:
        self.refresh_replica_stats()
        out = self.recorder.summary()
        out["members"] = self.members()
        out["policy"] = self.policy
        return out

    def metrics_txt(self) -> str:
        """Prometheus-style text for the whole fleet, on demand —
        pulls fresh replica recorder states first (no HTTP server;
        dump it wherever the scrape lives)."""
        self.refresh_replica_stats()
        return self.recorder.metrics_txt()

    # -- tracing (obs/) ----------------------------------------------------

    def collect_spans(self, trace_id: int | None = None) -> list:
        """Router-ring spans, after best-effort pulls of every
        reachable replica's flight recorder (covers traces still in
        flight; completed requests' spans already rode their
        Results).  Wire calls happen OUTSIDE the router lock."""
        if self.tracer is None:
            return []
        with self._lock:
            members = list(self._members)
        for m in members:
            self._salvage_trace(m)
        return self.tracer.spans(trace_id)

    def critical_path(self, trace_id: int) -> dict | None:
        """The "why was this request slow" report (obs/export.py):
        the longest serial chain with per-leg durations, from the
        router's stitched tree.  ``trace_id`` comes from the
        submitted future's ``trace_id`` attribute.  Returns ``None``
        when the ring holds no spans for that trace — at 1/N
        sampling that is most requests (unsampled and uneventful:
        shed/failover/SLO-miss traces are always kept, and
        ``trace_sample=1`` keeps everything)."""
        from theanompi_tpu_torch.obs import export

        if self.tracer is None:
            return None
        spans = self.tracer.spans(trace_id)
        if not spans:
            return None
        return export.critical_path(spans, trace_id)

    def export_trace(self, path, trace_id: int | None = None) -> str:
        """Write the Perfetto-openable Chrome-trace JSON for one
        trace (or everything in the ring) to ``path``."""
        from theanompi_tpu_torch.obs import export

        return export.write_chrome_trace(
            self.collect_spans(trace_id), path, trace_id=trace_id
        )
