"""Load-driven fleet autoscaling — the serving control plane
(port of ``theanompi_tpu/serving/autoscaler.py``, copied with the
port's imports; the spawn factory returns a started replica, whose
engine the factory builds — so an engine a replica cannot run, such as
speculation over a v1 decoder, is refused at the spawn)
— "traffic decides the fleet, not a flag".

The router and replicas are the fleet's data plane (failover
included); the supervisor makes the training world elastic.  This
composes them for serving: a policy loop that watches the fleet's backpressure
and spawns/retires replicas the way elastic training resizes the
world — supervisor semantics (watch a signal, act, record), applied
to capacity instead of liveness.

**The signal.**  ``pressure = outstanding / capacity``: every admitted
-but-unresolved request in the router (queued + in flight,
``Router.pending``) over the dispatchable fleet's total decode slots
(``Router.fleet_capacity``).  Pressure ≈ 1 means the decode batches
are exactly full; past it, requests queue — the operating point the
``fleet_roofline`` knee marks (utilization at ``target_util`` of a
replica's capacity).  The default thresholds bracket that knee:
scale UP when pressure holds above ``scale_up_at`` (sustained
backpressure, not a one-tick blip — ``up_hold_s`` hysteresis), scale
DOWN when it holds below ``scale_down_at`` for ``down_hold_s``, with
``cooldown_s`` between actions so one burst can't slam the fleet
both ways.

**Scale-up** calls the ``spawn`` factory (→ a started replica object:
an ``InProcessReplica``, a ``TCPReplicaClient`` onto a fresh replica
process, or a warm standby) and registers it with the router — it
joins healthy and takes traffic on the next dispatch.

**Scale-down** picks the least-loaded managed member and DRAINS it:
``Router.drain_replica`` stops new dispatches and requeues its
queued + in-flight requests through the ordinary failover/dedup path
(first completion wins, failover budget uncharged) — the
``Engine.abandon_all`` discipline applied fleet-side, so a retired
replica never drops a request.  ``Router.remove_replica`` then pulls
the victim's final telemetry snapshot (merged fleet counts stay
conserved across the membership change) and forgets it; the
``retire`` callback gets the replica object for process teardown.

**Accounting.**  Every spawn/retire lands in the fleet recorder's
scale-event log; ``FleetRecorder.replica_seconds()`` integrates it —
the cost metric the ``serving_autoscale`` bench row compares against
a statically peak-provisioned fleet under the same diurnal trace.

**Drills.**  Each tick runs ``maybe_inject_fault(index, tick)`` on
the autoscaler's own clock: the ``spike_load`` action
(``utils/faults.py``) raises :class:`~theanompi_tpu_torch.utils.faults
.LoadSpike`, which the loop treats as a sustained-backpressure
certificate — an immediate scale-up, hysteresis bypassed — so the
fault matrix can force membership churn (and compose it with a
``die_replica`` aimed at a prefill specialist mid-handoff) without
shaping real traffic.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from theanompi_tpu_torch.utils.faults import LoadSpike, maybe_inject_fault


class Autoscaler:
    """Policy loop over one :class:`~theanompi_tpu_torch.serving.Router`.

    ``spawn(index) -> replica`` provides new capacity (called with a
    monotonically increasing index); ``retire(replica)`` (optional)
    tears a drained victim down.  ``manage`` names the members this
    loop may retire — default: every member registered at
    ``start()`` plus everything it spawns.  ``min_replicas`` /
    ``max_replicas`` bound the MANAGED count; unmanaged members
    (e.g. a fixed pool of prefill specialists) are never touched.

    Drive it with ``start()``/``stop()`` (background thread) or call
    ``tick()`` directly (deterministic tests and closed-loop
    benches).
    """

    def __init__(
        self,
        router,
        spawn,
        *,
        retire=None,
        min_replicas: int = 1,
        max_replicas: int = 4,
        scale_up_at: float = 1.5,
        scale_down_at: float = 0.25,
        up_hold_s: float = 0.25,
        down_hold_s: float = 1.0,
        cooldown_s: float = 0.5,
        interval_s: float = 0.05,
        spawn_latency_s: float = 0.0,
        default_slots: int = 1,
        index: int = 0,
        manage=None,
        verbose: bool = False,
        tracer=None,
    ):
        if not 0 <= scale_down_at < scale_up_at:
            raise ValueError(
                f"need 0 <= scale_down_at < scale_up_at, got "
                f"{scale_down_at}/{scale_up_at}: overlapping "
                f"thresholds would oscillate the fleet"
            )
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}"
            )
        self.router = router
        self.spawn = spawn
        self.retire = retire
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_at = float(scale_up_at)
        self.scale_down_at = float(scale_down_at)
        self.up_hold_s = float(up_hold_s)
        self.down_hold_s = float(down_hold_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        # COLD-spawn modeling: a real
        # scale-up pays `serve_replica_main` startup — process spawn,
        # torch import, kernel builds — before the new member
        # serves a token.  `spawn_latency_s` charges that window
        # against the scale-up budget: the post-action cooldown is
        # measured from the replica's READINESS (spawn call + the
        # larger of the modeled latency and the measured spawn wall
        # time), so the backpressure that persists while the spawn is
        # cold DEFERS the next scale decision instead of
        # double-spawning into it.  The ledger charges from the
        # DECISION (record_spawn at call time): a booting replica is
        # paid-for capacity.
        self.spawn_latency_s = float(spawn_latency_s)
        self.spawn_latency_charged_s = 0.0
        self.default_slots = int(default_slots)
        self.index = int(index)
        self.verbose = bool(verbose)
        # span tracing (obs/tracer.py): scale actions are rare and
        # load-bearing, so each is its OWN always-sampled trace —
        # scale_up covers decision → modeled readiness, scale_down
        # covers drain → retire.  Defaults to the router's tracer so
        # control-plane lanes land in the same Perfetto export.
        self.tracer = tracer if tracer is not None \
            else getattr(router, "tracer", None)

        self.managed: set[str] = (
            set(str(n) for n in manage) if manage is not None
            else {str(n) for n in router.members()}
        )
        # the initial managed members are capacity from t0: their
        # spawn events open the replica-seconds ledger
        for name in sorted(self.managed):
            router.recorder.record_spawn(name, reason="initial")
        self.events: list[dict] = []
        self.n_ticks = 0
        self.last_pressure: float | None = None
        # bounded pressure history (wall-stamped) — the counter track
        # the single-view Perfetto export renders next to the request
        # spans (obs/export.chrome_trace counters=)
        self.pressure_samples: deque = deque(maxlen=4096)
        self._spawn_idx = len(self.managed)
        self._above_since: float | None = None
        self._below_since: float | None = None
        self._last_action_t: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # same discipline as InProcessReplica._loop: a control plane
        # that dies must die LOUDLY, never silently stop scaling
        self.dead = False
        self.death_cause: str | None = None

    def _say(self, msg: str) -> None:
        if self.verbose:
            print(f"autoscaler: {msg}", flush=True)

    # -- signals -----------------------------------------------------------

    def pressure(self) -> float:
        """Outstanding work per dispatchable decode slot."""
        cap = self.router.fleet_capacity(self.default_slots)
        return self.router.pending() / max(1, cap)

    def _managed_alive(self) -> list[str]:
        """Managed members that are HEALTHY — a dead managed replica
        must not consume max_replicas budget (blocking its own
        replacement) nor prop up the min_replicas floor."""
        return [
            n for n, info in self.router.members().items()
            if n in self.managed and info.get("healthy")
        ]

    def _cooled(self, now: float) -> bool:
        return (
            self._last_action_t is None
            or now - self._last_action_t >= self.cooldown_s
        )

    # -- actions -----------------------------------------------------------

    def _scale_up(self, now: float, why: str) -> bool:
        if len(self._managed_alive()) >= self.max_replicas:
            return False
        # decision stamp in the TRACER's clock domain (it may not be
        # time.monotonic — deterministic-test tracers pass clock=)
        t_dec = self.tracer.clock() if self.tracer is not None \
            else 0.0
        replica = self.spawn(self._spawn_idx)
        spawn_s = max(
            self.spawn_latency_s, time.monotonic() - now
        )
        self._spawn_idx += 1
        name = self.router.add_replica(replica)
        self.managed.add(name)
        # billed from the DECISION: the cold-start window is charged
        # replica-seconds even though no token serves during it
        self.router.recorder.record_spawn(name, t=now, reason=why)
        self.events.append({
            "event": "spawn", "replica": name, "t": now,
            "reason": why, "spawn_s": spawn_s,
        })
        self.spawn_latency_charged_s += spawn_s
        # cooldown from READINESS, not from the decision — pressure
        # observed while the spawn is still cold must not trigger a
        # second spawn the first one was already bought to relieve
        self._last_action_t = now + spawn_s
        self._above_since = self._below_since = None
        if self.tracer is not None:
            # decision → modeled readiness (the cold-start window
            # the ledger bills); lane "autoscaler" in the export
            self.tracer.record_span(
                self.tracer.new_context(force=True), "scale_up",
                t_dec, t_dec + spawn_s,
                lane="autoscaler", replica=name, reason=why,
                spawn_s=spawn_s,
            )
        self._say(f"scale-up -> {name} ({why}, spawn {spawn_s:.2f}s)")
        return True

    def _scale_down(self, now: float, why: str) -> bool:
        alive = self._managed_alive()
        if len(alive) <= self.min_replicas:
            return False
        loads = self.router.member_loads()
        # least-loaded managed victim; must leave the fleet able to
        # dispatch (≥ 1 healthy non-draining member overall)
        candidates = [n for n in alive if n in loads]
        if len(loads) <= 1 or not candidates:
            return False
        victim = min(candidates, key=lambda n: (loads[n], n))
        replica = self.router.replica_named(victim)
        t0 = self.tracer.clock() if self.tracer is not None else 0.0
        n_moved = self.router.drain_replica(victim)
        self.router.remove_replica(victim)
        if self.tracer is not None:
            # drain → retire, with the uncharged-requeue count — the
            # "why did these requests move" answer in the export
            self.tracer.record_span(
                self.tracer.new_context(force=True), "scale_down",
                t0, self.tracer.clock(), lane="autoscaler",
                replica=victim, reason=why, n_requeued=n_moved,
            )
        self.router.recorder.record_retire(victim, reason=why)
        self.managed.discard(victim)
        self.events.append({
            "event": "retire", "replica": victim, "t": now,
            "reason": why, "n_requeued": n_moved,
        })
        if self.retire is not None:
            self.retire(replica)
        self._last_action_t = now
        self._above_since = self._below_since = None
        self._say(
            f"scale-down -> retired {victim}, {n_moved} requests "
            f"requeued ({why})"
        )
        return True

    # -- the policy tick ---------------------------------------------------

    def tick(self) -> float:
        """One policy evaluation; returns the pressure it saw.
        ``spike_load`` drills fire here, on the autoscaler's own
        (index, tick) clock."""
        self.n_ticks += 1
        spike = False
        try:
            maybe_inject_fault(self.index, self.n_ticks)
        except LoadSpike as e:
            self._say(str(e))
            spike = True
        now = time.monotonic()
        p = self.pressure()
        self.last_pressure = p
        self.pressure_samples.append((time.time(), p))
        if spike:
            # drill semantics: the spike IS the sustained-backpressure
            # certificate — act now, hysteresis and cooldown bypassed
            self._scale_up(now, "spike_load drill")
            return p
        if p >= self.scale_up_at:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if (now - self._above_since >= self.up_hold_s
                    and self._cooled(now)):
                self._scale_up(now, f"pressure {p:.2f}")
        elif p <= self.scale_down_at:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if (now - self._below_since >= self.down_hold_s
                    and self._cooled(now)):
                self._scale_down(now, f"pressure {p:.2f}")
        else:
            self._above_since = self._below_since = None
        return p

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tm-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                self.tick()
                time.sleep(self.interval_s)
        except BaseException as e:  # noqa: BLE001 - a dead control plane is DATA
            # a failing spawn factory or router error must not
            # silently end autoscaling: record the cause (the fleet
            # keeps serving at its current size; the operator sees
            # dead=True in summary()) — mirroring the replica loop's
            # dead/death_cause contract
            self.dead = True
            self.death_cause = f"{type(e).__name__}: {e}"
            print(f"autoscaler: DIED: {self.death_cause}", flush=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def summary(self) -> dict:
        return {
            "n_ticks": self.n_ticks,
            "dead": self.dead,
            "death_cause": self.death_cause,
            "last_pressure": self.last_pressure,
            "spawn_latency_s": self.spawn_latency_s,
            "spawn_latency_charged_s": self.spawn_latency_charged_s,
            "managed": sorted(self.managed),
            "n_scale_ups": sum(
                e["event"] == "spawn" for e in self.events
            ),
            "n_scale_downs": sum(
                e["event"] == "retire" for e in self.events
            ),
            "events": list(self.events),
        }

    def counter_tracks(self, process: str = "autoscaler") -> list:
        """Chrome-trace counter samples of the pressure signal
        (``obs/export.chrome_trace``'s ``counters=``) — the gauge
        lane that explains WHY a scale_up span sits where it does in
        the single-view export."""
        return [
            {"process": process, "name": "pressure", "t": t,
             "values": {"pressure": round(p, 4)}}
            for t, p in list(self.pressure_samples)
        ]

    def metrics_txt(self, prefix: str = "tm_autoscaler") -> str:
        """Prometheus-style text for the control plane (stable
        names; ride it next to the router's fleet dump)."""
        from theanompi_tpu_torch.obs.metrics import render_metrics

        s = self.summary()
        p = prefix
        return render_metrics([
            (f"{p}_ticks_total", "counter", [(None, s["n_ticks"])]),
            (f"{p}_scale_ups_total", "counter",
             [(None, s["n_scale_ups"])]),
            (f"{p}_scale_downs_total", "counter",
             [(None, s["n_scale_downs"])]),
            (f"{p}_pressure", "gauge", [(None, s["last_pressure"])]),
            (f"{p}_managed_replicas", "gauge",
             [(None, len(s["managed"]))]),
            (f"{p}_spawn_latency_charged_seconds", "counter",
             [(None, s["spawn_latency_charged_s"])]),
            (f"{p}_dead", "gauge", [(None, s["dead"])]),
        ])
