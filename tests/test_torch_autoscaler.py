"""The port's fleet autoscaler (``serving/autoscaler.py``) and
``FleetRecorder`` against the JAX package's, on the CPU.

- POLICY: the two autoscalers, each over its own router and scripted
  replicas, driven by one pressure trace on a fake clock, see the same
  pressures and take the same scale actions at the same times.
- DRAIN: a scale-down drain requeues without charging the failover
  budget (``max_requeues=0`` and the request still serves).
- ACCOUNTING: ``replica_seconds`` integrates the spawn/retire log
  exactly, in both packages.
- DRILL: ``TM_FAULT_AT=<index>:<tick>:spike_load`` forces a scale-up at
  that tick, hysteresis bypassed.
- REFUSAL: a spawn whose engine is refused (speculation over the v1
  decoder) fails when the spawn builds it: the loop dies naming the
  cause; an 18-row verify window on a card (past K4's 16-row group)
  builds.
- RECORDER: ``FleetRecorder.summary()`` and ``metrics_txt`` over the same
  events and replica states (each package's ``ServingRecorder`` states,
  and the other package's, merged) equal the JAX ones.
- END TO END: real engines — a flooded one-replica fleet scales to two,
  serves every request with exact token accounting, drains back to one.
"""

import time

import pytest
import torch

import theanompi_tpu.serving.autoscaler as jax_autoscaler
from theanompi_tpu import serving as jax_serving
from theanompi_tpu.utils.recorder import FleetRecorder as JaxFleetRecorder
from theanompi_tpu.utils.recorder import ServingRecorder as JaxRecorder
import theanompi_tpu_torch.serving.autoscaler as port_autoscaler
from theanompi_tpu_torch import serving
from theanompi_tpu_torch.models import Llama
from theanompi_tpu_torch.utils import FleetRecorder, ServingRecorder, faults

pytestmark = pytest.mark.serving

PACKAGES = {"jax": (jax_serving, JaxRecorder, jax_autoscaler),
            "port": (serving, ServingRecorder, port_autoscaler)}


class Fake:
    """Scripted replica over either package: load is the count of
    unresolved submits; completions land in a real ServingRecorder."""

    def __init__(self, pkg, recorder_cls, name, slots=2):
        self.pkg = pkg
        self.name, self._slots, self.role = name, slots, "unified"
        self._hb = {"progress": 0, "time": 0.0, "status": "running"}
        self.submitted = []
        self.recorder = recorder_cls(max_slots=slots)

    def beat(self):
        self._hb = {"progress": self._hb["progress"] + 1,
                    "time": time.time(), "status": "running"}

    def submit(self, request):
        fut = self.pkg.ServingFuture()
        self.submitted.append((request, fut))
        return fut

    def resolve_all(self, n_tokens=2):
        for req, fut in self.submitted:
            if not fut.done():
                fut._set(self.pkg.Result(
                    status="ok", finish_reason="max_tokens",
                    tokens=list(range(n_tokens)), ttft_s=0.01, tpot_s=0.001,
                    e2e_s=0.02))
                self.recorder.record_request(
                    status="ok", finish_reason="max_tokens",
                    n_prompt=len(req.prompt), n_generated=n_tokens,
                    ttft_s=0.01, tpot_s=0.001, e2e_s=0.02)

    def load(self):
        return sum(not f.done() for _, f in self.submitted)

    def slots(self):
        return self._slots

    def heartbeat(self):
        return dict(self._hb)

    def alive(self):
        return True

    def recorder_state(self):
        return self.recorder.state_dict()

    def paging_stats(self):
        return None


class Clock:
    """The autoscaler's clock, advanced by the test."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


def fleet(which, monkeypatch, **asc_kw):
    pkg, rec, mod = PACKAGES[which]
    clock = Clock()
    monkeypatch.setattr(mod, "time", clock)
    fakes = [Fake(pkg, rec, "a")]
    router = pkg.Router(fakes, policy="least_loaded", startup_grace_s=60.0,
                        replica_queue_cap=None)
    fakes[0].beat()
    router.check_health()

    def spawn(i):
        f = Fake(pkg, rec, f"auto{i}")
        f.beat()
        fakes.append(f)
        return f

    asc = pkg.Autoscaler(router, spawn, **asc_kw)
    return router, asc, fakes, clock


def pressure_trace(which, monkeypatch):
    router, asc, fakes, clock = fleet(
        which, monkeypatch, min_replicas=1, max_replicas=3,
        scale_up_at=1.5, scale_down_at=0.25, up_hold_s=0.25,
        down_hold_s=1.0, cooldown_s=0.5)
    pressures = []

    def tick(dt):
        clock.sleep(dt)
        router.check_health()
        pressures.append(asc.tick())

    for _ in range(6):
        router.submit([1, 2], max_tokens=2)
    for dt in (0.0, 0.1, 0.2, 0.1):         # hold served at 0.3: spawn
        tick(dt)
    for _ in range(6):
        router.submit([3], max_tokens=2)
    for dt in (0.1, 0.3, 0.3, 0.2):         # cooldown, then a 3rd member
        tick(dt)
    for f in list(fakes):
        f.resolve_all()
    for dt in (0.2, 0.5, 0.6, 0.2, 0.9, 0.3, 0.8, 1.2, 2.0):
        tick(dt)                            # the lull: back down to 1
    drop = {"spawn_s"}
    events = [{k: v for k, v in e.items() if k not in drop}
              for e in asc.events]
    return pressures, events, asc.summary()["managed"], \
        [(e["event"], e["replica"]) for e in router.recorder.scale_events]


def test_same_pressure_trace_gives_the_jax_scale_events(monkeypatch):
    port = pressure_trace("port", monkeypatch)
    assert port == pressure_trace("jax", monkeypatch)
    kinds = [e["event"] for e in port[1]]
    assert kinds == ["spawn", "spawn", "retire", "retire"]
    assert len(port[2]) == 1


def test_drain_requeues_without_charging_the_failover_budget():
    pkg, rec = serving, ServingRecorder
    a, b = Fake(pkg, rec, "a"), Fake(pkg, rec, "b")
    router = serving.Router([a, b], policy="round_robin", max_requeues=0,
                            startup_grace_s=60.0)
    for f in (a, b):
        f.beat()
    router.check_health()
    fut = router.submit([1, 2], max_tokens=2)
    assert len(a.submitted) == 1
    assert router.drain_replica("a") == 1
    router._pump_queue()
    assert len(b.submitted) == 1            # moved, not shed "failover"
    b.resolve_all()
    assert fut.result(timeout=1.0).status == "ok"
    assert router.recorder.n_requeues == 1
    router.remove_replica("a")
    assert "a" not in router.members()


@pytest.mark.parametrize("cls", [FleetRecorder, JaxFleetRecorder],
                         ids=["port", "jax"])
def test_replica_seconds_is_exact(cls):
    fr = cls()
    assert fr.replica_seconds(now=5.0) == 0.0
    assert fr.summary()["replica_seconds"] is None
    fr.record_retire("ghost", t=1.0)        # no spawn: ignored
    fr.record_spawn("a", t=0.0)
    fr.record_spawn("b", t=10.0)
    fr.record_retire("b", t=30.0)           # b's first life: 20 s
    fr.record_spawn("b", t=50.0)
    fr.record_retire("b", t=55.0)           # its second: 5 s
    assert fr.replica_seconds(now=100.0) == 100.0 + 25.0
    s = fr.summary()
    assert (s["n_spawns"], s["n_retires"]) == (3, 3)


def test_spike_load_drill_forces_a_scale_up(monkeypatch):
    faults.reset_fault_cache()
    monkeypatch.setenv("TM_FAULT_AT", "9:2:spike_load")
    try:
        router, asc, fakes, _ = fleet(
            "port", monkeypatch, index=9, max_replicas=3, up_hold_s=600.0,
            cooldown_s=600.0)
        asc.tick()
        assert len(fakes) == 1
        asc.tick()                          # tick 2: the spike fires
        assert len(fakes) == 2
        assert asc.events[-1]["reason"] == "spike_load drill"
        asc.tick()                          # once only
        assert len(fakes) == 2 and len(router.members()) == 2
    finally:
        faults.reset_fault_cache()


def test_spawn_past_k4_row_limit_is_refused_at_the_spawn():
    """K4 has no row limit any more: a spawn factory that builds
    ``Engine(speculate_k=9)`` over a decoder on a card (2 query heads a
    kv head: 18 rows) spawns.  A spawn whose engine is refused
    (speculation over the v1 decoder) still raises when the spawn builds
    it; the loop dies loudly, naming the cause, and the fleet keeps its
    members."""
    cfg = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=64,
               vocab=64, seq_len=64, compute_dtype="float32")
    model = Llama(cfg, device="cpu")
    pkg, rec = serving, ServingRecorder
    a = Fake(pkg, rec, "a")
    router = serving.Router([a], startup_grace_s=60.0,
                            replica_queue_cap=None)
    a.beat()
    router.check_health()

    def engine(paged):
        kw = dict(block_size=8, prefill_chunk=8) if paged else {}
        dec = model.make_decoder(paged=paged, max_slots=2, max_seq=48, **kw)
        dec.device = torch.device("cuda", 0)   # what a card's decoder says
        return serving.Engine(dec, speculate_k=9)

    eng = engine(paged=True)                   # 18 rows build on a card
    assert eng.speculate_k == 9 and eng.decoder._rep == 2

    def spawn(i):
        return serving.InProcessReplica(engine(paged=False),
                                        name=f"auto{i}").start()

    asc = serving.Autoscaler(router, spawn, max_replicas=2, up_hold_s=0.0,
                             cooldown_s=0.0, interval_s=0.001)
    for _ in range(8):
        router.submit([1, 2], max_tokens=2)
    with pytest.raises(NotImplementedError, match="paged"):
        asc.tick()
    asc.start()
    deadline = time.monotonic() + 10.0
    while not asc.dead and time.monotonic() < deadline:
        time.sleep(0.005)
    asc.stop()
    assert asc.dead and "paged" in asc.death_cause
    assert list(router.members()) == ["a"]
    a.resolve_all()


def feed(fr, recorder_cls, states_from):
    """The same router-side events and replica states into ``fr``;
    replica ``r1``'s state comes from ``states_from`` (either package's
    ServingRecorder)."""
    for i in range(7):
        fr.record_request(status="ok", finish_reason="max_tokens",
                          n_prompt=10 + i, n_generated=4,
                          ttft_s=0.01 * (i + 1), tpot_s=0.002 * (i + 1),
                          queued_s=0.001 * i, e2e_s=0.05 * (i + 1))
    fr.record_request(status="shed", finish_reason="deadline", n_prompt=5,
                      n_generated=0, queued_s=0.3)
    for name in ("r0", "r1", "r0", "r2"):
        fr.record_dispatch(name)
    fr.record_requeue(2)
    fr.record_failover("r2")
    fr.record_rejoin("r2")
    fr.record_handoff(3)
    fr.record_spawn("r0", t=0.0)
    fr.record_spawn("r1", t=2.0)
    fr.record_retire("r1", t=7.5)
    fr.record_retire("r0", t=9.0)
    for name, cls in (("r0", recorder_cls), ("r1", states_from)):
        r = cls(max_slots=4)
        for j in range(5):
            r.record_step(active_slots=j % 4 + 1, queue_depth=j, dt_s=0.01,
                          tokens=j + 1, drafted=4, accepted=j % 3)
            r.record_request(status="ok", finish_reason="eos",
                             n_prompt=8, n_generated=j + 1, ttft_s=0.02,
                             tpot_s=0.003, e2e_s=0.04, n_prefix_hit=j)
        fr.attach_replica(name, r.state_dict(), {"blocks": j})
    return fr


@pytest.mark.parametrize("states_from", ["own", "other"])
def test_fleet_recorder_summary_and_merges_equal_the_jax_ones(states_from):
    port = feed(FleetRecorder(), ServingRecorder,
                ServingRecorder if states_from == "own" else JaxRecorder)
    jax_fr = feed(JaxFleetRecorder(), JaxRecorder,
                  JaxRecorder if states_from == "own" else ServingRecorder)
    assert port.summary() == jax_fr.summary()
    assert port.metrics_txt() == jax_fr.metrics_txt()
    s = port.summary()
    assert s["replica_seconds"] == 9.0 + 5.5
    assert s["per_replica"]["r1"]["n_completed"] == 5
    assert s["n_handoffs"] == 3 and s["n_requeues"] == 2


def test_flood_scales_up_serves_exactly_then_drains():
    cfg = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
               vocab=64, seq_len=64, compute_dtype="float32")
    model = Llama(cfg, device="cpu")

    def build():
        return model.make_decoder(paged=True, max_slots=2, max_seq=48,
                                  block_size=8, prefill_chunk=8)

    r0 = serving.InProcessReplica(serving.Engine(build()), name="r0").start()
    router = serving.Router([r0], policy="least_loaded",
                            health_interval_s=0.005, startup_grace_s=120.0,
                            replica_queue_cap=4).start()
    spawned = []

    def spawn(i):
        rep = serving.InProcessReplica(serving.Engine(build()),
                                       name=f"r{i}", index=i).start()
        spawned.append(rep)
        return rep

    asc = serving.Autoscaler(router, spawn, min_replicas=1, max_replicas=2,
                             scale_up_at=2.0, scale_down_at=0.2,
                             up_hold_s=0.0, down_hold_s=0.05,
                             cooldown_s=0.0, retire=lambda rep: rep.stop())
    try:
        n, mt = 10, 4
        futs = [router.submit([1 + i, 5, 9, 3, 17], max_tokens=mt, seed=i)
                for i in range(n)]
        asc.tick()                          # 10 outstanding / 2 slots
        assert len(router.members()) == 2
        rs = [f.result(timeout=120.0) for f in futs]
        assert all(x.status == "ok" for x in rs)
        assert sum(len(x.tokens) for x in rs) == n * mt
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and len(router.members()) > 1:
            asc.tick()
            time.sleep(0.01)
        assert len(router.members()) == 1
        summ = router.fleet_summary()
        assert summ["n_completed"] == n
        assert summ["n_spawns"] == 2 and summ["n_retires"] == 1
        assert summ["replica_seconds"] > 0.0
        assert min(summ["dispatched"].values()) >= 1
        assert len(summ["dispatched"]) == 2
    finally:
        router.stop(drain_s=5.0)
        r0.stop()
        for rep in spawned:
            rep.stop()
