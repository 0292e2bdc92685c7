"""The port's serving fleet router (``serving/router.py``, over
``serving/replica.py``) against the JAX package's, on the CPU.

- HASHING: ``ConsistentHashRing`` lookups (with removals and skip
  predicates) and ``prefix_affinity_key`` bytes equal the JAX ones for
  the same members and keys.
- POLICIES and ADMISSION: the same scripted traffic over scripted
  replicas (``Fake``, one class for both packages) is dispatched to
  the same members, and shed with the same reasons and counts, by the
  two routers, for each of the three policies.
- FAILOVER: the kill-one-of-three drill (``TM_FAULT_AT=1:2:die_replica``
  kills replica 1 after its second busy iteration) on the port's fleet
  gives the JAX fleet's ids and a one-replica port fleet's, at fp32
  with the JAX parameters carried across by ``params_from_jax``;
  every future resolves, the requeue and failover are recorded.
- MEMBERSHIP: a paused loop goes unhealthy and rejoins when resumed; a
  dead loop restarted over its engine rejoins and serves.
- ROLES: a prefill replica and a decode replica give the unified
  fleet's ids, one KV handoff a request.
"""

import time

import jax
import pytest

from theanompi_tpu import serving as jax_serving
from theanompi_tpu.utils import faults as jax_faults
from theanompi_tpu.utils.recorder import ServingRecorder as JaxRecorder
from theanompi_tpu_torch import serving
from theanompi_tpu_torch.models import Llama, params_from_jax
from theanompi_tpu_torch.utils import faults
from theanompi_tpu_torch.utils.recorder import ServingRecorder

from test_torch_decoder import SMALL, jax_model

pytestmark = pytest.mark.serving

PACKAGES = {"jax": (jax_serving, JaxRecorder),
            "port": (serving, ServingRecorder)}
PROMPTS = [[1 + i, 5, 9, 3 + i, 17] for i in range(6)]
SYS = list(range(40))


# -- hashing -----------------------------------------------------------------


def test_ring_lookups_equal_the_jax_ring():
    keys = [bytes([i % 256, i * 7 % 251, i // 3]) for i in range(300)]
    rings = [pkg.ConsistentHashRing(n_vnodes=32)
             for pkg in (jax_serving, serving)]
    for ring in rings:
        for n in ("r0", "r1", "r2", "tcp:4001"):
            ring.add(n)
    skips = (None, lambda n: n == "r1",
             lambda n: n in ("r0", "tcp:4001"), lambda n: True)
    for skip in skips:
        a, b = ([ring.lookup(k, skip=skip) for k in keys] for ring in rings)
        assert a == b
    for ring in rings:
        ring.remove("r2")
    assert [rings[0].lookup(k) for k in keys] == \
        [rings[1].lookup(k) for k in keys]
    assert rings[0].nodes() == rings[1].nodes() == {"r0", "r1", "tcp:4001"}


@pytest.mark.parametrize("block", [1, 8, 16, 64])
def test_prefix_affinity_key_bytes_equal(block):
    prompts = ([], [7], SYS, SYS + [101, 102], list(range(1000, 1130)),
               (x for x in range(5)))
    for p in prompts:
        p = list(p)
        assert serving.prefix_affinity_key(p, block) == \
            jax_serving.prefix_affinity_key(p, block)


# -- scripted replicas --------------------------------------------------------


class Fake:
    """The replica protocol, scripted, over either package's futures:
    ``log`` (shared) records (member, prompt) per submit; ``shed`` set
    resolves each submit shed with that reason at once."""

    def __init__(self, pkg, recorder_cls, name, log, load=0):
        self.pkg, self.recorder_cls = pkg, recorder_cls
        self.name, self.log = name, log
        self.fixed_load = load
        self._alive = True
        self._hb = {"progress": 0, "time": 0.0, "status": "running"}
        self.submitted = []
        self.shed = None

    def beat(self):
        self._hb = {"progress": self._hb["progress"] + 1,
                    "time": time.time(), "status": "running"}

    def submit(self, request):
        fut = self.pkg.ServingFuture()
        self.submitted.append((request, fut))
        self.log.append((self.name, list(request.prompt)))
        if self.shed is not None:
            fut._set(self.pkg.Result(status="shed", finish_reason=self.shed))
        return fut

    def resolve_all(self):
        for _, fut in self.submitted:
            if not fut.done():
                fut._set(self.pkg.Result(
                    status="ok", finish_reason="max_tokens", tokens=[1, 2],
                    ttft_s=0.01, tpot_s=0.001, e2e_s=0.02))

    def load(self):
        return self.fixed_load

    def heartbeat(self):
        return dict(self._hb)

    def alive(self):
        return self._alive

    def recorder_state(self):
        return self.recorder_cls(max_slots=2).state_dict()

    def paging_stats(self):
        return None


def fleet_of(which, names, loads=None, **kw):
    pkg, rec = PACKAGES[which]
    log = []
    fakes = [Fake(pkg, rec, n, log, load=(loads or {}).get(n, 0))
             for n in names]
    kw.setdefault("startup_grace_s", 60.0)
    router = pkg.Router(fakes, **kw)
    for f in fakes:
        f.beat()
    router.check_health()
    return router, fakes, log


def policy_trace(which, policy):
    """One scripted run: shared-prefix and distinct prompts, loads that
    change between submits, a backpressured member, a member that dies
    and one that rejoins.  Returns the (member, prompt) dispatch log."""
    router, fakes, log = fleet_of(
        which, ["a", "b", "c", "d"], loads={"a": 2, "b": 1, "c": 1},
        policy=policy, replica_queue_cap=4, affinity_block=16)
    prompts = [SYS + [100 + i] for i in range(4)] + \
        [list(range(50 + 3 * i, 70 + 5 * i)) for i in range(6)]
    for i, p in enumerate(prompts):
        router.submit(p, max_tokens=2, seed=i)
        fakes[i % 4].fixed_load = (i * 3) % 5
    fakes[1].fixed_load = 10                # b backpressured
    for i, p in enumerate(prompts[:6]):
        router.submit(p, max_tokens=2, seed=i)
    fakes[2]._alive = False                 # c dies: its work moves
    router.check_health()
    router._pump_queue()
    fakes[1].fixed_load = 0
    fakes[3].beat()
    router.check_health()
    for i, p in enumerate(prompts[4:]):
        router.submit(p, max_tokens=2, seed=i)
    for f in fakes:
        f.resolve_all()
    s = router.fleet_summary()
    return log, {k: s[k] for k in ("n_requeues", "n_failovers",
                                   "dispatched", "n_completed")}


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded",
                                    "prefix_affinity"])
def test_policies_pick_the_jax_members(policy):
    port = policy_trace("port", policy)
    assert port == policy_trace("jax", policy)
    assert len(port[0]) >= 20 and port[1]["n_failovers"] == 1


def admission_trace(which):
    """Each admission path once: fleet queue cap, a router-held
    deadline, a bounded requeue, a replica-side shed passed through, a
    submit after stop.  Returns each future's (status, reason) and the
    recorder's shed counts."""
    out = []
    router, (f,), _ = fleet_of(which, ["a"], fleet_queue_cap=2)
    futs = [router.submit([1, 2], max_tokens=2) for _ in range(3)]
    f.resolve_all()
    out += [futs[2].result(timeout=0).finish_reason,
            futs[0].result(timeout=0).status]

    router, (f,), _ = fleet_of(which, ["a"], loads={"a": 10},
                               replica_queue_cap=4)
    fut = router.submit([1, 2], max_tokens=2, deadline_s=0.01)
    time.sleep(0.03)
    router._pump_queue()
    out.append(fut.result(timeout=0).finish_reason)

    router, (f,), _ = fleet_of(which, ["a"], max_requeues=2)
    f.shed = "queue_full"                   # bounces back every time
    fut = router.submit([1, 2], max_tokens=2)
    for _ in range(4):
        router._pump_queue()
    out += [fut.result(timeout=1.0).finish_reason,
            router.recorder.n_requeues]

    router, (f,), _ = fleet_of(which, ["a"])
    f.shed = "no_blocks"                    # terminal: passed through
    out.append(router.submit([3], max_tokens=2).result(timeout=0)
               .finish_reason)
    router.stop(drain_s=0.1)
    out.append(router.submit([1, 2], max_tokens=2).result(timeout=0)
               .finish_reason)
    out.append(router.recorder.summary()["shed_reasons"])
    return out


def test_admission_sheds_with_the_jax_reasons():
    port = admission_trace("port")
    assert port == admission_trace("jax")
    assert port[:6] == ["queue_full", "ok", "deadline", "failover", 2,
                        "no_blocks"]


# -- real engines ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jm(devices8):
    return jax_model(devices8)


@pytest.fixture(scope="module")
def port_llama(jm):
    return Llama(SMALL, device="cpu",
                 params=params_from_jax(jax.device_get(jm.params), SMALL,
                                        "cpu"))


def make_fleet(pkg, decoders, roles=None, **router_kw):
    reps = [pkg.InProcessReplica(pkg.Engine(d), name=f"r{i}", index=i,
                                 role=(roles or {}).get(i, "unified")).start()
            for i, d in enumerate(decoders)]
    router_kw.setdefault("policy", "round_robin")
    router_kw.setdefault("health_interval_s", 0.005)
    router_kw.setdefault("startup_grace_s", 60.0)
    return pkg.Router(reps, **router_kw).start(), reps


def fleet_run(router, n=6, max_tokens=5):
    futs = [router.submit(PROMPTS[i], max_tokens=max_tokens, seed=i)
            for i in range(n)]
    return [f.result(timeout=180.0) for f in futs]


def teardown(router, reps):
    router.stop(drain_s=5.0)
    for r in reps:
        r.stop()


def drill(pkg, decoders, monkeypatch):
    """Three replicas, replica 1 killed after its 2nd busy iteration:
    (ids, fleet summary, the dead replica)."""
    for mod in (faults, jax_faults):
        mod.reset_fault_cache()
    monkeypatch.setenv("TM_FAULT_AT", "1:2:die_replica")
    router, reps = make_fleet(pkg, decoders)
    try:
        rs = fleet_run(router)
        summ = router.fleet_summary()
    finally:
        teardown(router, reps)
        monkeypatch.delenv("TM_FAULT_AT")
        for mod in (faults, jax_faults):
            mod.reset_fault_cache()
    assert all(r.status == "ok" for r in rs)
    return [r.tokens for r in rs], summ, reps[1]


@pytest.mark.parametrize("paged", [False, True], ids=["v1", "paged"])
def test_kill_one_of_three_gives_the_jax_fleet_ids(jm, port_llama, paged,
                                                   monkeypatch):
    kw = dict(max_slots=2, max_seq=48)
    if paged:
        kw.update(paged=True, block_size=8, prefill_chunk=8)
    router, reps = make_fleet(serving, [port_llama.make_decoder(**kw)])
    try:
        alone = [r.tokens for r in fleet_run(router)]
    finally:
        teardown(router, reps)
    ids, summ, dead = drill(
        serving, [port_llama.make_decoder(**kw) for _ in range(3)],
        monkeypatch)
    jax_ids, jax_summ, _ = drill(
        jax_serving, [jm.make_decoder(**kw) for _ in range(3)], monkeypatch)
    assert ids == alone == jax_ids
    assert all(len(t) == 5 for t in ids)
    assert dead.dead and "ReplicaDied" in dead.death_cause
    assert summ["n_completed"] == jax_summ["n_completed"] == 6
    assert summ["n_requeues"] >= 1 and summ["n_failovers"] >= 1
    assert summ["members"]["r1"]["healthy"] is False


def test_restart_and_stall_rejoin(port_llama, monkeypatch):
    """Replica 0 dies at its first busy iteration and its work moves;
    restarted over the same engine it rejoins and takes traffic; then a
    paused loop (a stuck step: no fresh beats) goes unhealthy, its work
    moves, and the resumed loop rejoins.  Ids never change."""

    def wait_healthy(router, name):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and \
                not router.members()[name]["healthy"]:
            time.sleep(0.01)
        return router.members()[name]["healthy"]

    decs = [port_llama.make_decoder(max_slots=2, max_seq=48)
            for _ in range(2)]
    faults.reset_fault_cache()
    monkeypatch.setenv("TM_FAULT_AT", "0:1:die_replica")
    router, reps = make_fleet(serving, decs, stall_timeout_s=60.0)
    try:
        ref = [r.tokens for r in fleet_run(router, n=4)]
        assert reps[0].dead and router.recorder.n_requeues >= 1
        monkeypatch.delenv("TM_FAULT_AT")
        faults.reset_fault_cache()
        reps[0].restart()
        assert wait_healthy(router, "r0") is True
        assert router.recorder.n_rejoins >= 1
        before = router.recorder.dispatched["r0"]
        assert [r.tokens for r in fleet_run(router, n=4)] == ref
        assert router.recorder.dispatched["r0"] > before

        router.stall_timeout_s = 0.3
        reps[0].pause()
        time.sleep(0.5)
        assert [r.tokens for r in fleet_run(router, n=4)] == ref
        assert router.members()["r0"]["healthy"] is False
        reps[0].resume()
        assert wait_healthy(router, "r0") is True
        assert router.recorder.n_rejoins >= 2
    finally:
        teardown(router, reps)
        faults.reset_fault_cache()


def test_disaggregated_fleet_gives_the_unified_ids(port_llama):
    kw = dict(paged=True, max_slots=2, max_seq=48, block_size=8,
              prefill_chunk=8)
    router, reps = make_fleet(serving, [port_llama.make_decoder(**kw)])
    try:
        unified = [r.tokens for r in fleet_run(router)]
    finally:
        teardown(router, reps)
    router, reps = make_fleet(
        serving, [port_llama.make_decoder(**kw) for _ in range(2)],
        roles={0: "prefill", 1: "decode"})
    try:
        rs = fleet_run(router)
        summ = router.fleet_summary()
    finally:
        teardown(router, reps)
    assert [r.tokens for r in rs] == unified
    assert summ["n_handoffs"] == len(PROMPTS)
    assert summ["dispatched"] == {"r0": 6, "r1": 6}
    assert all(r.ttft_s is not None for r in rs)


def test_kernel_launch_counts_survive_replica_threads():
    """Replica threads count their kernel launches at once: K4's (by
    route: bf16 on the tensor cores, fp32 in three TF32 passes, and by
    rows) and the RMS norm's counters lose no update under heavy thread
    switching."""
    import sys
    import threading

    import torch

    from theanompi_tpu_torch.ops import norm
    from theanompi_tpu_torch.serving import paged_attention as pa

    saved = (pa.paged_attend_cuda.launches, pa.paged_attend_cuda.tc_launches,
             pa.paged_attend_cuda.tf32x3_launches,
             dict(pa.paged_attend_cuda.launches_by_rows),
             norm.rms_norm_cuda.launches)
    pa.paged_attend_cuda.launches = pa.paged_attend_cuda.tc_launches = 0
    pa.paged_attend_cuda.tf32x3_launches = 0
    pa.paged_attend_cuda.launches_by_rows = {}
    norm.rms_norm_cuda.launches = 0
    n_threads, n = 12, 3000

    def work(i):
        dtype = torch.bfloat16 if i % 2 == 0 else torch.float32
        for _ in range(n):
            pa._count_launch(4 * (1 + i % 4), dtype)
            norm._count_launch()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert pa.paged_attend_cuda.launches == n_threads * n
        assert pa.paged_attend_cuda.tc_launches == n_threads * n // 2
        assert pa.paged_attend_cuda.tf32x3_launches == n_threads * n // 2
        assert pa.paged_attend_cuda.launches_by_rows == {
            r: 3 * n for r in (4, 8, 12, 16)}
        assert norm.rms_norm_cuda.launches == n_threads * n
    finally:
        sys.setswitchinterval(switch)
        (pa.paged_attend_cuda.launches, pa.paged_attend_cuda.tc_launches,
         pa.paged_attend_cuda.tf32x3_launches,
         pa.paged_attend_cuda.launches_by_rows,
         norm.rms_norm_cuda.launches) = saved
