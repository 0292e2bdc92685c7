"""The fleet's TCP wire across the packages, on the CPU at fp32 (the same
weights through ``params_from_jax``).

- A port ``ReplicaServer`` serves a JAX ``TCPReplicaClient`` under a JAX
  ``Router``, and a JAX ``ReplicaServer`` serves a port client under a
  port ``Router``: the ids equal the JAX engine's, and each side reads
  the other's frames (results, pings with role and slots, recorder
  states, span flight records, metrics text).
- A KV handoff record crosses the wire between the packages: a port
  prefill replica over TCP hands off to a JAX decode replica, and the
  ids equal the unified run's.
- A dead connection resolves every outstanding future; ``send_frame``'s
  timeout bounds a wedged peer.
- ``python -m theanompi_tpu_torch.serving.replica --spec-json ...``
  started with ``TM_FAULT_AT=0:2:die_replica`` builds its decoder from
  the checkpoint, prints ``REPLICA_READY``, serves, and its drill fails
  over to an in-process member; a child killed with SIGKILL mid-stream
  fails over the same way.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest

from theanompi_tpu import serving as jax_serving
from theanompi_tpu.utils.recorder import ServingRecorder as JaxRecorder
from theanompi_tpu_torch import serving
from theanompi_tpu_torch.models import Llama, params_from_jax
from theanompi_tpu_torch.models.llama import params_to_jax
from theanompi_tpu_torch.parallel.center_server import recv_frame, send_frame
from theanompi_tpu_torch.utils.checkpoint import save_checkpoint
from theanompi_tpu_torch.utils.recorder import ServingRecorder

from test_torch_decoder import SMALL, jax_model

pytestmark = pytest.mark.serving

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [[1 + i, 5, 9, 3 + i, 17, 2 * i + 1] for i in range(6)]
KW = dict(paged=True, max_slots=2, max_seq=48, block_size=8,
          prefill_chunk=8)
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def jm(devices8):
    return jax_model(devices8)


@pytest.fixture(scope="module")
def port_llama(jm):
    return Llama(SMALL, device="cpu",
                 params=params_from_jax(jax.device_get(jm.params), SMALL,
                                        "cpu"))


@pytest.fixture(scope="module")
def ref_ids(jm):
    """The JAX engine's ids, one engine, no fleet."""
    eng = jax_serving.Engine(jm.make_decoder(**KW))
    futs = [eng.submit(p, max_tokens=MAX_TOKENS, seed=i)
            for i, p in enumerate(PROMPTS)]
    eng.run_until_idle()
    return [f.result(timeout=0).tokens for f in futs]


def run(router, n=len(PROMPTS)):
    futs = [router.submit(PROMPTS[i], max_tokens=MAX_TOKENS, seed=i)
            for i in range(n)]
    return [f.result(timeout=120.0) for f in futs]


def router_of(pkg, replicas, **kw):
    kw.setdefault("policy", "round_robin")
    return pkg.Router(replicas, health_interval_s=0.005,
                      startup_grace_s=60.0, **kw).start()


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_servers_and_clients_cross_the_packages(jm, port_llama, ref_ids,
                                                server_side):
    """``server_side`` hosts the TCP replica; the other package's client
    and router drive it, beside an in-process member of the router's
    own package, tracing every request."""
    srv_pkg, cli_pkg = ((serving, jax_serving) if server_side == "port"
                        else (jax_serving, serving))
    srv_model, cli_model = ((port_llama, jm) if server_side == "port"
                            else (jm, port_llama))
    srv = srv_pkg.ReplicaServer(
        srv_pkg.Engine(srv_model.make_decoder(**KW), trace_sample=1),
        name="tcp0", index=0).start()
    client = cli_pkg.TCPReplicaClient(srv.address, name="tcp0",
                                      ping_interval_s=0.01)
    local = cli_pkg.InProcessReplica(
        cli_pkg.Engine(cli_model.make_decoder(**KW)), name="local1",
        index=1).start()
    router = router_of(cli_pkg, [client, local], trace_sample=1)
    try:
        rs = run(router)
        assert [r.tokens for r in rs] == ref_ids
        assert all(r.status == "ok" for r in rs)
        assert router.recorder.dispatched["tcp0"] == 3
        # pings carried the server's role and slots
        assert client.role == "unified" and client.slots() == 2
        # the server's recorder state loads in the client's package
        state = client.recorder_state()
        rec = (JaxRecorder if cli_pkg is jax_serving else ServingRecorder)()
        rec.load_state_dict(state)
        assert rec.summary()["n_completed"] == 3
        assert "serving_requests_total" in client.metrics_txt()
        # span flight records rode the results: every request's tree
        # holds the remote engine's spans under the router's root
        names = {s["name"] for s in router.collect_spans()}
        assert {"request", "dispatch", "engine_queue"} <= names
        remote = [s for s in client.trace_state()]
        assert remote and all(s["process"] == "engine" for s in remote)
    finally:
        router.stop(drain_s=5.0)
        client.close()
        local.stop()
        srv.stop()


def test_handoff_records_cross_the_wire_between_packages(port_llama, jm,
                                                         ref_ids):
    """A port prefill replica behind TCP, a JAX decode replica in
    process, a JAX router: every request is prefilled by the port,
    handed off over the frames and decoded by JAX."""
    srv = serving.ReplicaServer(serving.Engine(port_llama.make_decoder(**KW)),
                                name="pre", role="prefill").start()
    client = jax_serving.TCPReplicaClient(srv.address, name="pre",
                                          ping_interval_s=0.01,
                                          role="prefill")
    dec = jax_serving.InProcessReplica(
        jax_serving.Engine(jm.make_decoder(**KW)), name="dec", index=1,
        role="decode").start()
    router = router_of(jax_serving, [client, dec])
    try:
        rs = run(router)
        assert [r.tokens for r in rs] == ref_ids
        summ = router.fleet_summary()
        assert summ["n_handoffs"] == len(PROMPTS)
        assert summ["dispatched"] == {"pre": 6, "dec": 6}
    finally:
        router.stop(drain_s=5.0)
        client.close()
        dec.stop()
        srv.stop()


def test_dead_connection_resolves_every_outstanding_future():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    try:
        client = serving.TCPReplicaClient(lsock.getsockname(), name="mute",
                                          ping_interval_s=30.0)
        conn, _ = lsock.accept()
        futs = [client.submit(serving.Request(prompt=[1, 2, i]))
                for i in range(3)]
        assert not any(f.done() for f in futs)
        conn.close()                        # the peer dies mid-request
        for f in futs:
            res = f.result(timeout=10.0)
            assert (res.status, res.finish_reason) == ("shed",
                                                       "replica_dead")
        assert client.dead and not client._futures
        late = client.submit(serving.Request(prompt=[4])).result(timeout=0)
        assert late.finish_reason == "replica_dead"
        client.close()
    finally:
        lsock.close()


def test_send_frame_timeout_bounds_a_wedged_peer():
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        t0 = time.monotonic()
        with pytest.raises(OSError):        # socket.timeout is an OSError
            send_frame(a, bytes(8 << 20), timeout_s=0.3)
        assert time.monotonic() - t0 < 5.0
        c, d = socket.socketpair()
        send_frame(c, ("reply", (3, {"x": [1, 2]})), timeout_s=1.0)
        assert recv_frame(d) == ("reply", (3, {"x": [1, 2]}))
        c.close()
        d.close()
    finally:
        a.close()
        b.close()


# -- replica child processes ----------------------------------------------------


def start_child(ckpt: Path, name: str, env_extra: dict):
    spec = dict(config=SMALL, checkpoint=str(ckpt), device="cpu",
                paged=True, decoder={k: v for k, v in KW.items()
                                     if k != "paged"},
                name=name, index=0)
    env = dict(os.environ, **env_extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.serving.replica",
         "--spec-json", json.dumps(spec)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("REPLICA_READY"):
            return proc, int(line.split()[1])
    proc.wait(timeout=30)
    raise AssertionError(f"child exited {proc.returncode}: {''.join(lines)}")


@pytest.fixture
def checkpoint(port_llama, tmp_path):
    save_checkpoint(tmp_path, 0, {"params": params_to_jax(port_llama.params)})
    return tmp_path


@pytest.mark.parametrize("death", ["die_replica", "sigkill"])
def test_replica_child_builds_serves_and_fails_over(port_llama, ref_ids,
                                                    checkpoint, death):
    env = ({"TM_FAULT_AT": "0:2:die_replica"} if death == "die_replica"
           else {})
    proc, port = start_child(checkpoint, "child0", env)
    client = serving.TCPReplicaClient(("127.0.0.1", port), name="child0",
                                      ping_interval_s=0.01)
    local = serving.InProcessReplica(
        serving.Engine(port_llama.make_decoder(**KW)), name="local1",
        index=1).start()
    router = router_of(serving, [client, local])
    # long enough that the kill lands mid-stream; greedy ids extend the
    # MAX_TOKENS run's
    n_tok = MAX_TOKENS if death == "die_replica" else 30
    try:
        futs = [router.submit(p, max_tokens=n_tok, seed=i)
                for i, p in enumerate(PROMPTS)]
        if death == "sigkill":
            deadline = time.monotonic() + 60.0
            while client.heartbeat()["progress"] < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.002)
            os.kill(proc.pid, signal.SIGKILL)
        rs = [f.result(timeout=120.0) for f in futs]
        assert [r.tokens[:MAX_TOKENS] for r in rs] == ref_ids
        assert all(len(r.tokens) == n_tok for r in rs)
        summ = router.fleet_summary()
        assert summ["n_completed"] == len(PROMPTS)
        assert summ["n_failovers"] == 1 and summ["n_requeues"] >= 1
        assert summ["members"]["child0"]["healthy"] is False
        assert not client.alive()
    finally:
        router.stop(drain_s=5.0)
        client.shutdown()
        client.close()
        local.stop()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
