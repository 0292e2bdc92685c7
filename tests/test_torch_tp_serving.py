"""Tensor-parallel serving (tp = 2) in the port against the JAX tp = 2
engine and the port's own tp = 1.

Two gloo processes on the CPU, started once for the module, are ranks
0 and 1 of one ``ModelGroup``: each loads its shards of the JAX
model's parameters (``params_from_jax(rank, tp=2)``), rank 0 drives
``Engine`` and rank 1 follows its decoder calls.  They serve, in turn:
the v1 and paged decoders (greedy), speculative decoding
(``speculate_k=4``), sampled requests (temperature 0.8, per-request
seeds), a tp = 1 JAX checkpoint loaded at tp = 2, handoffs exported by
a tp = 1 port engine and decoded at tp = 2, and ``sharded_argmax`` on
crafted ties.  This process computes the references: the JAX tp = 2
engine on two fake CPU devices and the port's tp = 1 engine.  A tp = 2
``ReplicaServer`` child (rank 0 starting rank 1 itself) serves over
TCP at the end.

fp32 throughout.  Greedy and sampled ids are held equal, no tolerance:
the row-parallel sums round apart from tp = 1's at the ulp level,
which moves no argmax of these models (the JAX tp = 1 and tp = 2
engines agree the same way, ``tests/test_serving.py``).  The sampled
ids are the port's own (torch generators, not ``jax.random``): tp = 2
equals tp = 1 bitwise because the Gumbel noise is drawn for the full
vocab and sliced."""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.serving import Engine as JaxEngine
from theanompi_tpu_torch import serving
from theanompi_tpu_torch.models import Llama, params_from_jax
from theanompi_tpu_torch.models.llama import SHARD_AXIS
from theanompi_tpu_torch.parallel.mesh import init_group
from theanompi_tpu_torch.serving import Engine, Request

pytestmark = pytest.mark.serving

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
             vocab=64, seq_len=64, batch_size=4, lr=1e-2, n_train=64,
             n_val=32, compute_dtype="float32", remat=False)
V1_KW = dict(max_slots=4, max_seq=48)
PAGED_KW = dict(max_slots=4, max_seq=48, block_size=4, prefill_chunk=8)
REQUESTS = [([1 + i, 5, 9, 3 + i, 17] * (1 + i % 3), 5 + i) for i in range(6)]
TEMP = 0.8


def serve(engine_cls, dec, *, temperature=0.0, handoffs=None, **ekw):
    """Ids of every request in REQUESTS through one engine."""
    eng = engine_cls(dec, **ekw)
    futs = [eng.submit(Request(prompt=list(p), max_tokens=n, seed=10 + i,
                               temperature=temperature,
                               handoff=handoffs[i] if handoffs else None))
            if engine_cls is Engine else
            eng.submit(p, max_tokens=n, seed=10 + i, temperature=temperature)
            for i, (p, n) in enumerate(REQUESTS)]
    eng.run_until_idle()
    rs = [f.result(timeout=0) for f in futs]
    assert all(r.status == "ok" for r in rs), [r.status for r in rs]
    return [list(r.tokens) for r in rs]


CHILD = """
import json, pickle, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from test_torch_tp_serving import PAGED_KW, SMALL, TEMP, V1_KW, serve
from theanompi_tpu_torch.models import Llama, params_from_jax
from theanompi_tpu_torch.parallel import tp as tp_lib
from theanompi_tpu_torch.parallel.mesh import ModelGroup, destroy_group
from theanompi_tpu_torch.serving import Engine, decoder_from_checkpoint

rank = int(sys.argv[1])
cfg = dict(SMALL, tp=2)
group = ModelGroup.join("cpu", rank, 2, {init!r})
tree = pickle.load(open({tree!r}, "rb"))
model = Llama(cfg, "cpu", group=group,
              params=params_from_jax(tree, cfg, "cpu", rank=rank, tp=2))
out = {{}}


def run(name, dec, **kw):
    if rank:
        dec.follow()
        return
    out[name] = serve(Engine, dec, **kw)
    dec.close()


run("v1", model.make_decoder(**V1_KW))
run("paged", model.make_decoder(paged=True, **PAGED_KW))
run("spec", model.make_decoder(paged=True, **PAGED_KW), speculate_k=4,
    prefix_caching=False)
run("sampled", model.make_decoder(paged=True, **PAGED_KW),
    temperature=TEMP)
run("spec_sampled", model.make_decoder(paged=True, **PAGED_KW),
    temperature=TEMP, speculate_k=4, prefix_caching=False)
run("checkpoint", decoder_from_checkpoint(
    cfg, {ckpt!r}, device="cpu", paged=True, group=group, **PAGED_KW))
run("handoff", model.make_decoder(paged=True, **PAGED_KW),
    handoffs=pickle.load(open({handoffs!r}, "rb")))

# ties within a shard (40, 41: shard 1) and across the boundary (5, 37)
logits = np.zeros((3, 64), np.float32)
logits[0, [5, 37]] = 3.0
logits[1, [40, 41]] = 2.0
logits[2, [31, 32]] = 1.0
local = torch.from_numpy(logits[:, rank * 32:(rank + 1) * 32].copy())
ids = tp_lib.sharded_argmax(local, 64, group)
if rank == 0:
    out["ties"] = ids.tolist()
    json.dump(out, open({out!r}, "w"))
destroy_group()
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_tree(devices8):
    jm = JaxLlama(dict(SMALL))
    jm.build_model(n_replicas=1)
    jm.compile_iter_fns(mesh=make_mesh(data=1, model=1,
                                       devices=devices8[:1]))
    return jm, jax.device_get(jm.params)


@pytest.fixture(scope="module")
def port_tp1(jax_tree):
    _, tree = jax_tree
    return Llama(SMALL, device="cpu",
                 params=params_from_jax(tree, SMALL, "cpu"))


@pytest.fixture(scope="module")
def tp2(jax_tree, port_tp1, tmp_path_factory):
    """Every tp = 2 scenario, run once on two gloo ranks."""
    jm, tree = jax_tree
    tmp = tmp_path_factory.mktemp("tp2")
    jm.save(str(tmp / "ckpt"))
    pickle.dump(tree, open(tmp / "tree.pkl", "wb"))
    pre = Engine(port_tp1.make_decoder(paged=True, **PAGED_KW))
    futs = [pre.submit(Request(prompt=list(p), max_tokens=n,
                               prefill_only=True))
            for p, n in REQUESTS]
    pre.run_until_idle()
    handoffs = [f.result(timeout=0).handoff for f in futs]
    pickle.dump(handoffs, open(tmp / "handoffs.pkl", "wb"))
    script = tmp / "child.py"
    script.write_text(CHILD.format(
        root=str(Path(__file__).resolve().parent),
        init=f"tcp://localhost:{free_port()}", tree=str(tmp / "tree.pkl"),
        ckpt=str(tmp / "ckpt"), handoffs=str(tmp / "handoffs.pkl"),
        out=str(tmp / "out.json")))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture(scope="module")
def jax_tp2(devices8, jax_tree):
    """The JAX tp = 2 model on two fake CPU devices: the same init as
    tp = 1 (the full tree, device_put over the model axis)."""
    _, tree = jax_tree
    jm = JaxLlama(dict(SMALL, tp=2))
    jm.build_model(n_replicas=1)
    jm.compile_iter_fns(mesh=make_mesh(data=1, model=2,
                                       devices=devices8[:2]))
    for a, b in zip(jax.tree.leaves(jax.device_get(jm.params)),
                    jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    return jm


@pytest.mark.parametrize("paged", [False, True], ids=["v1", "paged"])
def test_greedy_ids_equal_jax_tp2_and_port_tp1(tp2, jax_tp2, port_tp1,
                                               paged):
    kw = PAGED_KW if paged else V1_KW
    want_jax = serve(JaxEngine, jax_tp2.make_decoder(paged=paged, **kw))
    want_tp1 = serve(Engine, port_tp1.make_decoder(paged=paged, **kw))
    got = tp2["paged" if paged else "v1"]
    assert got == want_jax == want_tp1
    assert [len(t) for t in got] == [n for _, n in REQUESTS]


def test_speculative_ids_equal_jax_tp2_and_one_token_decode(tp2, jax_tp2,
                                                            port_tp1):
    want_jax = serve(JaxEngine, jax_tp2.make_decoder(paged=True,
                                                     **PAGED_KW),
                     speculate_k=4, prefix_caching=False)
    one_token = serve(Engine, port_tp1.make_decoder(paged=True, **PAGED_KW))
    assert tp2["spec"] == want_jax == one_token


def test_sampled_ids_at_tp2_are_bitwise_tp1(tp2, port_tp1):
    dec = port_tp1.make_decoder(paged=True, **PAGED_KW)
    want = serve(Engine, dec, temperature=TEMP)
    assert tp2["sampled"] == want
    assert tp2["spec_sampled"] == want
    assert want != serve(Engine, dec)         # it really sampled


def test_sharded_argmax_ties_go_to_the_lowest_global_id(tp2):
    assert tp2["ties"] == [5, 40, 31]


def test_tp1_checkpoint_served_at_tp2(tp2, port_tp1):
    assert tp2["checkpoint"] == serve(
        Engine, port_tp1.make_decoder(paged=True, **PAGED_KW))


def test_tp1_handoff_decoded_at_tp2(tp2, port_tp1):
    """Prefill at tp = 1, decode at tp = 2: the record's global kv heads
    split over the receiving ranks, and the ids are the unified tp = 1
    run's."""
    assert tp2["handoff"] == serve(
        Engine, port_tp1.make_decoder(paged=True, **PAGED_KW))


def test_params_from_jax_slices_by_the_jax_param_specs(jax_tree):
    _, tree = jax_tree
    cfg = dict(SMALL, tp=2)
    shards = [params_from_jax(tree, cfg, "cpu", rank=r, tp=2)
              for r in range(2)]
    for name, ax in SHARD_AXIS.items():
        for li in range(SMALL["n_layers"]):
            full = (tree["layers"][li][name] if name not in
                    ("embed", "lm_head", "final_norm") else tree[name])
            parts = [(s["layers"][li][name] if name not in
                      ("embed", "lm_head", "final_norm") else s[name])
                     .numpy() for s in shards]
            if ax is None:
                for p in parts:
                    np.testing.assert_array_equal(p, full)
            else:
                assert parts[0].shape[ax] == full.shape[ax] // 2
                np.testing.assert_array_equal(
                    np.concatenate(parts, axis=ax), full)
    # rank 1 holds query heads 2-3 and kv head 1 (GQA's grouping)
    hd = SMALL["dim"] // SMALL["n_heads"]
    np.testing.assert_array_equal(shards[1]["layers"][0]["wq"].numpy(),
                                  tree["layers"][0]["wq"][:, 2 * hd:])
    np.testing.assert_array_equal(shards[1]["layers"][0]["wk"].numpy(),
                                  tree["layers"][0]["wk"][:, hd:])
    with pytest.raises(ValueError, match="rank"):
        params_from_jax(tree, cfg, "cpu", rank=2, tp=2)


def test_random_weights_are_the_same_at_any_tp():
    """A tp = 2 rank's random parameters are its slices of the tp = 1
    draw, so a seed names one model whatever the layout."""
    from theanompi_tpu_torch.parallel.mesh import ModelGroup

    full = Llama(SMALL, device="cpu").params
    g = ModelGroup(rank=1, size=2, device_group=None, cpu_group=None)
    part = Llama(dict(SMALL, tp=2), device="cpu", group=g).params
    torch.testing.assert_close(part["layers"][1]["wv"],
                               full["layers"][1]["wv"][:, 8:],
                               rtol=0, atol=0)
    torch.testing.assert_close(part["embed"], full["embed"][32:],
                               rtol=0, atol=0)


def test_nccl_wants_a_card_and_a_known_backend():
    with pytest.raises(ValueError, match="CUDA"):
        init_group(torch.device("cpu"), backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        init_group(torch.device("cpu"), backend="mpi")


def start_tp2_replica(jm, tmp_path):
    """A tp = 2 replica child on two CPU ranks; (process, port)."""
    jm.save(str(tmp_path))
    spec = dict(config=dict(SMALL, tp=2), checkpoint=str(tmp_path),
                devices=["cpu", "cpu"], paged=True, decoder=PAGED_KW,
                name="tp2")
    env = dict(os.environ, OMP_NUM_THREADS="1")
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


def test_tp2_replica_server_round_trip(jax_tree, port_tp1, tmp_path):
    """``python -m theanompi_tpu_torch.serving.replica`` at tp = 2 on two
    CPU ranks: rank 0 starts rank 1 itself, serves TCP, and its ids are
    the tp = 1 engine's; shutdown releases and ends the follower."""
    proc, port = start_tp2_replica(jax_tree[0], tmp_path)
    client = serving.TCPReplicaClient(("127.0.0.1", port), name="tp2",
                                      ping_interval_s=0.01)
    try:
        futs = [client.submit(Request(prompt=list(p), max_tokens=n,
                                      seed=10 + i))
                for i, (p, n) in enumerate(REQUESTS[:4])]
        got = [list(f.result(timeout=60).tokens) for f in futs]
    finally:
        client.shutdown()
        client.close()
    assert proc.wait(timeout=60) == 0
    want = serve(Engine, port_tp1.make_decoder(paged=True, **PAGED_KW))
    assert got == want[:4]


def test_tp2_replica_follower_ends_with_a_killed_replica(jax_tree,
                                                        tmp_path):
    """SIGKILL rank 0 of a tp = 2 replica: its follower rank, blocked on
    the next header, notices its parent is gone and exits."""
    import signal
    import time

    proc, _ = start_tp2_replica(jax_tree[0], tmp_path)
    out = subprocess.run(["pgrep", "-P", str(proc.pid)],
                         capture_output=True, text=True)
    (follower,) = [int(p) for p in out.stdout.split()]
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=30)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            os.kill(follower, 0)
        except ProcessLookupError:
            return
        time.sleep(0.1)
    os.kill(follower, signal.SIGKILL)
    raise AssertionError("the follower outlived its replica")


def test_tp2_replica_ends_when_its_follower_dies(jax_tree, tmp_path):
    """SIGKILL the follower rank of a tp = 2 replica: rank 0, which
    would block in its next collective, notices and exits non-zero."""
    import signal

    proc, _ = start_tp2_replica(jax_tree[0], tmp_path)
    out = subprocess.run(["pgrep", "-P", str(proc.pid)],
                         capture_output=True, text=True)
    (follower,) = [int(p) for p in out.stdout.split()]
    os.kill(follower, signal.SIGKILL)
    try:
        assert proc.wait(timeout=30) == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
