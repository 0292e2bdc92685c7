"""``exchange.gossip_push`` in the port against the JAX one.

Two gloo processes on the CPU, started once for the module, are the two
ranks of a group.  Each holds its replica (a two-leaf fp32 tree and a
score, numpy-seeded) and runs one GoSGD push round for every
(permutation, pushing mask) case: the swap and the identity, every
mask.  The merged trees and the new scores are held bitwise against the
JAX ``gossip_push`` under ``shard_map`` on two fake CPU devices (one
``ppermute`` there, one packed ``all_to_all_single`` here: the bytes
travel unchanged, and the merge is the same f32 arithmetic, the first
product fused into the add as XLA's CPU compiler contracts it), and
each round issues exactly one collective (one dtype).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.parallel.exchange import gossip_push

ROOT = Path(__file__).resolve().parent.parent
W = 2
PERMS = {"swap": [(0, 1), (1, 0)], "identity": [(0, 0), (1, 1)]}
MASKS = [(1, 1), (1, 0), (0, 1), (0, 0)]
CASES = [(p, m) for p in PERMS for m in MASKS]


def replicas(seed=0):
    rng = np.random.default_rng(seed)
    return ({"a": rng.standard_normal((W, 3, 4)).astype(np.float32),
             "b": rng.standard_normal((W, 5)).astype(np.float32)},
            rng.uniform(0.1, 1.0, W).astype(np.float32))


CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel import collectives, exchange
from theanompi_tpu_torch.parallel.mesh import AxisGroup, destroy_group, init_group
import torch.distributed as dist

rank = int(sys.argv[1])
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, 2, {init!r})
group = AxisGroup(rank, 2, (0, 1), dist.group.WORLD)
params, scores = pickle.load(open({inp!r}, "rb"))
out = {{}}
for key, perm, mask in {cases!r}:
    mine = {{k: torch.from_numpy(v[rank].copy()) for k, v in params.items()}}
    calls = collectives.ppermute.calls
    merged, total = exchange.gossip_push(
        mine, torch.tensor(scores[rank]), group=group, perm=perm,
        pushing=torch.tensor(mask))
    out[key] = ({{k: v.numpy() for k, v in merged.items()}},
                total.numpy(), collectives.ppermute.calls - calls)
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gossip_push")
    pickle.dump(replicas(), open(d / "in.pkl", "wb"))
    cases = [((p, m), PERMS[p], list(m)) for p, m in CASES]
    src = CHILD.format(root=str(ROOT), init=f"tcp://127.0.0.1:{free_port()}",
                       inp=str(d / "in.pkl"), out=str(d / "out"),
                       cases=cases)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(W)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-3000:]
    return [pickle.load(open(f"{d / 'out'}{r}", "rb")) for r in range(W)]


def jax_push(perm, mask):
    params, scores = replicas()
    mesh = make_mesh(data=W, devices=jax.devices("cpu")[:W])

    def body(p, s):
        merged, total = gossip_push(
            jax.tree.map(lambda a: a[0], p), s[0], axis_name="data",
            perm=perm, pushing=jnp.asarray(mask, jnp.float32))
        return jax.tree.map(lambda a: a[None], merged), total[None]

    spec = {"a": P("data"), "b": P("data")}
    merged, total = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, P("data")),
        out_specs=(spec, P("data"))))(params, scores)
    return {k: np.asarray(v) for k, v in merged.items()}, np.asarray(total)


@pytest.mark.parametrize("perm,mask", CASES)
def test_gossip_push_bitwise_jax(ranks, perm, mask):
    merged, total = jax_push(PERMS[perm], mask)
    for r in range(W):
        got, score, calls = ranks[r][(perm, mask)]
        assert calls == 1
        assert np.array_equal(score, total[r])
        for k in merged:
            assert np.array_equal(got[k], merged[k][r]), (k, r)
    if mask == (0, 0):
        # nobody pushes: each replica keeps its score and, up to the
        # merge's one rounding (s·w / s), its parameters
        params, scores = replicas()
        for r in range(W):
            got, score, _ = ranks[r][(perm, mask)]
            assert score == scores[r]
            for k in got:
                np.testing.assert_allclose(got[k], params[k][r], rtol=1e-6)
