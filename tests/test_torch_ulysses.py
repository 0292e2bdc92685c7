"""Ulysses attention in the port against the JAX package.

Two gloo processes on the CPU, started once for the module, are the two
ranks of a seq axis (``parallel.mesh.Layout`` with sp = 2).  Each takes
its half of the sequence of the same Q, K and V (numpy, seeded) and
runs ``ulysses_attention`` forward and backward: the head/sequence
all-to-alls (``HeadsToSeq``, ``SeqToHeads``, each the other's
backward) around ``flash_attention`` at the full sequence over half of
the heads (the plain versions of K1, K2 and K3 on the CPU), causal and
full, GQA ``kv_rep`` 1 and 2 with K/V compact on the wire.  The halves
are joined here and held against the JAX ``ulysses_attention_sharded``
(``kv_rep`` 1) or ``ulysses_attention`` under ``shard_map`` on two fake
CPU devices.  The divisibility error is checked without processes.

Tolerances (fp32; summation order only): outputs within 2e-5 and
gradients within 1e-4, absolute and relative, as the ring's.
"""

import os
import pickle
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses,
)
from theanompi_tpu.parallel.ulysses import ulysses_attention_sharded
from theanompi_tpu_torch.parallel.mesh import AxisGroup
from theanompi_tpu_torch.parallel.ulysses import ulysses_attention

ROOT = Path(__file__).resolve().parent.parent
B, H, T, D = 2, 4, 32, 16
SP = 2
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
CASES = [(causal, rep) for causal in (False, True) for rep in (1, 2)]


def inputs(rep, seed=3):
    rng = np.random.default_rng(seed + rep)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, H // rep, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H // rep, T, D)).astype(np.float32)
    w = np.sin(np.arange(B * H * T * D).reshape(B, H, T, D) / 555.0)
    return q, k, v, w.astype(np.float32)


CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel import ulysses as ul
from theanompi_tpu_torch.parallel.mesh import Layout, destroy_group, init_group

rank = int(sys.argv[1])
init_group(torch.device("cpu"), rank, 2, {init!r})
lay = Layout.build(1, 2)
cases = pickle.load(open({inp!r}, "rb"))
out = {{}}
t_loc = {t} // 2
for key, (q, k, v, w) in cases.items():
    causal, rep = key
    part = lambda a: torch.from_numpy(
        a[:, :, rank * t_loc:(rank + 1) * t_loc].copy())
    tq, tk, tv = (part(a).requires_grad_() for a in (q, k, v))
    o = ul.ulysses_attention(tq, tk, tv, lay.seq, causal=causal,
                             kv_rep=rep)
    (o * part(w)).sum().backward()
    out[key] = dict(o=o.detach().numpy(), dq=tq.grad.numpy(),
                    dk=tk.grad.numpy(), dv=tv.grad.numpy())
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def port_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("ulysses")
    pickle.dump({c: inputs(c[1]) for c in CASES}, open(d / "in.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), init=f"tcp://127.0.0.1:{free_port()}",
                       inp=str(d / "in.pkl"), out=str(d / "out"), t=T)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(SP)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
    ranks = [pickle.load(open(f"{d / 'out'}{r}", "rb")) for r in range(SP)]
    return {c: {n: np.concatenate([ranks[r][c][n] for r in range(SP)],
                                  axis=2)
                for n in ("o", "dq", "dk", "dv")} for c in CASES}


def jax_ref(q, k, v, w, causal, rep):
    mesh = make_mesh(data=1, seq=SP, devices=jax.devices("cpu")[:SP])
    spec = P(None, None, "seq", None)
    if rep == 1:
        def fwd(q, k, v):
            return ulysses_attention_sharded(q, k, v, mesh, causal=causal)
    else:
        fwd = jax.jit(jax.shard_map(
            partial(jax_ulysses, axis_name="seq", causal=causal,
                    kv_rep=rep),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))

    def loss(q, k, v):
        return jnp.sum(fwd(q, k, v) * w)

    g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(a) for a in (fwd(q, k, v), *g)]


@pytest.mark.parametrize("causal,rep", CASES)
def test_ulysses_matches_jax(port_out, causal, rep):
    q, k, v, w = inputs(rep)
    want = jax_ref(q, k, v, w, causal, rep)
    got = port_out[(causal, rep)]
    np.testing.assert_allclose(got["o"], want[0], atol=FWD_TOL,
                               rtol=FWD_TOL, err_msg="o")
    for name, ref in zip(("dq", "dk", "dv"), want[1:]):
        np.testing.assert_allclose(got[name], ref, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("h,hkv,sp", [(4, 4, 8), (4, 2, 4), (6, 3, 2)])
def test_rejects_indivisible_heads(h, hkv, sp):
    """JAX's error (before any collective): the query and the kv heads
    must both divide by the seq axis."""
    group = AxisGroup(rank=0, size=sp, ranks=tuple(range(sp)),
                      device_group=None)
    q = torch.zeros(1, h, 4, 16)
    kv = torch.zeros(1, hkv, 4, 16)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, kv, kv, group, kv_rep=h // hkv)
