"""Ring attention and its blockwise merge in the port against the JAX
package.

Two gloo processes on the CPU, started once for the module, are the two
ranks of a seq axis (``parallel.mesh.Layout`` with sp = 2).  Each takes
its half of the sequence of the same Q, K and V (numpy, seeded) and
runs ``ring_attention`` forward and backward, on the flash route (the
plain versions of K1, K2 and K3 on the CPU, per hop, the dK/dV
accumulators riding the ring) and on the dense route (``block_attn_*``
under autograd), causal and full, GQA ``kv_rep`` 1 and 2.  The halves
are put back together here and held against the JAX
``ring_attention_sharded`` (the dense ring, ``kv_rep`` 1) or
``ring_attention`` under ``shard_map`` on two fake CPU devices, and
against the JAX flash ring ``_ring_flash`` with the Pallas kernels in
interpret mode.  ``block_attn_*`` is held against JAX in this process.

Tolerances (fp32; the packages sum in other orders): outputs within
2e-5 and gradients within 1e-4, absolute and relative, the JAX ring
tests' own forward tolerance and a third of their 3e-4 gradient one.
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
from jax.sharding import PartitionSpec as P

from theanompi_tpu.ops import attention as jax_attn
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.parallel.ring_attention import (
    _ring_flash,
    ring_attention,
    ring_attention_sharded,
)
from theanompi_tpu_torch.ops import attention as port_attn

ROOT = Path(__file__).resolve().parent.parent
B, H, T, D = 2, 4, 64, 16
SP = 2
FWD_TOL = 2e-5
GRAD_TOL = 1e-4
CASES = [(impl, causal, rep) for impl in ("flash", "dense")
         for causal in (False, True) for rep in (1, 2)]


def inputs(rep, seed=0):
    rng = np.random.default_rng(seed + rep)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, H // rep, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H // rep, T, D)).astype(np.float32)
    # the cotangent: a fixed weighting of the output
    w = np.cos(np.arange(B * H * T * D).reshape(B, H, T, D) / 777.0)
    return q, k, v, w.astype(np.float32)


CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel import collectives
from theanompi_tpu_torch.parallel import ring_attention as ra
from theanompi_tpu_torch.parallel.mesh import Layout, destroy_group, init_group

rank = int(sys.argv[1])
init_group(torch.device("cpu"), rank, 2, {init!r})
lay = Layout.build(1, 2)
cases = pickle.load(open({inp!r}, "rb"))
fwd_calls = [0]
plain_fwd = ra.flash_attention_fwd


def counted(*a, **kw):
    fwd_calls[0] += 1
    return plain_fwd(*a, **kw)


ra.flash_attention_fwd = counted
out = {{}}
t_loc = {t} // 2
for key, (q, k, v, w) in cases.items():
    impl, causal, rep = key
    part = lambda a: torch.from_numpy(
        a[:, :, rank * t_loc:(rank + 1) * t_loc].copy())
    tq, tk, tv = (part(a).requires_grad_() for a in (q, k, v))
    fwd_calls[0] = 0
    hops = collectives.ppermute.calls
    o = ra.ring_attention(tq, tk, tv, lay.seq, causal=causal, kv_rep=rep,
                          impl=impl)
    (o * part(w)).sum().backward()
    out[key] = dict(o=o.detach().numpy(), dq=tq.grad.numpy(),
                    dk=tk.grad.numpy(), dv=tv.grad.numpy(),
                    fwd_calls=fwd_calls[0],
                    hops=collectives.ppermute.calls - hops)
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
    """Every case through two gloo ranks, their halves joined on T."""
    d = tmp_path_factory.mktemp("ring")
    cases = {c: inputs(c[2]) for c in CASES}
    pickle.dump(cases, open(d / "in.pkl", "wb"))
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
    joined = {}
    for c in CASES:
        joined[c] = {n: np.concatenate([ranks[r][c][n] for r in range(SP)],
                                       axis=2)
                     for n in ("o", "dq", "dk", "dv")}
        joined[c]["per_rank"] = [
            {n: ranks[r][c][n] for n in ("fwd_calls", "hops")}
            for r in range(SP)]
    return joined


def seq_mesh():
    return make_mesh(data=1, seq=SP, devices=jax.devices("cpu")[:SP])


def jax_ring(q, k, v, w, causal, rep, impl):
    """(o, dq, dk, dv) of the JAX ring on a 2-device seq mesh: the dense
    route through ``ring_attention_sharded`` at kv_rep 1, else
    ``ring_attention`` under ``shard_map``; the flash route through
    ``_ring_flash`` with the Pallas kernels in interpret mode."""
    mesh = seq_mesh()
    spec = P(None, None, "seq", None)
    if impl == "dense" and rep == 1:
        def fwd(q, k, v):
            return ring_attention_sharded(q, k, v, mesh, causal=causal)
    else:
        if impl == "dense":
            fn = partial(ring_attention, axis_name="seq", causal=causal,
                         kv_rep=rep)
        else:
            def fn(q, k, v):
                return _ring_flash(q, k, v, "seq", causal, D ** -0.5, rep,
                                   T // SP, True)
        fwd = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                    out_specs=spec, check_vma=False))

    def loss(q, k, v):
        return jnp.sum(fwd(q, k, v) * w)

    o = fwd(q, k, v)
    g = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(a) for a in (o, *g)]


def assert_close(got, want, tol, name):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("impl,causal,rep", CASES)
def test_ring_matches_jax_ring(port_out, impl, causal, rep):
    """Forward and gradients of each route against the same route of
    the JAX package (dense: ``ring_attention_sharded``/``ring_attention``;
    flash: ``_ring_flash`` in interpret mode)."""
    q, k, v, w = inputs(rep)
    want = jax_ring(q, k, v, w, causal, rep, impl)
    got = port_out[(impl, causal, rep)]
    assert_close(got["o"], want[0], FWD_TOL, "o")
    for name, ref in zip(("dq", "dk", "dv"), want[1:]):
        assert_close(got[name], ref, GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rep", [1, 2])
def test_flash_route_matches_dense_reference(port_out, causal, rep):
    """The port's flash ring against plain single-device attention (the
    JAX ``mha_reference`` on the repeated K/V): the merge of the hops'
    (o, lse) pairs and the ring-accumulated dK/dV are exact math."""
    q, k, v, w = inputs(rep)

    def loss(q, k, v):
        o = jax_attn.mha_reference(q, jnp.repeat(k, rep, axis=1),
                                   jnp.repeat(v, rep, axis=1),
                                   causal=causal)
        return jnp.sum(o * w), o

    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                   has_aux=True)(q, k, v)
    got = port_out[("flash", causal, rep)]
    assert_close(got["o"], np.asarray(o), FWD_TOL, "o")
    for name, ref in zip(("dq", "dk", "dv"), g):
        assert_close(got[name], np.asarray(ref), GRAD_TOL, name)


@pytest.mark.parametrize("causal", [False, True])
def test_invisible_hops_skip_the_kernels_not_the_hop(port_out, causal):
    """Causal: rank r folds r + 1 visible blocks (one kernel-forward
    call each) but both ranks make the same hops (forward: sp - 1;
    backward: K/V sp - 1, the dK/dV accumulators sp; one collective a
    hop for the tensors of one dtype, packed); full attention folds sp
    blocks on every rank."""
    for rep in (1, 2):
        per = port_out[("flash", causal, rep)]["per_rank"]
        for r, c in enumerate(per):
            assert c["fwd_calls"] == (r + 1 if causal else SP), (r, c)
            assert c["hops"] == (SP - 1) + SP, (r, c)


@pytest.mark.parametrize("causal", [False, True])
def test_block_attn_matches_jax(causal):
    """``block_attn_init``/``_update``/``_finish`` over four KV blocks
    against the JAX functions, and both against dense attention."""
    import torch

    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    blk, sm = 16, D ** -0.5
    jc = jax_attn.block_attn_init(B, H, T, D)
    tc = port_attn.block_attn_init(B, H, T, D)
    tq = torch.from_numpy(q)
    for i in range(0, T, blk):
        q_pos = np.arange(T) if causal else None
        k_pos = i + np.arange(blk) if causal else None
        jc = jax_attn.block_attn_update(
            jc, q, k[:, :, i:i + blk], v[:, :, i:i + blk],
            q_pos=None if q_pos is None else jnp.asarray(q_pos),
            k_pos=None if k_pos is None else jnp.asarray(k_pos),
            sm_scale=sm)
        tc = port_attn.block_attn_update(
            tc, tq, torch.from_numpy(k[:, :, i:i + blk]),
            torch.from_numpy(v[:, :, i:i + blk]),
            q_pos=None if q_pos is None else torch.from_numpy(q_pos),
            k_pos=None if k_pos is None else torch.from_numpy(k_pos),
            sm_scale=sm)
        for a, b in zip(tc, jc):
            assert_close(a.numpy(), np.asarray(b), FWD_TOL, "carry")
    got = port_attn.block_attn_finish(tc, torch.float32).numpy()
    assert_close(got, np.asarray(jax_attn.block_attn_finish(jc, jnp.float32)),
                 FWD_TOL, "finish")
    assert_close(got, np.asarray(jax_attn.mha_reference(q, k, v,
                                                        causal=causal)),
                 FWD_TOL, "dense")
