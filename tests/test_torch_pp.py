"""GPipe in the port (``parallel/pp.py``) against the JAX package.

Two gloo processes on the CPU, started once for the module, are the two
stages of a pipe axis (``parallel.mesh.Layout`` with pp = 2).  Each
holds its stage's parameters of a two-stage tanh-MLP stack (numpy,
seeded) and runs ``pipeline_apply`` over a two-leaf payload — the
activation and a side value each stage adds to, as the MoE moments ride
the Llama pipeline — at M = 2 and M = 4 microbatches, then a loss of
the last stage's outputs through ``last_stage_value`` and its backward.
The outputs, the loss, each stage's parameter gradients and the input's
gradient (summed over the stages: JAX's implicit ``pvary`` of the
replicated input transposes to that sum) are held against the JAX
``pipeline_apply`` under ``shard_map`` on two fake CPU devices, and both
stages must issue the same number of hops, forward and backward.
``last_stage_value`` and ``pipe_mean`` alone, and the microbatch split
and merge, are held against JAX too.

Tolerances (fp32; the packages sum in other orders): outputs and loss
within 1e-5, gradients within 1e-4, absolute and relative.
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
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.parallel import pp as jax_pp
from theanompi_tpu_torch.parallel import pp as port_pp

ROOT = Path(__file__).resolve().parent.parent
S, B, D = 2, 8, 8
MS = (2, 4)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(w=(0.5 * rng.standard_normal((S, D, D))).astype(np.float32),
                b=(0.1 * rng.standard_normal((S, D))).astype(np.float32),
                x=rng.standard_normal((B, D)).astype(np.float32),
                tgt=rng.standard_normal((B, D)).astype(np.float32))


def stage_math(w, b, payload, lib):
    """One stage: a residual tanh layer on ``x``, and ``s`` adds the
    new activation's mean square (the side value down the pipe)."""
    x = payload["x"]
    y = x + lib.tanh(x @ w + b)
    return {"x": y, "s": payload["s"] + (y * y).mean(-1)}


def loss_math(ys, tgt):
    return ((ys["x"] - tgt) ** 2).mean() + 0.5 * ys["s"].mean()


CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from theanompi_tpu_torch.parallel import collectives, pp
from theanompi_tpu_torch.parallel.mesh import Layout, destroy_group, init_group
from test_torch_pp import loss_math, stage_math

rank = int(sys.argv[1])
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, 2, {init!r})
pipe = Layout.build(1, 1, 2, 1).pipe
inp = pickle.load(open({inp!r}, "rb"))
out = {{}}
for m in {ms!r}:
    w = torch.from_numpy(inp["w"][rank]).requires_grad_()
    b = torch.from_numpy(inp["b"][rank]).requires_grad_()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    xm = {{"x": pp.split_microbatches(x, m),
           "s": torch.zeros(m, {b} // m)}}
    fwd = collectives.ppermute.calls
    ys = pp.pipeline_apply(
        lambda p, pay: stage_math(p[0], p[1], pay, torch), (w, b), xm, pipe)
    fwd = collectives.ppermute.calls - fwd
    tgt = pp.split_microbatches(torch.from_numpy(inp["tgt"]), m)
    loss = pp.last_stage_value(loss_math(ys, tgt), pipe)
    bwd = collectives.ppermute.calls
    loss.backward()
    bwd = collectives.ppermute.calls - bwd
    out[m] = dict(ys={{k: v.detach().numpy() for k, v in ys.items()}},
                  loss=float(loss), dw=w.grad.numpy(), db=b.grad.numpy(),
                  dx=x.grad.numpy(), hops=(fwd, bwd))
v = torch.full((3,), float(rank + 1), requires_grad=True)
last = pp.last_stage_value(v * 2.0, pipe)
(last * torch.arange(3.0)).sum().backward()
out["last_stage_value"] = (last.detach().numpy(), v.grad.numpy())
v = torch.full((3,), float(rank + 1), requires_grad=True)
mean = pp.pipe_mean(v * 2.0, pipe)
(mean * torch.arange(3.0)).sum().backward()
out["pipe_mean"] = (mean.detach().numpy(), v.grad.numpy())
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
    d = tmp_path_factory.mktemp("pp")
    pickle.dump(inputs(), open(d / "in.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), tests=str(ROOT / "tests"),
                       init=f"tcp://127.0.0.1:{free_port()}",
                       inp=str(d / "in.pkl"), out=str(d / "out"), ms=MS,
                       b=B)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(S)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-3000:]
    return [pickle.load(open(f"{d / 'out'}{r}", "rb")) for r in range(S)]


def jax_pipeline(m):
    inp = inputs()
    mesh = make_mesh(data=1, pipe=S, devices=jax.devices("cpu")[:S])

    def body(w, b, x, tgt):
        def loss(w, b, x):
            xm = {"x": jax_pp.split_microbatches(x, m),
                  "s": jnp.zeros((m, B // m), jnp.float32)}
            ys = jax_pp.pipeline_apply(
                lambda p, pay: stage_math(p[0][0], p[1][0], pay, jnp),
                (w, b), xm)
            val = jax_pp.last_stage_value(
                loss_math(ys, jax_pp.split_microbatches(tgt, m)))
            return val, ys

        (val, ys), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(w, b, x)
        return val, ys, g

    val, ys, (dw, db, dx) = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("pipe"), P("pipe"), P(), P()),
        out_specs=(P(), P("pipe"), (P("pipe"), P("pipe"), P()))))(
        inp["w"], inp["b"], inp["x"], inp["tgt"])
    # ys: every stage's [M, ...] stacked on dim 0; the last is valid
    return dict(loss=float(val), dw=np.asarray(dw), db=np.asarray(db),
                dx=np.asarray(dx),
                ys={k: np.asarray(v)[-m:] for k, v in ys.items()})


def close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("m", MS)
def test_pipeline_matches_jax(ranks, m):
    """The last stage's outputs and the loss on every stage; each
    stage's gradients; the input's gradient summed over the stages."""
    want = jax_pipeline(m)
    last = ranks[S - 1][m]
    for k in ("x", "s"):
        close(last["ys"][k], want["ys"][k], FWD_TOL, f"ys[{k}]")
    for r in range(S):
        got = ranks[r][m]
        close(got["loss"], want["loss"], FWD_TOL, f"rank {r} loss")
        close(got["dw"], want["dw"][r], GRAD_TOL, f"rank {r} dw")
        close(got["db"], want["db"][r], GRAD_TOL, f"rank {r} db")
    close(sum(ranks[r][m]["dx"] for r in range(S)), want["dx"], GRAD_TOL,
          "dx")
    # only stage 0's input feeds the chain
    assert not ranks[1][m]["dx"].any()


@pytest.mark.parametrize("m", MS)
def test_stages_issue_the_same_hops(ranks, m):
    """M + S - 2 hops forward (none after the last tick) and as many
    backward, on both stages, one a dtype (the payload is all fp32)."""
    want = (m + S - 2, m + S - 2)
    assert [ranks[r][m]["hops"] for r in range(S)] == [want] * S


def test_last_stage_value_and_pipe_mean_match_jax(ranks):
    """The forward values and each stage's cotangent: the mask for
    ``last_stage_value`` (psum's transpose is the identity), 1/S for
    ``pipe_mean``."""
    mesh = make_mesh(data=1, pipe=S, devices=jax.devices("cpu")[:S])
    ct = np.arange(3.0, dtype=np.float32)

    def run(fn):
        def body(v):
            val, vjp = jax.vjp(lambda u: fn(u * 2.0), v)
            return val, vjp(jnp.asarray(ct))[0]

        v = np.repeat(np.arange(1.0, S + 1, dtype=np.float32), 3)
        val, g = jax.shard_map(body, mesh=mesh, in_specs=P("pipe"),
                               out_specs=(P(), P("pipe")))(v)
        return np.asarray(val), np.asarray(g).reshape(S, 3)

    for name, fn in (("last_stage_value", jax_pp.last_stage_value),
                     ("pipe_mean", lambda u: lax.pmean(u, "pipe"))):
        val, g = run(fn)
        for r in range(S):
            got_val, got_g = ranks[r][name]
            close(got_val, val, 0, f"{name} value")
            close(got_g, g[r], 0, f"{name} cotangent, stage {r}")


def test_split_merge_roundtrip_and_indivisible():
    x = np.arange(36, dtype=np.float32).reshape(12, 3)
    for m in (1, 2, 3, 4, 6, 12):
        got = port_pp.split_microbatches(torch.from_numpy(x), m)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_pp.split_microbatches(x, m)))
        np.testing.assert_array_equal(
            port_pp.merge_microbatches(got).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        port_pp.split_microbatches(torch.from_numpy(x), 5)
    with pytest.raises(ValueError, match="not divisible"):
        jax_pp.split_microbatches(x, 5)
