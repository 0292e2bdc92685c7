"""The MoE FFN in the port (``parallel/moe.py``) against the JAX package.

In this process, on one rank (no expert group): the JAX
``TestMoeFfnUnit`` cases — identical experts reproduce the dense SwiGLU
FFN, dropped picks are clean zeros, the router's gradient flows, the
public ``load_balance_loss`` equals ``moe_ffn``'s aux, the capacity
formula — each also held against the JAX ``moe_ffn`` on the same
numpy-seeded inputs (outputs, aux and the VJP); and the top-k tie order
against ``lax.top_k`` (equal router logits).

On two gloo processes, started once for the module (an expert axis of
two ranks, each the owner of two of the four experts and of its own
half of the tokens): the forward and VJP of ``moe_ffn`` against the JAX
``moe_ffn`` under ``shard_map`` on two fake CPU devices, with and
without drops, with the aux moments meaned over the expert axis (JAX's
``batch_axes``).  The JAX router is cast expert-varying first, as the
JAX train step casts its parameters: its per-device gradient is then
the port's per-rank one (the aux mean's backward passes its cotangent
through unchanged; the exchange means the ranks' gradients).

Tolerances (fp32; the packages multiply and sum in other orders):
outputs and aux within 1e-5, gradients within 1e-4, absolute and
relative.
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
from theanompi_tpu.parallel import moe as jax_moe
from theanompi_tpu_torch.parallel import moe as port_moe

ROOT = Path(__file__).resolve().parent.parent
E, K, D, F = 4, 2, 16, 32
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
AUX_COEF = (0.5, 0.25)     # lb and z weights of the VJP's loss


def mats(b=2, t=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, D)).astype(np.float32),
            (0.1 * rng.standard_normal((D, E))).astype(np.float32),
            (0.1 * rng.standard_normal((E, D, F))).astype(np.float32),
            (0.1 * rng.standard_normal((E, D, F))).astype(np.float32),
            (0.1 * rng.standard_normal((E, F, D))).astype(np.float32))


def cotangent(shape):
    n = int(np.prod(shape))
    return np.cos(np.arange(n).reshape(shape) / 37.0).astype(np.float32)


def port_vjp(x, r, wg, wu, wd, ct, cf, **groups):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in
          (x, r, wg, wu, wd)]
    y, aux = port_moe.moe_ffn(*ts, n_experts=E, top_k=K,
                              capacity_factor=cf, **groups)
    loss = ((y * torch.from_numpy(ct)).sum() + AUX_COEF[0] * aux["lb"]
            + AUX_COEF[1] * aux["z"])
    grads = torch.autograd.grad(loss, ts)
    return (y.detach().numpy(), {k: v.detach().numpy()
                                 for k, v in aux.items()},
            [g.numpy() for g in grads])


def jax_vjp(x, r, wg, wu, wd, ct, cf):
    def loss(*a):
        y, aux = jax_moe.moe_ffn(*a, n_experts=E, top_k=K,
                                 capacity_factor=cf, expert_axis=None,
                                 model_axis=None)
        return (jnp.sum(y * ct) + AUX_COEF[0] * aux["lb"]
                + AUX_COEF[1] * aux["z"]), (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True)(x, r, wg, wu, wd)
    return (np.asarray(y), {k: np.asarray(v) for k, v in aux.items()},
            [np.asarray(g) for g in grads])


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def assert_same(port, ref):
    (py, paux, pg), (jy, jaux, jg) = port, ref
    assert_close(py, jy, FWD_TOL, "y")
    for k in ("lb", "z", "f", "p"):
        assert_close(paux[k], jaux[k], FWD_TOL, k)
    for name, a, b in zip(("x", "router", "we_gate", "we_up", "we_down"),
                          pg, jg):
        assert_close(a, b, GRAD_TOL, f"d{name}")


class TestMoeFfnUnit:
    """The JAX unit cases, one rank, against JAX."""

    def test_identical_experts_match_dense_ffn(self):
        x, r, wg, wu, wd = mats()
        same = [np.broadcast_to(w[:1], w.shape).copy() for w in (wg, wu, wd)]
        ct = cotangent(x.shape)
        port = port_vjp(x, r, *same, ct, 2.0)
        assert_same(port, jax_vjp(x, r, *same, ct, 2.0))
        xt = torch.from_numpy(x)
        dense = (torch.nn.functional.silu(xt @ torch.from_numpy(same[0][0]))
                 * (xt @ torch.from_numpy(same[1][0]))) \
            @ torch.from_numpy(same[2][0])
        np.testing.assert_allclose(port[0], dense.numpy(), atol=1e-5)
        assert 0.9 < float(port[1]["lb"]) < 1.5

    def test_router_gradients_flow(self):
        x, r, wg, wu, wd = mats()
        ct = 2.0 * x          # the JAX case's sum(y*y) weights y by 2y
        port = port_vjp(x, r, wg, wu, wd, ct, 1.25)
        assert_same(port, jax_vjp(x, r, wg, wu, wd, ct, 1.25))
        g = port[2][1]
        assert np.linalg.norm(g) > 0 and np.isfinite(g).all()

    def test_tiny_capacity_drops_are_clean_zeros(self):
        """Over-capacity picks contribute nothing: a token with both
        picks dropped comes out exactly zero (the residual carries it).
        64 tokens: the capacity floor of 8 an expert leaves most
        dropped."""
        x, r, wg, wu, wd = mats(b=4, t=16)
        ct = cotangent(x.shape)
        port = port_vjp(x, r, wg, wu, wd, ct, 0.25)
        assert_same(port, jax_vjp(x, r, wg, wu, wd, ct, 0.25))
        y = port[0].reshape(-1, D)
        assert np.isfinite(y).all()
        n = y.shape[0]
        c = port_moe.moe_capacity(n, E, K, 0.25)
        _, eidx, _, _ = port_moe.router_topk(
            torch.from_numpy(x.reshape(-1, D)), torch.from_numpy(r), K)
        flat = eidx.t().reshape(-1).numpy()
        rank = np.array([np.sum(flat[:i] == flat[i]) for i in range(len(flat))])
        kept = (rank < c).reshape(K, n).any(axis=0)
        assert (~kept).any()
        assert not y[~kept].any()

    def test_load_balance_loss_matches_moe_ffn_aux(self):
        x, r, wg, wu, wd = mats()
        _, aux = port_moe.moe_ffn(
            *(torch.from_numpy(a) for a in (x, r, wg, wu, wd)),
            n_experts=E, top_k=K, capacity_factor=2.0)
        _, eidx, probs, _ = port_moe.router_topk(
            torch.from_numpy(x.reshape(-1, D)), torch.from_numpy(r), K)
        lb = port_moe.load_balance_loss(eidx, probs, E)
        np.testing.assert_allclose(float(lb), float(aux["lb"]), rtol=1e-6)
        _, jidx, jprobs, _ = jax_moe.router_topk(x.reshape(-1, D), r, K)
        np.testing.assert_allclose(
            float(lb), float(jax_moe.load_balance_loss(jidx, jprobs, E)),
            rtol=1e-6)

    def test_capacity_formula(self):
        assert port_moe.moe_capacity(128, 4, 2, 1.25) == 80
        assert port_moe.moe_capacity(128, 4, 2, 2.0) == 128
        assert port_moe.moe_capacity(128, 4, 2, 100.0) == 128
        assert port_moe.moe_capacity(16, 8, 1, 1.0) == 8
        for n in (1, 7, 16, 100, 8192):
            for e, k in ((4, 2), (8, 2), (8, 1)):
                for cf in (0.25, 1.0, 1.25, 4.0):
                    assert port_moe.moe_capacity(n, e, k, cf) \
                        == jax_moe.moe_capacity(n, e, k, cf)


@pytest.mark.parametrize("kind", ["all_equal", "pairs"])
def test_topk_ties_match_lax_top_k(kind):
    """Equal router logits: ``lax.top_k`` gives the lower expert id
    first, and so does the port's stable descending sort."""
    x, r, _, _, _ = mats()
    x2 = x.reshape(-1, D)
    if kind == "all_equal":
        r = np.zeros_like(r)             # every probability 1/E
    else:
        r = r.copy()
        r[:, 2] = r[:, 0]                # experts 0 and 2 tie everywhere
        r[:, 3] = r[:, 1]                # and 1 and 3
    gates, eidx, probs, logits = port_moe.router_topk(
        torch.from_numpy(x2), torch.from_numpy(r), K)
    jg, je, jp, jl = jax_moe.router_topk(x2, r, K)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(je))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), rtol=1e-6)
    if kind == "all_equal":
        assert (eidx.numpy() == np.arange(K)).all()


# -- ep = 2 on two gloo ranks ---------------------------------------------------

EP = 2
EP_CASES = {"no_drops": 2.0, "drops": 1.0}

CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel import moe
from theanompi_tpu_torch.parallel.mesh import Layout, destroy_group, init_group
sys.path.insert(0, {tests!r})
from test_torch_moe import port_vjp

rank = int(sys.argv[1])
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, 2, {init!r})
lay = Layout.build(1, 1, 1, 2)
out = {{}}
for name, (cf, args) in pickle.load(open({inp!r}, "rb")).items():
    x, r, wg, wu, wd, ct = args
    b, el = x.shape[0] // 2, wg.shape[0] // 2
    mine = lambda a, n: a[rank * n:(rank + 1) * n].copy()
    calls = moe._a2a.calls
    out[name] = port_vjp(mine(x, b), r, mine(wg, el), mine(wu, el),
                         mine(wd, el), mine(ct, b), cf,
                         expert_group=lay.expert,
                         batch_group=lay.expert_data_seq)
    out[name] += (moe._a2a.calls - calls,)
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ep_inputs():
    x, r, wg, wu, wd = mats(b=4, seed=5)
    return x, r, wg, wu, wd, cotangent(x.shape)


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    pickle.dump({n: (cf, ep_inputs()) for n, cf in EP_CASES.items()},
                open(d / "in.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), tests=str(ROOT / "tests"),
                       init=f"tcp://127.0.0.1:{free_port()}",
                       inp=str(d / "in.pkl"), out=str(d / "out"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(EP)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-3000:]
    return [pickle.load(open(f"{d / 'out'}{r}", "rb")) for r in range(EP)]


def jax_ep(cf):
    x, r, wg, wu, wd, ct = ep_inputs()
    mesh = make_mesh(data=1, expert=EP, devices=jax.devices("cpu")[:EP])

    def body(x, r, wg, wu, wd, ct):
        r = lax.pcast(r, ("expert",), to="varying")

        def loss(*a):
            y, aux = jax_moe.moe_ffn(
                *a, n_experts=E, top_k=K, capacity_factor=cf,
                expert_axis="expert", model_axis=None,
                batch_axes=("expert",))
            return (jnp.sum(y * ct) + AUX_COEF[0] * aux["lb"]
                    + AUX_COEF[1] * aux["z"]), (y, aux)

        (_, (y, aux)), g = jax.value_and_grad(
            loss, argnums=tuple(range(5)), has_aux=True)(x, r, wg, wu, wd)
        return y, aux, g

    ex = P("expert")
    y, aux, g = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(ex, P(), ex, ex, ex, ex),
        out_specs=(ex, {k: P() for k in ("f", "p", "lb", "z")},
                   (ex,) * 5)))(x, r, wg, wu, wd, ct)
    return np.asarray(y), {k: np.asarray(v) for k, v in aux.items()}, \
        [np.asarray(a) for a in g]


@pytest.mark.parametrize("case", list(EP_CASES))
def test_moe_ffn_ep2_matches_jax_shard_map(ep_ranks, case):
    """Each rank's outputs, aux and per-rank gradients against the JAX
    devices' under ``shard_map``; two all-to-alls forward and two
    backward a rank."""
    jy, jaux, jg = jax_ep(EP_CASES[case])
    for r in range(EP):
        y, aux, grads, a2a = ep_ranks[r][case]
        assert a2a == 4
        b = y.shape[0]
        assert_close(y, jy[r * b:(r + 1) * b], FWD_TOL, "y")
        for k in ("lb", "z", "f", "p"):
            assert_close(aux[k], jaux[k], FWD_TOL, k)
        for name, got, want in zip(
                ("x", "router", "we_gate", "we_up", "we_down"), grads, jg):
            n = got.shape[0]
            assert_close(got, want[r * n:(r + 1) * n], GRAD_TOL,
                         f"rank {r} d{name}")


def test_ep2_equals_one_rank_without_drops(ep_ranks):
    """Without drops the expert layout is not a math choice: the two
    ranks' outputs are one rank's on the whole batch, their aux its aux,
    and each expert's gradient (its owner's, the all-to-all's backward
    having summed both ranks' tokens) its gradient."""
    x, r, wg, wu, wd, ct = ep_inputs()
    y, aux, g = port_vjp(x, r, wg, wu, wd, ct, EP_CASES["no_drops"])
    ys = [ep_ranks[k]["no_drops"] for k in range(EP)]
    assert_close(np.concatenate([o[0] for o in ys]), y, FWD_TOL, "y")
    for k in ("lb", "z", "f", "p"):
        assert_close(ys[0][1][k], aux[k], FWD_TOL, k)
    for i in (2, 3, 4):
        assert_close(np.concatenate([o[2][i] for o in ys]), g[i],
                     GRAD_TOL, f"expert grad {i}")
