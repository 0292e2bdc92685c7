"""The zoo's last knobs against the JAX package: the tie-split max-pool
backward (``Pool(bwd="tiesplit")``), ``BN(axis=…)`` and
``ResNet50(stage1_width=128)``.  All three are retired TPU experiments
with no card kernel: these CPU parity tests are what holds them.

Tolerances (fp32): the tie-split gradient sums the same shares in
another order than the JAX phase-decomposed gather, so it is held to
1e-6; ``BN(axis=…)`` to the layer tests' 1e-5 (channel reductions in
another order); ResNet-50 to the classifier tests' bars (logits 1e-4,
gradients 5e-3 relative L2 overall, 0.1 a leaf: eager PyTorch against
``jax.jit`` moves ResNet-50's gradients by ~1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import resnet50 as jax_resnet
from theanompi_tpu.models.base import softmax_cross_entropy as jax_xent
from theanompi_tpu.ops import layers as jl
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.ops import layers as tl
from theanompi_tpu_torch.ops.layers import softmax_cross_entropy, to_jax_layout
from theanompi_tpu_torch.utils.checkpoint import keystr, tree_to_flat

TIE_TOL = dict(rtol=1e-6, atol=1e-6)
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


# -- the tie-split max-pool backward -------------------------------------------

POOLS = [((3, 3), (1, 1), "SAME"), ((3, 3), (2, 2), "SAME"),
         ((2, 2), (2, 2), "VALID"), ((5, 5), (3, 3), "VALID"),
         ((3, 3), (2, 2), "VALID")]


def tied(rng, shape):
    """Small integers: most windows hold their max more than once."""
    return rng.integers(0, 3, size=shape).astype(np.float32)


@pytest.mark.parametrize("size,stride,pad", POOLS)
def test_tiesplit_gradient_matches_jax_on_ties(size, stride, pad):
    rng = np.random.default_rng(sum(size) + sum(stride))
    x = tied(rng, (2, 11, 13, 3))
    jy, vjp = jax.vjp(lambda a: jl.maxpool_tiesplit(a, size, stride, pad),
                      jnp.asarray(x))
    cot = rng.normal(size=jy.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(cot))

    xt = nchw(x).requires_grad_()
    yt = tl.maxpool_tiesplit(xt, size, stride, pad)
    yt.backward(nchw(cot))
    np.testing.assert_array_equal(nhwc(yt), np.asarray(jy))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jdx), **TIE_TOL)
    # the windows did tie, and the mass of every window was routed
    assert (np.asarray(jdx) % 1 != 0).any()
    np.testing.assert_allclose(xt.grad.sum().item(), cot.sum(), rtol=1e-5)


def test_tiesplit_differs_from_the_default_only_on_ties():
    """Unique maxima: the tie-split gradient is the default one, exactly.
    Ties: it splits where PyTorch's max pool gives one element all."""
    rng = np.random.default_rng(0)
    for x, same in ((rng.normal(size=(2, 9, 9, 4)), True),
                    (tied(rng, (2, 9, 9, 4)), False)):
        grads = []
        for bwd in ("tiesplit", ""):
            xt = nchw(x.astype(np.float32)).requires_grad_()
            pool = tl.Pool(3, 2, pad="SAME", bwd=bwd)
            pool(xt).sum().backward()
            grads.append(xt.grad)
        assert torch.equal(grads[0], grads[1]) == same


def test_pool_layer_tiesplit_matches_the_jax_layer(monkeypatch):
    """``TM_POOL_BWD=tiesplit`` on both packages' ``Pool`` layers."""
    monkeypatch.setenv("TM_POOL_BWD", "tiesplit")
    jp, tp = jl.Pool(3, 2, pad="SAME"), tl.Pool(3, 2, pad="SAME")
    assert jp.bwd == tp.bwd == "tiesplit"
    x = tied(np.random.default_rng(4), (2, 10, 10, 5))
    jy, vjp = jax.vjp(lambda a: jp.apply({}, {}, a)[0], jnp.asarray(x))
    (jdx,) = vjp(jnp.ones_like(jy))
    xt = nchw(x).requires_grad_()
    tp(xt).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jdx), **TIE_TOL)


def test_tiesplit_bf16_rounds_as_jax():
    """bf16: cnt and the share in bf16, the sum over windows in fp32,
    one bf16 rounding at the end — as the JAX backward."""
    rng = np.random.default_rng(7)
    x = tied(rng, (1, 8, 8, 2))
    cot = rng.normal(size=(1, 4, 4, 2)).astype(np.float32)
    size, stride = (3, 3), (2, 2)
    jy, vjp = jax.vjp(
        lambda a: jl.maxpool_tiesplit(a, size, stride, "SAME"),
        jnp.asarray(x, jnp.bfloat16))
    (jdx,) = vjp(jnp.asarray(cot, jnp.bfloat16))
    xt = nchw(x).bfloat16().requires_grad_()
    yt = tl.maxpool_tiesplit(xt, size, stride, "SAME")
    yt.backward(nchw(cot).bfloat16())
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(xt.grad.float()),
                               np.asarray(jdx, np.float32), rtol=2 ** -7,
                               atol=0)


# -- BN(axis=...) ------------------------------------------------------------

def bn_both(axis, shape, train, seed):
    """Forward, input and parameter gradients, and the new running
    statistics of both packages' ``BN(axis=axis)`` on one input."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=shape).astype(np.float32)
    jlayer, tlayer = jl.BN(axis=axis), tl.BN(axis=axis)
    jp, js, _ = jlayer.init(jax.random.PRNGKey(0), shape[1:])
    jp = {k: jnp.asarray(1 + 0.3 * rng.normal(size=v.shape), jnp.float32)
          for k, v in jp.items()}
    js = {"mean": jnp.asarray(0.2 * rng.normal(size=shape[-1]), jnp.float32),
          "var": jnp.asarray(1 + rng.random(shape[-1]), jnp.float32)}
    tlayer.init(torch.Generator().manual_seed(0), shape[1:])
    with torch.no_grad():
        for k in ("scale", "offset"):
            getattr(tlayer, k).copy_(torch.from_numpy(np.asarray(jp[k])))
        for k in ("mean", "var"):
            getattr(tlayer, k).copy_(torch.from_numpy(np.asarray(js[k])))
    cot = rng.normal(size=shape).astype(np.float32)

    y, vjp, ns = jax.vjp(
        lambda p, a: jlayer.apply(p, js, a, train=train), jp,
        jnp.asarray(x), has_aux=True)
    dp, dx = vjp(jnp.asarray(cot))
    want = (np.asarray(y), np.asarray(dx), np.asarray(dp["scale"]),
            np.asarray(dp["offset"]), np.asarray(ns["mean"]),
            np.asarray(ns["var"]))

    four = len(shape) == 4
    xt = (nchw(x) if four else torch.from_numpy(x)).requires_grad_()
    yt = tlayer(xt, train=train)
    yt.backward(nchw(cot) if four else torch.from_numpy(cot))
    got = (nhwc(yt), nhwc(xt.grad), tlayer.scale.grad.numpy(),
           tlayer.offset.grad.numpy(), tlayer.mean.detach().numpy(),
           tlayer.var.detach().numpy())
    return want, got


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("axis,shape", [
    (0, (16, 6)),                      # a bare int, FC activations
    ((0,), (16, 6)),
    ((0, 1, 2), (3, 5, 4, 6)),         # the default, spelled out
    ((-4, -3, -2), (3, 5, 4, 6)),      # negative axes
])
def test_bn_axis_matches_jax(axis, shape, train):
    want, got = bn_both(axis, shape, train, seed=len(shape) + train)
    for w, g, name in zip(want, got, ("y", "dx", "dscale", "doffset",
                                      "mean", "var")):
        assert w.shape == g.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **BN_TOL)


def test_bn_axis_spelled_as_the_default_is_the_default():
    """``axis=(0, 1, 2)`` on images computes what ``axis=None`` does."""
    rng = np.random.default_rng(2)
    x = nchw(rng.normal(size=(3, 5, 4, 6)).astype(np.float32))
    outs = []
    for axis in (None, (0, 1, 2)):
        bn = tl.BN(axis=axis)
        bn.init(torch.Generator().manual_seed(0), (5, 4, 6))
        outs.append((bn(x, train=True), bn.mean.clone(), bn.var.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# -- ResNet-50 at stage1_width = 128 ------------------------------------------

def test_resnet50_stage1_width_128_matches_jax():
    """The padded stage-1 network (stem and stage 1's internal convs 128
    wide, residual stream 256): train-mode logits, loss, gradients and
    BN statistics against the JAX model at crop 64, from the JAX init."""
    cfg = dict(crop=64, batch_size=4, compute_dtype="float32",
               stage1_width=128)
    jm = jax_resnet.ResNet50(dict(cfg))
    jm.build_model()
    rng = np.random.default_rng(0)

    def perturb(path, v):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            std, mean = (0.2, 0.0) if "bn3" in key else (0.1, 1.0)
            return jnp.asarray(mean + std * rng.normal(size=v.shape),
                               jnp.float32)
        if key.endswith("['offset']"):
            return jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
        return v

    params = jax.tree_util.tree_map_with_path(perturb, jm.params)
    pm = ResNet50(dict(cfg), device="cpu")
    pm.build_model()
    pm.restore_trees({"params": jax.device_get(params),
                      "net_state": jax.device_get(jm.net_state),
                      "opt_state": jax.device_get(jm.opt_state)})
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 1000, 4).astype(np.int32)

    def loss_fn(p):
        out, ns = jm.net.apply(p, jm.net_state, jnp.asarray(x), train=True)
        return jax_xent(out, jnp.asarray(y)), (out, ns)

    (l0, (o0, _)), g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    g0 = tree_to_flat(jax.device_get(g))
    out = pm.net(pm.prep_input(torch.from_numpy(x)), train=True)
    tloss = softmax_cross_entropy(out, torch.from_numpy(y))
    grads = torch.autograd.grad(tloss, pm.params)
    g1 = {keystr(p): to_jax_layout(t, lay) for (p, (_, lay)), t
          in zip(pm._params_at.items(), grads)}
    np.testing.assert_allclose(tloss.item(), float(l0), rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o0),
                               atol=1e-4, rtol=0)
    assert set(g1) == set(g0) and len(g0) == 161
    assert g0["[4]['conv2']['w']"].shape[-2:] == (128, 128)  # stage 1 padded
    assert g0["[4]['conv3']['w']"].shape[-1] == 256     # stream stays 256
    num = den = 0.0
    for k in g0:
        d2 = float(((g1[k] - g0[k]) ** 2).sum())
        n2 = float((g0[k] ** 2).sum())
        num, den = num + d2, den + n2
        assert d2 <= 0.1 ** 2 * n2, k
    assert num <= 5e-3 ** 2 * den, (num / den) ** 0.5
