"""Layer parity with the JAX package: every layer of the port's
``ops/layers.py`` against the JAX layer's ``apply`` and ``jax.vjp`` on
the same inputs (made from a seed with numpy) and the same parameters
(the JAX init carried across through the bridge's layouts).

fp32 throughout.  The frameworks sum in different orders (convolutions,
channel reductions, the loss mean), so outputs and gradients differ by
float rounding; every comparison holds them to rtol = atol = 1e-5.
Inputs are continuous draws, so max pooling meets no ties; what the
port does on ties is pinned in its own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.ops import layers as jl
from theanompi_tpu_torch.ops import layers as tl
from theanompi_tpu_torch.utils.checkpoint import keystr, tree_to_flat

TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(a):
    """A NHWC numpy batch as the port's NCHW-indexed channels_last view."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def copy_from_jax(layer, params, state):
    """The JAX layer's trees into the port layer's tensors."""
    for group, tree in (("params", params), ("state", state)):
        flat = tree_to_flat(jax.device_get(tree))
        entries = layer.jax_entries(group)
        assert set(flat) == {keystr(p) for p in entries}, group
        with torch.no_grad():
            for path, (t, layout) in entries.items():
                t.copy_(tl.from_jax_layout(flat[keystr(path)], layout))


def both(jlayer, tlayer, in_shape, *, seed, batch=2, train=False,
         params=None):
    """Forward and backward of both layers on one input and output
    cotangent; returns ((y, dx, dparams, state) jax, same port), each
    a numpy NHWC / JAX-layout value."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *in_shape)).astype(np.float32)
    jp, js, out_shape = jlayer.init(jax.random.PRNGKey(seed), in_shape)
    if params is not None:
        jp = params(jp, rng)
    assert tlayer.init(torch.Generator().manual_seed(0), in_shape) == \
        tuple(out_shape)
    copy_from_jax(tlayer, jp, js)
    cot = rng.normal(size=(batch, *out_shape)).astype(np.float32)

    y, vjp, new_state = jax.vjp(
        lambda p, a: jlayer.apply(p, js, a, train=train), jp, jnp.asarray(x),
        has_aux=True)
    dp, dx = vjp(jnp.asarray(cot))
    want = (np.asarray(y), np.asarray(dx), tree_to_flat(jax.device_get(dp)),
            tree_to_flat(jax.device_get(new_state)))

    xt = (nchw(x) if x.ndim == 4 else torch.from_numpy(x)).requires_grad_()
    yt = tlayer(xt, train=train)
    yt.backward(nchw(cot) if cot.ndim == 4 else torch.from_numpy(cot))
    got = (nhwc(yt), nhwc(xt.grad),
           {keystr(p): tl.to_jax_layout(t.grad, lay)
            for p, (t, lay) in tlayer.jax_entries("params").items()},
           {keystr(p): tl.to_jax_layout(t, lay)
            for p, (t, lay) in tlayer.jax_entries("state").items()})
    return want, got


def assert_same(want, got):
    names = ("y", "dx", "dparams", "state")
    for name, w, g in zip(names, want, got):
        if isinstance(w, dict):
            assert set(w) == set(g), name
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=f"{name}{k}",
                                           **TOL)
        else:
            assert w.shape == g.shape, name
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


# -- conv -----------------------------------------------------------------------

@pytest.mark.parametrize("kw,in_shape", [
    (dict(out_ch=4, kernel=3, stride=1, pad="SAME"), (8, 8, 3)),
    # 'SAME' with stride 2 on an even size: pads (0, 1), the odd pad at
    # the bottom and right (WResNet's stride-2 3x3 convs)
    (dict(out_ch=4, kernel=3, stride=2, pad="SAME"), (8, 8, 3)),
    (dict(out_ch=4, kernel=3, stride=2, pad="SAME"), (7, 7, 3)),
    (dict(out_ch=4, kernel=2, stride=2, pad="SAME"), (7, 6, 3)),
    # the 1x1 stride-2 shortcut: 'SAME' pads nothing
    (dict(out_ch=4, kernel=1, stride=2, pad="SAME"), (8, 8, 3)),
    (dict(out_ch=6, kernel=5, stride=1, pad="VALID"), (9, 9, 2)),
    (dict(out_ch=4, kernel=3, stride=2, pad="VALID", bias=False), (9, 8, 3)),
    (dict(out_ch=4, kernel=3, stride=1, pad=1), (6, 6, 3)),
    (dict(out_ch=5, kernel=7, stride=2, pad=3, bias=False), (16, 16, 3)),
    (dict(out_ch=4, kernel=3, stride=1, pad="SAME", groups=2), (6, 6, 4)),
    (dict(out_ch=6, kernel=3, stride=2, pad=1, groups=3), (7, 7, 6)),
], ids=lambda v: str(v))
def test_conv_matches_jax(kw, in_shape):
    kw = dict(kw)
    args = (kw.pop("out_ch"), kw.pop("kernel"))
    want, got = both(jl.Conv(*args, **kw), tl.Conv(*args, **kw), in_shape,
                     seed=len(str(kw)) + in_shape[0],
                     params=lambda p, rng: dict(p, **(
                         {"b": jnp.asarray(rng.normal(size=p["b"].shape),
                                           jnp.float32)} if "b" in p else {})))
    assert_same(want, got)


def test_s2d_conv_equals_jax_space_to_depth_path():
    """ResNet-50's stem, ``Conv(s2d=True)``: the JAX layer computes it
    through ``_s2d_conv`` (the space-to-depth transform), the port
    through the plain strided conv; they are one function."""
    in_shape = (16, 16, 3)
    assert jl._s2d_applicable((2, *in_shape), 7, 2, 3)
    want, got = both(jl.Conv(8, 7, stride=2, pad=3, bias=False, s2d=True),
                     tl.Conv(8, 7, stride=2, pad=3, bias=False, s2d=True),
                     in_shape, seed=7)
    assert_same(want, got)
    with pytest.raises(ValueError, match="s2d"):
        tl.Conv(8, 7, stride=2, pad="SAME", s2d=True)


# -- pooling --------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("size,stride,pad,hw", [
    (3, 2, "SAME", (8, 8)),      # ResNet-50's stem pool: pads (0, 1)
    (3, 2, "SAME", (7, 7)),
    (3, 1, "SAME", (5, 6)),
    (2, 2, "VALID", (8, 6)),
    (3, 2, "VALID", (9, 9)),     # AlexNet's pools
])
def test_pool_matches_jax(mode, size, stride, pad, hw):
    want, got = both(jl.Pool(size, stride, mode=mode, pad=pad),
                     tl.Pool(size, stride, mode=mode, pad=pad),
                     (*hw, 3), seed=size * 10 + hw[0])
    assert_same(want, got)


def test_max_pool_ties_route_to_the_first_element_in_window_order():
    """On ties the whole gradient of a window goes to its first
    attaining element in row-major window order, in both packages
    (``select_and_scatter``'s ``ge`` select in the JAX one); with
    overlapping windows an element collects each window it wins."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    for size, stride, pad, want in (
        (2, 2, "VALID", [[1, 0, 1, 0], [0, 0, 0, 0], [1, 0, 1, 0],
                         [0, 0, 0, 0]]),
        (3, 1, "VALID", [[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 0, 0],
                         [0, 0, 0, 0]]),
        (3, 2, "SAME", [[1, 0, 1, 0], [0, 0, 0, 0], [1, 0, 1, 0],
                        [0, 0, 0, 0]]),
    ):
        jp = jl.Pool(size, stride, pad=pad)
        y, vjp = jax.vjp(lambda a: jp.apply({}, {}, a)[0], jnp.asarray(x))
        dj = np.asarray(vjp(jnp.ones_like(y))[0])[0, :, :, 0]
        xt = nchw(x).requires_grad_()
        yt = tl.Pool(size, stride, pad=pad)(xt)
        yt.backward(torch.ones_like(yt))
        np.testing.assert_array_equal(xt.grad[0, 0].numpy(), want)
        np.testing.assert_array_equal(dj, want)


def test_pool_tiesplit_is_not_ported(monkeypatch):
    """The tie-split backward is ported (its gradients against JAX are in
    ``tests/test_torch_zoo_knobs.py``): the constructor and
    ``TM_POOL_BWD`` select it as the JAX ``Pool`` does, a disable value
    selects the default, and an unknown value still raises."""
    assert tl.Pool(3, 2, bwd="tiesplit").bwd == "tiesplit"
    monkeypatch.setenv("TM_POOL_BWD", "tiesplit")
    assert tl.Pool(3, 2).bwd == "tiesplit"
    assert tl.Pool(3, 2, bwd="").bwd == ""
    monkeypatch.setenv("TM_POOL_BWD", "off")
    assert tl.Pool(3, 2).mode == "max" and tl.Pool(3, 2).bwd == ""
    monkeypatch.setenv("TM_POOL_BWD", "bogus")
    with pytest.raises(ValueError, match="unknown Pool bwd"):
        tl.Pool(3, 2)


# -- normalization ------------------------------------------------------------

def test_lrn_matches_jax():
    want, got = both(jl.LRN(n=5, alpha=1e-2, beta=0.75),
                     tl.LRN(n=5, alpha=1e-2, beta=0.75), (5, 5, 7), seed=3)
    assert_same(want, got)


def random_bn(p, rng):
    return {k: jnp.asarray(1.0 + 0.5 * rng.normal(size=v.shape), jnp.float32)
            for k, v in p.items()}


@pytest.mark.parametrize("train", [True, False])
def test_bn_matches_jax(train):
    """Train mode: y, the custom backward (dx, dscale, doffset) and the
    running-statistic update ``0.9*old + 0.1*batch`` with the biased
    one-pass variance; eval mode normalizes by the running statistics
    (non-trivial ones, copied in from random JAX state)."""
    jbn, tbn = jl.BN(), tl.BN()
    rng = np.random.default_rng(9)
    in_shape = (5, 4, 6)
    x = (2.0 + 3.0 * rng.normal(size=(3, *in_shape))).astype(np.float32)
    jp, js, _ = jbn.init(jax.random.PRNGKey(0), in_shape)
    jp = random_bn(jp, rng)
    js = {"mean": jnp.asarray(rng.normal(size=6), jnp.float32),
          "var": jnp.asarray(rng.uniform(0.5, 2.0, size=6), jnp.float32)}
    tbn.init(torch.Generator(), in_shape)
    copy_from_jax(tbn, jp, js)
    cot = rng.normal(size=x.shape).astype(np.float32)
    y, vjp, new_state = jax.vjp(
        lambda p, a: jbn.apply(p, js, a, train=train), jp, jnp.asarray(x),
        has_aux=True)
    dp, dx = vjp(jnp.asarray(cot))
    xt = nchw(x).requires_grad_()
    yt = tbn(xt, train=train)
    yt.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx), **TOL)
    np.testing.assert_allclose(tbn.scale.grad.numpy(), np.asarray(dp["scale"]),
                               **TOL)
    np.testing.assert_allclose(tbn.offset.grad.numpy(),
                               np.asarray(dp["offset"]), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   np.asarray(new_state[k]), **TOL)
    if train:
        xf = x.reshape(-1, 6)
        batch_var = (xf * xf).mean(0) - xf.mean(0) ** 2   # biased
        np.testing.assert_allclose(
            tbn.var.numpy(), 0.9 * np.asarray(js["var"]) + 0.1 * batch_var,
            rtol=1e-5)


def test_bn_function_matches_jax_bn_train_vjp():
    """The port's ``_BNTrain`` autograd function against
    ``jax.vjp(_bn_train)`` directly: outputs (y, batch mean, biased
    batch variance) and the cotangents of x, scale and offset."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 3, 3, 5)).astype(np.float32)
    scale = rng.normal(size=5).astype(np.float32)
    offset = rng.normal(size=5).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    (y, mean, var), vjp = jax.vjp(
        lambda a, s, o: jl._bn_train(a, s, o, (0, 1, 2), 1e-5),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset))
    dx, ds, do = vjp((jnp.asarray(cot), jnp.zeros(5), jnp.zeros(5)))
    xt = nchw(x).requires_grad_()
    st, ot = (torch.from_numpy(a).requires_grad_() for a in (scale, offset))
    yt, mt, vt = tl._BNTrain.apply(xt, st, ot, 1e-5)
    yt.backward(nchw(cot))
    for got, want in ((nhwc(yt), y), (mt.numpy(), mean), (vt.numpy(), var),
                      (nhwc(xt.grad), dx), (st.grad.numpy(), ds),
                      (ot.grad.numpy(), do)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bn_saves_its_input_in_its_own_dtype():
    """A bf16 activation is saved as bf16 (no fp32 copy kept for the
    backward), y and dx come back bf16, the statistics fp32."""
    bn = tl.BN()
    bn.init(torch.Generator(), (4, 4, 8))
    x = torch.randn(2, 8, 4, 4).to(torch.bfloat16).to(
        memory_format=torch.channels_last).requires_grad_()
    y = bn(x, train=True)
    saved = y.grad_fn.saved_tensors
    assert saved[0].dtype == torch.bfloat16 and saved[0].shape == x.shape
    assert all(t.dtype == torch.float32 for t in saved[1:])
    y.float().sum().backward()
    assert y.dtype == x.grad.dtype == torch.bfloat16
    assert bn.mean.dtype == bn.var.dtype == torch.float32


# -- the rest ----------------------------------------------------------------------

def test_fc_matches_jax():
    want, got = both(jl.FC(7), tl.FC(7), (5,), seed=4, batch=3,
                     params=lambda p, rng: dict(p, b=jnp.asarray(
                         rng.normal(size=7), jnp.float32)))
    assert_same(want, got)


def test_dropout_at_rate_0_and_in_eval_is_identity():
    x = torch.randn(3, 4, 5, 5)
    assert torch.equal(tl.Dropout(0.0)(x, train=True), x)
    assert torch.equal(tl.Dropout(0.5)(x, train=False), x)
    want, got = both(jl.Dropout(0.0), tl.Dropout(0.0), (4, 4, 2), seed=1,
                     train=True)
    assert_same(want, got)
    with pytest.raises(ValueError, match="gen"):
        tl.Dropout(0.5)(x, train=True)
    y = tl.Dropout(0.5)(x, train=True, gen=torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(y[kept], x[kept] / 0.5)


def test_concat_matches_jax():
    def branches(mod):
        return [mod.Conv(3, 1), mod.Sequential([mod.Conv(2, 3),
                                                mod.Activation("relu")]),
                mod.Pool(3, 1, pad="SAME")]

    want, got = both(jl.Concat(branches(jl)), tl.Concat(branches(tl)),
                     (5, 5, 4), seed=5)
    assert_same(want, got)


@pytest.mark.parametrize("name", ["GlobalAvgPool", "Flatten"])
def test_global_avg_pool_and_flatten_match_jax(name):
    """Flatten keeps the JAX package's NHWC element order."""
    want, got = both(getattr(jl, name)(), getattr(tl, name)(), (3, 4, 5),
                     seed=6)
    assert_same(want, got)


def test_sequential_matches_jax_and_nests_like_its_tree():
    def net(mod):
        return mod.Sequential([mod.Conv(4, 3, stride=2), mod.BN(),
                               mod.Activation("relu"), mod.Pool(2, 2),
                               mod.Flatten(), mod.FC(3)])

    tnet = net(tl)
    want, got = both(net(jl), tnet, (8, 8, 3), seed=8, train=True)
    assert_same(want, got)
    assert list(tnet.jax_entries("params")) == [
        (0, "w"), (0, "b"), (1, "scale"), (1, "offset"), (5, "w"), (5, "b")]
    assert list(tnet.jax_entries("state")) == [(1, "mean"), (1, "var")]


def test_softmax_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(2)
    for n_classes, k in ((10, 1), (10, 5), (3, 5)):    # k clamps to 3
        logits = rng.normal(size=(16, n_classes)).astype(np.float32)
        labels = rng.integers(0, n_classes, size=16).astype(np.int32)
        tlog, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
        np.testing.assert_allclose(
            float(tl.softmax_cross_entropy(tlog, tlab)),
            float(jl.softmax_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels))), **TOL)
        assert float(tl.accuracy(tlog, tlab, k)) == float(
            jl.accuracy(jnp.asarray(logits), jnp.asarray(labels), k))
    assert float(tl.accuracy(tlog, tlab, 5)) == 1.0
