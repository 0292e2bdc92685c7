"""GoogLeNet of the port against the JAX package's (crop 96, batch 2,
fp32), under both settings of ``fused_inception``.

Crop 96 is the smallest the aux heads take with room to spare: they
read inception 4a and 4d at crop/16 = 6, and their ``Pool(5, 3)`` is
VALID.  The JAX model's parameters are carried into the port through
the classifier bridge and both nets see the same numpy batch.
Tolerances (fp32; the frameworks sum the convolutions, LRN windows and
FC products in different orders):

- eval logits within ``LOGIT_ATOL`` (measured at most 1.4e-6 fused,
  1.2e-6 unfused, on logits up to 1.3);
- train mode with every ``Dropout`` at rate 0 in both nets: each of the
  three logits of the tuple within ``LOGIT_ATOL`` (measured at most
  1.2e-6), the aux-weighted loss
  (main + 0.3 aux1 + 0.3 aux2) within ``LOSS_RTOL`` relative (measured
  0.0), the gradients in relative L2 norm within ``GRAD_TREE_REL`` over
  the whole tree and ``GRAD_LEAF_REL`` per leaf.  The gradient of this
  net at init is not continuous in fp32 rounding: the max pools route
  it to one element of a window, and a near tie flips under a 1e-6
  relative nudge of the input, which moves the port's own gradients by
  1.4e-4 over the tree and 1.9e-3 on a leaf.  Measured against JAX:
  fused 7.7e-7 (tree) and 1.3e-6 (worst leaf); unfused 8.1e-4 and
  6.5e-3, where the JAX package's own jitted and eager gradients agree
  within 4.2e-7 under the test suite's XLA flags and differ by 6.5e-3
  (tree) without them.  A wrong branch or slice moves them by O(1).
- the fused and the unfused port on the same weights: logits within
  ``LOGIT_ATOL`` (measured 0.0, eval and train), as the JAX package
  holds its two modules to each other.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import googlenet as jax_googlenet
from theanompi_tpu.ops.layers import Concat as JaxConcat
from theanompi_tpu.ops.layers import Dropout as JaxDropout
from theanompi_tpu.ops.layers import Sequential as JaxSequential
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu_torch.models.googlenet import GoogLeNet
from theanompi_tpu_torch.ops.layers import Dropout, to_jax_layout
from theanompi_tpu_torch.utils.checkpoint import keystr, tree_to_flat

CFG = dict(crop=96, batch_size=2, n_train=2, n_val=2,
           compute_dtype="float32", seed=7)
LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TREE_REL, GRAD_LEAF_REL = 5e-3, 5e-2


@pytest.fixture(autouse=True)
def no_dataset(tmp_path_factory, monkeypatch):
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    monkeypatch.setenv("TM_DATA_DIR", str(d))


def jax_dropouts(layer):
    """Every JAX ``Dropout`` under ``layer`` (a net of JAX layers)."""
    if isinstance(layer, JaxDropout):
        yield layer
    elif isinstance(layer, JaxSequential):
        for sub in layer.layers:
            yield from jax_dropouts(sub)
    elif isinstance(layer, JaxConcat):
        for sub in layer.branches:
            yield from jax_dropouts(sub)
    else:
        for sub in vars(layer).values():
            if hasattr(sub, "apply"):
                yield from jax_dropouts(sub)


def trees_of(jm):
    return {g: jax.device_get(t) for g, t in
            (("params", jm.params), ("net_state", jm.net_state),
             ("opt_state", jm.opt_state))}


def port_model(fused, trees=None):
    pm = GoogLeNet(dict(CFG, fused_inception=fused), device="cpu")
    pm.build_model()
    if trees is not None:
        pm.restore_trees(trees)
    return pm


@pytest.fixture(scope="module", params=[True, False], ids=["fused",
                                                           "unfused"])
def models(request):
    """(JAX model, port model on its parameters, x, y) with dropout
    off in both nets."""
    fused = request.param
    jm = jax_googlenet.GoogLeNet(dict(CFG, fused_inception=fused))
    jm.build_model()
    pm = port_model(fused, trees_of(jm))
    for d in jax_dropouts(jm.net):
        d.rate = 0.0
    for m in pm.net.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 96, 96, 3)).astype(np.float32)
    y = rng.integers(0, 1000, 2).astype(np.int32)
    return jm, pm, x, y


def test_param_tree_is_the_jax_one(models):
    jm, pm, _, _ = models
    want = tree_to_flat(jax.device_get(jm.params))
    got = tree_to_flat(pm.checkpoint_trees()["params"])
    assert set(got) == set(want)
    assert not any("pool" in k for k in got)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    n_drop = sum(isinstance(m, Dropout) for m in pm.net.modules())
    assert n_drop == len(list(jax_dropouts(jm.net))) == 3


def test_eval_logits_match_jax(models):
    jm, pm, x, _ = models
    want, _ = jm.net.apply(jm.params, jm.net_state, jnp.asarray(x))
    with torch.no_grad():
        got = pm.net(pm.prep_input(torch.from_numpy(x)))
    assert isinstance(got, torch.Tensor) and got.shape == (2, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_train_tuple_aux_loss_and_gradients_match_jax(models):
    jm, pm, x, y = models

    def loss_fn(p):
        out, _ = jm.net.apply(p, jm.net_state, jnp.asarray(x), train=True)
        return jm.compute_loss(out, jnp.asarray(y)), out

    (loss, outs), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jm.params)
    want = tree_to_flat(jax.device_get(g))
    out = pm.net(pm.prep_input(torch.from_numpy(x)), train=True)
    assert isinstance(out, tuple) and len(out) == 3
    for o, w in zip(out, outs):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   atol=LOGIT_ATOL, rtol=0)
    tloss = pm.compute_loss(out, torch.from_numpy(y).long())
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=LOSS_RTOL)
    grads = torch.autograd.grad(tloss, pm.params)
    got = {keystr(p): to_jax_layout(t, lay)
           for (p, (_, lay)), t in zip(pm._params_at.items(), grads)}
    assert set(got) == set(want)
    num = den = 0.0
    for k in want:
        d2 = float(((got[k] - want[k]) ** 2).sum())
        n2 = float((want[k] ** 2).sum())
        num, den = num + d2, den + n2
        assert d2 <= GRAD_LEAF_REL ** 2 * n2, (k, (d2 / n2) ** 0.5)
    assert num <= GRAD_TREE_REL ** 2 * den, (num / den) ** 0.5


def unfuse(flat: dict, have: dict) -> dict:
    """A fused net's parameters (flat JAX-layout keystr map) as the
    unfused net's, whose own map ``have`` gives the branch widths: each
    merged 1x1 conv's output channels split into the three branch
    convs, ``b3``/``b5``/``pproj`` moved to branches 1-3."""
    out = {}
    for k, v in flat.items():
        m = re.fullmatch(r"(.*)\['first'\]\['(w|b)'\]", k)
        if m:
            prefix, leaf = m.groups()
            lo = 0
            for path in ("[0][0]", "[1][0][0]", "[2][0][0]"):
                width = have[f"{prefix}{path}['b']"].shape[0]
                out[f"{prefix}{path}['{leaf}']"] = v[..., lo:lo + width]
                lo += width
            assert lo == v.shape[-1], k
            continue
        m = re.fullmatch(r"(.*)\['(b3|b5|pproj)'\](.*)", k)
        if m:
            branch = {"b3": 1, "b5": 2, "pproj": 3}[m.group(2)]
            k = f"{m.group(1)}[{branch}][1]{m.group(3)}"
        out[k] = v
    return out


def test_fused_matches_unfused_on_the_same_weights():
    fused, plain = port_model(True), port_model(False)
    have = tree_to_flat(plain.checkpoint_trees()["params"])
    params = unfuse(tree_to_flat(fused.checkpoint_trees()["params"]), have)
    assert set(params) == set(have)
    plain.restore_trees({"params": params, "net_state": {},
                         "opt_state": plain.checkpoint_trees()["opt_state"]})
    for m in (fused, plain):
        for d in m.net.modules():
            if isinstance(d, Dropout):
                d.rate = 0.0
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 96, 96, 3)).astype(np.float32))
    with torch.no_grad():
        a = fused.net(fused.prep_input(x))
        b = plain.net(plain.prep_input(x))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=LOGIT_ATOL,
                                   rtol=0)
        a = fused.net(fused.prep_input(x), train=True)
        b = plain.net(plain.prep_input(x), train=True)
        for u, v in zip(a, b):
            np.testing.assert_allclose(u.numpy(), v.numpy(),
                                       atol=LOGIT_ATOL, rtol=0)


# -- checkpoints across the packages ------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_port_checkpoint_loads_into_jax(tmp_path, fused):
    pm = port_model(fused)
    pm.save(str(tmp_path))
    jm = jax_googlenet.GoogLeNet(dict(CFG, fused_inception=fused))
    jm.build_model()
    jm.compile_iter_fns(mesh=make_mesh(data=1,
                                       devices=jax.devices("cpu")[:1]))
    assert jm.load(str(tmp_path))
    want = {g: tree_to_flat(t) for g, t in pm.checkpoint_trees().items()}
    for group, tree in jm.checkpoint_trees().items():
        got = tree_to_flat(jax.device_get(tree))
        assert set(got) == set(want[group]), group
        for k, v in got.items():
            assert np.array_equal(v, want[group][k]), (group, k)


@pytest.mark.parametrize("fused", [True, False])
def test_jax_checkpoint_loads_into_the_port(tmp_path, fused):
    jm = jax_googlenet.GoogLeNet(dict(CFG, fused_inception=fused))
    jm.build_model()
    trees = trees_of(jm)
    jax_save(str(tmp_path), 0, trees, {"epoch": 0, "lr": 0.01})
    pm = port_model(fused)
    assert pm.load(str(tmp_path)) and pm.epoch == 0
    got = {g: tree_to_flat(t) for g, t in pm.checkpoint_trees().items()}
    for group, tree in trees.items():
        want = tree_to_flat(tree)
        assert set(got[group]) == set(want), group
        for k, v in want.items():
            assert np.array_equal(got[group][k], v), (group, k)


@pytest.mark.parametrize("saved", [True, False])
def test_checkpoint_of_the_other_setting_names_the_knob(tmp_path, saved):
    port_model(saved).save(str(tmp_path))
    pm = port_model(not saved)
    with pytest.raises(RuntimeError, match="fused_inception"):
        pm.load(str(tmp_path))
