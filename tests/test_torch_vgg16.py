"""VGG16 of the port against the JAX package's (crop 32, batch 2, fp32).

The JAX model's parameters are carried into the port through the
classifier bridge (``restore_trees`` of ``jax.device_get(params)``) and
both nets see the same numpy batch.  Tolerances (fp32; the frameworks
sum the convolutions and the FC products in different orders):

- eval logits within ``LOGIT_ATOL`` (measured at most 7.5e-8, on
  logits up to 0.049);
- one train step with every ``Dropout`` at rate 0 in both nets: the loss
  within ``LOSS_RTOL`` relative (measured 0.0) and every gradient leaf
  within ``GRAD_ATOL`` + ``GRAD_RTOL`` x |JAX| (measured at most 7.3e-8
  absolute, 0.7% of that bound, on leaves of norm up to 1.7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import vgg16 as jax_vgg16
from theanompi_tpu.ops.layers import Dropout as JaxDropout
from theanompi_tpu.ops.layers import softmax_cross_entropy as jax_xent
from theanompi_tpu_torch.models.vgg16 import VGG16
from theanompi_tpu_torch.ops.layers import Dropout, softmax_cross_entropy
from theanompi_tpu_torch.ops.layers import to_jax_layout
from theanompi_tpu_torch.utils.checkpoint import keystr, tree_to_flat

CFG = dict(crop=32, batch_size=2, n_train=2, n_val=2,
           compute_dtype="float32", seed=5)
LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def no_dataset(tmp_path, monkeypatch):
    (tmp_path / "no_data").mkdir()
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path / "no_data"))


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model on its parameters, x, y), dropout off in
    both nets."""
    jm = jax_vgg16.VGG16(dict(CFG))
    jm.build_model()
    pm = VGG16(dict(CFG), device="cpu")
    pm.build_model()
    pm.restore_trees({g: jax.device_get(t) for g, t in
                      (("params", jm.params), ("net_state", jm.net_state),
                       ("opt_state", jm.opt_state))})
    for layer in jm.net.layers:
        if isinstance(layer, JaxDropout):
            layer.rate = 0.0
    for m in pm.net.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 1000, 2).astype(np.int32)
    return jm, pm, x, y


def test_param_tree_is_the_jax_one(models):
    jm, pm, _, _ = models
    want = tree_to_flat(jax.device_get(jm.params))
    got = tree_to_flat(pm.checkpoint_trees()["params"])
    assert set(got) == set(want) and len(want) == 32
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_eval_logits_match_jax(models):
    jm, pm, x, _ = models
    want, _ = jm.net.apply(jm.params, jm.net_state, jnp.asarray(x))
    with torch.no_grad():
        got = pm.net(pm.prep_input(torch.from_numpy(x)))
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_train_step_loss_and_gradients_match_jax(models):
    jm, pm, x, y = models

    def loss_fn(p):
        out, _ = jm.net.apply(p, jm.net_state, jnp.asarray(x), train=True)
        return jax_xent(out, jnp.asarray(y))

    loss, vjp = jax.vjp(loss_fn, jm.params)
    (g,) = vjp(jnp.ones_like(loss))
    want = tree_to_flat(jax.device_get(g))
    out = pm.net(pm.prep_input(torch.from_numpy(x)), train=True)
    tloss = softmax_cross_entropy(out, torch.from_numpy(y))
    grads = torch.autograd.grad(tloss, pm.params)
    got = {keystr(p): to_jax_layout(t, lay)
           for (p, (_, lay)), t in zip(pm._params_at.items(), grads)}
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=LOSS_RTOL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
