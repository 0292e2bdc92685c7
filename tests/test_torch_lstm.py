"""The IMDB LSTM of the port against the JAX package, on the CPU.

- ``ImdbData`` batches are bitwise the JAX ones: the synthetic task and
  both ``imdb.pkl`` layouts.
- ``Embedding`` and ``LSTM`` (every pool, with and without padding):
  forward and ``jax.vjp`` gradients in fp32 within 1e-5.
- The model: eval logits, train loss and gradients from the JAX
  parameters; token ids through ``prep_input``, the stager and the
  device-resident train set stay integers.
- A short BSP trajectory on one rank against the JAX worker, and
  checkpoints both ways.

Tiny widths throughout: vocab 64, embedding 8, hidden 8, maxlen 12,
batch 4; dropout 0 where the two packages train (their dropout masks
come from different generators).
"""

import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import lstm as jax_lstm
from theanompi_tpu.models.data import imdb as jax_imdb
from theanompi_tpu.ops import recurrent as jax_rec
from theanompi_tpu.ops.layers import softmax_cross_entropy as jax_xent
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch.models.data import imdb
from theanompi_tpu_torch.models.lstm import LSTM
from theanompi_tpu_torch.ops import recurrent
from theanompi_tpu_torch.ops.layers import (
    softmax_cross_entropy,
    to_jax_layout,
)
from theanompi_tpu_torch.utils.checkpoint import keystr, tree_to_flat
from theanompi_tpu_torch.workers import bsp_worker as port_worker

CFG = dict(vocab=64, emb_dim=8, hidden=8, maxlen=12, batch_size=4,
           n_train=32, n_val=8, compute_dtype="float32", dropout=0.0,
           lr=0.1, seed=3)
LSTM_MODEL = dict(modelfile="theanompi_tpu_torch.models.lstm",
                  modelclass="LSTM")
# fp32: the two packages differ by summation order only
ATOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def no_dataset(tmp_path_factory, monkeypatch):
    """Every data module takes its synthetic path: TM_DATA_DIR is an
    empty directory."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    monkeypatch.setenv("TM_DATA_DIR", str(d))
    return d


def flat(tree):
    return tree_to_flat(jax.device_get(tree))


# -- data ---------------------------------------------------------------------

def assert_same_batches(a, b):
    assert (a.n_batch_train, a.n_batch_val) == (b.n_batch_train,
                                                b.n_batch_val)
    assert a.n_batch_train and a.n_batch_val
    for epoch in (0, 1):
        a.shuffle(epoch)
        b.shuffle(epoch)
        for i in range(a.n_batch_train):
            for x, y in zip(a.train_batch(i), b.train_batch(i)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    for i in range(a.n_batch_val):
        for x, y in zip(a.val_batch(i), b.val_batch(i)):
            np.testing.assert_array_equal(x, y)
    for split in ("train", "val"):
        for x, y in zip(a.dataset_arrays(split), b.dataset_arrays(split)):
            np.testing.assert_array_equal(x, y)


def test_synthetic_batches_are_the_jax_ones():
    kw = dict(batch_size=4, n_replicas=2, maxlen=12, vocab=64, seed=5,
              n_train=40, n_val=20)
    a, b = imdb.ImdbData(**kw), jax_imdb.ImdbData(**kw)
    assert a.synthetic and b.synthetic
    assert_same_batches(a, b)
    with pytest.raises(ValueError, match="vocab >= 30"):
        imdb.ImdbData(vocab=20)


@pytest.mark.parametrize("layout", ["two_pickles", "one_tuple"])
def test_both_pkl_layouts_give_the_jax_batches(tmp_path, monkeypatch,
                                               layout):
    rng = np.random.default_rng(0)

    def split(n):
        xs = [rng.integers(1, 90, rng.integers(3, 20)).tolist()
              for _ in range(n)]
        return xs, rng.integers(0, 2, n).tolist()

    train, test = split(30), split(14)
    with open(tmp_path / "imdb.pkl", "wb") as f:
        if layout == "two_pickles":
            pickle.dump(train, f)
            pickle.dump(test, f)
        else:
            pickle.dump((train, test), f)
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path))
    kw = dict(batch_size=3, n_replicas=2, maxlen=10, vocab=64, seed=1)
    a, b = imdb.ImdbData(**kw), jax_imdb.ImdbData(**kw)
    assert not a.synthetic and not b.synthetic
    assert_same_batches(a, b)
    # ids past the vocab are the unknown id 1, reviews padded with 0
    x = a.dataset_arrays("train")[0]
    assert x.max() < 64 and (x == 1).any() and (x == imdb.PAD_ID).any()


# -- layers -------------------------------------------------------------------

def test_embedding_forward_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (4, 12)).astype(np.int32)
    ids[0, :5] = 7                       # repeated ids accumulate
    dy = rng.normal(size=(4, 12, 8)).astype(np.float32)
    jl = jax_rec.Embedding(64, 8)
    y0, vjp = jax.vjp(lambda p: jl.apply(p, {}, jnp.asarray(ids))[0],
                      {"w": jnp.asarray(w)})
    (g0,) = vjp(jnp.asarray(dy))
    pl = recurrent.Embedding(64, 8)
    pl.init(torch.Generator(), (12,))
    with torch.no_grad():
        pl.w.copy_(torch.from_numpy(w))
    y1 = pl(torch.from_numpy(ids))
    (g1,) = torch.autograd.grad(y1, pl.w, torch.from_numpy(dy))
    np.testing.assert_array_equal(y1.detach().numpy(), np.asarray(y0))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g0["w"]), atol=ATOL,
                               rtol=0)
    assert set(pl.jax_entries("params")) == {("w",)}


def lstm_pair(pool, rng, e=5, h=6, t=9):
    """The JAX layer's parameters (a forget bias 1 plus noise) copied
    into the port's layer."""
    jl = jax_rec.LSTM(h, pool=pool)
    params, _, shape = jl.init(jax.random.PRNGKey(1), (t, e))
    params = dict(params, b=params["b"] + jnp.asarray(
        0.1 * rng.normal(size=params["b"].shape), jnp.float32))
    pl = recurrent.LSTM(h, pool=pool)
    assert pl.init(torch.Generator(), (t, e)) == shape
    b0 = pl.b.detach().clone()
    assert b0[h:2 * h].eq(1).all() and b0[:h].eq(0).all()
    with torch.no_grad():
        for k in ("wx", "wh", "b"):
            getattr(pl, k).copy_(torch.from_numpy(np.array(params[k])))
    return jl, params, pl


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("pool", ["mean", "last", "seq"])
def test_lstm_forward_and_vjp_match_jax(pool, padded):
    rng = np.random.default_rng(2)
    jl, params, pl = lstm_pair(pool, rng)
    x = rng.normal(size=(3, 9, 5)).astype(np.float32)
    mask = None
    if padded:
        # row 1 padded after 4 steps, row 2 entirely padding (clamped
        # denominator)
        mask = np.ones((3, 9), np.float32)
        mask[1, 4:] = 0
        mask[2] = 0
    jm = None if mask is None else jnp.asarray(mask)
    y0, vjp = jax.vjp(
        lambda p, xx: jl.apply(p, {}, xx, mask=jm)[0], params,
        jnp.asarray(x))
    dy = rng.normal(size=y0.shape).astype(np.float32)
    gp0, gx0 = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_(True)
    y1 = pl(xt, mask=None if mask is None else torch.from_numpy(mask))
    assert tuple(y1.shape) == y0.shape
    grads = torch.autograd.grad(y1, [pl.wx, pl.wh, pl.b, xt],
                                torch.from_numpy(dy))
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(y0),
                               atol=ATOL, rtol=0)
    for k, g in zip(("wx", "wh", "b"), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(gp0[k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(gx0), atol=ATOL,
                               rtol=0)


def test_padded_steps_hold_the_state_in_bf16():
    """The cell carries h and c in the compute dtype, as the JAX scan
    does: in bf16 the pooled output ignores junk in padded steps, and
    stays within two bf16 ulps at its magnitude (outputs below 0.5:
    ulp 2**-8, so 4e-3) of the JAX bf16 result on the same inputs
    (measured: one ulp)."""
    rng = np.random.default_rng(4)
    jl, params, pl = lstm_pair("mean", rng)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    mask = np.ones((2, 9), np.float32)
    mask[0, 5:] = 0
    x2 = x.copy()
    x2[0, 5:] = 99.0
    outs = [pl(torch.from_numpy(a).bfloat16(), mask=torch.from_numpy(mask))
            for a in (x, x2)]
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])
    y0, _ = jl.apply(params, {}, jnp.asarray(x, jnp.bfloat16),
                     mask=jnp.asarray(mask))
    np.testing.assert_allclose(outs[0].float().detach().numpy(),
                               np.asarray(y0, np.float32), atol=4e-3,
                               rtol=0)
    assert np.abs(np.asarray(y0, np.float32)).max() < 0.5


# -- the model ----------------------------------------------------------------

def jax_and_port(cfg, n_replicas=1):
    jm = jax_lstm.LSTM(dict(cfg))
    jm.build_model(n_replicas=n_replicas)
    pm = LSTM(dict(cfg), device="cpu")
    pm.build_model(n_replicas=n_replicas)
    pm.restore_trees({"params": jax.device_get(jm.params),
                      "net_state": jax.device_get(jm.net_state),
                      "opt_state": jax.device_get(jm.opt_state)})
    return jm, pm


def test_model_logits_loss_and_gradients_match_jax():
    jm, pm = jax_and_port(CFG)
    assert {k for k in flat(jm.params)} == {
        "['embed']['w']", "['lstm']['wx']", "['lstm']['wh']",
        "['lstm']['b']", "['fc']['w']", "['fc']['b']"}
    assert pm.checkpoint_trees()["net_state"] == {}
    x, y = jm.data.train_batch(1)
    assert (x == imdb.PAD_ID).any()            # padded reviews

    def loss_fn(p):
        out, _ = jm.net.apply(p, jm.net_state, jm.prep_input(jnp.asarray(x)),
                              train=True, rng=jax.random.PRNGKey(0))
        return jax_xent(out, jnp.asarray(y)), out

    (l0, o0), g0 = jax.value_and_grad(loss_fn, has_aux=True)(jm.params)
    e0, _ = jm.net.apply(jm.params, jm.net_state, jnp.asarray(x))
    xt = pm.prep_input(torch.from_numpy(x))
    out = pm.net(xt, train=True, gen=torch.Generator())
    l1 = softmax_cross_entropy(out, torch.from_numpy(y))
    grads = torch.autograd.grad(l1, pm.params)
    with torch.no_grad():
        e1 = pm.net(xt)
    np.testing.assert_allclose(l1.item(), float(l0), rtol=LOSS_RTOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o0),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(e1.numpy(), np.asarray(e0), atol=ATOL, rtol=0)
    want = flat(g0)
    for (path, (_, layout)), g in zip(pm._params_at.items(), grads):
        np.testing.assert_allclose(to_jax_layout(g, layout),
                                   want[keystr(path)], atol=ATOL, rtol=0,
                                   err_msg=keystr(path))


def test_token_ids_stay_integers_to_the_table():
    """bf16 holds no 4999: ``prep_input`` keeps int32 ids, the stager
    does not cast them, and the device-resident train set keeps them
    integers too."""
    m = LSTM(dict(CFG, vocab=5000, compute_dtype="bfloat16"), device="cpu")
    x = torch.tensor([[4999, 257, 0]], dtype=torch.int32)
    out = m.prep_input(x)
    assert out.dtype == torch.int32 and out.tolist() == x.tolist()
    assert int(x.to(torch.bfloat16)[0, 0]) != 4999
    m.build_model()
    m.compile_iter_fns()
    xs, ys = m.put_batch(m.data.train_batch(0))
    assert xs.dtype == torch.int32 and ys.dtype == torch.int64
    np.testing.assert_array_equal(xs.numpy(), m.data.train_batch(0)[0][:4])
    cached = LSTM(dict(CFG, device_data_cache=True), device="cpu")
    cached.build_model()
    cached.compile_iter_fns()
    cx, cy = cached._device_cache
    assert cx.dtype == torch.int32 and cy.dtype == torch.int64
    np.testing.assert_array_equal(cx.numpy(),
                                  cached.data.dataset_arrays("train")[0])
    cached.data.shuffle(0)
    np.testing.assert_array_equal(cached._cached_batch(1)[0].numpy(),
                                  cached.data.train_batch(1)[0][:4])


# -- training -----------------------------------------------------------------

def write_init(directory, cfg, n_replicas=1):
    """The JAX model's initial state as the checkpoint both workers
    resume from (epoch -1: the run starts at epoch 0)."""
    model = jax_lstm.LSTM(dict(cfg))
    model.build_model(n_replicas=n_replicas)
    jax_save(directory, 0, {k: jax.device_get(v)
                            for k, v in model.checkpoint_trees().items()},
             {"epoch": -1, "lr": cfg["lr"]})


TRAIN = dict(CFG, n_train=32, n_val=8)


@pytest.fixture(scope="module")
def bsp_runs(tmp_path_factory):
    """One JAX BSP run (1 device, 8 steps, 2 val batches) from the init
    checkpoint, which it leaves behind with its epoch-0 checkpoint."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_DATA_DIR", str(d))
        init = tmp_path_factory.mktemp("lstm_init")
        write_init(init, TRAIN)
        run_dir = tmp_path_factory.mktemp("lstm_jax")
        shutil.copytree(init, run_dir, dirs_exist_ok=True)
        out = jax_worker.run(
            devices=[0], modelfile="theanompi_tpu.models.lstm",
            modelclass="LSTM", config=TRAIN, n_epochs=1,
            checkpoint_dir=str(run_dir), resume=True, verbose=False)
    model = out["model"]
    return {"init": init, "jax_dir": run_dir,
            "losses": out["recorder"].train_losses, "val": out["final_val"],
            "trees": {g: flat(t) for g, t in model.checkpoint_trees().items()}}


def test_bsp_one_rank_matches_the_jax_worker(bsp_runs, tmp_path):
    shutil.copytree(bsp_runs["init"], tmp_path, dirs_exist_ok=True)
    out = port_worker.run(devices=["cpu"], config=TRAIN, n_epochs=1,
                          checkpoint_dir=str(tmp_path), resume=True,
                          verbose=False, **LSTM_MODEL)
    losses = out["recorder"].train_losses
    assert out["resumed_from"] == [-1, None] and len(losses) == 8
    np.testing.assert_allclose(losses, bsp_runs["losses"], rtol=LOSS_RTOL,
                               atol=0)
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(out["final_val"][key],
                                   bsp_runs["val"][key], rtol=1e-5)
    got = {g: tree_to_flat(t)
           for g, t in out["model"].checkpoint_trees().items()}
    for group in ("params", "opt_state"):
        assert set(got[group]) == set(bsp_runs["trees"][group])
        for k, v in bsp_runs["trees"][group].items():
            np.testing.assert_allclose(got[group][k], v, atol=ATOL, rtol=0,
                                       err_msg=f"{group}{k}")


def test_port_checkpoint_loads_into_the_jax_model(tmp_path):
    out = port_worker.run(devices=["cpu"], config=TRAIN, n_epochs=1,
                          checkpoint_dir=str(tmp_path), verbose=False,
                          **LSTM_MODEL)
    jm = jax_lstm.LSTM(dict(TRAIN))
    jm.build_model()
    assert jm.load(str(tmp_path))
    assert jm.epoch == 0
    want = {g: tree_to_flat(t)
            for g, t in out["model"].checkpoint_trees().items()}
    for group in ("params", "opt_state"):
        got = flat(getattr(jm, group))
        assert set(got) == set(want[group])
        for k in got:
            np.testing.assert_array_equal(got[k], want[group][k])


def test_jax_checkpoint_resumes_in_the_port(bsp_runs, tmp_path):
    """The JAX run's epoch-0 checkpoint restores bitwise, and a second
    epoch trains from it."""
    shutil.copytree(bsp_runs["jax_dir"], tmp_path, dirs_exist_ok=True)
    model = LSTM(dict(TRAIN), device="cpu")
    model.build_model()
    assert model.load(str(tmp_path)) and model.epoch == 0
    got = {g: tree_to_flat(t) for g, t in model.checkpoint_trees().items()}
    for group in ("params", "opt_state"):
        for k, v in bsp_runs["trees"][group].items():
            np.testing.assert_array_equal(got[group][k], v)
    out = port_worker.run(devices=["cpu"], config=TRAIN, n_epochs=2,
                          checkpoint_dir=str(tmp_path), resume=True,
                          verbose=False, **LSTM_MODEL)
    assert out["resumed_from"] == [0, None] and out["epochs"] == 2
    assert all(np.isfinite(out["recorder"].train_losses))
