"""Training parity with the JAX package: the fused LM heads, the
optimizers, checkpoints in both directions, and the port's Llama
trained by its ``bsp_worker.run`` against the JAX package's, from the
same initial parameters and the same ``MarkovLMData`` batches.

The JAX initial state (parameters and fresh Adam moments) is written
as a JAX checkpoint stamped ``epoch -1``; both workers resume from a
copy of it, so epoch 0 of each starts from bitwise-equal state (this
is also the JAX -> port checkpoint crossing).  One rank here against a
1-device JAX CPU mesh, two gloo processes against a 2-device data mesh.

Tolerances: fp32 throughout; the frameworks sum in different orders
(matmuls, the loss mean, the softmax), so gradients differ by float
rounding, ~1e-7 relative.  Adam's update lr*m/(sqrt(v)+eps) passes
that on, amplified where |g| ~ eps.  Over 8 steps at lr 1e-2 the
losses differ by at most 1.3e-7 relative and the parameters by 3.8e-6
(measured); the tests hold them to rtol 1e-6 and atol 1e-5 (a
thousandth of one Adam step).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.ops import optimizers as jax_opt
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.parallel import tp as jax_tp
from theanompi_tpu.utils import Recorder as JaxRecorder
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch import BSP
from theanompi_tpu_torch.models.llama import params_to_jax
from theanompi_tpu_torch.ops import optimizers as port_opt
from theanompi_tpu_torch.parallel import tp as port_tp
from theanompi_tpu_torch.utils import checkpoint as port_ckpt
from theanompi_tpu_torch.workers import bsp_worker as port_worker

CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=16, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, lr=1e-2, optimizer="adam",
           exch_strategy="ici32")
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# -- the fused heads --------------------------------------------------------------

HEAD_ATOL = 1e-5       # fp32, summation order only


def head_inputs(seed, n=24, d=16, v=96):
    rng = np.random.default_rng(seed)
    x2 = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, size=n).astype(np.int32)
    c = rng.normal(size=n).astype(np.float32)    # loss-vector cotangent
    return x2, w, labels, c


def jax_head(x2, w, labels, c, n_chunks):
    def f(x2, w):
        if n_chunks > 1:
            lv, pred = jax_tp.chunked_unembed_xent(
                x2, w, jnp.asarray(labels), w.shape[1], n_chunks, None)
        else:
            lv, pred = jax_tp.dense_unembed_xent(
                x2, w, jnp.asarray(labels), w.shape[1], None)
        return jnp.sum(lv * c), (lv, pred)

    (_, (lv, pred)), (dx, dw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x2), jnp.asarray(w))
    return [np.asarray(a) for a in (lv, pred, dx, dw)]


def port_head(x2, w, labels, c, n_chunks):
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x2, w))
    y = torch.from_numpy(labels)
    if n_chunks > 1:
        lv, pred = port_tp.chunked_unembed_xent(tx, tw, y, w.shape[1],
                                                n_chunks)
    else:
        lv, pred = port_tp.dense_unembed_xent(tx, tw, y, w.shape[1])
    (lv * torch.from_numpy(c)).sum().backward()
    return [a.detach().numpy() for a in (lv, pred, tx.grad, tw.grad)]


@pytest.mark.parametrize("n_chunks", [1, 4, 6])
def test_heads_match_jax_custom_vjps(n_chunks):
    """Loss vector, argmax and both gradients: the dense head
    (n_chunks 1) against ``dense_unembed_xent``, the chunked head
    against ``chunked_unembed_xent``."""
    x2, w, labels, c = head_inputs(n_chunks)
    got = port_head(x2, w, labels, c, n_chunks)
    want = jax_head(x2, w, labels, c, n_chunks)
    for name, a, b in zip(("loss_vec", "pred", "dx", "dw"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=HEAD_ATOL, rtol=0,
                                   err_msg=name)


def test_pick_xent_chunks_matches_jax():
    for v in (256, 8192, 8193, 32000, 65536, 128256):
        assert port_tp.pick_xent_chunks(v) == jax_tp.pick_xent_chunks(v)
    assert port_tp.pick_xent_chunks(128256) == 24   # the Llama-3 head


def test_val_metrics_match_jax():
    """Val loss, top-1 and top-5 error at tp=1 (inside a one-device
    shard_map, where the JAX functions find their model axis)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=(3, 5)).astype(np.int32)
    labels[0, 0] = 40                                # out of range: miss
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels).long()
    mesh = make_mesh(data=1, devices=jax.devices("cpu")[:1])
    for port_fn, jax_fn in (
        (port_tp.sharded_softmax_xent, jax_tp.sharded_softmax_xent),
        (port_tp.sharded_top1_err, jax_tp.sharded_top1_err),
        (lambda a, b, v: port_tp.sharded_topk_err(a, b, v, k=5),
         lambda a, b, v: jax_tp.sharded_topk_err(a, b, v, k=5)),
    ):
        want = jax.shard_map(lambda a, b: jax_fn(a, b, 40), mesh=mesh,
                             in_specs=(P(), P()), out_specs=P(),
                             check_vma=False)(logits, labels)
        np.testing.assert_allclose(float(port_fn(tl, ty, 40)), float(want),
                                   atol=1e-6)


# -- optimizers --------------------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 5e-4])
@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam"])
def test_optimizers_match_jax_over_three_updates(name, wd):
    """Parameters and state after 3 updates from the same params and
    gradients; fp32, atol 1e-7 (elementwise forms, identical operation
    order; a last-ulp difference in pow or sqrt at most)."""
    rng = np.random.default_rng(len(name))
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jo = jax_opt.get(name, weight_decay=wd)
    po = port_opt.get(name, weight_decay=wd)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    tp_ = [torch.from_numpy(p.copy()) for p in params]
    ts = po.init(tp_)
    for step, g in enumerate(grads):
        lr = 0.05 / (step + 1)
        jp, js = jo.update(jp, [jnp.asarray(x) for x in g], js,
                           jnp.float32(lr))
        ts = po.update(tp_, [torch.from_numpy(x) for x in g], ts, lr)
    for a, b in zip(tp_, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=0)
    if name == "adam":
        assert int(ts["t"]) == int(js["t"]) == 3
        for key in ("m", "v"):
            for a, b in zip(ts[key], js[key]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-7, rtol=0)
    elif name != "sgd":
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                       rtol=0)


def write_init(directory, cfg, n_dev):
    """The JAX model's initial params + optimizer state as a checkpoint
    both workers resume from (epoch -1: the run starts at epoch 0)."""
    model = JaxLlama(cfg)
    model.build_model(n_replicas=n_dev)
    model.compile_iter_fns(
        mesh=make_mesh(data=n_dev, devices=jax.devices("cpu")[:n_dev]))
    jax_save(directory, 0, {"params": jax.device_get(model.params),
                            "opt_state": jax.device_get(model.opt_state)},
             {"epoch": -1, "lr": cfg["lr"]})


def jax_run(tmp, cfg, n_dev, n_epochs=1):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.llama",
        modelclass="Llama", config=cfg, n_epochs=n_epochs,
        checkpoint_dir=str(tmp), resume=True, verbose=False)
    return (out["recorder"].train_losses,
            leaves(jax.device_get(out["model"].params)), out["final_val"])


def port_run(tmp, cfg, n_epochs=1, resume=True):
    return port_worker.run(
        devices=["cpu"], modelfile="theanompi_tpu_torch.models.llama",
        modelclass="Llama", config=cfg, n_epochs=n_epochs,
        checkpoint_dir=str(tmp), resume=resume, verbose=False)


def port_leaves(model):
    return leaves(params_to_jax(model.params))


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    out = {}
    for n_dev in (1, 2):
        d = tmp_path_factory.mktemp(f"init{n_dev}")
        write_init(d, dict(CFG, batch_size=CFG["batch_size"] // n_dev),
                   n_dev)
        out[n_dev] = d
    return out


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    return {n: tmp_path_factory.mktemp(f"jax{n}") for n in (1, 2)}


@pytest.fixture(scope="module")
def jax_ref(init_dir, jax_dirs):
    """The JAX trajectories: 1 device (batch 4), 2 devices (batch 2
    each, the same global batch of 4); each leaves its epoch-0
    checkpoint in ``jax_dirs``."""
    out = {}
    for n_dev in (1, 2):
        d = jax_dirs[n_dev]
        shutil.copytree(init_dir[n_dev], d, dirs_exist_ok=True)
        out[n_dev] = jax_run(
            d, dict(CFG, batch_size=CFG["batch_size"] // n_dev), n_dev)
    return out


def assert_same_run(losses, params, want, n_steps=8):
    want_losses, want_params, _ = want
    assert len(losses) == len(want_losses) == n_steps
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=0)
    assert len(params) == len(want_params)
    for got, ref in zip(params, want_params):
        np.testing.assert_allclose(got, ref, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("bucket_mb", [0, 4, 0.01])
def test_one_rank_matches_jax(jax_ref, init_dir, tmp_path, bucket_mb):
    """exchange_bucket_mb 0 and 4 are the monolithic path at this size;
    0.01 MiB cuts the model into 9 buckets."""
    shutil.copytree(init_dir[1], tmp_path, dirs_exist_ok=True)
    out = port_run(tmp_path, dict(CFG, exchange_bucket_mb=bucket_mb))
    assert out["resumed_from"] == [-1, None] and out["iterations"] == 8
    assert_same_run(out["recorder"].train_losses, port_leaves(out["model"]),
                    jax_ref[1])
    got_val, want_val = out["final_val"], jax_ref[1][2]
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(got_val[key], want_val[key], rtol=1e-5)


@pytest.mark.parametrize("strategy,bucket_mb", [("ici32", 0.01),
                                                ("asa32", 0)])
def test_two_gloo_ranks_match_jax_two_device_mesh(jax_ref, init_dir,
                                                  tmp_path, strategy,
                                                  bucket_mb):
    """Two processes launched by ``BSP().init`` (one per "cpu" device,
    a gloo group), each taking its half of every global batch; the
    per-step losses and final parameters come back through the
    checkpoint rank 0 writes."""
    shutil.copytree(init_dir[2], tmp_path, dirs_exist_ok=True)
    rule = BSP()
    rule.init(devices=["cpu", "cpu"],
              modelfile="theanompi_tpu_torch.models.llama",
              modelclass="Llama",
              config=dict(CFG, batch_size=2, exch_strategy=strategy,
                          exchange_bucket_mb=bucket_mb),
              n_epochs=1, checkpoint_dir=str(tmp_path), resume=True,
              verbose=False)
    assert rule.wait() == 0
    _, trees, meta = port_ckpt.load_latest(tmp_path,
                                           ("params", "opt_state"))
    assert meta["epoch"] == 0 and meta["world_size"] == 2
    assert meta["global_batch"] == 4
    assert_same_run(meta["recorder"]["train_losses"],
                    leaves(trees["params"]), jax_ref[2])


# -- checkpoints across the packages ------------------------------------------------

def test_port_checkpoint_loads_into_jax_llama(tmp_path):
    """A port run's checkpoint (seeded init, one epoch) restores into
    the JAX ``Llama.load``: same parameters bitwise, the Adam state and
    step count, the epoch, lr and recorder history, and the same val
    metrics from the JAX val step."""
    out = port_run(tmp_path, CFG, resume=False)
    model = JaxLlama(CFG)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(
        mesh=make_mesh(data=1, devices=jax.devices("cpu")[:1]))
    rec = JaxRecorder(verbose=False)
    assert model.load(str(tmp_path), rec)
    assert model.epoch == 0 and model.current_lr == CFG["lr"]
    assert rec.train_losses == out["recorder"].train_losses
    for a, b in zip(leaves(jax.device_get(model.params)),
                    port_leaves(out["model"])):
        assert np.array_equal(a, b)
    assert int(model.opt_state["t"]) == 8
    vals = [model.val_iter(j, rec) for j in range(model.data.n_batch_val)]
    got = out["final_val"]
    for i, key in enumerate(("loss", "err", "err_top5")):
        np.testing.assert_allclose(np.mean([v[i] for v in vals]), got[key],
                                   rtol=1e-5)


def test_jax_checkpoint_resumes_in_the_port(jax_ref, jax_dirs, tmp_path,
                                            tmp_path_factory):
    """The JAX run's end-of-epoch-0 checkpoint (params, Adam state,
    recorder) resumes in the port for epoch 1, on the trajectory the
    JAX worker takes when it resumes from the same checkpoint."""
    shutil.copytree(jax_dirs[1], tmp_path, dirs_exist_ok=True)
    jax_dir = tmp_path_factory.mktemp("jax_resume")
    shutil.copytree(jax_dirs[1], jax_dir, dirs_exist_ok=True)
    want = jax_run(jax_dir, CFG, 1, n_epochs=2)
    out = port_run(tmp_path, CFG, n_epochs=2)
    assert out["resumed_from"] == [0, None] and out["epochs"] == 2
    assert_same_run(out["recorder"].train_losses, port_leaves(out["model"]),
                    want, n_steps=16)
