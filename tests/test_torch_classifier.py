"""The image-classifier path of the port against the JAX package: the
data modules, ResNet-50 and AlexNet step math, WResNet trained by both
BSP workers from one JAX-written initial checkpoint (one rank against a
1-device mesh, two gloo processes against a 2-device mesh), and
checkpoints in both directions.

Tolerances (fp32 throughout; the frameworks round convolutions, channel
reductions and the loss mean in different orders):

- WResNet-10-1 trajectories (8 momentum steps at lr 0.02): losses
  within ``LOSS_RTOL``, parameters, momentum and BN running statistics
  within ``PARAM_ATOL`` (measured at most 8.4e-6 and 1.2e-4, on one
  rank; 1.1e-7 and 1.7e-6 on two, 2e-7 and 7e-6 resumed).  The rate is
  kept at 0.02 because at 0.05 the trajectory itself is sensitive past
  any tolerance: a 1e-7 relative perturbation of the port's initial
  parameters moves its own parameters by 5e-4 within 8 steps.
- ResNet-50 (crop 64, batch 4, train mode, BN scales drawn so every
  residual branch is live): loss within 1e-5 relative, logits and the
  updated BN statistics within 1e-4.  Its gradients are held in
  relative L2 norm, ``RESNET_GRAD_REL`` over the whole tree and
  ``RESNET_LEAF_REL`` per leaf: on these inputs fp32 rounding alone
  moves them that far — ``jax.jit(jax.grad)`` and the eager
  ``jax.grad`` of the same JAX function differ by 1.3e-3 over the tree
  and 3% on their worst leaf.
- AlexNet (crop 64, eval): logits and gradients within 1e-5.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theanompi_tpu.models import alex_net as jax_alex
from theanompi_tpu.models import resnet50 as jax_resnet
from theanompi_tpu.models import wresnet as jax_wresnet
from theanompi_tpu.models.data import cifar10 as jax_cifar
from theanompi_tpu.models.data import imagenet as jax_imagenet
from theanompi_tpu.models.data import synthetic as jax_synthetic
from theanompi_tpu.native import read_tmb as jax_read_tmb
from theanompi_tpu.ops.layers import softmax_cross_entropy as jax_xent
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils import Recorder as JaxRecorder
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.data import cifar10, imagenet, synthetic
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.models.wresnet import WResNet
from theanompi_tpu_torch.native import read_tmb, write_tmb
from theanompi_tpu_torch.ops.layers import softmax_cross_entropy, to_jax_layout
from theanompi_tpu_torch.utils.checkpoint import keystr, tree_to_flat
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(depth=10, widen=1, batch_size=8, n_train=64, n_val=16,
           compute_dtype="float32", seed=3, lr=0.02, exch_strategy="ici32")
WRN = dict(modelfile="theanompi_tpu_torch.models.wresnet",
           modelclass="WResNet")
LOSS_RTOL = 5e-5
PARAM_ATOL = 5e-4
RESNET_GRAD_REL = 5e-3
RESNET_LEAF_REL = 0.1


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


def cpu_mesh(n):
    return make_mesh(data=n, devices=jax.devices("cpu")[:n])


# -- data modules ---------------------------------------------------------------

def assert_batches_equal(a, b, n_train, n_val, epochs=(0, 1)):
    assert (a.n_batch_train, a.n_batch_val) == (n_train, n_val)
    assert (b.n_batch_train, b.n_batch_val) == (n_train, n_val)
    for epoch in epochs:
        a.shuffle(epoch)
        b.shuffle(epoch)
        for i in range(n_train):
            for x, y in zip(a.train_batch(i), b.train_batch(i)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for i in range(n_val):
        for x, y in zip(a.val_batch(i), b.val_batch(i)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_synthetic_cifar_and_imagenet_batches_are_the_jax_ones():
    kw = dict(n_train=48, n_val=16, noise=0.3, label_noise=0.25, seed=5)
    assert_batches_equal(
        synthetic.SyntheticClassData((6, 6, 3), 7, 8, 2, **kw),
        jax_synthetic.SyntheticClassData((6, 6, 3), 7, 8, 2, **kw), 3, 1)
    kw = dict(batch_size=4, n_replicas=2, seed=2, n_train=32, n_val=16)
    assert_batches_equal(cifar10.Cifar10Data(**kw),
                         jax_cifar.Cifar10Data(**kw), 4, 2)
    kw = dict(batch_size=2, n_replicas=1, crop=24, seed=1, n_train=6, n_val=4)
    assert_batches_equal(imagenet.ImageNetData(**kw),
                         jax_imagenet.ImageNetData(**kw), 3, 2)


def test_real_cifar_files_give_the_jax_batches(tmp_path, monkeypatch):
    """The pickle path with its standardization and the aug_rng crop and
    flip draws."""
    import pickle

    rng = np.random.default_rng(0)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (8, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 8).tolist()}, f)
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path))
    kw = dict(batch_size=4, n_replicas=2, seed=4, label_noise=0.1)
    port, ref = cifar10.Cifar10Data(**kw), jax_cifar.Cifar10Data(**kw)
    assert not port.synthetic
    assert_batches_equal(port, ref, 5, 1)


def test_tmb_files_round_trip_and_give_the_jax_batches(tmp_path,
                                                       monkeypatch):
    """``write_tmb``/``read_tmb`` round trip, a port-written file read by
    the JAX reader, and the ImageNet module over ``.tmb`` files (crop,
    flip, the uint8 wire and its ``device_mean``; the JAX module on its
    Python prefetch path) against the JAX module's batches."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (4, 12, 12, 3), dtype=np.uint8)
    y = rng.integers(0, 1000, 4).astype(np.int32)
    write_tmb(tmp_path / "one.tmb", x, y)
    for reader in (read_tmb, jax_read_tmb):
        got_x, got_y = reader(tmp_path / "one.tmb")
        np.testing.assert_array_equal(np.asarray(got_x), x)
        np.testing.assert_array_equal(got_y, y)
    with pytest.raises(ValueError, match="uint8"):
        write_tmb(tmp_path / "bad.tmb", x.astype(np.float32) + 0.5, y)

    for split, n in (("train", 12), ("val", 4)):
        imagenet.write_batch_files(
            tmp_path, rng.integers(0, 256, (n, 12, 12, 3), dtype=np.uint8),
            rng.integers(0, 1000, n).astype(np.int32), 4, split=split)
    np.save(tmp_path / "imagenet_batches" / "img_mean.npy",
            rng.uniform(100, 150, (1, 12, 12, 3)).astype(np.float32))
    monkeypatch.setenv("TM_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("TM_NATIVE", "0")
    kw = dict(batch_size=2, n_replicas=2, crop=8, seed=3)
    port, ref = imagenet.ImageNetData(**kw), jax_imagenet.ImageNetData(**kw)
    assert not port.synthetic
    np.testing.assert_array_equal(port.device_mean, ref.device_mean)
    assert_batches_equal(port, ref, 3, 1)


# -- step math of the ImageNet models ------------------------------------------

def jax_and_port(jax_cls, port_cls, cfg, perturb=None, seed=0):
    """The JAX model's parameters (``perturb``ed) and BN state copied
    into the port's model built from the same config."""
    jm = jax_cls(dict(cfg))
    jm.build_model()
    rng = np.random.default_rng(seed)
    params = jm.params
    if perturb is not None:
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: perturb(jax.tree_util.keystr(p), v, rng), params)
    pm = port_cls(dict(cfg), device="cpu")
    pm.build_model()
    pm.restore_trees({"params": jax.device_get(params),
                      "net_state": jax.device_get(jm.net_state),
                      "opt_state": jax.device_get(jm.opt_state)})
    x = rng.normal(size=(4, cfg["crop"], cfg["crop"], 3)).astype(np.float32)
    y = rng.integers(0, 1000, 4).astype(np.int32)
    return jm, params, pm, x, y


def step_math(jm, params, pm, x, y, train):
    """(loss, logits, grads, new BN state) of both packages, the JAX
    ones first, grads and state as flat JAX-layout maps."""
    def loss_fn(p):
        out, ns = jm.net.apply(p, jm.net_state, jnp.asarray(x), train=train)
        return jax_xent(out, jnp.asarray(y)), (out, ns)

    (loss, (logits, ns)), g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = (float(loss), np.asarray(logits), flat(g), flat(ns))
    out = pm.net(pm.prep_input(torch.from_numpy(x)), train=train)
    tloss = softmax_cross_entropy(out, torch.from_numpy(y))
    grads = torch.autograd.grad(tloss, pm.params)
    got = (tloss.item(), out.detach().numpy(),
           {keystr(p): to_jax_layout(t, lay) for (p, (_, lay)), t
            in zip(pm._params_at.items(), grads)},
           flat(pm.checkpoint_trees()["net_state"]))
    return want, got


def resnet_perturb(key, v, rng):
    """BN scales and offsets drawn so every residual branch is live (the
    init zeroes each block's last BN scale)."""
    if key.endswith("['scale']"):
        std, mean = (0.2, 0.0) if "bn3" in key else (0.1, 1.0)
        return jnp.asarray(mean + std * rng.normal(size=v.shape), jnp.float32)
    if key.endswith("['offset']"):
        return jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
    return v


def test_resnet50_train_step_math_matches_jax():
    """Train-mode forward, loss, gradients and the updated BN statistics
    at crop 64; this covers the JAX package's space-to-depth stem (the
    port's plain strided conv) and the asymmetric 'SAME' stem pool."""
    cfg = dict(crop=64, batch_size=4, compute_dtype="float32")
    jm, params, pm, x, y = jax_and_port(jax_resnet.ResNet50, ResNet50, cfg,
                                        resnet_perturb)
    assert jm.net.layers[0].s2d
    (l0, o0, g0, s0), (l1, o1, g1, s1) = step_math(jm, params, pm, x, y,
                                                   train=True)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(o1, o0, atol=1e-4, rtol=0)
    assert set(s1) == set(s0) and len(s0) == 2 * 53
    for k in s0:
        np.testing.assert_allclose(s1[k], s0[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert set(g1) == set(g0) and len(g0) == 161
    num = den = 0.0
    for k in g0:
        d2, n2 = float(((g1[k] - g0[k]) ** 2).sum()), float((g0[k] ** 2).sum())
        num, den = num + d2, den + n2
        assert d2 <= RESNET_LEAF_REL ** 2 * n2, k
    assert num <= RESNET_GRAD_REL ** 2 * den, (num / den) ** 0.5


def test_alexnet_eval_forward_and_gradient_match_jax():
    cfg = dict(crop=64, batch_size=4, compute_dtype="float32")
    jm, params, pm, x, y = jax_and_port(jax_alex.AlexNet, AlexNet, cfg)
    (l0, o0, g0, _), (l1, o1, g1, _) = step_math(jm, params, pm, x, y,
                                                 train=False)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(o1, o0, atol=1e-5, rtol=1e-5)
    assert set(g1) == set(g0) and len(g0) == 16
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


# -- WResNet under both BSP workers ----------------------------------------------

def write_init(directory, cfg, n_dev):
    """The JAX model's initial state as a checkpoint both workers resume
    from (epoch -1: the run starts at epoch 0)."""
    model = jax_wresnet.WResNet(cfg)
    model.build_model(n_replicas=n_dev)
    model.compile_iter_fns(mesh=cpu_mesh(n_dev))
    jax_save(directory, 0, {k: jax.device_get(v)
                            for k, v in model.checkpoint_trees().items()},
             {"epoch": -1, "lr": cfg["lr"]})


def jax_run(directory, cfg, n_dev, n_epochs=1):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.wresnet",
        modelclass="WResNet", config=cfg, n_epochs=n_epochs,
        checkpoint_dir=str(directory), resume=True, verbose=False)
    model = out["model"]
    return {"losses": out["recorder"].train_losses, "val": out["final_val"],
            "trees": {g: flat(t) for g, t in model.checkpoint_trees().items()}}


def port_trees(model):
    return {g: tree_to_flat(t) for g, t in model.checkpoint_trees().items()}


def assert_same_run(got, want, n_steps=8):
    assert len(got["losses"]) == len(want["losses"]) == n_steps
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               atol=0)
    for group in ("params", "net_state", "opt_state"):
        g, w = got["trees"][group], want["trees"][group]
        assert set(g) == set(w), group
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{group}{k}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Init checkpoints, and the JAX runs on 1 device (batch 8) and 2
    devices (batch 4 each: the same global batch), each leaving its
    epoch-0 checkpoint behind."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    out = {"init": {}, "jax_dir": {}, "jax": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_DATA_DIR", str(d))
        for n in (1, 2):
            cfg = dict(CFG, batch_size=CFG["batch_size"] // n)
            init = tmp_path_factory.mktemp(f"wrn_init{n}")
            write_init(init, cfg, n)
            run_dir = tmp_path_factory.mktemp(f"wrn_jax{n}")
            shutil.copytree(init, run_dir, dirs_exist_ok=True)
            out["init"][n], out["jax_dir"][n] = init, run_dir
            out["jax"][n] = jax_run(run_dir, cfg, n)
    return out


def test_one_rank_matches_the_jax_worker(runs, tmp_path):
    shutil.copytree(runs["init"][1], tmp_path, dirs_exist_ok=True)
    out = port_worker.run(devices=["cpu"], config=CFG, n_epochs=1,
                          checkpoint_dir=str(tmp_path), resume=True,
                          verbose=False, **WRN)
    assert out["resumed_from"] == [-1, None] and out["iterations"] == 8
    assert_same_run({"losses": out["recorder"].train_losses,
                     "trees": port_trees(out["model"])}, runs["jax"][1])
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(out["final_val"][key],
                                   runs["jax"][1]["val"][key], rtol=1e-4)


CHILD = """
import json, sys
import numpy as np
from theanompi_tpu_torch.utils.checkpoint import tree_to_flat
from theanompi_tpu_torch.workers import bsp_worker
spec = json.loads(sys.argv[1])
path = spec.pop("out")
res = bsp_worker.run(**spec)
arrays = {"losses": np.asarray(res["recorder"].train_losses)}
for group, tree in res["model"].checkpoint_trees().items():
    for k, v in tree_to_flat(tree).items():
        arrays[group + ":" + k] = v
np.savez(path, **arrays)
"""


def test_two_gloo_ranks_match_the_jax_two_device_mesh(runs, tmp_path):
    """``bsp_worker.run`` in two processes of one gloo group, each
    taking its half of every global batch: both ranks end on the JAX
    2-device trajectory, with equal BN running statistics (averaged
    over the ranks every step) and equal parameters."""
    ckpt_dir = tmp_path / "ckpt"
    shutil.copytree(runs["init"][2], ckpt_dir)
    port = 29500 + os.getpid() % 2000
    procs = []
    for rank in range(2):
        spec = dict(devices=["cpu", "cpu"], rank=rank, world_size=2,
                    init_method=f"tcp://localhost:{port}",
                    config=dict(CFG, batch_size=4), n_epochs=1,
                    checkpoint_dir=str(ckpt_dir), resume=True,
                    verbose=False, out=str(tmp_path / f"rank{rank}.npz"),
                    **WRN)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, json.dumps(spec)], env=env))
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    ranks = []
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            trees = {}
            for name in z.files:
                if name != "losses":
                    group, key = name.split(":", 1)
                    trees.setdefault(group, {})[key] = z[name]
            ranks.append({"losses": list(z["losses"]), "trees": trees})
    for got in ranks:
        assert_same_run(got, runs["jax"][2])
    for group in ("net_state", "params"):
        for k, v in ranks[0]["trees"][group].items():
            np.testing.assert_array_equal(ranks[1]["trees"][group][k], v)


# -- checkpoints across the packages ---------------------------------------------

def test_port_checkpoint_loads_into_jax_wresnet(tmp_path):
    """A port run's checkpoint (seeded init, one epoch) restores into
    the JAX ``WResNet.load``: parameters, BN statistics and momentum
    bitwise, epoch, lr and recorder history, and the same val metrics
    from the JAX val step."""
    out = port_worker.run(devices=["cpu"], config=CFG, n_epochs=1,
                          checkpoint_dir=str(tmp_path), verbose=False, **WRN)
    model = jax_wresnet.WResNet(CFG)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=cpu_mesh(1))
    rec = JaxRecorder(verbose=False)
    assert model.load(str(tmp_path), rec)
    assert model.epoch == 0 and model.current_lr == CFG["lr"]
    assert rec.train_losses == out["recorder"].train_losses
    want = port_trees(out["model"])
    for group, tree in model.checkpoint_trees().items():
        got = flat(tree)
        assert set(got) == set(want[group]), group
        for k, v in got.items():
            assert np.array_equal(v, want[group][k]), (group, k)
    vals = [model.val_iter(j, rec) for j in range(model.data.n_batch_val)]
    for i, key in enumerate(("loss", "err", "err_top5")):
        np.testing.assert_allclose(np.mean([v[i] for v in vals]),
                                   out["final_val"][key], rtol=1e-5)


def test_jax_checkpoint_resumes_in_the_port(runs, tmp_path,
                                            tmp_path_factory):
    """The JAX run's end-of-epoch-0 checkpoint (trained parameters, BN
    statistics, momentum, recorder) resumes in the port for epoch 1, on
    the trajectory the JAX worker takes from the same checkpoint."""
    shutil.copytree(runs["jax_dir"][1], tmp_path, dirs_exist_ok=True)
    jax_dir = tmp_path_factory.mktemp("wrn_jax_resume")
    shutil.copytree(runs["jax_dir"][1], jax_dir, dirs_exist_ok=True)
    want = jax_run(jax_dir, CFG, 1, n_epochs=2)
    out = port_worker.run(devices=["cpu"], config=CFG, n_epochs=2,
                          checkpoint_dir=str(tmp_path), resume=True,
                          verbose=False, **WRN)
    assert out["resumed_from"] == [0, None] and out["epochs"] == 2
    assert_same_run({"losses": out["recorder"].train_losses,
                     "trees": port_trees(out["model"])}, want, n_steps=16)


# -- entry points and refusals ---------------------------------------------------

TINY = dict(batch_size=2, n_train=2, n_val=2, compute_dtype="float32")


def test_entry_points_train_on_the_cpu_and_want_the_card_by_default(
        monkeypatch, tmp_path):
    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.launcher import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSP().init(launch="inprocess", config=CFG, **WRN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["BSP", "theanompi_tpu_torch.models.resnet50", "ResNet50",
              "--kwargs", '{"n_epochs": 1}'])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet50(TINY)

    rule = BSP()
    rule.init(devices=["cpu"], launch="inprocess", config=CFG, n_epochs=1,
              verbose=False, **WRN)
    out = rule.wait()
    assert out["device"] == "cpu" and out["iterations"] == 8
    assert all(np.isfinite(out["recorder"].train_losses))
    assert main(["BSP", "theanompi_tpu_torch.models.resnet50", "ResNet50",
                 "--devices", "cpu", "--kwargs", json.dumps({
                     "config": dict(TINY, crop=32), "n_epochs": 1,
                     "verbose": False, "checkpoint_dir": str(tmp_path)})]) == 0
    assert (tmp_path / "ckpt_0.npz").exists()


@pytest.mark.parametrize("model,config,error,match", [
    (WResNet, dict(loader_pipeline=1), ValueError, "at least 2 ring slots"),
    (WResNet, dict(steps_per_call=4), NotImplementedError, "A7"),
    (WResNet, dict(device_data_cache=True, steps_per_call=4),
     NotImplementedError, "A7"),
])
def test_unported_knobs_raise(model, config, error, match):
    with pytest.raises(error, match=match):
        model(dict(TINY, **config), device="cpu")


def test_classifiers_take_the_trace_and_profile_knobs(tmp_path):
    """``trace`` and ``step_profile`` run through the classifiers' BSP as
    through the Llama's: the JAX worker's leg names and span count on
    the same config, coverage within JAX's bar, and the iteration spans
    and the profile's counter track in the export."""
    cfg = dict(CFG, trace=True, trace_sample=2, step_profile=True)
    want = jax_worker.run(devices=[0], modelfile="theanompi_tpu.models."
                          "wresnet", modelclass="WResNet", config=cfg,
                          n_epochs=1, verbose=False)
    export = tmp_path / "trace.json"
    out = port_worker.run(devices=["cpu"], n_epochs=1, verbose=False,
                          config=dict(cfg, trace_export=str(export)), **WRN)
    prof = out["step_profile"]
    assert "error" not in prof
    # the port's mean of the loss and error over the ranks is a
    # collective of its own outside the exchange's range, so it files
    # under exchange_other; JAX's trace holds one collective, inside
    # exchange_b0
    jax_legs = list(want["step_profile"]["legs"])
    assert "exchange_other" not in jax_legs
    assert list(prof["legs"]) == jax_legs[:-1] + ["exchange_other",
                                                  "host_gap"]
    assert "optimizer" in prof["legs"] and "exchange_b0" in prof["legs"]
    assert 0.95 <= prof["coverage"] <= 1.05
    assert prof["step_flops"] > 0
    assert out["trace_spans"] == want["trace_spans"]
    names = {e.get("name") for e in json.loads(export.read_text())[
        "traceEvents"]}
    assert {"iteration", "load", "step", "step_phase_s:WResNet"} <= names


def test_unported_exchanges_raise():
    """The exchanges refused until ROADMAP A8 landed now compile: the
    int8 wire with its zero residuals, zero1 with a flat optimizer shard
    (one rank: the whole padded buffer) in place of the velocity."""
    from theanompi_tpu_torch.parallel.mesh import destroy_group

    try:
        m = WResNet(dict(CFG, exch_compression="int8"), device="cpu")
        m.build_model()
        m.compile_iter_fns()
        padded = m._fspec.padded
        assert m._ef_layout == ("int8", padded, m._fspec.bucket_len)
        assert [t.shape for t in m.ef_state.values()] == [(padded,)] * 2
        m.compile_iter_fns(exch_strategy="zero1")
        assert m._zero1_layout == (padded, m._fspec.bucket_len)
        assert [t.shape for t in m.opt_state] == [(padded,)]
        assert list(m.ef_state) == ["r1"]
    finally:
        destroy_group()