"""The port's ``torch.nn`` zoo (``models/torch_zoo``) against the JAX
package's ``flax_zoo``.

Every case starts from the flax init, carried across through numpy by
``TorchClassifier.params_from_flax`` (or a JAX checkpoint):

- ``TorchLayer`` over ``_CNN`` and ``_ResNet18`` (width 8) against
  ``FlaxLayer``: eval logits within ``LOGIT_ATOL`` 1e-5 and the
  ``batch_stats`` after one train-mode call within ``STATS_ATOL`` 1e-6
  (dropout follows the last BN, so its masks, which no two packages
  draw alike, do not reach them); the key paths are the flax tree's.
- ``TorchResNet18`` (width 8, no dropout) under BSP: one rank, 4 steps,
  against JAX ``FlaxResNet18`` through the JAX worker (losses rtol
  ``LOSS_RTOL`` 5e-5, val rtol 1e-4, parameters, BN statistics and
  momentum atol ``PARAM_ATOL`` 5e-4: ``test_torch_classifier.py``'s for
  WResNet, a fp32 conv net in eager torch against XLA); two gloo ranks
  against the JAX worker on 2 devices, the ranks' parameters and BN
  statistics bitwise equal.  (Two ranks are held to JAX's two-device
  run, not to the one-rank run: train-mode BN normalizes each rank's
  half-batch with its own statistics, as each JAX device does.)
- ``TorchCNN`` under EASGD with two in-process replicas: exchanges
  happen and the center's val error falls, the JAX ``slow`` smoke at a
  tier-1 size.
- Checkpoints both ways: the port's loads into the JAX ``FlaxResNet18``
  (its ``restore_trees``), and a JAX checkpoint loads back, bitwise.
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

from theanompi_tpu.models.flax_zoo import FlaxLayer, FlaxResNet18
from theanompi_tpu.models.flax_zoo.cnn import _CNN, _ResNet18
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils import Recorder as JaxRecorder
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch.models.torch_zoo import (
    TorchClassifier,
    TorchCNN,
    TorchLayer,
    TorchResNet18,
)
from theanompi_tpu_torch.models.torch_zoo.cnn import _CNN as PortCNN
from theanompi_tpu_torch.utils.checkpoint import tree_to_flat
from theanompi_tpu_torch.workers import bsp_worker as port_worker
from theanompi_tpu_torch.workers import easgd_worker as port_easgd

ROOT = Path(__file__).resolve().parent.parent
ZOO = dict(modelfile="theanompi_tpu_torch.models.torch_zoo")
CFG = dict(width=8, batch_size=8, n_train=32, n_val=16,
           compute_dtype="float32", seed=3, lr=0.02, exch_strategy="ici32")
LOGIT_ATOL = 1e-5
STATS_ATOL = 1e-6
LOSS_RTOL = 5e-5
VAL_RTOL = 1e-4
PARAM_ATOL = 5e-4
MODULES = {"cnn": (_CNN, TorchCNN), "resnet18": (_ResNet18, TorchResNet18)}


@pytest.fixture(autouse=True)
def no_data(tmp_path_factory, monkeypatch):
    """The synthetic CIFAR-10: TM_DATA_DIR is an empty directory."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    monkeypatch.setenv("TM_DATA_DIR", str(d))


def flat(tree):
    return tree_to_flat(jax.device_get(tree))


def flax_and_port(name, width=8):
    """A flax init of ``name`` and the port's model built with it."""
    module, Model = MODULES[name]
    layer = FlaxLayer(module(width=width))
    params, state, out = layer.init(jax.random.PRNGKey(0), (32, 32, 3))
    port = Model(dict(CFG, width=width), device="cpu")
    port.build_model()
    port.params_from_flax(jax.device_get({"params": params, **state}))
    return layer, params, state, out, port


def batch(seed=1, n=4):
    return np.random.default_rng(seed).normal(
        size=(n, 32, 32, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", list(MODULES))
def test_eval_logits_match_flax(name):
    layer, params, state, out, port = flax_and_port(name)
    assert port._out_shape == out == (10,)
    assert set(flat(params)) == set(flat(port.params_to_flax()["params"]))
    x = batch()
    want, _ = layer.apply(params, state, jnp.asarray(x))
    got = port.net(nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(MODULES))
def test_train_call_updates_batch_stats_as_flax(name):
    layer, params, state, _, port = flax_and_port(name)
    x = batch(2)
    _, new = layer.apply(params, state, jnp.asarray(x), train=True,
                         rng=jax.random.PRNGKey(2))
    port.net(nchw(x), train=True, gen=torch.Generator().manual_seed(0))
    got = flat(port.params_to_flax()["batch_stats"])
    want = flat(new["batch_stats"])
    assert set(got) == set(want)
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=STATS_ATOL, rtol=0,
                                   err_msg=k)
        moved += not np.array_equal(w, flat(state["batch_stats"])[k])
    assert moved == len(want)


def test_forward_uses_the_contract_tensors_and_gen():
    """The module's own leaves are on the meta device; the forward reads
    the contract's tensors (a slot rebound through ``.data``, as the
    replica engine does, changes the output) and draws dropout from
    ``gen`` alone (two generators seeded alike give one mask, the global
    stream is untouched)."""
    _, _, _, _, port = flax_and_port("cnn")
    assert all(p.device.type == "meta" for p in port.net.module.parameters())
    x = nchw(batch())
    base = port.net(x).detach()
    k = port.params[0]
    saved = k.data
    k.data = torch.zeros_like(saved)
    assert not torch.equal(port.net(x).detach(), base)
    k.data = saved
    state = torch.random.get_rng_state()
    a = port.net(x, train=True, gen=torch.Generator().manual_seed(5))
    b = port.net(x, train=True, gen=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(torch.random.get_rng_state(), state)


def test_any_module_plugs_in():
    """A ``TorchClassifier`` over a plain ``nn.Sequential`` with torch's
    own layers trains a step: Linear kernels in the ``[in, out]``
    layout, ``nn.BatchNorm2d``'s running statistics as state."""
    def factory(config):
        return torch.nn.Sequential(
            torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.BatchNorm2d(4),
            torch.nn.Flatten(), torch.nn.Linear(4 * 32 * 32, 10))

    class Wrapped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = factory(None)

        def forward(self, x, train=False):
            self.net.train(train)
            return self.net(x)

    model = TorchClassifier(dict(CFG), device="cpu",
                            module_factory=lambda c: Wrapped())
    model.build_model()
    assert ("net", "3", "kernel") in model._params_at
    assert model._params_at[("net", "3", "kernel")][1] == "fc"
    assert ("batch_stats", "net", "1", "mean") in model._state_at
    model.compile_iter_fns()
    rec = port_worker.Recorder(verbose=False)
    before = [t.detach().clone() for t in model.params]
    model.train_iter(0, rec)
    assert all(not torch.equal(a, b) for a, b in zip(before, model.params))
    port_worker.destroy_group()


# -- TorchResNet18 under BSP against FlaxResNet18 -----------------------------

def cpu_mesh(n):
    return make_mesh(data=n, devices=jax.devices("cpu")[:n])


def write_init(directory, cfg, n_dev):
    """The JAX model's initial state (the flax init, fresh BN statistics
    and momentum) as a checkpoint both workers resume (epoch -1)."""
    model = FlaxResNet18(cfg)
    model.build_model(n_replicas=n_dev)
    model.compile_iter_fns(mesh=cpu_mesh(n_dev))
    jax_save(directory, 0, {k: jax.device_get(v)
                            for k, v in model.checkpoint_trees().items()},
             {"epoch": -1, "lr": cfg["lr"]})


def jax_run(directory, cfg, n_dev):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.flax_zoo",
        modelclass="FlaxResNet18", config=cfg, n_epochs=1,
        checkpoint_dir=str(directory), resume=True, verbose=False)
    return {"losses": out["recorder"].train_losses, "val": out["final_val"],
            "trees": {g: flat(t) for g, t in
                      out["model"].checkpoint_trees().items()}}


def assert_same_run(got, want, n_steps=4):
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
    """Init checkpoints and the JAX runs on 1 device (batch 8) and 2
    devices (batch 4 each: the same global batch)."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    out = {"init": {}, "jax": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_DATA_DIR", str(d))
        for n in (1, 2):
            cfg = dict(CFG, batch_size=CFG["batch_size"] // n)
            init = tmp_path_factory.mktemp(f"r18_init{n}")
            write_init(init, cfg, n)
            run_dir = tmp_path_factory.mktemp(f"r18_jax{n}")
            shutil.copytree(init, run_dir, dirs_exist_ok=True)
            out["init"][n] = init
            out["jax"][n] = jax_run(run_dir, cfg, n)
    return out


def port_trees(model):
    return {g: tree_to_flat(t) for g, t in model.checkpoint_trees().items()}


def test_resnet18_one_rank_matches_the_jax_worker(runs, tmp_path):
    shutil.copytree(runs["init"][1], tmp_path, dirs_exist_ok=True)
    out = port_worker.run(devices=["cpu"], config=CFG, n_epochs=1,
                          checkpoint_dir=str(tmp_path), resume=True,
                          verbose=False, modelclass="TorchResNet18", **ZOO)
    assert out["resumed_from"] == [-1, None] and out["iterations"] == 4
    assert_same_run({"losses": out["recorder"].train_losses,
                     "trees": port_trees(out["model"])}, runs["jax"][1])
    for key in ("loss", "err", "err_top5"):
        np.testing.assert_allclose(out["final_val"][key],
                                   runs["jax"][1]["val"][key], rtol=VAL_RTOL)


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


def test_resnet18_two_gloo_ranks_match_the_jax_two_device_mesh(runs,
                                                                tmp_path):
    from test_torch_parallel_train import free_port

    ckpt_dir = tmp_path / "ckpt"
    shutil.copytree(runs["init"][2], ckpt_dir)
    port = free_port()
    procs = []
    for rank in range(2):
        spec = dict(devices=["cpu", "cpu"], rank=rank, world_size=2,
                    init_method=f"tcp://127.0.0.1:{port}",
                    config=dict(CFG, batch_size=4), n_epochs=1,
                    checkpoint_dir=str(ckpt_dir), resume=True,
                    verbose=False, out=str(tmp_path / f"rank{rank}.npz"),
                    modelclass="TorchResNet18", **ZOO)
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
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


def test_cnn_under_easgd_two_replicas():
    """``TorchCNN`` under EASGD with two in-process replicas (tau 2):
    the exchanges happen and the center's val error falls over three
    epochs, as the JAX ``slow`` smoke's at a tier-1 size."""
    out = port_easgd.run(
        devices=["cpu", "cpu"], modelclass="TorchCNN",
        config=dict(CFG, batch_size=16, n_train=512, n_val=64, lr=0.1,
                    lr_schedule=None),
        n_epochs=3, tau=2, verbose=False, **ZOO)
    assert out["exchanges"] > 0 and out["iterations"] == 48
    errs = [v["err"] for v in out["recorder"].val_records]
    assert len(errs) == 3
    assert errs[-1] < errs[0], errs


# -- checkpoints across the packages ------------------------------------------

def test_port_checkpoint_loads_into_jax_resnet18(tmp_path):
    """A port run's checkpoint (seeded init, one epoch) restores into the
    JAX ``FlaxResNet18.load``: parameters, BN statistics and momentum
    bitwise, and the JAX val step gives the run's val metrics."""
    out = port_worker.run(devices=["cpu"], config=CFG, n_epochs=1,
                          checkpoint_dir=str(tmp_path), verbose=False,
                          modelclass="TorchResNet18", **ZOO)
    model = FlaxResNet18(CFG)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=cpu_mesh(1))
    rec = JaxRecorder(verbose=False)
    assert model.load(str(tmp_path), rec)
    want = port_trees(out["model"])
    for group, tree in model.checkpoint_trees().items():
        got = flat(tree)
        assert set(got) == set(want[group]), group
        for k, v in got.items():
            assert np.array_equal(v, want[group][k]), (group, k)
    vals = [model.val_iter(j, rec) for j in range(model.data.n_batch_val)]
    for i, key in enumerate(("loss", "err", "err_top5")):
        np.testing.assert_allclose(np.mean([v[i] for v in vals]),
                                   out["final_val"][key], rtol=VAL_RTOL)


def test_jax_checkpoint_loads_into_the_port(runs, tmp_path):
    """The JAX worker's epoch-0 checkpoint loads into ``TorchResNet18``
    bitwise (every group), and ``params_to_flax`` returns the flax
    variables it holds."""
    shutil.copytree(runs["init"][1], tmp_path, dirs_exist_ok=True)
    model = FlaxResNet18(CFG)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=cpu_mesh(1))
    rec = JaxRecorder(verbose=False)
    assert model.load(str(tmp_path), rec)
    port = TorchResNet18(CFG, device="cpu")
    port.build_model()
    port.compile_iter_fns()
    assert port.load(str(tmp_path))
    want = {g: flat(t) for g, t in model.checkpoint_trees().items()}
    got = port_trees(port)
    for group in ("params", "net_state", "opt_state"):
        assert set(got[group]) == set(want[group]), group
        for k, v in want[group].items():
            assert np.array_equal(got[group][k], v), (group, k)
    variables = port.params_to_flax()
    assert set(variables) == {"params", "batch_stats"}
    for k, v in flat(variables["params"]).items():
        assert np.array_equal(v, want["params"][k]), k
    port_worker.destroy_group()


def test_torch_layer_draws_from_the_generator():
    """``TorchLayer.init`` draws linen's default distributions from the
    explicit generator: the same seed gives the same parameters, kernels
    truncated at two standard deviations of ``lecun_normal``."""
    draws = []
    for _ in range(2):
        layer = TorchLayer(PortCNN(width=8))
        assert layer.init(torch.Generator().manual_seed(0),
                          (32, 32, 3)) == (10,)
        draws.append({k: t.detach().clone() for k, (t, _) in
                      layer.own_entries("params").items()})
    assert draws[0].keys() == draws[1].keys()
    assert all(torch.equal(draws[0][k], draws[1][k]) for k in draws[0])
    k = draws[0][("Conv_0", "kernel")]
    std = (1 / 27) ** 0.5 / .87962566103423978
    assert k.shape == (8, 3, 3, 3) and k.abs().max() <= 2 * std
    assert not draws[0][("Dense_0", "bias")].any()
    assert draws[0][("BatchNorm_0", "scale")].eq(1).all()
