"""Selective remat, ``remat_save=("attn_out",)``, in the port against the
JAX package and against the port's own full remat, through the BSP
worker.

JAX names the attention output ``attn_out`` and, under ``remat``, its
``save_only_these_names`` policy keeps it, so the backward does not run
the attention forward again.  The port runs each layer as two
checkpointed segments around the attention call, which runs once and
keeps its residuals.  Every run resumes the JAX model's initial state
(an epoch -1 checkpoint) for one epoch of 8 steps and 2 val batches
(the data and optimizers of ``test_torch_train.py`` and
``test_torch_parallel_train.py``):

- one rank (flash attention): the losses and the final parameters
  against the JAX worker with the same knob, bitwise equal to the
  port's ``remat=True`` run, and the plain flash forward (the CPU's K1)
  called L times a step, not 2L;
- a name the layer does not have: JAX's policy saves nothing, which is
  full remat; so does the port (bitwise ``remat=True``, 2L a step);
- sp = 2 with ring attention and with Ulysses on two gloo processes
  against the JAX worker on the same 2-device layout, bitwise the
  port's own full remat there, with the forward hops (r + 1 on seq rank
  r for the causal ring, one all-to-all'd call for Ulysses) made once a
  step, not twice.

Tolerances, fp32 throughout, as the tp and sp training tests: losses
rtol 2e-6, final parameters atol 1e-5.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch.models.llama import params_to_jax
from theanompi_tpu_torch.ops import attention
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=16, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, exch_strategy="ici32",
           remat=True)
STEPS, VAL_BATCHES, LAYERS = 8, 2, 2
SAVE = dict(remat_save=("attn_out",))
OPTS = {"adam": dict(optimizer="adam", lr=1e-2),
        "sgd": dict(optimizer="sgd", lr=0.5)}
LAYOUTS = {"ring": dict(sp=2, sp_mode="ring"),
           "ulysses": dict(sp=2, sp_mode="ulysses")}
LOSS_RTOL = 2e-6
PARAM_ATOL = 1e-5


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_init(directory, cfg):
    model = JaxLlama(dict(cfg, sp=1))
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=make_mesh(data=1,
                                          devices=jax.devices("cpu")[:1]))
    jax_save(directory, 0, {"params": jax.device_get(model.params),
                            "opt_state": jax.device_get(model.opt_state)},
             {"epoch": -1, "lr": cfg["lr"]})


def resume_copy(init, tmp):
    shutil.copytree(init, tmp, dirs_exist_ok=True)
    return str(tmp)


def jax_run(d, cfg, n_dev=1):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.llama",
        modelclass="Llama", config=cfg, n_epochs=1, checkpoint_dir=str(d),
        resume=True, verbose=False)
    return dict(losses=out["recorder"].train_losses,
                params=leaves(jax.device_get(out["model"].params)))


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    out = {}
    for opt, kw in OPTS.items():
        d = tmp_path_factory.mktemp(f"init_{opt}")
        write_init(d, dict(CFG, **kw))
        out[opt] = d
    return out


@pytest.fixture
def k1_calls(monkeypatch):
    """Calls of the plain flash forward: K1's CPU version, which flash
    attention, each ring hop and Ulysses' local attention run."""
    n = [0]
    plain = attention.mha_reference_fwd

    def counted(*a, **k):
        n[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(attention, "mha_reference_fwd", counted)
    return n


def port_run(init, tmp, cfg, calls):
    calls[0] = 0
    out = port_worker.run(
        devices=["cpu"], modelfile="theanompi_tpu_torch.models.llama",
        modelclass="Llama", config=cfg, n_epochs=1,
        checkpoint_dir=resume_copy(init, tmp), resume=True, verbose=False)
    return dict(losses=out["recorder"].train_losses,
                params=leaves(params_to_jax(out["model"].params)),
                k1=calls[0])


def assert_same_run(got, want):
    assert len(got["losses"]) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL, atol=0)
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


def assert_bitwise(a, b):
    assert a["losses"] == b["losses"]
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(x, y)


def test_one_rank_matches_jax_and_full_remat(inits, tmp_path, k1_calls):
    cfg = dict(CFG, **OPTS["adam"], **SAVE)
    want = jax_run(resume_copy(inits["adam"], tmp_path / "jax"), cfg)
    got = port_run(inits["adam"], tmp_path / "save", cfg, k1_calls)
    full = port_run(inits["adam"], tmp_path / "full",
                    dict(CFG, **OPTS["adam"]), k1_calls)
    assert_same_run(got, want)
    assert_bitwise(got, full)
    # the forward once a step (L), against twice (2L) under full remat;
    # each val batch runs it once
    val = VAL_BATCHES * LAYERS
    assert got["k1"] == STEPS * LAYERS + val
    assert full["k1"] == STEPS * 2 * LAYERS + val


@pytest.mark.parametrize("names", [("foo",), ()])
def test_a_name_the_layer_lacks_is_full_remat(inits, tmp_path, k1_calls,
                                              names):
    """JAX's ``save_only_these_names`` saves nothing for a name the layer
    does not have (and an empty tuple is no policy): full remat, in
    both packages."""
    cfg = dict(CFG, **OPTS["adam"], remat_save=names)
    want = jax_run(resume_copy(inits["adam"], tmp_path / "jax"), cfg)
    got = port_run(inits["adam"], tmp_path / "named", cfg, k1_calls)
    full = port_run(inits["adam"], tmp_path / "full",
                    dict(CFG, **OPTS["adam"]), k1_calls)
    assert_same_run(got, want)
    assert_bitwise(got, full)
    assert got["k1"] == STEPS * 2 * LAYERS + VAL_BATCHES * LAYERS


def test_remat_off_ignores_the_names(inits, tmp_path, k1_calls):
    """Without ``remat`` the knob changes nothing (JAX reads it only
    under remat): no replay at all."""
    cfg = dict(CFG, **OPTS["adam"], remat=False)
    plain = port_run(inits["adam"], tmp_path / "plain", cfg, k1_calls)
    named = port_run(inits["adam"], tmp_path / "named", dict(cfg, **SAVE),
                     k1_calls)
    assert_bitwise(named, plain)
    assert named["k1"] == plain["k1"] == (STEPS + VAL_BATCHES) * LAYERS


# -- sp = 2 on two gloo processes ---------------------------------------------

CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.models.llama import params_to_jax
from theanompi_tpu_torch.ops import attention
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.workers import bsp_worker

rank = int(sys.argv[1])
init = {init!r}
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, 2, init)
calls = [0]
plain = attention.mha_reference_fwd


def counted(*a, **k):
    calls[0] += 1
    return plain(*a, **k)


attention.mha_reference_fwd = counted
out = {{}}
for name, cfg, d in pickle.load(open({jobs!r}, "rb")):
    calls[0] = 0
    res = bsp_worker.run(
        devices=["cpu", "cpu"], rank=rank, world_size=2, init_method=init,
        modelfile="theanompi_tpu_torch.models.llama", modelclass="Llama",
        config=cfg, n_epochs=1, checkpoint_dir=d, resume=True,
        verbose=False)
    p = params_to_jax(res["model"].params)
    out[name] = dict(losses=res["recorder"].train_losses, k1=calls[0],
                     embed=p["embed"], wq=[lp["wq"] for lp in p["layers"]])
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


@pytest.fixture(scope="module")
def sp_runs(inits, tmp_path_factory):
    """The two gloo ranks run each layout with ``remat_save`` and with
    full remat, in turn, while this process runs the JAX worker."""
    root = tmp_path_factory.mktemp("sp")
    jobs = []
    for layout, kw in LAYOUTS.items():
        for arm, knob in (("save", SAVE), ("full", {})):
            cfg = dict(CFG, **OPTS["sgd"], **kw, **knob)
            jobs.append(((layout, arm), cfg,
                         resume_copy(inits["sgd"], root / f"{layout}_{arm}")))
    pickle.dump(jobs, open(root / "jobs.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), init=f"tcp://127.0.0.1:{free_port()}",
                       jobs=str(root / "jobs.pkl"), out=str(root / "out"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    want = {layout: jax_run(
        resume_copy(inits["sgd"], tmp_path_factory.mktemp(f"jax_{layout}")),
        dict(CFG, **OPTS["sgd"], **kw, **SAVE), n_dev=2)
        for layout, kw in LAYOUTS.items()}
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    ranks = [pickle.load(open(f"{root / 'out'}{r}", "rb")) for r in range(2)]
    return ranks, want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp2_matches_jax_and_full_remat(sp_runs, layout):
    ranks, want = sp_runs
    # the forward's K1 calls a layer on seq rank r: the causal ring's
    # r + 1 visible hops; Ulysses' one call over its heads
    for r in range(2):
        save, full = ranks[r][(layout, "save")], ranks[r][(layout, "full")]
        assert len(save["losses"]) == len(want[layout]["losses"]) == STEPS
        np.testing.assert_allclose(save["losses"], want[layout]["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        assert save["losses"] == full["losses"]
        for a, b in zip([save["embed"]] + save["wq"],
                        [full["embed"]] + full["wq"]):
            np.testing.assert_array_equal(a, b)
        hops = r + 1 if layout == "ring" else 1
        val = VAL_BATCHES * LAYERS * hops
        assert save["k1"] == STEPS * LAYERS * hops + val
        assert full["k1"] == STEPS * 2 * LAYERS * hops + val
    np.testing.assert_allclose(ranks[0][(layout, "save")]["embed"],
                               want[layout]["params"][0], atol=PARAM_ATOL,
                               rtol=0)
