"""K steps a call over the device-resident data (``device_data_cache``
with ``steps_per_call``) in the port against the JAX package, through
the BSP worker, and against the port's own staged per-step path.

Every run resumes the JAX model's initial state, written as a
checkpoint stamped epoch -1.  The train set lives on the device and
each step's rows come from the epoch permutation there, sliced at the
step's batch index; ``train_chunk`` runs ``steps_per_call`` = 4 steps a
call and the worker takes the epoch's tail shorter than 4 one step at a
time:

- a tiny Llama (2 layers, dim 64; 6 batches an epoch: a chunk of 4 and
  a tail of 2, two epochs) against the JAX worker's K-step scan, and
  bitwise against the port's staged run from the same state;
- a tiny WResNet-10-1 (2 chunks) and the IMDB LSTM (a chunk and a
  tail) the same way;
- sp = 2 (ring) and MoE at ep = 2 on two gloo processes against the
  JAX worker on the same 2-device layout (SGD at lr 0.5: a wrongly
  scaled gradient moves it);
- a run preempted inside an epoch and resumed, bitwise the
  uninterrupted run (Llama and WResNet);
- ``step_profile`` over a chunk (its window is one chunk of 4 steps);
- the fallbacks the JAX package warns about, with its words;
- the async rules, which in both packages take one step a call and
  never call ``train_chunk``: the knob changes no bit of them.

Tolerances, fp32 throughout: the packages sum in other orders, ~1e-7
relative in a gradient; Adam (and SGD at lr 0.5) carry it on.  Llama:
losses rtol 2e-6 (the tp and sp training tests'), parameters atol 4e-5
(``PARAM_ATOL``); the classifiers: the bars of ``test_torch_classifier.py`` and
``test_torch_lstm.py``.  Against the port's own staged path every loss
and parameter is bitwise equal.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.models import lstm as jax_lstm
from theanompi_tpu.models import wresnet as jax_wresnet
from theanompi_tpu.models.base import TMModel as JaxTMModel
from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch.models.base import TMModel
from theanompi_tpu_torch.models.llama import Llama, params_to_jax
from theanompi_tpu_torch.utils import faults
from theanompi_tpu_torch.utils import supervisor as sup
from theanompi_tpu_torch.utils.checkpoint import tree_to_flat
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
CACHE = dict(device_data_cache=True, steps_per_call=4)
LLAMA_CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                 vocab=64, seq_len=16, batch_size=4, n_train=24, n_val=8,
                 compute_dtype="float32", seed=3, lr=1e-2,
                 optimizer="adam", exch_strategy="ici32")
LLAMA = dict(modelfile="theanompi_tpu_torch.models.llama",
             modelclass="Llama")
#: two epochs of 6 batches: a chunk of 4, then a tail of 2
LLAMA_EPOCHS = 2
LOSS_RTOL = 2e-6
#: at dim 64 with Adam the port's STAGED run already ends 1.73e-5 from
#: JAX's staged run after 6 steps (measured; the cached runs of both
#: packages give their staged runs' numbers exactly), as a deeper stack
#: does in test_torch_stack_train.py
PARAM_ATOL = 4e-5
#: the layouts on two gloo ranks, at SGD lr 0.5 (the global batch of 4
#: over two replicas at ep = 2)
SMALL = dict(LLAMA_CFG, dim=32, ffn_dim=64, optimizer="sgd", lr=0.5)
LAYOUTS = {"ring": dict(SMALL, sp=2, sp_mode="ring"),
           "ep2": dict(SMALL, n_experts=4, moe_top_k=2, capacity_factor=2.0,
                       ep=2, batch_size=2)}


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def no_dataset(tmp_path_factory, monkeypatch):
    """Every data module takes its synthetic path."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    monkeypatch.setenv("TM_DATA_DIR", str(d))


def write_llama_init(directory, cfg):
    model = JaxLlama(dict(cfg, ep=1, batch_size=4))
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=make_mesh(data=1,
                                          devices=jax.devices("cpu")[:1]))
    jax_save(directory, 0, {"params": jax.device_get(model.params),
                            "opt_state": jax.device_get(model.opt_state)},
             {"epoch": -1, "lr": cfg["lr"]})


def resume_copy(init, tmp):
    shutil.copytree(init, tmp, dirs_exist_ok=True)
    return str(tmp)


def jax_llama_run(d, cfg, n_dev=1, n_epochs=1):
    out = jax_worker.run(
        devices=list(range(n_dev)), modelfile="theanompi_tpu.models.llama",
        modelclass="Llama", config=cfg, n_epochs=n_epochs,
        checkpoint_dir=str(d), resume=True, verbose=False)
    return dict(losses=out["recorder"].train_losses,
                params=leaves(jax.device_get(out["model"].params)))


def port_run(d, cfg, model=LLAMA, n_epochs=1, **kw):
    return port_worker.run(devices=["cpu"], config=cfg, n_epochs=n_epochs,
                           checkpoint_dir=str(d), resume=True,
                           verbose=False, **model, **kw)


def spy_chunks(monkeypatch, classes) -> list:
    """The ``k`` of every ``train_chunk`` call of ``classes``' models."""
    calls = []
    for cls in classes:
        orig = cls.__dict__["train_chunk"]

        def spy(self, count, k, recorder, _orig=orig):
            calls.append(k)
            return _orig(self, count, k, recorder)

        monkeypatch.setattr(cls, "train_chunk", spy)
    return calls


@pytest.fixture
def chunk_calls(monkeypatch):
    """The ``k`` of every ``train_chunk`` call of the port's models (a
    cached ``train_iter`` is a chunk of one)."""
    return spy_chunks(monkeypatch, (TMModel,))


# -- Llama at one rank --------------------------------------------------------

@pytest.fixture(scope="module")
def llama_init(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama_init")
    write_llama_init(d, LLAMA_CFG)
    return d


@pytest.fixture(scope="module")
def jax_llama(llama_init, tmp_path_factory):
    """The JAX worker on its K-step scan: two epochs, each a scan of 4
    and two single steps of the scan's 1-step twin."""
    d = resume_copy(llama_init, tmp_path_factory.mktemp("jax_llama"))
    return jax_llama_run(d, dict(LLAMA_CFG, **CACHE),
                         n_epochs=LLAMA_EPOCHS)


def test_llama_chunk_matches_jax(jax_llama, llama_init, tmp_path,
                                 chunk_calls):
    out = port_run(resume_copy(llama_init, tmp_path),
                   dict(LLAMA_CFG, **CACHE), n_epochs=LLAMA_EPOCHS)
    model = out["model"]
    # per epoch: one chunk of 4, then the tail a cached step at a time
    assert chunk_calls == [4, 1, 1] * LLAMA_EPOCHS
    assert model._feed is None and model._device_cache is not None
    got = out["recorder"].train_losses
    assert len(got) == len(jax_llama["losses"]) == 6 * LLAMA_EPOCHS
    np.testing.assert_allclose(got, jax_llama["losses"], rtol=LOSS_RTOL,
                               atol=0)
    for a, b in zip(leaves(params_to_jax(model.params)),
                    jax_llama["params"]):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


def test_llama_chunk_is_bitwise_the_staged_path(llama_init, tmp_path):
    runs = [port_run(resume_copy(llama_init, tmp_path / name),
                     dict(LLAMA_CFG, **knobs), n_epochs=LLAMA_EPOCHS)
            for name, knobs in (("staged", {}), ("cached", CACHE))]
    assert runs[0]["recorder"].train_losses == \
        runs[1]["recorder"].train_losses
    for a, b in zip(*(r["model"]._leaves() for r in runs)):
        assert torch.equal(a, b)
    assert runs[0]["final_val"] == runs[1]["final_val"]


@pytest.fixture
def drills(monkeypatch):
    """No drill, heartbeat or restart context leaks into or out of a
    test."""
    for var in ("TM_FAULT_AT", "TM_FAULT_STATE", "TM_WORLD_FILE",
                sup.HEARTBEAT_ENV, sup.RESTART_CTX_ENV):
        monkeypatch.delenv(var, raising=False)
    faults.reset_fault_cache()
    sup.reset_heartbeat_cache()
    yield monkeypatch
    faults.reset_fault_cache()
    sup.reset_heartbeat_cache()


def flat_trees(model) -> dict:
    return {g: tree_to_flat(t) for g, t in model.checkpoint_trees().items()}


@pytest.mark.parametrize("name", ["llama", "wresnet"])
def test_preempted_inside_an_epoch_resumes_bitwise(name, llama_init,
                                                   tmp_path, drills):
    """A SIGTERM after the first chunk of epoch 0 checkpoints with
    ``next_iter`` 4; the run resumed from it takes batches 4.. of that
    epoch, not 0.., so its losses and final state are bitwise the
    uninterrupted run's, the next epoch too."""
    if name == "llama":
        cfg, spec, init = dict(LLAMA_CFG, **CACHE), LLAMA, llama_init
    else:
        cfg = dict(WRN_CFG, **CACHE)
        spec = dict(modelfile="theanompi_tpu_torch.models.wresnet",
                    modelclass="WResNet")
        init = tmp_path / "fresh"           # both runs start from the seed
        init.mkdir()
    whole = port_run(resume_copy(init, tmp_path / "whole"), cfg, spec,
                     n_epochs=2)
    d = resume_copy(init, tmp_path / "cut")
    drills.setenv("TM_FAULT_AT", "0:3:sigterm")
    faults.reset_fault_cache()
    out = port_run(d, cfg, spec, n_epochs=2)
    assert out["preempted"] and out["iterations"] == 4
    drills.delenv("TM_FAULT_AT")
    faults.reset_fault_cache()
    out = port_run(d, cfg, spec, n_epochs=2)
    assert out["resumed_from"] == [0, 4] and not out["preempted"]
    assert out["recorder"].train_losses == whole["recorder"].train_losses
    got, want = flat_trees(out["model"]), flat_trees(whole["model"])
    for group in ("params", "opt_state"):
        for k, v in want[group].items():
            np.testing.assert_array_equal(got[group][k], v,
                                          err_msg=f"{group}{k}")


def test_llama_preferred_chunk_and_the_tail():
    """``steps_per_call`` defaults to 2 with the cache; a remainder
    shorter than the chunk is a step at a time; ``train_iter`` on the
    cached path takes the rows of its own batch index."""
    m = Llama(dict(LLAMA_CFG, device_data_cache=True), device="cpu")
    m.build_model()
    m.compile_iter_fns()
    assert m._chunk_k == 2 and m.preferred_chunk(6) == 2
    assert m.preferred_chunk(1) == 1
    m4 = Llama(dict(LLAMA_CFG, **CACHE), device="cpu")
    m4.build_model()
    m4.compile_iter_fns()
    assert [m4.preferred_chunk(n) for n in (6, 4, 3, 1)] == [4, 4, 1, 1]
    # the default without the cache: one step a call
    assert TMModel.preferred_chunk(Llama(LLAMA_CFG, device="cpu"), 6) == 1
    from theanompi_tpu_torch.utils import Recorder

    rec = Recorder(verbose=False)
    m4.data.shuffle(0)
    m4.train_chunk(0, 4, rec)
    m4.train_iter(4, rec)
    assert rec.n_iter == 5 and len(rec.train_losses) == 5
    for j in (0, 4, 5):
        got = m4._cached_batch(j)
        for a, b in zip(got, m4.data.train_batch(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_chunk_reads_nothing_back_through_the_chunked_head(monkeypatch):
    """The chunked head's backward found its rows with ``torch.nonzero``,
    whose size the host reads back: a sync a head chunk inside every
    step of the chunk (24 a step at Llama-3's vocab, found on the card).
    A chunk through the chunked head now runs with ``nonzero`` refused,
    and its losses are the staged run's."""
    cfg = dict(LLAMA_CFG, xent_chunks=4)

    def refuse(*a, **k):
        raise AssertionError("a data-dependent shape in the step")

    from theanompi_tpu_torch.utils import Recorder

    losses = []
    for knobs in ({}, CACHE):
        m = Llama(dict(cfg, **knobs), device="cpu")
        m.build_model()
        m.compile_iter_fns()
        assert m._n_xent_chunks == 4
        rec = Recorder(verbose=False)
        m.data.shuffle(0)
        with monkeypatch.context() as mp:
            mp.setattr(torch, "nonzero", refuse)
            mp.setattr(torch.Tensor, "nonzero", refuse)
            m.train_chunk(0, 4, rec)
        losses.append(rec.train_losses)
    assert losses[0] == losses[1] and len(losses[0]) == 4


@pytest.mark.parametrize("knobs,why", [
    (dict(device_data_cache=True, steps_per_call=1), "steps_per_call < 2"),
    (dict(device_data_cache=True), "dataset_sequences"),
])
def test_llama_cache_fallbacks_warn_with_the_jax_words(knobs, why):
    """Where JAX warns and stages per step (``steps_per_call`` < 2, or
    data without ``dataset_sequences``), the port does the same with
    the same message."""
    msgs = []
    for cls, kw in ((JaxLlama, {}), (Llama, dict(device="cpu"))):
        m = cls(dict(LLAMA_CFG, **knobs), **kw)
        m.build_model()
        if why == "dataset_sequences":
            m.data.dataset_sequences = None     # what getattr finds
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if cls is JaxLlama:
                m.compile_iter_fns(mesh=make_mesh(
                    data=1, devices=jax.devices("cpu")[:1]))
            else:
                m.compile_iter_fns()
        assert m._chunk_k == 0 if cls is Llama else m._scan_k == 0
        msgs.append([str(x.message) for x in w
                     if "device_data_cache" in str(x.message)])
    assert len(msgs[1]) == 1 and msgs[0] == msgs[1]
    assert why in msgs[1][0]


def test_step_profile_over_a_chunk(llama_init, tmp_path):
    out = port_run(resume_copy(llama_init, tmp_path),
                   dict(LLAMA_CFG, **CACHE, step_profile=True))
    prof = out["step_profile"]
    assert "error" not in prof, prof
    assert prof["n_steps"] == 4
    assert {"compute", "optimizer", "exchange_b0"} <= set(prof["legs"])
    assert 0.95 <= prof["coverage"] <= 1.05


# -- the classifiers ----------------------------------------------------------

WRN_CFG = dict(depth=10, widen=1, batch_size=8, n_train=64, n_val=16,
               compute_dtype="float32", seed=3, lr=0.02,
               exch_strategy="ici32")
LSTM_CFG = dict(vocab=64, emb_dim=8, hidden=8, maxlen=12, batch_size=4,
                n_train=24, n_val=8, compute_dtype="float32", dropout=0.0,
                lr=0.1, seed=3)
CLASSIFIERS = {
    # 8 batches: two chunks; bars of test_torch_classifier.py
    "wresnet": (jax_wresnet.WResNet, WRN_CFG, "wresnet", "WResNet",
                5e-5, 5e-4),
    # 6 batches: a chunk and a tail of 2; bars of test_torch_lstm.py
    "lstm": (jax_lstm.LSTM, LSTM_CFG, "lstm", "LSTM", 1e-5, 1e-5),
}


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_classifier_chunk_matches_jax_and_the_staged_path(name, tmp_path,
                                                          chunk_calls):
    jax_cls, cfg, mod, cls, loss_rtol, atol = CLASSIFIERS[name]
    init = tmp_path / "init"
    model = jax_cls(dict(cfg))
    model.build_model(n_replicas=1)
    if name == "wresnet":
        model.compile_iter_fns(mesh=make_mesh(
            data=1, devices=jax.devices("cpu")[:1]))
    jax_save(init, 0, {k: jax.device_get(v)
                       for k, v in model.checkpoint_trees().items()},
             {"epoch": -1, "lr": cfg["lr"]})
    want = jax_worker.run(
        devices=[0], modelfile=f"theanompi_tpu.models.{mod}",
        modelclass=cls, config=dict(cfg, **CACHE), n_epochs=1,
        checkpoint_dir=resume_copy(init, tmp_path / "jax"), resume=True,
        verbose=False)
    spec = dict(modelfile=f"theanompi_tpu_torch.models.{mod}",
                modelclass=cls)
    staged = port_run(resume_copy(init, tmp_path / "staged"), cfg, spec)
    del chunk_calls[:]
    cached = port_run(resume_copy(init, tmp_path / "cached"),
                      dict(cfg, **CACHE), spec)
    nb = cfg["n_train"] // cfg["batch_size"]
    # the chunks, then the tail a cached step at a time
    assert chunk_calls == [4] * (nb // 4) + [1] * (nb % 4)
    losses = cached["recorder"].train_losses
    assert losses == staged["recorder"].train_losses and len(losses) == nb
    np.testing.assert_allclose(losses, want["recorder"].train_losses,
                               rtol=loss_rtol, atol=0)
    got = {g: tree_to_flat(t)
           for g, t in cached["model"].checkpoint_trees().items()}
    ref = {g: tree_to_flat(t)
           for g, t in staged["model"].checkpoint_trees().items()}
    jref = {g: {k: np.asarray(v) for k, v in tree_to_flat(
        jax.device_get(t)).items()}
        for g, t in want["model"].checkpoint_trees().items()}
    for group in ("params", "opt_state"):
        for k, v in got[group].items():
            np.testing.assert_array_equal(v, ref[group][k])
            np.testing.assert_allclose(v, jref[group][k], atol=atol, rtol=0,
                                       err_msg=f"{group}{k}")


# -- sp = 2 and MoE on two gloo processes -------------------------------------

CHILD = """
import pickle, sys
import torch
sys.path.insert(0, {root!r})
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.workers import bsp_worker

rank = int(sys.argv[1])
init = {init!r}
torch.set_num_threads(1)
init_group(torch.device("cpu"), rank, 2, init)
out = {{}}
for name, cfg, d in pickle.load(open({jobs!r}, "rb")):
    res = bsp_worker.run(
        devices=["cpu", "cpu"], rank=rank, world_size=2, init_method=init,
        modelfile="theanompi_tpu_torch.models.llama", modelclass="Llama",
        config=cfg, n_epochs=1, checkpoint_dir=d, resume=True,
        verbose=False)
    out[name] = dict(losses=res["recorder"].train_losses,
                     cached=res["model"]._device_cache is not None,
                     chunk=res["model"]._chunk_k)
pickle.dump(out, open({out!r} + str(rank), "wb"))
destroy_group()
"""


@pytest.fixture(scope="module")
def layout_inits(tmp_path_factory):
    out = {}
    for name, cfg in LAYOUTS.items():
        d = tmp_path_factory.mktemp(f"init_{name}")
        write_llama_init(d, dict(cfg, sp=1, ep=1))
        out[name] = d
    return out


@pytest.fixture(scope="module")
def pair_runs(layout_inits, tmp_path_factory):
    """The two gloo ranks run both layouts in turn while this process
    runs the JAX worker on the same layouts."""
    root = tmp_path_factory.mktemp("pair")
    jobs = [(name, dict(cfg, **CACHE),
             resume_copy(layout_inits[name], root / name))
            for name, cfg in LAYOUTS.items()]
    pickle.dump(jobs, open(root / "jobs.pkl", "wb"))
    src = CHILD.format(root=str(ROOT), init=f"tcp://127.0.0.1:{free_port()}",
                       jobs=str(root / "jobs.pkl"), out=str(root / "out"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    want = {name: jax_llama_run(
        resume_copy(layout_inits[name],
                    tmp_path_factory.mktemp(f"jax_{name}")),
        dict(cfg, **CACHE), n_dev=2) for name, cfg in LAYOUTS.items()}
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-4000:]
    ranks = [pickle.load(open(f"{root / 'out'}{r}", "rb")) for r in range(2)]
    return ranks, want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_chunk_matches_jax(pair_runs, layout):
    """sp = 2 (each seq rank takes its columns of the cached rows) and
    MoE at ep = 2 (each replica its rows, expert-major): both ranks'
    per-step losses (a chunk of 4 and a tail of 2) against the JAX
    worker's scan on the same layout."""
    ranks, want = pair_runs
    for r in range(2):
        got = ranks[r][layout]
        assert got["chunk"] == 4 and got["cached"]
        assert len(got["losses"]) == len(want[layout]["losses"]) == 6
        np.testing.assert_allclose(got["losses"], want[layout]["losses"],
                                   rtol=LOSS_RTOL, atol=0)


# -- the async rules ----------------------------------------------------------

def test_async_rules_take_one_step_a_call(tmp_path, monkeypatch):
    """JAX's EASGD and GoSGD drive their replicas a step at a time and
    never take a chunk of steps; the port's the same: with the knobs
    every loss is the run without them, bitwise, in either package."""
    from theanompi_tpu.models.base import ClassifierModel as JaxClassifier
    from theanompi_tpu.rules import EASGD as JaxEASGD
    from theanompi_tpu_torch import EASGD, GOSGD

    calls = spy_chunks(monkeypatch, (TMModel, JaxTMModel, JaxClassifier))
    cfg = dict(LSTM_CFG, n_train=64)
    kw = dict(modelclass="LSTM", launch="inprocess", n_epochs=1,
              verbose=False)
    for rule in (EASGD, GOSGD):
        runs = []
        for knobs in ({}, CACHE):
            r = rule()
            r.init(devices=["cpu"] * 2, modelfile="theanompi_tpu_torch."
                   "models.lstm", config=dict(cfg, **knobs), **kw)
            runs.append(r.wait()["recorder"].train_losses)
        assert runs[0] == runs[1] and len(runs[0]) > 0
    runs = []
    for knobs in ({}, CACHE):
        r = JaxEASGD()
        r.init(devices=[0, 1], modelfile="theanompi_tpu.models.lstm",
               config=dict(cfg, **knobs), **kw)
        runs.append(r.wait()["recorder"].train_losses)
    assert runs[0] == runs[1] and len(runs[0]) > 0
    assert all(k == 1 for k in calls), calls
