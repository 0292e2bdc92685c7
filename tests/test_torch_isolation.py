"""Isolation of the port: ``theanompi_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``theanompi_tpu``, and every
entry point refuses to run without a CUDA device unless the caller asks
for the CPU.

The import check runs in a subprocess: ``tests/conftest.py`` has
already imported jax into this one."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from theanompi_tpu_torch import resolve_device
from theanompi_tpu_torch.models import Llama, params_from_jax
from theanompi_tpu_torch.serving import decoder_from_checkpoint

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "theanompi_tpu_torch"
CFG = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=64, compute_dtype="float32")

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py")
)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.'))\n"
        "             or m == 'theanompi_tpu'\n"
        "             or m.startswith('theanompi_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert len(MODULES) >= 15
    assert {"theanompi_tpu_torch.data", "theanompi_tpu_torch.data.pipeline",
            "theanompi_tpu_torch.data.sharding",
            "theanompi_tpu_torch.parallel.debug",
            "theanompi_tpu_torch.models.vgg16",
            "theanompi_tpu_torch.models.googlenet",
            "theanompi_tpu_torch.models.lstm",
            "theanompi_tpu_torch.models.data.imdb",
            "theanompi_tpu_torch.ops.recurrent",
            "theanompi_tpu_torch.workers.replica_engine",
            "theanompi_tpu_torch.workers.easgd_worker",
            "theanompi_tpu_torch.workers.gosgd_worker",
            "theanompi_tpu_torch.parallel.center_server",
            "theanompi_tpu_torch.parallel.gossip_net",
            "theanompi_tpu_torch.obs", "theanompi_tpu_torch.obs.tracer",
            "theanompi_tpu_torch.obs.export",
            "theanompi_tpu_torch.obs.metrics",
            "theanompi_tpu_torch.serving.speculation",
            "theanompi_tpu_torch.serving.tokenize",
            "theanompi_tpu_torch.serving.kv_transfer",
            "theanompi_tpu_torch.serving.replica",
            "theanompi_tpu_torch.serving.router",
            "theanompi_tpu_torch.serving.autoscaler",
            "theanompi_tpu_torch.utils.faults",
            "theanompi_tpu_torch.ops.norm",
            # the native .tmb loader, the zoo's knobs and tp > 1 serving
            "theanompi_tpu_torch.native",
            "theanompi_tpu_torch.models.data.imagenet",
            "theanompi_tpu_torch.ops.layers",
            "theanompi_tpu_torch.models.resnet50",
            "theanompi_tpu_torch.parallel.mesh",
            "theanompi_tpu_torch.parallel.tp",
            "theanompi_tpu_torch.models.llama",
            "theanompi_tpu_torch.serving.decoder",
            # the exchange extensions: zero1, the compressed wire,
            # sharded checkpoints and their reshard
            "theanompi_tpu_torch.parallel.exchange",
            "theanompi_tpu_torch.parallel.strategies",
            "theanompi_tpu_torch.ops.optimizers",
            "theanompi_tpu_torch.models.base",
            "theanompi_tpu_torch.utils.checkpoint",
            "theanompi_tpu_torch.utils.sharded_checkpoint",
            "theanompi_tpu_torch.utils.reshard",
            # resilience: the supervisor, heartbeats and drills
            "theanompi_tpu_torch.utils.supervisor",
            # training at tp > 1 and sp > 1: the ring and Ulysses
            "theanompi_tpu_torch.parallel.ring_attention",
            "theanompi_tpu_torch.parallel.ulysses",
            "theanompi_tpu_torch.parallel.pp",
            "theanompi_tpu_torch.parallel.moe",
            "theanompi_tpu_torch.parallel.collectives",
            "theanompi_tpu_torch.ops.attention",
            # the nn.Module adapter, flax_zoo's counterpart
            "theanompi_tpu_torch.models.torch_zoo",
            "theanompi_tpu_torch.models.torch_zoo.adapter",
            "theanompi_tpu_torch.models.torch_zoo.cnn"} <= set(MODULES)


def test_native_loader_source_is_the_ports_own_copy():
    """The loader's C++ lives in the port (no framework in it) and builds
    into the checkout's build directory, not beside the source."""
    src = (PORT / "native" / "loader.cc").read_text()
    assert "#include <jax" not in src and "Python.h" not in src
    ref = (ROOT / "theanompi_tpu" / "native" / "loader.cc").read_text()
    body = src[src.index("#include"):]
    assert body == ref[ref.index("#include"):]


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "theanompi_tpu"), \
            (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(CFG)
    model = Llama(CFG, device="cpu")
    assert model.params["embed"].device.type == "cpu"
    from theanompi_tpu_torch.models.llama import params_to_jax

    tree = params_to_jax(model.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, CFG)
    with pytest.raises((RuntimeError, FileNotFoundError)):
        decoder_from_checkpoint(CFG, str(tmp_path))
    # the decoders and the engine take the model's device
    dec = model.make_decoder(max_slots=2, max_seq=16)
    assert dec.cache[0]["k"].device.type == "cpu"


def test_decoder_from_checkpoint_needs_the_card(no_cuda, tmp_path):
    """With a checkpoint present, loading onto the default device is
    refused for want of a card, not served on the CPU."""
    import numpy as np

    from theanompi_tpu_torch.models.llama import params_to_jax
    from theanompi_tpu_torch.utils.checkpoint import array_digest

    tree = params_to_jax(Llama(CFG, device="cpu").params)
    flat = {"params:['embed']": tree["embed"],
            "params:['final_norm']": tree["final_norm"],
            "params:['lm_head']": tree["lm_head"]}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            flat[f"params:['layers'][{i}]['{k}']"] = v
    np.savez(tmp_path / "ckpt_3.npz", **flat)
    import json

    (tmp_path / "ckpt_3.json").write_text(json.dumps(
        {"_digests": {k: array_digest(v) for k, v in flat.items()}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decoder_from_checkpoint(CFG, str(tmp_path))
    dec = decoder_from_checkpoint(CFG, str(tmp_path), device="cpu",
                                  max_slots=2, max_seq=16)
    assert torch.equal(dec.model.params["lm_head"],
                       torch.from_numpy(tree["lm_head"]))


# -- the training entry points ---------------------------------------------------

TRAIN = dict(CFG, seq_len=8, batch_size=2, n_train=4, n_val=2)
LLAMA = dict(modelfile="theanompi_tpu_torch.models.llama", modelclass="Llama")


def test_training_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from theanompi_tpu_torch import BSP
    from theanompi_tpu_torch.launcher import main
    from theanompi_tpu_torch.workers import bsp_worker

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSP().init(launch="inprocess", config=TRAIN, **LLAMA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bsp_worker.run(config=TRAIN, **LLAMA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["BSP", LLAMA["modelfile"], "Llama", "--kwargs",
              '{"n_epochs": 1}'])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(TRAIN).compile_iter_fns()

    model = Llama(TRAIN, device="cpu")
    model.build_model()
    model.compile_iter_fns()
    p = model.params["layers"][0]["wq"]
    assert p.device.type == "cpu" and p.dtype == torch.float32
    assert p.requires_grad

    rule = BSP()
    rule.init(devices=["cpu"], launch="inprocess", config=TRAIN,
              n_epochs=1, verbose=False, **LLAMA)
    out = rule.wait()
    assert out["device"] == "cpu" and out["iterations"] == 2
    assert main(["BSP", LLAMA["modelfile"], "Llama", "--devices", "cpu",
                 "--kwargs", json.dumps({"config": TRAIN, "n_epochs": 1,
                                         "verbose": False,
                                         "checkpoint_dir": str(tmp_path)})]
                ) == 0
    assert (tmp_path / "ckpt_0.npz").exists()


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(exch_strategy="icii32"), ValueError, "unknown exch_strategy"),
    (dict(exch_strategy="zero2"), ValueError, "unknown exch_strategy"),
    (dict(config=dict(TRAIN, exch_compression="int4")),
     ValueError, "unknown exch_compression"),
    (dict(config=dict(TRAIN, exchange_bucket_mb=-1)), ValueError,
     "exchange_bucket_mb"),
    (dict(config=dict(TRAIN, elastic=True, elastic_batch_policy="all")),
     ValueError, "elastic_batch_policy"),
    # trace and step_profile are no longer refused: the worker goes on
    # to join its group
    (dict(config=dict(TRAIN, trace=True, step_profile=True)),
     AssertionError, "the group was joined"),
    # elastic at pp = 2 is no longer refused: the worker goes on to join
    # the group its resume runs over
    (dict(config=dict(TRAIN, pp=2, elastic=True), devices=["cpu"] * 2,
          world_size=2, init_method="tcp://127.0.0.1:1"),
     AssertionError, "the group was joined"),
    (dict(config=dict(TRAIN, n_experts=4, exch_strategy="zero1")),
     NotImplementedError, "MoE expert sharding"),
    (dict(config=dict(TRAIN, tp=2)), ValueError, "needs at least 2"),
    (dict(config=dict(TRAIN, sp=2, sp_mode="ulysses")), ValueError,
     "needs at least 2"),
    (dict(config=dict(TRAIN, loader_pipeline=1)), ValueError,
     "at least 2 ring slots"),
    (dict(devices=["meta"]), ValueError, "unsupported device"),
    (dict(devices=["cpu", "cpu"]), ValueError, "one process per device"),
])
def test_bad_values_fail_before_the_model_is_built(monkeypatch, kwargs,
                                                   error, match):
    from theanompi_tpu_torch.workers import bsp_worker

    def built(*a, **k):
        raise AssertionError("the model was built")

    def joined(*a, **k):
        raise AssertionError("the group was joined")

    monkeypatch.setattr(Llama, "build_model", built)
    monkeypatch.setattr(bsp_worker, "init_group", joined)
    kw = dict(devices=["cpu"], config=TRAIN, verbose=False, **LLAMA)
    kw.update(kwargs)
    threads = torch.get_num_threads()
    with pytest.raises(error, match=match):
        bsp_worker.run(**kw)
    torch.set_num_threads(threads)


def test_fault_drills_fail_before_the_model_is_built(monkeypatch):
    """A malformed ``TM_FAULT_AT`` fails before the build; a well-formed
    drill list goes on to build the model."""
    from theanompi_tpu_torch.utils import faults
    from theanompi_tpu_torch.workers import bsp_worker

    def built(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(Llama, "build_model", built)
    monkeypatch.setenv("TM_FAULT_AT", "0:2:explode")
    faults.reset_fault_cache()
    try:
        with pytest.raises(ValueError, match="TM_FAULT_AT"):
            bsp_worker.run(devices=["cpu"], config=TRAIN, verbose=False,
                           **LLAMA)
        monkeypatch.setenv("TM_FAULT_AT", "0:2,1:0:sigterm")
        faults.reset_fault_cache()
        with pytest.raises(AssertionError, match="the model was built"):
            bsp_worker.run(devices=["cpu"], config=TRAIN, verbose=False,
                           **LLAMA)
    finally:
        faults.reset_fault_cache()


def test_replica_child_needs_the_card_and_builds_under_fault_drills(
        no_cuda, monkeypatch, tmp_path):
    """``serve_replica_main`` resolves its device like every entry point
    (the card unless the spec says "cpu"); a decoder builds with a
    drill in the environment, and so does a training run, whose loop
    never reaches the replica drill's step."""
    from theanompi_tpu_torch.models.llama import params_to_jax
    from theanompi_tpu_torch.serving.replica import serve_replica_main
    from theanompi_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(tmp_path, 0, {"params": params_to_jax(
        Llama(CFG, device="cpu").params)})
    monkeypatch.setenv("TM_FAULT_AT", "0:2:die_replica")
    spec = json.dumps({"config": CFG, "checkpoint": str(tmp_path)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_replica_main(["--spec-json", spec])
    dec = decoder_from_checkpoint(CFG, str(tmp_path), device="cpu",
                                  paged=True, max_slots=2, max_seq=16,
                                  block_size=4, prefill_chunk=4)
    assert dec.pools[0]["k"].device.type == "cpu"
    from theanompi_tpu_torch.utils import faults
    from theanompi_tpu_torch.workers import bsp_worker

    faults.reset_fault_cache()
    try:
        out = bsp_worker.run(devices=["cpu"], config=TRAIN, n_epochs=1,
                             verbose=False, **LLAMA)
    finally:
        faults.reset_fault_cache()
    assert out["iterations"] == 2 and not out["preempted"]


def test_unported_rules_and_modes_raise(tmp_path):
    """A process of a multi-process async run drives one device: two
    devices given to it are refused; a supervised launch needs the
    checkpoint directory its relaunches resume from, and then holds a
    supervisor rather than a process."""
    from theanompi_tpu_torch import EASGD, GOSGD, BSP

    lstm = dict(modelfile="theanompi_tpu_torch.models.lstm",
                modelclass="LSTM")
    for rule in (EASGD(), GOSGD()):
        with pytest.raises(ValueError, match="one process drives one"):
            rule.init(devices=["cpu"] * 2, launch="inprocess", world_size=2,
                      init_method="tcp://localhost:1", **lstm)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        BSP().init(devices=["cpu"], launch="supervised", **LLAMA)
    rule = BSP()
    rule.init(devices=["cpu"], launch="supervised",
              checkpoint_dir=str(tmp_path / "ck"), **LLAMA)
    assert rule._handle.supervisor is not None
    assert rule._handle.poll() is None      # no life started yet
    with pytest.raises(RuntimeError, match="init"):
        BSP().wait()
