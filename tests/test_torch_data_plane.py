"""The data plane of the port (``theanompi_tpu_torch/data``) against the
JAX package's, on the CPU: the ``loader_pipeline`` resolver, the
streaming loader (ported from ``tests/test_data_pipeline.py``), the
shard cursors, the three feeds of a BSP run (synchronous, pipelined,
device-resident) giving the same bits, the checkpoint's stream cursor,
the feed's lifetime, and the knob repairs (``TM_FAULT_AT`` refused,
``TM_DEBUG_SYNC=1`` checking the replicas on 1 and 2 gloo ranks).

The sharp invariant: the pipeline changes WHERE host work happens,
never WHAT trains — the permutation, not the transport, defines the
batch order.  The same on the card, with pinned buffers and a copy
stream, is ``tests/test_torch_data_plane_cuda.py``.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from theanompi_tpu.data import ShardedBatches as JaxShardedBatches
from theanompi_tpu.data import StreamingLoader as JaxStreamingLoader
from theanompi_tpu.data import coverage_check as jax_coverage_check
from theanompi_tpu.data import resolve_loader_depth as jax_resolve
from theanompi_tpu.data import shard_ids as jax_shard_ids
from theanompi_tpu_torch.data import (
    HostStager,
    ShardedBatches,
    StreamingLoader,
    coverage_check,
    resolve_loader_depth,
    shard_ids,
)
from theanompi_tpu_torch.models.llama import Llama
from theanompi_tpu_torch.models.wresnet import WResNet
from theanompi_tpu_torch.parallel.debug import check_replicas_synced
from theanompi_tpu_torch.utils import Recorder
from theanompi_tpu_torch.utils.checkpoint import checkpoint_meta, tree_to_flat
from theanompi_tpu_torch.workers import bsp_worker

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(depth=10, widen=1, batch_size=8, n_train=64, n_val=16,
           compute_dtype="float32", seed=3, lr=0.02, exch_strategy="ici32")
WRN = dict(modelfile="theanompi_tpu_torch.models.wresnet",
           modelclass="WResNet")
LLAMA_CFG = dict(dim=32, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=64,
                 vocab=64, seq_len=8, batch_size=2, n_train=8, n_val=2,
                 compute_dtype="float32")
LLAMA = dict(modelfile="theanompi_tpu_torch.models.llama",
             modelclass="Llama")


@pytest.fixture(autouse=True)
def no_dataset(tmp_path_factory, monkeypatch):
    """Synthetic data (an empty TM_DATA_DIR), and none of the env knobs
    this file sets leaking in."""
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    monkeypatch.setenv("TM_DATA_DIR", str(d))
    for var in ("TM_FAULT_AT", "TM_DEBUG_SYNC", "TM_LOADER_JOURNAL"):
        monkeypatch.delenv(var, raising=False)


def loader_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "tm-loader" and t.is_alive()]


# -- the loader_pipeline knob -------------------------------------------------

@pytest.mark.parametrize("raw", [None, False, 0, True, 2, 5, "3"])
def test_resolve_loader_depth_is_the_jax_one(raw):
    cfg = {"loader_pipeline": raw}
    assert resolve_loader_depth(cfg) == jax_resolve(cfg)
    assert resolve_loader_depth({}) == jax_resolve({}) == 0
    assert resolve_loader_depth({"loader_pipeline": True}) == 2


@pytest.mark.parametrize("raw", [1, -1, "fast"])
def test_resolve_loader_depth_refuses_what_jax_refuses(raw):
    cfg = {"loader_pipeline": raw}
    with pytest.raises(ValueError) as want:
        jax_resolve(cfg)
    with pytest.raises(ValueError) as got:
        resolve_loader_depth(cfg)
    assert str(got.value) == str(want.value)


# -- StreamingLoader (identity stage) -----------------------------------------

def ident_loader(n=8, **kw):
    def fetch(i):
        return (np.full((2,), i, np.float32),)

    return StreamingLoader(fetch, lambda b: b, n_batches=lambda: n, **kw)


def test_sequential_delivery_rides_the_ring():
    ld = ident_loader(8)
    got = [int(ld.next(i)[0][0]) for i in range(8)]
    ld.stop()
    assert got == list(range(8))
    assert ld.staged >= 1 and ld.starved == 0
    assert not loader_threads()


def test_out_of_sequence_index_resyncs():
    ld = ident_loader(8)
    seq = [0, 1, 5, 6, 0, 1]
    got = [int(ld.next(i)[0][0]) for i in seq]
    ld.stop()
    assert got == seq


def test_starved_consumer_degrades_to_synchronous_fetch():
    slow = {"armed": True}

    def fetch(i):
        if i == 3 and slow.pop("armed", False):
            time.sleep(0.5)
        return (np.full((2,), i, np.float32),)

    ld = StreamingLoader(fetch, lambda b: b, n_batches=lambda: 8, depth=2,
                         timeout_s=0.1)
    got = [int(ld.next(i)[0][0]) for i in range(8)]
    ld.stop()
    assert got == list(range(8))   # sequence intact, no deadlock
    assert ld.starved >= 1
    assert ld.staged + ld.starved == 8


def test_ring_depth_below_two_refuses():
    with pytest.raises(ValueError):
        ident_loader(8, depth=1)


def test_cursor_counts_in_sample_units_with_the_jax_keys():
    ld = ident_loader(8, global_batch=32)
    ref = JaxStreamingLoader(lambda i: (np.zeros(2),), lambda b: b,
                             n_batches=8, global_batch=32)
    for i in range(3):
        ld.next(i)
        ref.next(i)
    cur, want = ld.cursor(), ref.cursor()
    ld.stop()
    ref.stop()
    assert set(cur) == set(want)
    assert cur["next_iter"] == want["next_iter"] == 3
    assert cur["next_sample"] == want["next_sample"] == 3 * 32
    assert cur["global_batch"] == 32
    assert cur["staged"] + cur["starved"] == 3


def test_journal_records_delivered_sample_ids(tmp_path, monkeypatch):
    jpath = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TM_LOADER_JOURNAL", str(jpath))
    perm = np.arange(16)[::-1]
    ld = StreamingLoader(
        lambda i: (np.zeros((2,), np.float32),), lambda b: b,
        n_batches=lambda: 4, global_batch=4,
        sample_ids=lambda i: perm[i * 4:(i + 1) * 4],
        journal_meta=lambda: {"epoch": 1, "world": 8, "worker": 0},
    )
    for i in range(4):
        ld.next(i)
    ld.stop()
    entries = [json.loads(line) for line in open(jpath)]
    assert [e["iter"] for e in entries] == [0, 1, 2, 3]
    assert all(e["epoch"] == 1 and e["world"] == 8 for e in entries)
    assert sorted(s for e in entries for s in e["ids"]) == list(range(16))


# -- shard cursors ------------------------------------------------------------

class SynthData:
    def __init__(self, n=64, gb=8, seed=7):
        self._train_x = np.arange(n, dtype=np.float32)
        self._train_y = np.arange(n, dtype=np.int32)
        self.global_batch = gb
        self.n_batch_train = n // gb
        self._perm = np.random.default_rng(seed).permutation(n)

    def batch_indices(self, i):
        gb = self.global_batch
        return self._perm[i * gb:(i + 1) * gb]

    def train_batch(self, i):
        sel = self.batch_indices(i)
        return self._train_x[sel], self._train_y[sel]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_shard_ids_and_sharded_batches_are_the_jax_ones(n):
    ids = np.random.default_rng(n).permutation(40)
    for w in range(n):
        assert np.array_equal(shard_ids(ids, w, n), jax_shard_ids(ids, w, n))
    d = SynthData(64, 8)
    for w in range(n):
        ours, ref = ShardedBatches(d, w, n), JaxShardedBatches(d, w, n)
        assert (ours.n_batch_train, ours.global_batch) == (
            ref.n_batch_train, ref.global_batch)
        for i in range(d.n_batch_train):
            for a, b in zip(ours.train_batch(i), ref.train_batch(i)):
                assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        shard_ids(ids, n, n)
    with pytest.raises(ValueError):
        ShardedBatches(d, n, n)


def test_coverage_check_is_the_jax_one():
    d = SynthData(64, 8)
    entries = []
    for world, iters in ((8, range(0, 4)), (4, range(4, 8))):
        for w in range(world):
            sb = ShardedBatches(d, w, world)
            for i in iters:
                entries.append({"epoch": 0, "iter": i, "world": world,
                                "worker": w,
                                "ids": [int(s) for s in sb.batch_indices(i)]})
    kw = dict(global_batch=8, n_batch_train=8,
              perm_for_epoch=lambda e: d._perm)
    for case in (entries, entries[1:], entries + entries[:1]):
        assert coverage_check(case, **kw) == jax_coverage_check(case, **kw)
    assert coverage_check(entries, **kw) == ([], [])
    lost, _ = coverage_check(entries[1:], **kw)
    assert len(lost) == 1


# -- the stager on the CPU ----------------------------------------------------

def test_cpu_stager_takes_this_ranks_rows_unpinned():
    x = np.random.default_rng(0).normal(size=(8, 3, 3, 2)).astype(np.float32)
    y = np.arange(8, dtype=np.int32)
    st = HostStager("cpu", 2, rank=3, dtypes=(None, torch.int64))
    staged = st.stage((x, y))
    assert staged.event is None
    sx, sy = staged.wait()
    assert torch.equal(sx, torch.from_numpy(x[6:8]))
    assert sy.dtype == torch.int64 and sy.tolist() == [6, 7]
    assert not sx.is_pinned()


# -- the three feeds of a BSP run ---------------------------------------------

def wrn_run(tmp_path=None, n_epochs=2, **knobs):
    out = bsp_worker.run(devices=["cpu"], config=dict(CFG, **knobs),
                         n_epochs=n_epochs, verbose=False,
                         checkpoint_dir=None if tmp_path is None
                         else str(tmp_path), **WRN)
    return out


@pytest.fixture(scope="module")
def sync_run(tmp_path_factory):
    d = tmp_path_factory.getbasetemp() / "no_data"
    d.mkdir(exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TM_DATA_DIR", str(d))
        out = wrn_run()
    return {"losses": out["recorder"].train_losses,
            "trees": {g: tree_to_flat(t) for g, t in
                      out["model"].checkpoint_trees().items()},
            "loader": out["loader"]}


@pytest.mark.parametrize("knobs", [dict(loader_pipeline=2),
                                   dict(loader_pipeline=True),
                                   dict(device_data_cache=True)],
                         ids=["pipelined", "pipelined_true", "device_cache"])
def test_feeds_train_bitwise_equal_to_the_synchronous_run(sync_run, knobs):
    """Two epochs of WResNet-10-1 (16 steps, an epoch boundary the
    feed resyncs across): losses and every parameter, BN statistic and
    momentum bitwise the synchronous run's."""
    out = wrn_run(**knobs)
    assert sync_run["loader"] is None
    assert out["recorder"].train_losses == sync_run["losses"]
    assert len(sync_run["losses"]) == 16
    for group, tree in out["model"].checkpoint_trees().items():
        got = tree_to_flat(tree)
        assert set(got) == set(sync_run["trees"][group])
        for k, v in got.items():
            assert np.array_equal(v, sync_run["trees"][group][k]), (group, k)
    if "loader_pipeline" in knobs:
        loader = out["loader"]
        assert loader["staged"] + loader["starved"] == 16
        assert loader["next_iter"] == 8 and loader["global_batch"] == 8
    else:
        assert out["loader"] is None
        assert out["model"]._device_cache is not None
    assert out["model"]._feed is None
    assert not loader_threads()


def test_llama_pipelined_feed_is_bitwise_equal_to_synchronous():
    runs = [bsp_worker.run(devices=["cpu"], config=dict(LLAMA_CFG, **knobs),
                           n_epochs=1, verbose=False, **LLAMA)
            for knobs in ({}, {"loader_pipeline": 2})]
    assert runs[0]["recorder"].train_losses == \
        runs[1]["recorder"].train_losses
    assert len(runs[0]["recorder"].train_losses) == 4
    from theanompi_tpu_torch.models.llama import _leaves

    for a, b in zip(*(_leaves(r["model"].params) for r in runs)):
        assert torch.equal(a, b)
    assert runs[1]["loader"]["staged"] + runs[1]["loader"]["starved"] == 4
    # the device-resident train set moves no batch bytes a step: a feed
    # asked for beside it is declined, loudly
    m = Llama(dict(LLAMA_CFG, device_data_cache=True, loader_pipeline=2),
              device="cpu")
    m.build_model()
    with pytest.warns(UserWarning, match="device_data_cache"):
        m.compile_iter_fns()
    assert m._feed is None and m._device_cache is not None


def test_checkpoint_stamps_the_jax_loader_cursor(tmp_path):
    wrn_run(tmp_path, n_epochs=1, loader_pipeline=2)
    meta = checkpoint_meta(tmp_path / "ckpt_0.npz")
    cur = meta["loader_cursor"]
    ref = JaxStreamingLoader(lambda i: (), lambda b: b, n_batches=1)
    assert set(cur) == set(ref.cursor()) | {"epoch"}
    ref.stop()
    assert cur["epoch"] == 0 and cur["next_iter"] == 8
    assert cur["next_sample"] == 8 * 8 and cur["global_batch"] == 8
    assert cur["staged"] + cur["starved"] == 8


def test_feed_lifetime_and_the_cache_declining_it():
    m = WResNet(dict(CFG, loader_pipeline=2), device="cpu")
    m.build_model()
    m.compile_iter_fns()
    rec = Recorder(verbose=False)
    m.data.shuffle(0)
    m.train_iter(0, rec)
    assert m._feed is not None and loader_threads()
    m.close_feed()
    m.close_feed()
    assert m._feed is None and not loader_threads()
    # the device-resident set moves no batch bytes a step: a feed
    # asked for beside it is declined, loudly
    m = WResNet(dict(CFG, loader_pipeline=2, device_data_cache=True),
                device="cpu")
    m.build_model()
    with pytest.warns(UserWarning, match="device_data_cache"):
        m.compile_iter_fns()
    assert m._feed is None and m._device_cache is not None


def test_device_cache_without_dataset_arrays_stages_per_step():
    m = WResNet(dict(CFG, device_data_cache=True), device="cpu")
    m.build_model()
    m.data.dataset_arrays = None
    with pytest.warns(UserWarning, match="dataset_arrays"):
        m.compile_iter_fns()
    assert m._device_cache is None
    rec = Recorder(verbose=False)
    m.data.shuffle(0)
    m.train_iter(0, rec)
    assert np.isfinite(rec.train_losses[0])


def test_no_producer_thread_outlives_a_failed_run(monkeypatch):
    def boom(self, count, recorder):
        self._feed.next(count)
        raise RuntimeError("step failed")

    monkeypatch.setattr(WResNet, "train_iter", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        wrn_run(n_epochs=1, loader_pipeline=2)
    assert not loader_threads()


# -- the knob repairs ---------------------------------------------------------

def test_fault_drills_are_refused_naming_a9(monkeypatch):
    """The classifier path runs under a drill list: ``stall_loader`` on
    the synchronous feed (no producer to stall) leaves the run as it
    was, and a malformed list is refused before anything is built."""
    from theanompi_tpu_torch.utils import faults

    monkeypatch.setenv("TM_FAULT_AT", "0:3:stall_loader")
    faults.reset_fault_cache()
    try:
        out = wrn_run(n_epochs=1)
        assert out["iterations"] == 8 and out["loader"] is None
        assert WResNet(CFG, device="cpu").config["depth"] == 10
        monkeypatch.setenv("TM_FAULT_AT", "0:3:melt")
        faults.reset_fault_cache()
        with pytest.raises(ValueError, match="TM_FAULT_AT"):
            wrn_run(n_epochs=1)
    finally:
        faults.reset_fault_cache()


def test_debug_sync_on_one_rank(monkeypatch, capsys):
    monkeypatch.setenv("TM_DEBUG_SYNC", "1")
    bsp_worker.run(devices=["cpu"], config=CFG, n_epochs=1, verbose=True,
                   print_freq=100, **WRN)
    assert "debug-sync epoch 0: spread=0" in capsys.readouterr().out


CHILD = """
import json, sys
import torch
from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.parallel.debug import check_replicas_synced
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.workers import bsp_worker

spec = json.loads(sys.argv[1])
rank, out = spec["rank"], {}
res = bsp_worker.run(init_method=spec["ports"][0], **spec["run"])
out["losses"] = res["recorder"].train_losses
# the desync: rank 1 nudges a parameter after its last step
step = ClassifierModel.train_iter
def nudged(self, count, recorder):
    step(self, count, recorder)
    if rank == 1 and count == self.data.n_batch_train - 1:
        with torch.no_grad():
            self.params[0].add_(1e-3)
ClassifierModel.train_iter = nudged
try:
    bsp_worker.run(init_method=spec["ports"][1], **spec["run"])
    out["desync"] = None
except RuntimeError as e:
    out["desync"] = str(e)
# the function alone: equal bits give 0.0, one nudged element its size
init_group(torch.device("cpu"), rank, 2, spec["ports"][2])
t = [torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.bfloat16)]
out["equal"] = check_replicas_synced(t)
t[0][1, 2] += 0.25 * rank
out["nudged"] = check_replicas_synced(t, strict=False)
destroy_group()
json.dump(out, open(spec["out"], "w"))
"""


def test_debug_sync_on_two_gloo_ranks_and_a_desync(tmp_path):
    """Two gloo ranks with ``TM_DEBUG_SYNC=1``: a clean epoch passes
    the check; with rank 1's parameter nudged after its last step the
    epoch-end check raises on both ranks; and the function alone gives
    0.0 on equal bits and the nudge's size on a nudged element."""
    base = 29500 + os.getpid() % 1500
    ports = [f"tcp://localhost:{base + k}" for k in (0, 1500, 3000)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), TM_DEBUG_SYNC="1")
    procs = []
    for rank in range(2):
        spec = dict(rank=rank, ports=ports, out=str(tmp_path / f"{rank}.json"),
                    run=dict(devices=["cpu", "cpu"], rank=rank, world_size=2,
                             config=dict(CFG, batch_size=4), n_epochs=1,
                             verbose=False, **WRN))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, json.dumps(spec)], env=env))
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    outs = [json.loads((tmp_path / f"{r}.json").read_text())
            for r in range(2)]
    assert outs[0]["losses"] == outs[1]["losses"]
    for out in outs:
        assert len(out["losses"]) == 8
        assert "replica desync in params" in out["desync"]
        assert out["equal"] == 0.0
        assert out["nudged"] == 0.25


def test_debug_sync_alone_is_zero_without_a_group():
    assert check_replicas_synced([torch.ones(3)]) == 0.0
