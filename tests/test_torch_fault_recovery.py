"""The port's resilience end to end on its real BSP worker, tiny fp32
Llama on the CPU: supervised runs through the ``TM_FAULT_AT`` drills
(1 and 2 gloo ranks) against the JAX worker's uninterrupted
trajectory, preemption checkpoints crossing the packages, the drills
at two ranks, the rank-group runner, the ``stall_loader`` drill on the
streaming feed and an elastic 2 → 1 shrink under zero1.

Tolerances: the port and the JAX worker sum in different orders, so
losses are held to ``tests/test_torch_train.py``'s rtol 1e-6 (fp32,
8-16 Adam steps).  Port against port takes the same tolerance: on the
CPU two identical runs of the port already differ by an ulp in some
losses (the CPU kernels' threaded reductions), a resumed one too.
"""

import shutil
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu.utils import faults as jax_faults
from theanompi_tpu.utils import supervisor as jax_sup
from theanompi_tpu.utils.checkpoint import save_checkpoint as jax_save
from theanompi_tpu.workers import bsp_worker as jax_worker
from theanompi_tpu_torch import BSP, launcher
from theanompi_tpu_torch.utils import checkpoint as port_ckpt
from theanompi_tpu_torch.utils import faults
from theanompi_tpu_torch.utils import supervisor as sup
from theanompi_tpu_torch.workers import bsp_worker as port_worker

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=16, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, lr=1e-2, optimizer="adam",
           exch_strategy="ici32")
LLAMA = dict(modelfile="theanompi_tpu_torch.models.llama",
             modelclass="Llama")
LOSS_RTOL = 1e-6
FAST = dict(backoff_base_s=0.01, backoff_cap_s=0.05, poll_interval_s=0.05,
            seed=0)


@pytest.fixture(autouse=True)
def clean_drills(monkeypatch):
    """No drill, heartbeat or restart context leaks into or out of a
    test (both packages' caches dropped)."""
    for var in ("TM_FAULT_AT", "TM_FAULT_STATE", "TM_WORLD_FILE",
                sup.HEARTBEAT_ENV, sup.RESTART_CTX_ENV):
        monkeypatch.delenv(var, raising=False)
    for mod in (faults, jax_faults):
        mod.reset_fault_cache()
    sup.reset_heartbeat_cache()
    jax_sup.reset_heartbeat_cache()
    yield monkeypatch
    for mod in (faults, jax_faults):
        mod.reset_fault_cache()
    sup.reset_heartbeat_cache()
    jax_sup.reset_heartbeat_cache()


def write_init(directory: Path, cfg: dict) -> Path:
    """The JAX model's initial params and Adam state as a checkpoint
    stamped epoch -1, which every run here resumes from."""
    model = JaxLlama(cfg)
    model.build_model(n_replicas=1)
    model.compile_iter_fns(mesh=make_mesh(data=1,
                                          devices=jax.devices("cpu")[:1]))
    jax_save(directory, 0, {"params": jax.device_get(model.params),
                            "opt_state": jax.device_get(model.opt_state)},
             {"epoch": -1, "lr": cfg["lr"]})
    return directory


def jax_run(directory, n_epochs=2, **kw):
    out = jax_worker.run(devices=[0], modelfile="theanompi_tpu.models.llama",
                         modelclass="Llama", config=CFG, n_epochs=n_epochs,
                         checkpoint_dir=str(directory), resume=True,
                         verbose=False, **kw)
    return out


def port_run(directory, n_epochs=2, **kw):
    return port_worker.run(devices=["cpu"], config=CFG, n_epochs=n_epochs,
                           checkpoint_dir=str(directory), resume=True,
                           verbose=False, **LLAMA, **kw)


@pytest.fixture(scope="module")
def init_dir(tmp_path_factory):
    return write_init(tmp_path_factory.mktemp("init"), CFG)


@pytest.fixture(scope="module")
def jax_losses(init_dir, tmp_path_factory):
    """The JAX worker's uninterrupted two epochs (16 steps)."""
    d = tmp_path_factory.mktemp("jax_ref")
    shutil.copytree(init_dir, d, dirs_exist_ok=True)
    return jax_run(d)["recorder"].train_losses


def final_losses(directory) -> list:
    """The per-step losses the newest checkpoint's recorder carries."""
    path = port_ckpt.latest_checkpoint(directory)
    return port_ckpt.checkpoint_meta(path)["recorder"]["train_losses"]


def test_supervised_run_through_die_and_sigterm_matches_jax(
        init_dir, jax_losses, tmp_path, clean_drills):
    """``BSP().init(launch="supervised")``: a sigterm mid-epoch 0
    (preemption checkpoint, resumed inside the epoch) and a die in
    epoch 1 (resumed from epoch 0's checkpoint, its two steps redone);
    the 16 losses are the JAX worker's uninterrupted ones."""
    shutil.copytree(init_dir, tmp_path, dirs_exist_ok=True)
    clean_drills.setenv("TM_FAULT_AT", "0:3:sigterm,1:2:die")
    rule = BSP()
    rule.init(devices=["cpu"], launch="supervised", config=CFG, n_epochs=2,
              checkpoint_dir=str(tmp_path), resume=True, verbose=False,
              supervise=FAST, **LLAMA)
    rep = rule.wait()
    assert rep["completed"] and rep["n_restarts"] == 2
    assert [(e["cause"], e["exit_code"], e["resumed_from"])
            for e in rep["restarts"]] == [("sigterm", 0, [0, 4]),
                                          ("preemption", 137, [0, None])]
    assert all(e["recovery_s"] > 0 for e in rep["restarts"])
    assert rep["mttr_s"] > 0
    assert rep["final_heartbeat"]["status"] == "completed"
    got = final_losses(tmp_path)
    assert len(got) == len(jax_losses) == 16
    np.testing.assert_allclose(got, jax_losses, rtol=LOSS_RTOL, atol=0)
    meta = port_ckpt.checkpoint_meta(port_ckpt.latest_checkpoint(tmp_path))
    assert [e["cause"] for e in meta["recorder"]["restart_events"]] == \
        ["sigterm", "preemption"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_preemption_checkpoint_resumes_across_the_packages(
        init_dir, jax_losses, tmp_path, clean_drills, writer):
    """One package is preempted at epoch 0 iter 5 (SIGTERM in-process:
    the checkpoint stamps ``next_iter`` 6); the other resumes it inside
    the epoch, and the 16 losses are the uninterrupted run's."""
    shutil.copytree(init_dir, tmp_path, dirs_exist_ok=True)
    clean_drills.setenv("TM_FAULT_AT", "0:5:sigterm")
    first, second = (jax_run, port_run) if writer == "jax" \
        else (port_run, jax_run)
    out = first(tmp_path)
    assert out["preempted"] and out["iterations"] == 6
    meta = port_ckpt.checkpoint_meta(port_ckpt.latest_checkpoint(tmp_path))
    assert meta["next_iter"] == 6 and meta["preempted"] is True
    clean_drills.delenv("TM_FAULT_AT")
    out = second(tmp_path)
    assert out["resumed_from"] == [0, 6] and not out["preempted"]
    np.testing.assert_allclose(out["recorder"].train_losses, jax_losses,
                               rtol=LOSS_RTOL, atol=0)


def test_supervised_two_ranks_match_one(init_dir, tmp_path, clean_drills):
    """Two gloo ranks (batch 2 each, the same global batch) supervised
    through a sigterm both ranks agree on; their losses are the one-rank
    run's."""
    shutil.copytree(init_dir, tmp_path / "one", dirs_exist_ok=True)
    want = port_run(tmp_path / "one")["recorder"].train_losses
    d = tmp_path / "two"
    shutil.copytree(init_dir, d, dirs_exist_ok=True)
    clean_drills.setenv("TM_FAULT_AT", "0:2:sigterm")
    rule = BSP()
    rule.init(devices=["cpu", "cpu"], launch="supervised",
              config=dict(CFG, batch_size=2), n_epochs=2,
              checkpoint_dir=str(d), resume=True, verbose=False,
              supervise=FAST, **LLAMA)
    rep = rule.wait()
    assert [(e["cause"], e["resumed_from"]) for e in rep["restarts"]] == \
        [("sigterm", [0, 3])]
    np.testing.assert_allclose(final_losses(d), want, rtol=LOSS_RTOL, atol=0)


def test_corrupt_ckpt_at_two_ranks_fails_verification(init_dir, tmp_path,
                                                      clean_drills):
    """Both ranks fire the drill; one corrupts (an XOR by each would
    flip the bytes back), then both die 137."""
    shutil.copytree(init_dir, tmp_path, dirs_exist_ok=True)
    clean_drills.setenv("TM_FAULT_AT", "1:0:corrupt_ckpt")
    rule = BSP()
    rule.init(devices=["cpu", "cpu"], config=dict(CFG, batch_size=2),
              n_epochs=2, checkpoint_dir=str(tmp_path), resume=True,
              verbose=False, **LLAMA)
    with pytest.raises(RuntimeError, match=r"\[137, 137\]"):
        rule.wait()
    (path,) = port_ckpt.checkpoints(tmp_path)
    assert port_ckpt.checkpoint_meta(path)["epoch"] == 0
    assert not port_ckpt.verify_checkpoint(path)
    assert port_ckpt.latest_checkpoint(tmp_path, validate=True) is None
    assert (tmp_path / "ckpt_0.npz.corrupt").exists()


def test_the_ranks_agree_on_a_preemption(tmp_path):
    """Under a supervisor at two ranks, a SIGTERM seen by rank 1 alone
    stops both at the same boundary (the max allreduce)."""
    code = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(ROOT)!r})
        from theanompi_tpu_torch.parallel.mesh import init_group
        from theanompi_tpu_torch.utils import supervisor as sup
        from theanompi_tpu_torch.workers.bsp_worker import _preempt_agreed
        r = int(sys.argv[1])
        init_group(torch.device("cpu"), r, 2, sys.argv[2])
        flag = torch.zeros(1)
        first = _preempt_agreed(flag, 2, True)
        sup._preempt_requested = r == 1
        print(first, _preempt_agreed(flag, 2, True),
              _preempt_agreed(flag, 2, False))
    """)
    cmds = [[sys.executable, "-c", code, str(r), launcher.INIT_METHOD]
            for r in range(2)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, text=True)
             for c in launcher._with_init(cmds)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert outs == [["False", "True", "False"], ["False", "True", "True"]]


def test_the_group_runner_ends_a_life_when_one_rank_dies(tmp_path):
    """Rank 1 dies 137 while rank 0 would sit in a collective for a
    minute: the runner kills rank 0 at once and exits 137."""
    marker = tmp_path / "rank0-finished"
    sleeper = (f"import time, pathlib; time.sleep(60); "
               f"pathlib.Path({str(marker)!r}).touch()")
    cmds = [[sys.executable, "-c", sleeper],
            [sys.executable, "-c", "import os, time; time.sleep(0.5); "
             "os._exit(137)"]]
    t0 = time.monotonic()
    r = subprocess.run(launcher.rank_group_cmd(cmds), cwd=ROOT, timeout=120)
    assert r.returncode == 137
    assert time.monotonic() - t0 < 30 and not marker.exists()
    # a signal death reads as 128 + N; every rank exiting 0 is 0; the
    # caller's SIGTERM handler is back afterwards
    before = signal.getsignal(signal.SIGTERM)
    assert launcher.run_rank_group([[sys.executable, "-c",
                                     "import os, signal; "
                                     "os.kill(os.getpid(), signal.SIGKILL)"]]
                                   ) == 137
    assert launcher.run_rank_group([[sys.executable, "-c", ""]] * 2) == 0
    assert signal.getsignal(signal.SIGTERM) is before


def test_stall_loader_degrades_and_stays_bitwise(tmp_path, clean_drills):
    """The producer sits out four batches (a sleep of the consumer's
    timeout each, so the consumer's wait on one of them runs out): the
    consumer fetches it itself (``starved``), and every loss is the
    synchronous run's.  The drill fires after step 0, with batches 1
    and 2 already in the depth-2 ring; the consumer starves on batch 3
    as long as steps 1 and 2 take less than three timeouts (6 s), which
    holds on a loaded host too (two stalled batches left it 2 s)."""
    cfg = dict(CFG, n_train=16)
    want = port_worker.run(devices=["cpu"], config=cfg, n_epochs=1,
                           verbose=False, **LLAMA)
    clean_drills.setenv("TM_FAULT_AT", "0:0:stall_loader")
    clean_drills.setenv("TM_STALL_LOADER_N", "4")
    faults.reset_fault_cache()          # the first run parsed no drill
    out = port_worker.run(devices=["cpu"], config=dict(cfg, loader_pipeline=2),
                          n_epochs=1, verbose=False, **LLAMA)
    assert out["recorder"].train_losses == want["recorder"].train_losses
    assert out["loader"]["starved"] >= 1
    assert out["loader"]["staged"] + out["loader"]["starved"] == 4


def test_elastic_shrink_two_to_one_under_zero1(init_dir, tmp_path,
                                               clean_drills):
    """``elastic=True`` at two ranks under a bucketed zero1: a
    ``shrink_world`` drill in epoch 1 takes the world to 1; the
    relaunch keeps the global batch (batch 4 at one rank) and reshards
    the zero1 state from epoch 0's ``.shards``; epoch 1's losses equal
    a one-rank run resumed from a copy of that checkpoint."""
    cfg = dict(CFG, batch_size=2, exch_strategy="zero1",
               exchange_bucket_mb=0.01)
    d = tmp_path / "elastic"
    clean_drills.setenv("TM_FAULT_AT", "1:2:shrink_world")
    rule = BSP()
    rule.init(devices=["cpu", "cpu"], elastic=True, config=cfg, n_epochs=2,
              checkpoint_dir=str(d), verbose=False, supervise=FAST, **LLAMA)
    rep = rule.wait()
    assert rep["elastic"] and rep["world_size_history"] == [2, 1]
    (ev,) = rep["restarts"]
    assert ev["cause"] == "preemption" and ev["world_size"] == 1
    assert ev["resharded"] is True and ev["resumed_from"] == [0, None]
    meta = port_ckpt.checkpoint_meta(port_ckpt.latest_checkpoint(d))
    assert meta["world_size"] == 1 and meta["global_batch"] == 4
    got = meta["recorder"]["train_losses"]
    clean_drills.delenv("TM_FAULT_AT")
    ref = tmp_path / "ref"
    ref.mkdir()
    shutil.copytree(d / "ckpt_0.shards", ref / "ckpt_0.shards")
    out = port_worker.run(devices=["cpu"], config=dict(cfg, elastic=True),
                          n_epochs=2, checkpoint_dir=str(ref), resume=True,
                          verbose=False, **LLAMA)
    note = out["elastic_resume"]
    assert note == {"policy": "global", "saved_world": 2, "saved_global": 4,
                    "batch_size": 4}
    assert out["resharded"] and out["resumed_from"] == [0, None]
    assert len(got) == len(out["recorder"].train_losses) == 16
    np.testing.assert_allclose(got, out["recorder"].train_losses,
                               rtol=LOSS_RTOL, atol=0)


ASYNC_CFG = dict(vocab=64, emb_dim=8, hidden=8, maxlen=12, batch_size=4,
                 n_train=64, n_val=16, compute_dtype="float32", seed=3)


@pytest.mark.parametrize("rule", ["EASGD", "GOSGD"])
def test_async_rules_preempt_and_resume_inside_the_epoch(tmp_path,
                                                         clean_drills, rule):
    """The async rules' loops carry the same hooks: a sigterm after
    iteration 1 checkpoints with ``next_iter`` 2 and ``preempted``, and
    a resume continues at iteration 2 (two workers in one process)."""
    import theanompi_tpu_torch as tm

    kw = dict(devices=["cpu"] * 2, launch="inprocess",
              modelfile="theanompi_tpu_torch.models.lstm",
              modelclass="LSTM", config=ASYNC_CFG, n_epochs=1,
              checkpoint_dir=str(tmp_path), verbose=False)
    clean_drills.setenv("TM_FAULT_AT", "0:1:sigterm")
    first = getattr(tm, rule)()
    first.init(**kw)
    out = first.wait()
    assert out["preempted"] and out["iterations"] == 2
    meta = port_ckpt.checkpoint_meta(port_ckpt.latest_checkpoint(tmp_path))
    assert meta["next_iter"] == 2 and meta["preempted"] is True
    second = getattr(tm, rule)()
    second.init(**kw, resume=True)
    out = second.wait()
    assert not out["preempted"] and out["resumed_from"] == [0, 2]
    assert out["iterations"] == 8    # 64 / (4 x 2 workers) steps in all
