"""The port's resilience units against the JAX package's: the
supervisor (``utils/supervisor.py``, a copy), the fault drills'
parsing and state, checkpoint validation, quarantine and retention,
the recorder's restart accounting, and the elastic policy functions of
``workers/bsp_worker.py``.

Where the JAX package has the same function, both run on the same
inputs: the exit table, the backoff delays at one seed, the reports
of a supervised toy child (keys and causes), the elastic batch policy
and world fit on one checkpoint's metadata, and the checkpoint a
validated resume picks in one directory holding both packages'
checkpoints (the same pick, the same quarantined and pruned names).
The toy children are plain Python, so every supervisor test runs in
about a second.
"""

import json
import os
import shutil
import signal
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from theanompi_tpu.utils import checkpoint as jax_ckpt
from theanompi_tpu.utils import supervisor as jax_sup
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder
from theanompi_tpu.workers import bsp_worker as jax_bsp
from theanompi_tpu_torch import launcher
from theanompi_tpu_torch.utils import checkpoint as port_ckpt
from theanompi_tpu_torch.utils import faults
from theanompi_tpu_torch.utils import supervisor as sup
from theanompi_tpu_torch.utils.recorder import Recorder
from theanompi_tpu_torch.workers import bsp_worker as port_bsp

PACKAGES = {"jax": jax_sup, "port": sup}
FAST = dict(backoff_base_s=0.01, backoff_cap_s=0.05, poll_interval_s=0.05,
            verbose=False, seed=0)


# -- heartbeats ---------------------------------------------------------------

@pytest.fixture()
def hb_file(tmp_path, monkeypatch):
    p = tmp_path / "hb.json"
    monkeypatch.setenv(sup.HEARTBEAT_ENV, str(p))
    sup.reset_heartbeat_cache()
    yield p
    sup.reset_heartbeat_cache()


def test_heartbeat_is_a_noop_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv(sup.HEARTBEAT_ENV, raising=False)
    sup.reset_heartbeat_cache()
    sup.heartbeat(5, 0, 1)
    sup.flush_final_heartbeat()
    assert list(tmp_path.iterdir()) == []
    sup.reset_heartbeat_cache()


def test_heartbeat_stamp_reads_in_both_packages(hb_file):
    sup.heartbeat(7, epoch=1, it=3, resumed_from=[1, 2])
    for pkg in PACKAGES.values():
        hb = pkg.read_heartbeat(hb_file)
        assert hb["progress"] == 7 and hb["epoch"] == 1 and hb["iter"] == 3
        assert hb["status"] == "running" and hb["resumed_from"] == [1, 2]
        assert hb["pid"] == os.getpid()


def test_running_stamps_are_throttled_status_is_not(hb_file):
    sup.heartbeat(1)
    sup.heartbeat(2)                 # within 50 ms: dropped
    assert sup.read_heartbeat(hb_file)["progress"] == 1
    sup.heartbeat(3, status="preempted")
    assert sup.read_heartbeat(hb_file)["status"] == "preempted"
    time.sleep(sup._HB_MIN_INTERVAL_S + 0.01)
    sup.heartbeat(4)
    assert sup.read_heartbeat(hb_file)["progress"] == 4


@pytest.mark.parametrize("prev,ok,want", [
    ("running", True, "completed"), ("running", False, "failed"),
    ("preempted", True, "preempted"), ("failed", True, "failed"),
])
def test_final_heartbeat_keeps_progress_and_never_upgrades(hb_file, prev,
                                                           ok, want):
    sup.heartbeat(9, 2, 4, status=prev)
    sup.flush_final_heartbeat(ok=ok)
    hb = sup.read_heartbeat(hb_file)
    assert (hb["progress"], hb["epoch"], hb["iter"]) == (9, 2, 4)
    assert hb["status"] == want


def test_read_heartbeat_tolerates_garbage(tmp_path):
    p = tmp_path / "hb.json"
    assert sup.read_heartbeat(p) is None
    p.write_text("{not json")
    assert sup.read_heartbeat(p) is None


# -- graceful preemption --------------------------------------------------------

def test_sigterm_sets_the_flag_and_uninstall_restores():
    before = signal.getsignal(signal.SIGTERM)
    try:
        assert sup.install_preemption_handler()
        assert not sup.preemption_requested()
        signal.raise_signal(signal.SIGTERM)
        assert sup.preemption_requested()
        sup.reset_preemption()
        assert not sup.preemption_requested()
    finally:
        sup.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is before
    assert not sup.preemption_requested()


# -- exits, backoff ---------------------------------------------------------------

EXIT_TABLE = [
    (0, "completed", "clean"), (0, None, "clean"),
    (0, "preempted", "sigterm"), (137, None, "preemption"),
    (-signal.SIGKILL, None, "preemption"), (143, None, "sigterm"),
    (-signal.SIGTERM, None, "sigterm"), (1, None, "crash"),
    (3, "running", "crash"),
]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("rc,hb,want", EXIT_TABLE)
def test_classify_exit_table(pkg, rc, hb, want):
    assert PACKAGES[pkg].classify_exit(rc, hb) == want


@pytest.mark.parametrize("jitter,seed", [(0.0, 0), (0.25, 7), (0.5, 11)])
def test_backoff_delays_equal_the_jax_supervisors(tmp_path, jitter, seed):
    kw = dict(checkpoint_dir=str(tmp_path), backoff_base_s=1.0,
              backoff_cap_s=8.0, backoff_jitter=jitter, seed=seed)
    mine = sup.Supervisor(cmd_for=lambda r: ["true"], **kw)
    ref = jax_sup.Supervisor(cmd_for=lambda r: ["true"], **kw)
    got = [mine._backoff(a) for a in range(1, 7)]
    assert got == [ref._backoff(a) for a in range(1, 7)]
    if not jitter:
        assert got == [1.0, 2.0, 4.0, 8.0, 8.0, 8.0]


# -- the supervisor loop on toy children ---------------------------------------------

def child(tmp_path: Path, body: str) -> Path:
    p = tmp_path / "child.py"
    p.write_text(body)
    return p


CLEAN = """
import json, os, time
open(os.environ["TM_HEARTBEAT_FILE"], "w").write(json.dumps(
    {"progress": 3, "status": "completed", "time": time.time()}))
"""

# dies 137 in its first life (no marker), completes in the second,
# which must have been launched with resume and the restart context
DIE_THEN_RESUME = """
import json, os, sys, time
marker = os.path.join(os.path.dirname(__file__), "lived-" + sys.argv[2])
hb = os.environ["TM_HEARTBEAT_FILE"]
open(hb, "w").write(json.dumps(
    {"progress": 1, "status": "running", "time": time.time()}))
time.sleep(0.3)
if not os.path.exists(marker):
    open(marker, "w").write("x")
    os._exit(137)
assert sys.argv[1] == "resume", sys.argv
ctx = json.loads(os.environ["TM_RESTART_CONTEXT"])
assert ctx["cause"] == "preemption" and ctx["restart"] == 1
open(hb, "w").write(json.dumps(
    {"progress": 2, "status": "completed", "time": time.time(),
     "resumed_from": [0, None]}))
"""

HANG_ONCE = """
import json, os, sys, time
hb = os.environ["TM_HEARTBEAT_FILE"]
marker = os.path.join(os.path.dirname(__file__), "lived-" + sys.argv[1])
open(hb, "w").write(json.dumps(
    {"progress": 1, "status": "running", "time": time.time()}))
if not os.path.exists(marker):
    open(marker, "w").write("x")
    time.sleep(600)
open(hb, "w").write(json.dumps(
    {"progress": 2, "status": "completed", "time": time.time()}))
"""


def supervise_both(tmp_path, cmd_for, **kw) -> dict:
    """``{package: report}`` of the same toy child under each package's
    supervisor (separate checkpoint directories)."""
    out = {}
    for name, pkg in PACKAGES.items():
        if kw.get("elastic"):
            def one(r, n_devices=None, n=name):
                return cmd_for(r, n, n_devices=n_devices)
        else:
            def one(r, n=name):
                return cmd_for(r, n)
        s = pkg.Supervisor(cmd_for=one,
                           checkpoint_dir=str(tmp_path / f"ck-{name}"),
                           **{**FAST, **kw})
        out[name] = s.run()
    return out


def test_clean_completion_no_restarts(tmp_path):
    c = child(tmp_path, CLEAN)
    reps = supervise_both(tmp_path, lambda r, n: [sys.executable, str(c)])
    assert reps["port"].keys() == reps["jax"].keys()
    for rep in reps.values():
        assert rep["completed"] and rep["n_restarts"] == 0
        assert rep["final_heartbeat"]["status"] == "completed"


def test_die_then_resume(tmp_path):
    c = child(tmp_path, DIE_THEN_RESUME)
    reps = supervise_both(tmp_path, lambda r, n: [
        sys.executable, str(c), "resume" if r else "fresh", n])
    assert reps["port"].keys() == reps["jax"].keys()
    for rep in reps.values():
        assert rep["completed"] and rep["n_restarts"] == 1
        (ev,) = rep["restarts"]
        assert ev["cause"] == "preemption" and ev["exit_code"] == 137
        assert ev["resumed_from"] == [0, None]
        assert ev["recovery_s"] is not None
    assert reps["port"]["restarts"][0].keys() == \
        reps["jax"]["restarts"][0].keys()


def test_hang_is_killed_within_the_timeout(tmp_path):
    c = child(tmp_path, HANG_ONCE)
    t0 = time.monotonic()
    s = sup.Supervisor(cmd_for=lambda r: [sys.executable, str(c), "port"],
                       checkpoint_dir=str(tmp_path / "ck"),
                       stall_timeout_s=1.0, startup_grace_s=20.0, **FAST)
    rep = s.run()
    assert time.monotonic() - t0 < 20.0
    assert rep["completed"] and rep["n_restarts"] == 1
    assert rep["restarts"][0]["cause"] == "hang"
    assert rep["restarts"][0]["exit_code"] is None


def test_budget_exhaustion_is_loud(tmp_path):
    c = child(tmp_path, """
import json, os, time
open(os.environ["TM_HEARTBEAT_FILE"], "w").write(json.dumps(
    {"progress": 1, "status": "running", "time": time.time()}))
time.sleep(0.2)
os._exit(137)
""")
    for pkg in PACKAGES.values():
        s = pkg.Supervisor(cmd_for=lambda r: [sys.executable, str(c)],
                           checkpoint_dir=str(tmp_path / "ck"),
                           max_restarts=2, crash_loop_budget=99, **FAST)
        with pytest.raises(pkg.SupervisorGaveUp,
                           match="budget exhausted") as ei:
            s.run()
        assert [e["cause"] for e in ei.value.report["restarts"]] == \
            ["preemption"] * 2


def test_crash_loop_gives_up_early(tmp_path):
    reports = []
    for pkg in PACKAGES.values():
        s = pkg.Supervisor(
            cmd_for=lambda r: [sys.executable, "-c", "raise SystemExit(3)"],
            checkpoint_dir=str(tmp_path / "ck"), max_restarts=50,
            crash_loop_budget=2, **FAST)
        with pytest.raises(pkg.SupervisorGaveUp, match="crash loop") as ei:
            s.run()
        reports.append(ei.value.report)
    assert reports[0]["n_restarts"] == reports[1]["n_restarts"] <= 3
    assert reports[0].keys() == reports[1].keys()


def test_metrics_txt_counts_causes(tmp_path):
    c = child(tmp_path, DIE_THEN_RESUME)
    s = sup.Supervisor(cmd_for=lambda r: [
        sys.executable, str(c), "resume" if r else "fresh", "m"],
        checkpoint_dir=str(tmp_path / "ck"), **FAST)
    s.run()
    txt = s.metrics_txt()
    assert "tm_train_restarts_total 1" in txt
    assert 'tm_train_restart_causes_total{cause="preemption"} 1' in txt


# -- elastic supervision ------------------------------------------------------------

SHRINK = """
import json, os, sys, time
hb = os.environ["TM_HEARTBEAT_FILE"]
n = int(sys.argv[1])
open(hb, "w").write(json.dumps(
    {"progress": 1, "status": "running", "time": time.time(),
     "world_size": n}))
time.sleep(0.2)
if n == 8:
    open(os.environ["TM_WORLD_FILE"], "w").write("4")
    os._exit(137)
ctx = json.loads(os.environ["TM_RESTART_CONTEXT"])
assert ctx["world_size"] == 4, ctx
open(hb, "w").write(json.dumps(
    {"progress": 2, "status": "completed", "time": time.time(),
     "world_size": n, "resharded": True}))
"""


def test_elastic_relaunch_resizes_the_world(tmp_path):
    c = child(tmp_path, SHRINK)
    reps = supervise_both(
        tmp_path,
        lambda r, n, n_devices=None: [sys.executable, str(c),
                                      str(n_devices)],
        elastic=True, n_devices=8, elastic_min_dp=2)
    for rep in reps.values():
        assert rep["completed"] and rep["elastic"] is True
        assert rep["world_size_history"] == [8, 4]
        (ev,) = rep["restarts"]
        assert ev["world_size"] == 4 and ev["resharded"] is True
    assert reps["port"].keys() == reps["jax"].keys()


def test_elastic_min_dp_gives_up_loudly(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / ".world").write_text("1")
    s = sup.Supervisor(cmd_for=lambda r, n_devices=None: [sys.executable,
                                                          "-c", ""],
                       checkpoint_dir=str(ck), elastic=True, n_devices=8,
                       elastic_min_dp=2, **FAST)
    with pytest.raises(sup.SupervisorGaveUp, match="elastic_min_dp"):
        s.run()
    with pytest.raises(ValueError, match="n_devices"):
        sup.Supervisor(cmd_for=lambda r: [], checkpoint_dir=str(ck),
                       elastic=True)


def test_probe_clamps_and_ignores_garbage(tmp_path):
    ck = tmp_path / "ck"
    probes = []
    for pkg in PACKAGES.values():
        s = pkg.Supervisor(cmd_for=lambda r: [], checkpoint_dir=str(ck),
                           elastic=True, n_devices=8, verbose=False)
        got = []
        for text in (None, "16", "6", "nonsense"):
            if text is not None:
                (ck / ".world").write_text(text)
            got.append(s._probe_world())
        (ck / ".world").unlink()
        probes.append(got)
    assert probes[0] == probes[1] == [8, 8, 6, 8]


def group_specs(cmd: list[str]) -> list[dict]:
    """The spec json of each rank of a rank-group command."""
    assert cmd[-2] == "--rank-group"
    return [json.loads(c[c.index("--spec-json") + 1])
            for c in json.loads(cmd[-1])]


def test_cmd_factory_resizes_the_device_list():
    """One command a life: the rank-group runner over one process a
    device, each with its rank, the world and the rendezvous
    placeholder; an elastic relaunch takes a prefix of the devices."""
    kw = dict(devices=["cpu"] * 4, modelfile="m", modelclass="C",
              rule_kwargs={"n_epochs": 1})
    cmd_for = sup.make_worker_cmd_factory(
        "theanompi_tpu_torch.workers.bsp_worker", **kw)
    jax_for = jax_sup.make_worker_cmd_factory(
        "theanompi_tpu.workers.bsp_worker", **kw)
    for n in (None, 2):
        specs = group_specs(cmd_for(True, n_devices=n))
        want = json.loads(jax_for(True, n_devices=n)[-1])
        assert len(specs) == len(want["devices"])
        assert all(s["devices"] == want["devices"] for s in specs)
        assert all(s["kwargs"] == want["kwargs"] for s in specs)
    ranks = json.loads(cmd_for(False, n_devices=2)[-1])
    assert [c[c.index("--rank") + 1] for c in ranks] == ["0", "1"]
    assert all(c[c.index("--world-size") + 1] == "2" for c in ranks)
    assert all(c[c.index("--init-method") + 1] == launcher.INIT_METHOD
               for c in ranks)
    assert group_specs(cmd_for(False))[0]["kwargs"]["resume"] is False


def test_cmd_factory_async_rule_is_one_process():
    cmd_for = sup.make_worker_cmd_factory(
        "theanompi_tpu_torch.workers.easgd_worker", ["cpu"] * 4, "m", "C",
        {})
    (rank,) = json.loads(cmd_for(True)[-1])
    assert "--rank" not in rank
    assert json.loads(rank[rank.index("--spec-json") + 1])["devices"] == \
        ["cpu"] * 4


def test_each_life_gets_a_fresh_rendezvous():
    cmds = [["x", launcher.INIT_METHOD], ["y", launcher.INIT_METHOD]]
    a, b = launcher._with_init(cmds), launcher._with_init(cmds)
    assert a[0][1] == a[1][1] != b[0][1] == b[1][1]
    assert a[0][1].startswith("tcp://localhost:")


# -- fault drills: parsing and fired state -------------------------------------------

@pytest.fixture()
def clean_faults(monkeypatch):
    monkeypatch.delenv("TM_FAULT_AT", raising=False)
    monkeypatch.delenv("TM_FAULT_STATE", raising=False)
    faults.reset_fault_cache()
    yield monkeypatch
    faults.reset_fault_cache()


def test_fault_list_parses_every_training_action(clean_faults):
    clean_faults.setenv("TM_FAULT_AT", "1:3:die, 2:1:hang ,3:2:corrupt_ckpt,"
                        "4:0,0:1:lose_device,1:2:shrink_world,"
                        "0:4:stall_loader,0:5:sigterm")
    assert faults._target() == [
        (1, 3, "die"), (2, 1, "hang"), (3, 2, "corrupt_ckpt"), (4, 0, "die"),
        (0, 1, "lose_device"), (1, 2, "shrink_world"),
        (0, 4, "stall_loader"), (0, 5, "sigterm")]
    clean_faults.setenv("TM_FAULT_AT", "1:2:explode")
    faults.reset_fault_cache()
    with pytest.raises(ValueError, match="TM_FAULT_AT"):
        faults.maybe_inject_fault(1, 2)


def test_sigterm_fires_once_and_the_state_survives_a_relaunch(clean_faults,
                                                              tmp_path):
    state = tmp_path / "fault_state"
    clean_faults.setenv("TM_FAULT_AT", "0:0:sigterm,1:0:sigterm")
    clean_faults.setenv("TM_FAULT_STATE", str(state))
    try:
        sup.install_preemption_handler()
        faults.maybe_inject_fault(0, 0)
        assert sup.preemption_requested()
        assert state.read_text().strip() == "0"
        faults.reset_fault_cache()           # the relaunched process
        sup.reset_preemption()
        faults.maybe_inject_fault(0, 0)      # fired last life: skipped
        assert not sup.preemption_requested()
        faults.maybe_inject_fault(1, 0)
        assert sup.preemption_requested()
    finally:
        sup.uninstall_preemption_handler()


def test_only_rank_zero_writes_the_fired_state(clean_faults, tmp_path):
    """Rank 1 fires the same fault but leaves the file alone; it still
    holds the fault as fired in its own process."""
    state = tmp_path / "fault_state"
    clean_faults.setenv("TM_FAULT_AT", "0:0:stall_loader")
    clean_faults.setenv("TM_FAULT_STATE", str(state))
    met = []
    faults.maybe_inject_fault(0, 0, rank=1, barrier=lambda: met.append(1))
    assert met == [1] and not state.exists()
    assert faults._fired == {0}
    faults.reset_fault_cache()
    faults.maybe_inject_fault(0, 0, rank=0, barrier=lambda: met.append(0))
    assert met == [1, 0] and state.read_text().strip() == "0"
    assert faults.consume_loader_stall()   # each rank stalls its own feed


def test_corrupt_without_a_directory_raises(clean_faults):
    clean_faults.setenv("TM_FAULT_AT", "0:0:corrupt_ckpt")
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        faults.maybe_inject_fault(0, 0)


@pytest.mark.parametrize("action,start,want", [
    ("lose_device", 8, 7), ("shrink_world", 8, 4), ("shrink_world", 1, 1),
])
def test_world_drills_write_the_file_and_die(tmp_path, action, start, want):
    """The port's drill writes the count the JAX drill writes, then dies
    137 (a subprocess: ``os._exit`` cannot be caught in-process)."""
    import subprocess

    codes, counts = [], []
    for pkg in ("theanompi_tpu", "theanompi_tpu_torch"):
        wf = tmp_path / f"world-{pkg}"
        env = dict(os.environ, TM_FAULT_AT=f"0:0:{action}",
                   TM_WORLD_FILE=str(wf),
                   PYTHONPATH=str(Path(__file__).resolve().parent.parent))
        code = (f"from {pkg}.utils import faults\n"
                f"faults.maybe_inject_fault(0, 0, world={start})\n")
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        codes.append(r.returncode)
        counts.append(int(wf.read_text().strip()))
    assert codes == [137, 137] and counts == [want, want]


def test_world_drill_needs_the_world_file(clean_faults):
    clean_faults.setenv("TM_FAULT_AT", "0:0:lose_device")
    clean_faults.delenv("TM_WORLD_FILE", raising=False)
    with pytest.raises(RuntimeError, match="TM_WORLD_FILE"):
        faults.maybe_inject_fault(0, 0, world=8)


# -- the recorder's restarts ------------------------------------------------------------

def test_record_restart_round_trips_across_the_packages(monkeypatch):
    monkeypatch.setenv(sup.RESTART_CTX_ENV, json.dumps(
        {"restart": 2, "cause": "hang", "t_fail": time.time() - 1.0,
         "world_size": 4}))
    rec = Recorder(verbose=False)
    sup.record_restart_into(rec, 3, 5, resharded=True)
    rec.record_restart("preemption", 4, None, recovery_s=3.0)
    (first, second) = rec.restart_events
    assert first["cause"] == "hang" and first["restart"] == 2
    assert (first["resumed_epoch"], first["resumed_iter"]) == (3, 5)
    assert first["world_size"] == 4 and first["resharded"] is True
    assert second["restart"] == 2      # the count of events so far
    assert rec.mttr_s == pytest.approx((first["recovery_s"] + 3.0) / 2)
    ref = JaxRecorder(verbose=False)
    ref.load_state_dict(rec.state_dict())
    assert ref.restart_events == rec.restart_events
    assert ref.mttr_s == rec.mttr_s
    back = Recorder(verbose=False)
    back.load_state_dict(ref.state_dict())
    assert back.restart_events == rec.restart_events


# -- checkpoint validation, quarantine, retention ----------------------------------------

def trees(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(6, 10)).astype(np.float32),
                       "b": rng.normal(size=10).astype(np.float32)}}


def flip(path: Path, n: int = 16) -> None:
    data = bytearray(path.read_bytes())
    mid = len(data) // 2
    for k in range(mid, mid + n):
        data[k] ^= 0xFF
    path.write_bytes(bytes(data))


def mixed_dir(d: Path) -> Path:
    """Steps 0, 2, 4 written by the JAX package and 1, 3, 5 by the port;
    steps 5 and 4 corrupt (a bit flip, a truncation)."""
    d.mkdir()
    for step in range(6):
        save = jax_ckpt.save_checkpoint if step % 2 == 0 \
            else port_ckpt.save_checkpoint
        save(d, step, trees(step), {"epoch": step})
    flip(d / "ckpt_5.npz")
    blob = (d / "ckpt_4.npz").read_bytes()
    (d / "ckpt_4.npz").write_bytes(blob[: len(blob) // 2])
    return d


def test_verify_agrees_with_jax_on_both_packages_files(tmp_path):
    """Both packages' files verify alike; the port's npz (digests hashed
    in threads) has every member CRC right for numpy's zip reader, and
    its arrays and digests are the JAX writer's, for a 0-d, a
    Fortran-ordered and an empty array too."""
    import zipfile

    d = mixed_dir(tmp_path / "d")
    for step in range(6):
        p = d / f"ckpt_{step}.npz"
        assert port_ckpt.verify_checkpoint(p) == \
            jax_ckpt.verify_checkpoint(p) == (step < 4)
    with zipfile.ZipFile(d / "ckpt_3.npz") as z:
        assert z.testzip() is None
    tree = {"params": {**trees(0)["params"], "s": np.float32(2.0),
                       "f": np.asfortranarray(np.ones((3, 2))),
                       "e": np.zeros((0, 4), np.int32)}}
    for save in (port_ckpt.save_checkpoint, jax_ckpt.save_checkpoint):
        save(tmp_path / save.__module__, 0, tree, {"epoch": 0})
    mine, ref = (tmp_path / m / "ckpt_0.npz" for m in (
        port_ckpt.save_checkpoint.__module__,
        jax_ckpt.save_checkpoint.__module__))
    with np.load(mine) as a, np.load(ref) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
    assert json.loads(mine.with_suffix(".json").read_text())["_digests"] == \
        json.loads(ref.with_suffix(".json").read_text())["_digests"]


def test_validated_resume_picks_and_quarantines_as_jax(tmp_path):
    mine = mixed_dir(tmp_path / "port")
    ref = tmp_path / "jax"
    shutil.copytree(mine, ref)
    got = port_ckpt.latest_checkpoint(mine, validate=True)
    want = jax_ckpt.latest_checkpoint(ref, validate=True)
    assert got.name == want.name == "ckpt_3.npz"
    names = sorted(p.name for p in mine.iterdir())
    assert names == sorted(p.name for p in ref.iterdir())
    assert {"ckpt_5.npz.corrupt", "ckpt_5.json.corrupt",
            "ckpt_4.npz.corrupt", "ckpt_4.json.corrupt"} <= set(names)
    # a second corruption of one step gets a numbered name
    for d, ck in ((mine, port_ckpt), (ref, jax_ckpt)):
        ck.save_checkpoint(d, 5, trees(5), {"epoch": 5})
        flip(d / "ckpt_5.npz")
        assert ck.latest_checkpoint(d, validate=True).name == "ckpt_3.npz"
    assert sorted(p.name for p in mine.iterdir()) == \
        sorted(p.name for p in ref.iterdir())
    assert (mine / "ckpt_5.npz.corrupt1").exists()


def test_a_corrupt_npz_without_digests_fails_in_both_packages(tmp_path):
    """A checkpoint whose sidecar has no digests verifies structurally
    only: the zip's member CRCs still catch a flipped data byte, in the
    port as in the JAX package, so both quarantine it and pick the same
    older checkpoint."""
    mine = tmp_path / "port"
    mine.mkdir()
    for step in range(2):
        port_ckpt.save_checkpoint(mine, step, trees(step), {"epoch": step})
        side = mine / f"ckpt_{step}.json"
        meta = json.loads(side.read_text())
        del meta["_digests"]
        side.write_text(json.dumps(meta))
    flip(mine / "ckpt_1.npz", n=1)
    ref = tmp_path / "jax"
    shutil.copytree(mine, ref)
    p = mine / "ckpt_1.npz"
    assert port_ckpt.verify_checkpoint(p) is jax_ckpt.verify_checkpoint(p) \
        is False
    got = port_ckpt.latest_checkpoint(mine, validate=True)
    want = jax_ckpt.latest_checkpoint(ref, validate=True)
    assert got.name == want.name == "ckpt_0.npz"
    assert sorted(p.name for p in mine.iterdir()) == \
        sorted(p.name for p in ref.iterdir())
    assert (mine / "ckpt_1.npz.corrupt").exists()


def test_the_ranks_load_the_checkpoint_rank_0_chose(tmp_path):
    """At two gloo ranks rank 0 alone validates: it quarantines the
    corrupt newest checkpoint and both ranks get the one it picked (one
    hash a life, not one a rank); with none left both get None."""
    import subprocess
    import textwrap

    mixed_dir(tmp_path / "d")
    (tmp_path / "empty").mkdir()
    root = Path(__file__).resolve().parent.parent
    code = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(root)!r})
        from theanompi_tpu_torch.models.base import resume_checkpoint
        from theanompi_tpu_torch.parallel.mesh import init_group
        from theanompi_tpu_torch.utils import checkpoint as ck
        r = int(sys.argv[1])
        init_group(torch.device("cpu"), r, 2, sys.argv[2])
        if r == 1:   # rank 1 opens no checkpoint
            ck.verify_checkpoint = None
        got = resume_checkpoint({str(tmp_path / "d")!r})
        none = resume_checkpoint({str(tmp_path / "empty")!r})
        print(got.name, none)
    """)
    cmds = [[sys.executable, "-c", code, str(r), launcher.INIT_METHOD]
            for r in range(2)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, text=True)
             for c in launcher._with_init(cmds)]
    outs = [p.communicate(timeout=120)[0].splitlines() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert [o[-1] for o in outs] == ["ckpt_3.npz None"] * 2
    # rank 0 reports the two quarantines; rank 1 validated nothing
    assert sum("quarantined" in line for line in outs[0]) == 2
    assert len(outs[1]) == 1
    assert sorted(p.name for p in (tmp_path / "d").glob("*.corrupt")) == [
        "ckpt_4.json.corrupt", "ckpt_4.npz.corrupt", "ckpt_5.json.corrupt",
        "ckpt_5.npz.corrupt"]


def test_an_elastic_life_validates_its_checkpoint_once(tmp_path):
    """An elastic resume's rank commands: the launcher's world fit
    validates (and quarantines) once, and hands the ranks a spec with
    ``validate_checkpoint`` off, so no rank hashes the file again."""
    port_ckpt.save_checkpoint(tmp_path, 0, trees(0),
                              {"world_size": 2, "global_batch": 6})
    port_ckpt.save_checkpoint(tmp_path, 1, trees(1),
                              {"world_size": 2, "global_batch": 8})
    flip(tmp_path / "ckpt_1.npz")
    kw = {"config": {"elastic": True, "batch_size": 3}, "resume": True,
          "checkpoint_dir": str(tmp_path), "verbose": False}
    cmds = launcher.rank_cmds("theanompi_tpu_torch.workers.bsp_worker",
                              ["cpu"] * 4, "m", "M", kw)
    assert len(cmds) == 3        # global batch 6 of ckpt_0 fits 3 ranks
    spec = json.loads(cmds[0][cmds[0].index("--spec-json") + 1])
    assert spec["kwargs"]["config"]["validate_checkpoint"] is False
    assert (tmp_path / "ckpt_1.npz.corrupt").exists()
    assert kw["config"] == {"elastic": True, "batch_size": 3}
    plain = launcher.rank_cmds("theanompi_tpu_torch.workers.bsp_worker",
                               ["cpu"] * 4, "m", "M", dict(kw, resume=False))
    assert "validate_checkpoint" not in plain[0][plain[0].index(
        "--spec-json") + 1]


def test_prune_keeps_the_same_files_as_jax(tmp_path):
    mine = mixed_dir(tmp_path / "port")
    ref = tmp_path / "jax"
    shutil.copytree(mine, ref)
    for d, ck in ((mine, port_ckpt), (ref, jax_ckpt)):
        ck.latest_checkpoint(d, validate=True)      # quarantine 4 and 5
        ck.save_checkpoint(d, 6, trees(6), {"epoch": 6}, keep_last=2)
    names = sorted(p.name for p in mine.iterdir())
    assert names == sorted(p.name for p in ref.iterdir())
    assert [p.name for p in port_ckpt.checkpoints(mine)] == \
        ["ckpt_6.npz", "ckpt_3.npz"]
    assert "ckpt_5.npz.corrupt" in names    # evidence is never collected
    with pytest.raises(ValueError, match="keep_last"):
        port_ckpt.prune_checkpoints(mine, 0)


def test_sharded_checkpoints_validate_and_prune(tmp_path):
    from theanompi_tpu_torch.utils.sharded_checkpoint import (
        save_sharded_checkpoint,
    )

    for step in range(3):
        save_sharded_checkpoint(tmp_path, step, trees(step), {"epoch": step},
                                keep_last=2)
    assert [p.name for p in port_ckpt.checkpoints(tmp_path)] == \
        ["ckpt_2.shards", "ckpt_1.shards"]
    (npy,) = (tmp_path / "ckpt_2.shards").glob("params*w*.npy")
    flip(npy)
    assert not port_ckpt.verify_checkpoint(tmp_path / "ckpt_2.shards")
    assert jax_ckpt.latest_checkpoint(tmp_path, validate=False).name == \
        "ckpt_2.shards"
    got = port_ckpt.latest_checkpoint(tmp_path, validate=True)
    assert got.name == "ckpt_1.shards"
    assert (tmp_path / "ckpt_2.shards.corrupt").is_dir()


# -- the elastic policy functions against the JAX worker's ------------------------------

POLICY_CASES = [
    # (saved meta, config, new replicas)
    ({"world_size": 8, "global_batch": 32}, {"batch_size": 4}, 4),
    ({"world_size": 2, "global_batch": 8}, {"batch_size": 4}, 1),
    ({"world_size": 4}, {"batch_size": 2}, 2),
    ({"world_size": 2, "global_batch": 8},
     {"batch_size": 4, "elastic_batch_policy": "per_replica", "lr": 0.1,
      "lr_schedule": {"10": 0.01}}, 1),
    ({"world_size": 1, "global_batch": 8}, {"batch_size": 8}, 1),
    ({}, {"batch_size": 8}, 2),
]


@pytest.mark.parametrize("meta,cfg,n", POLICY_CASES)
def test_apply_elastic_policy_equals_jax(tmp_path, meta, cfg, n):
    port_ckpt.save_checkpoint(tmp_path, 0, trees(0), meta)
    mine, ref = dict(cfg), dict(cfg)
    got = port_bsp._apply_elastic_policy(mine, n, str(tmp_path), False)
    want = jax_bsp._apply_elastic_policy(ref, n, str(tmp_path), False)
    assert got == want and mine == ref
    # the worker hands it the metadata of the checkpoint rank 0 chose
    given = dict(cfg)
    assert port_bsp._apply_elastic_policy(
        given, n, str(tmp_path / "unread"), False,
        meta=port_ckpt.checkpoint_meta(tmp_path / "ckpt_0.npz")) == want
    assert given == ref


def test_apply_elastic_policy_refusals_equal_jax(tmp_path):
    port_ckpt.save_checkpoint(tmp_path, 0, trees(0),
                              {"world_size": 2, "global_batch": 6})
    for fn in (port_bsp._apply_elastic_policy,
               jax_bsp._apply_elastic_policy):
        with pytest.raises(ValueError, match="does not divide"):
            fn({"batch_size": 3}, 4, str(tmp_path), False)
        with pytest.raises(ValueError, match="elastic_batch_policy"):
            fn({"elastic_batch_policy": "nope"}, 4, str(tmp_path), False)


@pytest.mark.parametrize("devices,cfg", [
    (list(range(7)), {"batch_size": 4}),
    (list(range(4)), {"batch_size": 4}),
    (list(range(7)), {"batch_size": 4, "elastic_batch_policy": "per_replica"}),
    (["cpu"] * 3, {"batch_size": 4}),
])
def test_elastic_trim_devices_equals_jax(tmp_path, devices, cfg):
    port_ckpt.save_checkpoint(tmp_path, 0, trees(0),
                              {"world_size": 8, "global_batch": 32})
    got = port_bsp._elastic_trim_devices(devices, cfg, str(tmp_path), False)
    want = jax_bsp._elastic_trim_devices(devices, cfg, str(tmp_path), False)
    assert got == want
    assert port_bsp._elastic_trim_devices(
        devices, cfg, str(tmp_path / "empty"), False) == devices


def test_the_peek_quarantines_what_load_would(tmp_path):
    """A corrupt newest checkpoint is quarantined by the peek, so the
    policy reads the world of the checkpoint the resume loads; the JAX
    peek reads the same."""
    port_ckpt.save_checkpoint(tmp_path, 0, trees(0),
                              {"world_size": 2, "global_batch": 8})
    port_ckpt.save_checkpoint(tmp_path, 1, trees(1),
                              {"world_size": 4, "global_batch": 8})
    flip(tmp_path / "ckpt_1.npz")
    ref = tmp_path / "jax"
    shutil.copytree(tmp_path, ref)
    assert port_bsp._peek_resume_meta({}, str(tmp_path)) == \
        jax_bsp._peek_resume_meta({}, str(ref)) == \
        {"world_size": 2, "global_batch": 8}
    assert (tmp_path / "ckpt_1.npz.corrupt").exists()


# -- the CLI -------------------------------------------------------------------------

def test_cli_supervise_runs_and_refuses_what_jax_refuses(tmp_path, capsys):
    """``tmlauncher --supervise`` runs the ranks under the supervisor
    (one clean life here); ``--elastic-min-dp`` needs ``--devices``, as
    in the JAX CLI, and a supervised launch needs ``checkpoint_dir``."""
    cfg = dict(dim=16, n_layers=1, n_heads=2, n_kv_heads=1, ffn_dim=32,
               vocab=32, seq_len=8, batch_size=2, n_train=4, n_val=2,
               compute_dtype="float32")
    argv = ["BSP", "theanompi_tpu_torch.models.llama", "Llama"]
    summary = tmp_path / "report.json"
    kw = {"config": cfg, "n_epochs": 1, "verbose": False,
          "checkpoint_dir": str(tmp_path / "ck")}
    assert launcher.main(argv + ["--devices", "cpu", "--supervise",
                                 "--max-restarts", "1", "--kwargs",
                                 json.dumps(kw), "--summary-json",
                                 str(summary)]) == 0
    rep = json.loads(summary.read_text())
    assert rep["completed"] and rep["n_restarts"] == 0
    assert rep["final_heartbeat"]["status"] == "completed"
    assert port_ckpt.checkpoint_meta(
        port_ckpt.latest_checkpoint(tmp_path / "ck"))["epoch"] == 0
    with pytest.raises(SystemExit):
        launcher.main(argv + ["--elastic-min-dp", "1"])
    assert "--elastic-min-dp needs --devices" in capsys.readouterr().err
    with pytest.raises(ValueError, match="checkpoint_dir"):
        launcher.main(argv + ["--devices", "cpu", "--supervise"])
