"""Process launcher + the ``tmlauncher`` CLI (port of
``theanompi_tpu/launcher.py``).

``launch`` runs a worker

- ``mode="inprocess"``: in this process (blocking; ``wait()`` returns
  the worker's summary), or
- ``mode="subprocess"``: detached (``rule.init()`` returns at once and
  ``wait()`` joins).  BSP takes one process per device, each given its
  rank, the world size and a ``tcp://localhost:<port>`` rendezvous for
  its ``torch.distributed`` group.  A worker module marked
  ``SINGLE_CONTROLLER`` (EASGD, GoSGD) takes one process for all its
  workers when every device entry names one device (the workers are
  replicas in that process), and otherwise one process per entry, each
  given its one device, its rank, the world size and the rendezvous.

- ``mode="supervised"`` (or ``supervise={...}``, or ``elastic=...``):
  under ``utils/supervisor.Supervisor``.  Each life is one command,
  this module's rank-group runner (``run_rank_group``): it starts the
  processes ``mode="subprocess"`` would start, at a fresh
  ``tcp://localhost:<port>`` rendezvous, waits on all of them, and on
  the first rank that exits non-zero kills the others and exits with
  that rank's code.  The supervisor relaunches with ``resume=True``
  until the run completes; ``wait()`` returns its report.

``devices=None`` means every visible card (an error without one); a
list of ``"cpu"`` entries is the only way onto the CPU, and a relaunch
runs where the first launch ran.

    python -m theanompi_tpu_torch.launcher BSP \\
        theanompi_tpu_torch.models.llama Llama --kwargs '{"n_epochs": 1}'

``--coordinator host:port --num-hosts N --host-id i`` makes this
process rank ``i`` of ``N`` (started by hand or by a cluster's job
runner, one command per process), its peers met at
``tcp://host:port``; on one card, N such commands with ``--devices 0``
run N async workers there.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

ROOT = Path(__file__).resolve().parent.parent
#: stands for the rendezvous in a rank command; ``run_rank_group`` and
#: ``launch(mode="subprocess")`` fill in a fresh one
INIT_METHOD = "{init_method}"


@dataclass
class LaunchHandle:
    mode: str
    procs: list = field(default_factory=list)
    result: Any = None
    supervisor: Any = None  # utils.supervisor.Supervisor (supervised)

    def wait(self) -> Any:
        if self.mode == "supervised" and self.supervisor is not None:
            # blocks through failures: relaunches with resume=True
            # until clean completion or the restart budget is spent
            # (then utils.supervisor.SupervisorGaveUp propagates);
            # returns the supervision report (restart causes, MTTR)
            self.result = self.supervisor.run()
            return self.result
        if self.mode == "subprocess":
            rcs = [p.wait() for p in self.procs]
            if any(rcs):
                raise RuntimeError(f"worker processes exited with {rcs}")
            return 0
        return self.result

    def poll(self) -> Optional[int]:
        if self.mode == "supervised" and self.supervisor is not None:
            p = self.supervisor.proc
            return p.poll() if p is not None else None
        rcs = [p.poll() for p in self.procs]
        if any(rc is None for rc in rcs):
            return None
        return next((rc for rc in rcs if rc), 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _single_controller(worker_module: str, devices) -> bool:
    """Whether the worker runs all its workers in one process: an async
    rule whose device entries name one device."""
    from theanompi_tpu_torch.parallel.mesh import resolve_worker_devices

    mod = importlib.import_module(worker_module)
    return (bool(getattr(mod, "SINGLE_CONTROLLER", False))
            and len(set(resolve_worker_devices(devices))) == 1)


def _child_env() -> dict:
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def rank_cmds(worker_module: str, devices, modelfile: str, modelclass: str,
              rule_kwargs: dict) -> list[list[str]]:
    """The commands of a run's processes: one per device for BSP (each
    given its rank, the world size and the rendezvous ``INIT_METHOD``
    stands for), one for all the workers of an async rule whose device
    entries name one device, else one per entry.  An elastic resume
    under the ``"global"`` batch policy first fits the world to the
    saved global batch (the worker module's
    ``_elastic_trim_devices``), since here the world is the number of
    processes.  That fit validates the resume checkpoint (quarantining a
    corrupt one), so the ranks load the newest left without hashing it
    again (``validate_checkpoint`` off in their spec): one validation a
    life."""
    from theanompi_tpu_torch.parallel.mesh import (
        resolve_devices,
        resolve_worker_devices,
    )

    mod = importlib.import_module(worker_module)
    cfg = dict(rule_kwargs.get("config") or {})
    trim = getattr(mod, "_elastic_trim_devices", None)
    ckpt_dir = rule_kwargs.get("checkpoint_dir")
    if trim is not None and cfg.get("elastic") \
            and rule_kwargs.get("resume") and ckpt_dir:
        from theanompi_tpu_torch.utils.checkpoint import (
            checkpoint_meta,
            latest_checkpoint,
        )

        path = latest_checkpoint(
            ckpt_dir, validate=bool(cfg.get("validate_checkpoint", True)))
        devices = trim(devices, cfg, ckpt_dir,
                       bool(rule_kwargs.get("verbose", True)),
                       meta=checkpoint_meta(path) if path else {})
        rule_kwargs = dict(rule_kwargs,
                           config=dict(cfg, validate_checkpoint=False))

    def spec(devs):
        return json.dumps({"devices": devs, "modelfile": modelfile,
                           "modelclass": modelclass,
                           "kwargs": rule_kwargs})

    if getattr(mod, "SINGLE_CONTROLLER", False):
        devs = [str(d) for d in resolve_worker_devices(devices)]
        if len(set(devs)) == 1:
            return [[sys.executable, "-m", worker_module, "--spec-json",
                     spec(devices)]]
        specs = [spec([d]) for d in devs]   # each process one worker
    else:
        devs = [str(d) for d in resolve_devices(devices)]
        specs = [spec(devs)] * len(devs)
    return [
        [sys.executable, "-m", worker_module, "--spec-json", sp,
         "--rank", str(r), "--world-size", str(len(specs)),
         "--init-method", INIT_METHOD]
        for r, sp in enumerate(specs)
    ]


def _with_init(cmds: list[list[str]]) -> list[list[str]]:
    """``cmds`` with ``INIT_METHOD`` replaced by a fresh rendezvous."""
    init = f"tcp://localhost:{_free_port()}"
    return [[init if a == INIT_METHOD else a for a in c] for c in cmds]


def rank_group_cmd(cmds: list[list[str]]) -> list[str]:
    """The command that runs ``cmds`` as one group (``run_rank_group``):
    what a supervisor starts for each life.  This file runs as a script
    there, so the runner imports the standard library only and each
    life starts its ranks at once."""
    return [sys.executable, str(Path(__file__).resolve()), "--rank-group",
            json.dumps(cmds)]


def run_rank_group(cmds: list[list[str]], poll_s: float = 0.05) -> int:
    """Start ``cmds`` (one process a rank) at a fresh rendezvous and wait
    on all of them.  The first that exits non-zero ends the group: the
    others are killed at once (they would otherwise block in their next
    collective until the backend's own timeout), and its code is
    returned, a signal death -N as 128 + N.  SIGTERM to the runner is
    passed on to every rank (a preemption reaches them all); 0 when
    every rank exits 0."""
    procs = [subprocess.Popen(c, env=_child_env()) for c in _with_init(cmds)]

    def forward(signum, frame):  # pragma: no cover - signal path
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:           # not the main thread: nothing to forward
        prev = None
    try:
        while True:
            rcs = [p.poll() for p in procs]
            first = next((rc for rc in rcs if rc), None)
            if first is not None or None not in rcs:
                break
            time.sleep(poll_s)
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if first is None:
        return 0
    return 128 - first if first < 0 else first


def launch(
    worker_module: str,
    devices: Sequence[Any] | None,
    modelfile: str,
    modelclass: str,
    mode: str = "subprocess",
    rule_kwargs: dict | None = None,
    supervise: dict | None = None,
    elastic: dict | bool | None = None,
) -> LaunchHandle:
    """Run ``worker_module``'s ``run`` on ``devices`` (see module
    docstring).

    ``mode="supervised"`` (or any ``supervise={...}`` kwargs) wraps the
    run in ``utils.supervisor.Supervisor``: exits are classified (clean
    / preemption-like 137 / crash), hangs are detected by heartbeat
    stall and killed, and every failure relaunches with ``resume=True``
    into the same ``checkpoint_dir`` under exponential backoff.
    ``wait()`` then returns the supervision report; the restart budget
    spending out raises ``SupervisorGaveUp``.  ``supervise`` keys =
    ``Supervisor`` kwargs (``max_restarts``, ``stall_timeout_s``,
    ``backoff_base_s``, ``crash_loop_budget``, ...).

    ``elastic`` (implies supervised) makes the run survive PERMANENT
    capacity loss by resizing the world: each relaunch probes the
    available device count and runs at that width, the worker reshards
    its checkpoint onto the new layout (``config["elastic"]`` is set
    for it), and the report carries the per-launch
    ``world_size_history``.  Pass ``True`` or a dict: ``{"min_dp": 2}``
    bounds how far the world may shrink (``tmlauncher
    --elastic-min-dp``)."""
    rule_kwargs = dict(rule_kwargs or {})
    if supervise is None:
        # rule.init(..., launch="supervised", supervise={...}) arrives
        # through rule_kwargs — pull it out before it reaches run()
        supervise = rule_kwargs.pop("supervise", None)
    if elastic is None:
        elastic = rule_kwargs.pop("elastic", None)
    if elastic:
        el = dict(elastic) if isinstance(elastic, dict) else {}
        n_dev = len(devices) if devices is not None else el.get("n_devices")
        if not n_dev:
            raise ValueError(
                "elastic launch needs an explicit baseline world: "
                "pass devices=[...] or elastic={'n_devices': N}"
            )
        supervise = dict(supervise or {})
        supervise.setdefault("elastic", True)
        supervise.setdefault("elastic_min_dp", int(el.get("min_dp", 1)))
        supervise.setdefault("n_devices", int(n_dev))
        # the worker side of elasticity: reshard on load + batch/LR
        # policy (workers/bsp_worker._apply_elastic_policy)
        cfg = dict(rule_kwargs.get("config") or {})
        cfg.setdefault("elastic", True)
        rule_kwargs["config"] = cfg
        mode = "supervised"
    if mode == "supervised" or supervise is not None:
        from theanompi_tpu_torch.utils.supervisor import (
            Supervisor,
            make_worker_cmd_factory,
        )

        checkpoint_dir = rule_kwargs.get("checkpoint_dir")
        if not checkpoint_dir:
            raise ValueError(
                "supervised launch needs rule_kwargs['checkpoint_dir'] "
                "— relaunch-with-resume is the whole recovery story"
            )
        # the card unless the caller asked for the CPU, checked here
        # rather than in the first life
        rank_cmds(worker_module, devices, modelfile, modelclass,
                  dict(rule_kwargs, resume=False))
        supervise = dict(supervise or {})
        supervise.setdefault("env", _child_env())
        sup = Supervisor(
            cmd_for=make_worker_cmd_factory(
                worker_module, devices, modelfile, modelclass,
                rule_kwargs,
            ),
            checkpoint_dir=checkpoint_dir,
            initial_resume=bool(rule_kwargs.get("resume", False)),
            **supervise,
        )
        return LaunchHandle(mode="supervised", supervisor=sup)
    if mode == "inprocess":
        mod = importlib.import_module(worker_module)
        return LaunchHandle(mode=mode, result=mod.run(
            devices=devices, modelfile=modelfile, modelclass=modelclass,
            **rule_kwargs,
        ))
    if mode == "subprocess":
        cmds = _with_init(rank_cmds(worker_module, devices, modelfile,
                                    modelclass, rule_kwargs))
        return LaunchHandle(mode=mode, procs=[
            subprocess.Popen(c, env=_child_env()) for c in cmds])
    raise ValueError(f"unknown launch mode {mode!r}")


def finish_distributed(ok: bool = True, rank: int = 0,
                       world_size: int = 1) -> None:
    """Exit one process of a multi-process run WITHOUT a teardown that
    waits on its peers: a peer that died mid-run (preemption,
    ``TM_FAULT_AT`` drills) would make it hang or fail after the run
    finished and wrote its checkpoints.  Rank 0 first stamps the
    terminal heartbeat (what tells a supervisor "clean exit" from "died
    during shutdown" on this ``os._exit`` path), then stdio is flushed
    and the process exits 0 (1 when not ``ok``).  No-op at one
    process (a normal interpreter exit is fine there)."""
    if int(world_size) <= 1:
        return
    if int(rank) == 0:
        from theanompi_tpu_torch.utils import supervisor as _sup

        _sup.flush_final_heartbeat(ok=ok)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if ok else 1)


def _parse_devices(text: str | None, one_process: bool = False):
    """``--devices``: a card count (``2``) or a comma list of device
    names (``cpu``, ``cpu,cpu``, ``0,1``, ``cuda:1``).  For one process
    of a run started elsewhere (``one_process``, the ``--coordinator``
    flags) a bare number names a card: ``0`` is card 0."""
    if text is None:
        return None
    if text.isdigit() and not one_process:
        return list(range(int(text)))
    return [int(d) if d.isdigit() else d for d in text.split(",")]


def main(argv: Sequence[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--rank-group"]:
        # one life of a supervised run (rank_group_cmd)
        return run_rank_group(json.loads(argv[1]))
    ap = argparse.ArgumentParser(
        prog="tmlauncher",
        description="Launch theanompi_tpu_torch training.",
    )
    ap.add_argument("rule", choices=["BSP", "EASGD", "GOSGD"])
    ap.add_argument("modelfile",
                    help="e.g. theanompi_tpu_torch.models.llama")
    ap.add_argument("modelclass", help="e.g. Llama")
    ap.add_argument("--devices", default=None,
                    help="card count, or a comma list of devices "
                    "('cpu', 'cpu,cpu', '0,1'; for EASGD/GOSGD one entry "
                    "per worker: 'cpu,cpu' or '0,0' in one process, '0,1' "
                    "a process per card; with --coordinator a bare number "
                    "names this process's card); default: every card")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous: this process "
                    "is then rank --host-id of --num-hosts")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="processes of the run (with --coordinator)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this process's rank (with --coordinator)")
    ap.add_argument("--kwargs", default="{}",
                    help="JSON dict of extra rule/worker kwargs")
    ap.add_argument("--supervise", action="store_true",
                    help="self-healing mode: run the worker processes under "
                    "the supervisor (relaunch with resume on crash or "
                    "preemption, hang watchdog); needs checkpoint_dir in "
                    "--kwargs")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="supervisor restart budget (with --supervise)")
    ap.add_argument("--stall-timeout-s", type=float, default=120.0,
                    help="supervisor hang watchdog: kill and relaunch after "
                    "this many seconds without a heartbeat (with "
                    "--supervise)")
    ap.add_argument("--elastic-min-dp", type=int, default=None,
                    help="elastic self-healing (implies --supervise): "
                    "relaunch at the surviving device count after a "
                    "permanent capacity loss, resharding the checkpoint "
                    "onto the new layout, down to this minimum dp; needs "
                    "--devices (the baseline world) and checkpoint_dir in "
                    "--kwargs")
    ap.add_argument("--summary-json", default=None,
                    help="write the run's summary (its JSON-able entries, "
                    "the recorder's losses, segments and window marks and, "
                    "on a card, the peak device memory) to this file")
    ns = ap.parse_args(argv)

    if ns.elastic_min_dp is not None:
        if ns.devices is None:
            ap.error("--elastic-min-dp needs --devices (the baseline world "
                     "size the run starts at)")
        ns.supervise = True
    if ns.coordinator is not None:
        if ns.supervise:
            # a supervised child would be spawned without the
            # rendezvous, so each process would train alone into the
            # shared checkpoint_dir: refuse instead
            ap.error("--supervise does not compose with --coordinator: run "
                     "one supervised launcher per host without "
                     "--coordinator, or let the cluster's job runner "
                     "restart the whole run")
        if ns.num_hosts is None or ns.host_id is None:
            ap.error("--coordinator needs --num-hosts and --host-id")
        if not 0 <= ns.host_id < ns.num_hosts:
            ap.error(f"--host-id {ns.host_id} is not a rank of "
                     f"--num-hosts {ns.num_hosts}")

    import theanompi_tpu_torch as tm
    from theanompi_tpu_torch.parallel.mesh import resolve_devices

    rule = getattr(tm, ns.rule)()
    devices = _parse_devices(ns.devices, ns.coordinator is not None)
    kwargs = json.loads(ns.kwargs)
    if ns.coordinator is not None:
        # one process of a run started elsewhere: it runs here
        launch_mode = "inprocess"
        kwargs.update(rank=ns.host_id, world_size=ns.num_hosts,
                      init_method=f"tcp://{ns.coordinator}")
    elif ns.supervise:
        launch_mode = "supervised"
        kwargs["supervise"] = {"max_restarts": ns.max_restarts,
                               "stall_timeout_s": ns.stall_timeout_s}
        if ns.elastic_min_dp is not None:
            kwargs["elastic"] = {"min_dp": ns.elastic_min_dp}
    elif (_single_controller(rule.worker_module, devices)
          or len(resolve_devices(devices)) == 1):
        # EASGD/GoSGD on one device: every worker in this process
        launch_mode = "inprocess"
    else:
        launch_mode = "subprocess"
    rule.init(devices=devices, modelfile=ns.modelfile,
              modelclass=ns.modelclass, launch=launch_mode, **kwargs)
    out = rule.wait()
    if ns.summary_json:
        _write_summary(ns.summary_json, out)
    if ns.coordinator is not None:
        # no teardown that waits on a peer may undo a completed run
        finish_distributed(ok=True, rank=ns.host_id,
                           world_size=ns.num_hosts)
    return 0


def _write_summary(path: str, out) -> None:
    """The summary's JSON-able entries (an in-process run's; a detached
    run's is its exit code), with the recorder's per-step losses,
    segments and window marks, and the peak memory of the run's card."""
    out = out if isinstance(out, dict) else {"exit_code": out}
    doc = {}
    for k, v in out.items():
        try:
            json.dumps(v)
        except TypeError:
            continue
        doc[k] = v
    rec = out.get("recorder")
    if rec is not None:
        doc["train_losses"] = rec.train_losses
        doc["window_marks"] = rec.window_marks
        doc["total_segments"] = dict(rec.total_segments)
    if str(out.get("device", "")).startswith("cuda"):
        import torch

        doc["peak_device_bytes"] = torch.cuda.max_memory_allocated(
            out["device"])
    Path(path).write_text(json.dumps(doc))


if __name__ == "__main__":
    raise SystemExit(main())
