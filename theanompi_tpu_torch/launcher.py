"""Process launcher + the ``tmlauncher`` CLI (port of
``theanompi_tpu/launcher.py``).

``launch`` runs a worker

- ``mode="inprocess"``: in this process (blocking; ``wait()`` returns
  the worker's summary), or
- ``mode="subprocess"``: detached (``rule.init()`` returns at once and
  ``wait()`` joins).  BSP takes one process per device, each given its
  rank, the world size and a ``tcp://localhost:<port>`` rendezvous for
  its ``torch.distributed`` group.  A worker module marked
  ``SINGLE_CONTROLLER`` (EASGD, GoSGD: every worker a replica in one
  process) takes one process for all its workers.

``devices=None`` means every visible card (an error without one); a
list of ``"cpu"`` entries is the only way onto the CPU.  The
``"supervised"`` mode and elastic relaunch are not ported yet
(ROADMAP.md A9).

    python -m theanompi_tpu_torch.launcher BSP \\
        theanompi_tpu_torch.models.llama Llama --kwargs '{"n_epochs": 1}'
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

from theanompi_tpu_torch.parallel.mesh import resolve_devices

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class LaunchHandle:
    mode: str
    procs: list = field(default_factory=list)
    result: Any = None

    def wait(self) -> Any:
        if self.mode == "subprocess":
            rcs = [p.wait() for p in self.procs]
            if any(rcs):
                raise RuntimeError(f"worker processes exited with {rcs}")
            return 0
        return self.result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _single_controller(worker_module: str) -> bool:
    """Whether the worker runs all its workers in one process."""
    mod = importlib.import_module(worker_module)
    return bool(getattr(mod, "SINGLE_CONTROLLER", False))


def launch(
    worker_module: str,
    devices: Sequence[Any] | None,
    modelfile: str,
    modelclass: str,
    mode: str = "subprocess",
    rule_kwargs: dict | None = None,
) -> LaunchHandle:
    """Run ``worker_module``'s ``run`` on ``devices`` (see module
    docstring)."""
    rule_kwargs = dict(rule_kwargs or {})
    if mode == "supervised" or rule_kwargs.get("supervise") \
            or rule_kwargs.get("elastic"):
        raise NotImplementedError(
            "supervised and elastic launches are not ported yet (ROADMAP.md "
            "A9: supervisor, elastic resume, fault drills)"
        )
    if mode == "inprocess":
        mod = importlib.import_module(worker_module)
        return LaunchHandle(mode=mode, result=mod.run(
            devices=devices, modelfile=modelfile, modelclass=modelclass,
            **rule_kwargs,
        ))
    if mode == "subprocess":
        env = os.environ.copy()
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        if _single_controller(worker_module):
            spec = json.dumps({"devices": devices, "modelfile": modelfile,
                               "modelclass": modelclass,
                               "kwargs": rule_kwargs})
            return LaunchHandle(mode=mode, procs=[subprocess.Popen(
                [sys.executable, "-m", worker_module, "--spec-json", spec],
                env=env)])
        devs = [str(d) for d in resolve_devices(devices)]
        spec = json.dumps({"devices": devs, "modelfile": modelfile,
                           "modelclass": modelclass, "kwargs": rule_kwargs})
        init = f"tcp://localhost:{_free_port()}"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", worker_module, "--spec-json", spec,
                 "--rank", str(r), "--world-size", str(len(devs)),
                 "--init-method", init],
                env=env,
            )
            for r in range(len(devs))
        ]
        return LaunchHandle(mode=mode, procs=procs)
    raise ValueError(f"unknown launch mode {mode!r}")


def _parse_devices(text: str | None):
    """``--devices``: a card count (``2``) or a comma list of device
    names (``cpu``, ``cpu,cpu``, ``0,1``, ``cuda:1``)."""
    if text is None:
        return None
    if text.isdigit():
        return list(range(int(text)))
    return [int(d) if d.isdigit() else d for d in text.split(",")]


def main(argv: Sequence[str] | None = None) -> int:
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
                    "per worker: 'cpu,cpu', '0,0'); default: every card")
    ap.add_argument("--kwargs", default="{}",
                    help="JSON dict of extra rule/worker kwargs")
    ap.add_argument("--supervise", action="store_true",
                    help="self-healing mode (not ported yet: ROADMAP A9)")
    ns = ap.parse_args(argv)

    import theanompi_tpu_torch as tm

    rule = getattr(tm, ns.rule)()
    devices = _parse_devices(ns.devices)
    # BSP: one process per device; EASGD/GoSGD: every worker in this one
    one = (_single_controller(rule.worker_module)
           or len(resolve_devices(devices)) == 1)
    rule.init(
        devices=devices,
        modelfile=ns.modelfile,
        modelclass=ns.modelclass,
        launch="supervised" if ns.supervise
        else "inprocess" if one else "subprocess",
        **json.loads(ns.kwargs),
    )
    rule.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
