"""Self-healing runs: supervised relaunch + hang watchdog + heartbeats.

A copy of ``theanompi_tpu/utils/supervisor.py`` (stdlib only; spans
through the port's ``obs/tracer.py``).  It changes only where the
port's launch differs from the JAX one: a BSP run of the port is one
process per rank, where the JAX run is one controller.  So a LIFE is a
group of processes: :func:`make_worker_cmd_factory` builds the command
of the launcher's rank-group runner (``launcher.run_rank_group``),
which starts every rank at a fresh ``tcp://localhost:<port>``
rendezvous, waits on all of them, kills the rest as soon as one exits
non-zero, and exits with that first failing rank's code (a signal
death -N as 128 + N, so 137 stays preemption-like).  The supervisor
starts the runner in a session of its own, so ``_kill_group`` ends
every rank.  Rank 0 stamps the heartbeat (a hang on any other rank
stalls rank 0 at its next collective).

The reference's whole failure story was "checkpoint every epoch,
restart from the last one" — with a HUMAN rerunning the command
(SURVEY §5.3).  This module closes the loop by machine:

- **Worker side** (cheap, env-gated): ``heartbeat(...)`` stamps
  monotonic progress (total iterations + epoch/iter + wall time) to
  the ``TM_HEARTBEAT_FILE`` once per iteration boundary;
  ``install_preemption_handler()`` turns SIGTERM into a flag the loop
  checks at the same boundary, so a planned preemption checkpoints
  mid-epoch and exits cleanly instead of losing the epoch.  Without
  the env vars every call is a no-op — unsupervised runs pay one
  cached ``None`` check.

- **Supervisor side**: ``Supervisor`` launches the worker command,
  watches the heartbeat, and

  * classifies exits — clean completion / graceful preemption /
    preemption-like kill (137 / SIGKILL) / crash,
  * declares a **hang** when progress stalls past ``stall_timeout_s``
    (``startup_grace_s`` covers the slow first beat), kills
    the process group, and treats it like a crash,
  * relaunches with ``resume=True`` into the same ``checkpoint_dir``
    after exponential backoff with jitter,
  * in **elastic** mode (``elastic=True``) probes the available
    device count before every (re)launch (the ``.world`` file a
    ``lose_device``/``shrink_world`` drill — or the platform — wrote)
    and relaunches at THAT width instead of waiting for lost hardware;
    the worker reshards its checkpoint onto the new layout
    (``models/base.load(reshard=True)``) and the report carries the
    ``world_size_history``.  Below ``elastic_min_dp`` it gives up
    loudly,
  * gives up LOUDLY when ``max_restarts`` is spent or
    ``crash_loop_budget`` consecutive restarts made zero progress
    (raises ``SupervisorGaveUp`` carrying the full report — never a
    silent infinite loop),
  * reports every restart's cause, exit code, resumed-from step, and
    time-to-recovery (detection → first new progress), plus the mean
    (MTTR).

Entry point: ``launcher.launch(..., mode="supervised",
supervise={...})``; drills: ``utils/faults.py``
(``TM_FAULT_AT=...:die|hang|sigterm|corrupt_ckpt``).
"""

from __future__ import annotations

import inspect
import json
import os
import random
import signal
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

HEARTBEAT_ENV = "TM_HEARTBEAT_FILE"
RESTART_CTX_ENV = "TM_RESTART_CONTEXT"

# ---------------------------------------------------------------------------
# worker side: heartbeats
# ---------------------------------------------------------------------------

_hb_path: Path | None | str = "unset"
_hb_last_write = 0.0
_HB_MIN_INTERVAL_S = 0.05  # progress stamps are throttled; status never


def reset_heartbeat_cache() -> None:
    global _hb_path, _hb_last_write
    _hb_path = "unset"
    _hb_last_write = 0.0


def _hb_file() -> Path | None:
    global _hb_path
    if _hb_path == "unset":
        p = os.environ.get(HEARTBEAT_ENV)
        _hb_path = Path(p) if p else None
    return _hb_path  # type: ignore[return-value]


def heartbeat(
    progress: int,
    epoch: int | None = None,
    it: int | None = None,
    status: str = "running",
    **extra: Any,
) -> None:
    """Stamp monotonic progress for the supervisor's watchdog.  No-op
    without ``TM_HEARTBEAT_FILE``; ``"running"`` stamps are throttled
    to one write per 50 ms (a stalled loop is judged on a timescale of
    seconds — per-iteration fsync churn would tax the hot loop for
    nothing); status transitions always write."""
    global _hb_last_write
    path = _hb_file()
    if path is None:
        return
    now = time.time()
    if status == "running" and now - _hb_last_write < _HB_MIN_INTERVAL_S:
        return
    rec = {
        "progress": int(progress),
        "epoch": None if epoch is None else int(epoch),
        "iter": None if it is None else int(it),
        "status": status,
        "time": now,
        "pid": os.getpid(),
    }
    rec.update(extra)
    tmp = path.with_name(path.name + ".tmp")
    try:
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, path)
        _hb_last_write = now
    except OSError:
        pass  # a full/broken disk must never take down training


def flush_final_heartbeat(ok: bool = True, status: str | None = None) -> None:
    """Terminal stamp preserving the last progress count — lets the
    supervisor distinguish "clean exit" from "died during shutdown"
    even on the no-barrier ``os._exit`` path
    (``launcher.finish_distributed``).  An already-terminal
    ``preempted``/``failed`` status is PRESERVED, never upgraded:
    a graceful drain followed by a clean shutdown must still read as
    preempted, or the supervisor would classify it clean and abandon
    the remaining epochs."""
    path = _hb_file()
    if path is None:
        return
    prev = read_heartbeat(path) or {}
    if status is None:
        prev_status = prev.get("status")
        if prev_status in ("preempted", "failed"):
            status = prev_status
        else:
            status = "completed" if ok else "failed"
    heartbeat(
        int(prev.get("progress", 0)),
        prev.get("epoch"),
        prev.get("iter"),
        status=status,
    )


def read_heartbeat(path: str | Path) -> dict | None:
    """Best-effort read (the writer may be mid-replace or dead)."""
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# worker side: graceful preemption (SIGTERM → checkpoint at boundary)
# ---------------------------------------------------------------------------

_preempt_requested = False
_prev_sigterm: Any = None  # handler displaced by install (for restore)
_handler_installed = False


def _on_sigterm(signum, frame) -> None:  # pragma: no cover - trivial
    global _preempt_requested
    _preempt_requested = True


def install_preemption_handler() -> bool:
    """Idempotent; main-thread only (returns False elsewhere — a
    worker driven from a thread keeps default SIGTERM semantics).
    Pair with ``uninstall_preemption_handler()`` when the worker loop
    returns, so a long-lived IN-PROCESS host (notebook, service) gets
    its normal SIGTERM semantics back instead of a flag nobody reads."""
    global _preempt_requested, _prev_sigterm, _handler_installed
    _preempt_requested = False
    try:
        prev = signal.signal(signal.SIGTERM, _on_sigterm)
        if not _handler_installed:  # keep the ORIGINAL across re-installs
            _prev_sigterm = prev
            _handler_installed = True
        return True
    except ValueError:
        return False


def uninstall_preemption_handler() -> None:
    """Restore the SIGTERM handler displaced by install (no-op when
    never installed or not on the main thread)."""
    global _prev_sigterm, _handler_installed, _preempt_requested
    if not _handler_installed:
        return
    try:
        signal.signal(signal.SIGTERM, _prev_sigterm)
    except (ValueError, TypeError):
        return
    _handler_installed = False
    _prev_sigterm = None
    _preempt_requested = False


def preemption_requested() -> bool:
    return _preempt_requested


def reset_preemption() -> None:
    global _preempt_requested
    _preempt_requested = False


# ---------------------------------------------------------------------------
# worker side: restart context (set by the supervisor on relaunch)
# ---------------------------------------------------------------------------

def restart_context() -> dict | None:
    """The supervisor's note to a relaunched worker: restart ordinal,
    the classified cause of the previous death, and the wall-clock
    failure-detection time (for worker-side recovery latency)."""
    raw = os.environ.get(RESTART_CTX_ENV)
    if not raw:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None


def record_restart_into(recorder, resumed_epoch: int | None,
                        resumed_iter: int | None,
                        resharded: bool | None = None) -> None:
    """Fold the restart context (if any) into the recorder so restart
    cause / resumed-from / recovery latency / world size survive in
    checkpoints and worker summaries."""
    ctx = restart_context()
    if ctx is None or recorder is None:
        return
    t_fail = ctx.get("t_fail")
    recorder.record_restart(
        cause=ctx.get("cause", "unknown"),
        resumed_epoch=resumed_epoch,
        resumed_iter=resumed_iter,
        recovery_s=(time.time() - t_fail) if t_fail else None,
        restart=ctx.get("restart"),
        world_size=ctx.get("world_size"),
        resharded=resharded,
    )


def begin_resilient_run(
    model,
    recorder,
    checkpoint_dir: str | None,
    resume: bool,
    verbose: bool = False,
    path=None,
) -> tuple[int, list | None]:
    """The shared worker-loop preamble (BSP/EASGD/GoSGD, in-process
    and distributed): install the graceful-SIGTERM handler, restore
    the newest VALID checkpoint — honoring a mid-epoch ``next_iter``
    preemption stamp — and fold any supervisor restart context into
    the recorder.

    Returns ``(start_iter, resumed_from)``: the batch index the first
    epoch iteration should start at, and ``[epoch, iter]`` of the
    resume point (``None`` when starting fresh; ``iter`` is ``None``
    for an epoch-boundary resume).  ``path``: the checkpoint to restore
    when the caller already chose it (``models.base.resume_checkpoint``:
    rank 0 validated it for every rank).  Pair with
    ``uninstall_preemption_handler()`` when the loop returns."""
    install_preemption_handler()
    start_iter = 0
    resumed_from: list | None = None
    if resume and checkpoint_dir and model.load(checkpoint_dir, recorder,
                                                path=path):
        nxt = getattr(model, "restored_meta", {}).get("next_iter")
        if nxt is None:
            model.epoch += 1  # saved after finishing that epoch
            resumed_from = [model.epoch - 1, None]
            if verbose:
                print(f"resumed from epoch {model.epoch - 1}",
                      flush=True)
        else:
            # preemption checkpoint: continue INSIDE the epoch at the
            # exact boundary (the epoch-keyed shuffle replays the same
            # batch sequence)
            start_iter = int(nxt)
            resumed_from = [model.epoch, start_iter]
            if verbose:
                print(
                    f"resumed mid-epoch {model.epoch} at iter "
                    f"{start_iter}", flush=True,
                )
    record_restart_into(
        recorder,
        resumed_from[0] if resumed_from else None,
        resumed_from[1] if resumed_from else None,
        resharded=bool(getattr(model, "resharded_from", None)) or None,
    )
    return start_iter, resumed_from


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------

class SupervisorGaveUp(RuntimeError):
    """Raised when the restart budget is spent — carries the report."""

    def __init__(self, msg: str, report: dict):
        super().__init__(msg)
        self.report = report


@dataclass
class RestartEvent:
    restart: int                 # 1-based ordinal of the relaunch
    cause: str                   # preemption | sigterm | hang | crash
    exit_code: Optional[int]     # None when killed by the watchdog
    at_progress: int             # heartbeat progress when it died
    backoff_s: float
    t_detect: float              # wall clock at failure detection
    resumed_from: Optional[list] = None   # [epoch, iter] after relaunch
    recovery_s: Optional[float] = None    # detection → first new progress
    world_size: Optional[int] = None      # devices the relaunch runs at
    resharded: Optional[bool] = None      # elastic reshard on resume

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def classify_exit(returncode: int | None, hb_status: str | None) -> str:
    """Map (exit code, final heartbeat status) to a restart cause.

    137 / -SIGKILL is the preemption signature (``os._exit(137)``,
    OOM-killer, scheduler kill); a clean 0 with a ``preempted``
    heartbeat is a graceful SIGTERM drain; 143 / -SIGTERM means the
    default handler won the race (no graceful drain); anything else
    is a crash."""
    if returncode == 0:
        if hb_status == "preempted":
            return "sigterm"
        return "clean"
    if returncode in (137, -signal.SIGKILL):
        return "preemption"
    if returncode in (143, -signal.SIGTERM):
        return "sigterm"
    return "crash"


@dataclass
class Supervisor:
    """Supervise one worker command to completion through failures.

    ``cmd_for(resume: bool) -> list[str]`` builds the worker command —
    the supervisor owns WHEN to pass ``resume=True`` (every relaunch),
    the caller owns what the command looks like.
    """

    cmd_for: Callable[..., Sequence[str]]
    checkpoint_dir: str
    max_restarts: int = 5
    stall_timeout_s: float = 120.0
    startup_grace_s: float = 600.0
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 30.0
    backoff_jitter: float = 0.25
    crash_loop_budget: int = 3
    poll_interval_s: float = 0.2
    initial_resume: bool = False
    heartbeat_file: Optional[str] = None
    env: Optional[dict] = None
    verbose: bool = True
    seed: Optional[int] = None   # pins backoff jitter (tests)
    # -- elastic mode: resize the world instead of relaunching into it.
    # On every (re)launch the supervisor probes the available device
    # count (the world file — written by the platform, an operator, or
    # a lose_device/shrink_world drill) and relaunches the worker at
    # THAT width; the worker reshards its checkpoint onto the new
    # layout (config['elastic'], models/base.load(reshard=True)).
    # A probe below ``elastic_min_dp`` gives up loudly — the bound is
    # on the available DEVICE count (== dp for every configuration
    # the resharding loader supports; model-parallel flat packs
    # refuse to reshard anyway, see utils/reshard.py).  Capacity
    # returning (the file growing back, or being deleted) grows the
    # next relaunch back automatically.
    elastic: bool = False
    elastic_min_dp: int = 1
    n_devices: Optional[int] = None      # baseline world (elastic)
    world_file: Optional[str] = None     # default {ckpt}/.world
    # span tracing (obs/tracer.py): when a Tracer is attached the
    # whole supervised run is ONE always-sampled trace — a "life"
    # span per (re)launch (spawn → death/completion, with cause,
    # exit code, progress, and the elastic world) under a
    # "supervised_run" root, so restart storms read as lanes in the
    # same Perfetto export the serving fleet uses.
    tracer: Optional[object] = None

    events: list = field(default_factory=list, init=False)
    proc: Optional[subprocess.Popen] = field(default=None, init=False)
    world_history: list = field(default_factory=list, init=False)

    def __post_init__(self) -> None:
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.elastic and not self.n_devices:
            raise ValueError(
                "elastic supervision needs n_devices (the baseline "
                "world size the run starts at)"
            )
        self._rng = random.Random(self.seed)
        ckpt = Path(self.checkpoint_dir)
        ckpt.mkdir(parents=True, exist_ok=True)
        self._hb_path = Path(
            self.heartbeat_file or (ckpt / "heartbeat.json")
        )
        self._fault_state = ckpt / ".fault_state"
        self._world_file = Path(self.world_file or (ckpt / ".world"))
        # signature-detected ONCE (never a call-time except TypeError,
        # which would swallow a factory's own bugs and silently
        # relaunch at the full world)
        try:
            self._cmd_takes_world = "n_devices" in inspect.signature(
                self.cmd_for
            ).parameters
        except (TypeError, ValueError):
            self._cmd_takes_world = True  # uninspectable: pass it

    # -- internals ---------------------------------------------------------

    def _say(self, msg: str) -> None:
        if self.verbose:
            print(f"[supervisor] {msg}", flush=True)

    def _probe_world(self) -> int:
        """Devices available for the next launch: the world file's
        count (clamped to the baseline — hardware never grows past
        what the run was given), else the baseline.  An unreadable /
        nonsense file is ignored rather than trusted."""
        try:
            n = int(self._world_file.read_text().strip())
        except (OSError, ValueError):
            return int(self.n_devices or 0)
        if n < 1:
            return n
        return min(n, int(self.n_devices or n))

    def _child_env(self, restart: int, cause: str | None,
                   t_fail: float | None,
                   world: int | None = None) -> dict:
        env = dict(self.env if self.env is not None else os.environ)
        env[HEARTBEAT_ENV] = str(self._hb_path)
        # fired faults survive relaunches (utils/faults.py) — without
        # this a TM_FAULT_AT drill would re-kill every resume forever
        env.setdefault("TM_FAULT_STATE", str(self._fault_state))
        if self.elastic:
            # lose_device/shrink_world drills (and platform hooks)
            # write the shrunken device count here; the next relaunch
            # probes it
            env.setdefault("TM_WORLD_FILE", str(self._world_file))
        if restart > 0:
            ctx = {"restart": restart, "cause": cause, "t_fail": t_fail}
            if world is not None:
                ctx["world_size"] = world
            env[RESTART_CTX_ENV] = json.dumps(ctx)
        else:
            env.pop(RESTART_CTX_ENV, None)
        return env

    def _spawn(self, resume: bool, restart: int, cause: str | None,
               t_fail: float | None) -> subprocess.Popen:
        world = None
        if self.elastic:
            world = self._probe_world()
            self.world_history.append(world)
            if self._cmd_takes_world:
                cmd = list(self.cmd_for(resume, n_devices=world))
            else:
                # a legacy factory without the elastic parameter —
                # world still recorded/reported, command unchanged
                cmd = list(self.cmd_for(resume))
        else:
            cmd = list(self.cmd_for(resume))
        # own session: a hang is killed as a GROUP (the worker may have
        # its own children — data loader pools, center servers)
        return subprocess.Popen(
            cmd,
            env=self._child_env(restart, cause, t_fail, world=world),
            start_new_session=True,
        )

    def _kill_group(self) -> None:
        p = self.proc
        if p is None or p.poll() is not None:
            return
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                p.kill()
            except ProcessLookupError:
                pass
        p.wait()

    def _backoff(self, attempt: int) -> float:
        base = min(
            self.backoff_cap_s,
            self.backoff_base_s * (2.0 ** max(0, attempt - 1)),
        )
        return base * (1.0 + self.backoff_jitter * self._rng.random())

    def _fold_hb_into_last_event(self, hb: dict | None) -> None:
        """Workers stamp run-constant facts (resumed_from, and on
        elastic runs resharded) on every boundary — attribute them to
        the restart that caused this life, whenever they appear."""
        if hb is None or not self.events:
            return
        ev = self.events[-1]
        if hb.get("resumed_from") is not None and ev.resumed_from is None:
            ev.resumed_from = hb["resumed_from"]
        if hb.get("resharded") is not None and ev.resharded is None:
            ev.resharded = bool(hb["resharded"])

    def _read_hb(self) -> tuple[int, float, dict | None]:
        hb = read_heartbeat(self._hb_path)
        if hb is None:
            return -1, 0.0, None
        return int(hb.get("progress", -1)), float(hb.get("time", 0.0)), hb

    # -- the loop ----------------------------------------------------------

    def run(self) -> dict:
        """Supervise until clean completion; raises SupervisorGaveUp
        when the budget is spent.  Returns the report dict."""
        restart = 0
        consecutive_no_progress = 0
        resume = self.initial_resume
        cause: str | None = None
        t_fail: float | None = None
        pending: RestartEvent | None = None  # awaiting recovery proof
        self._trace_ctx = self._run_root = None
        if self.tracer is not None:
            self._trace_ctx = self.tracer.new_context(force=True)
            self._run_root = self.tracer.start_span(
                self._trace_ctx, "supervised_run"
            )

        while True:
            if self.elastic:
                avail = self._probe_world()
                if avail < max(1, self.elastic_min_dp):
                    report = self._report(
                        completed=False, final_hb=self._read_hb()[2]
                    )
                    raise SupervisorGaveUp(
                        f"supervisor: elastic world shrank to {avail} "
                        f"device(s), below elastic_min_dp="
                        f"{self.elastic_min_dp} — giving up (grow "
                        f"{self._world_file} back, or delete it, to "
                        f"resume at capacity)",
                        report,
                    )
            _, last_hb_time, _ = self._read_hb()
            self.proc = self._spawn(resume, restart, cause, t_fail)
            t_launch_tr = (
                self.tracer.clock() if self.tracer is not None else 0.0
            )
            t_launch = time.monotonic()
            last_beat = t_launch
            seen_beat_this_run = False
            hang = False

            while True:
                rc = self.proc.poll()
                now = time.monotonic()
                progress, hb_time, hb = self._read_hb()
                # liveness = a FRESH write, not a progress comparison:
                # after a resume the counter legitimately goes BACK to
                # the checkpoint's value, and workers only stamp at
                # iteration boundaries — so any new stamp means the
                # loop is moving
                if hb_time > last_hb_time:
                    last_hb_time = hb_time
                    last_beat = now
                    seen_beat_this_run = True
                    # workers stamp their run-constant resumed-from on
                    # every boundary — attribute it to the restart that
                    # caused this life, whenever it first appears
                    self._fold_hb_into_last_event(hb)
                    if pending is not None:
                        # recovered: the relaunched worker completed an
                        # iteration (its first boundary stamp)
                        pending.recovery_s = time.time() - pending.t_detect
                        pending = None
                if rc is not None:
                    break
                limit = (
                    self.stall_timeout_s if seen_beat_this_run
                    else self.startup_grace_s
                )
                if now - last_beat > limit:
                    self._say(
                        f"hang: no heartbeat for {limit:.0f}s "
                        f"(progress={progress}); killing pid "
                        f"{self.proc.pid}"
                    )
                    self._kill_group()
                    hang = True
                    rc = self.proc.returncode
                    break
                time.sleep(self.poll_interval_s)

            t_fail = time.time()
            progress, _, hb = self._read_hb()
            hb_status = (hb or {}).get("status")
            cause = "hang" if hang else classify_exit(rc, hb_status)
            if self.tracer is not None:
                self.tracer.record_span(
                    self._trace_ctx, "life", t_launch_tr,
                    self.tracer.clock(),
                    parent_id=self._run_root["span_id"],
                    lane="supervisor", life=restart, cause=cause,
                    exit_code=None if hang else rc,
                    progress=max(progress, 0),
                    world_size=(self.world_history[-1]
                                if self.elastic and self.world_history
                                else None),
                )
            # last stamp before death may carry the resume point
            self._fold_hb_into_last_event(hb)
            pending = None  # died before proving recovery: unset

            if cause == "clean":
                report = self._report(completed=True, final_hb=hb)
                self._say(
                    f"done: {report['n_restarts']} restart(s), "
                    f"causes={[e['cause'] for e in report['restarts']]}"
                )
                return report

            # "progress" for the crash-loop budget = the run stamped at
            # least one iteration boundary (progress counters are NOT
            # comparable across a resume, which rewinds to the
            # checkpoint)
            consecutive_no_progress = (
                0 if seen_beat_this_run else consecutive_no_progress + 1
            )
            restart += 1
            if restart > self.max_restarts:
                report = self._report(completed=False, final_hb=hb)
                raise SupervisorGaveUp(
                    f"supervisor: restart budget exhausted "
                    f"({self.max_restarts} restarts; last cause "
                    f"{cause!r}, rc={rc}) — giving up. Causes: "
                    f"{[e.cause for e in self.events] + [cause]}",
                    report,
                )
            if consecutive_no_progress > self.crash_loop_budget:
                report = self._report(completed=False, final_hb=hb)
                raise SupervisorGaveUp(
                    f"supervisor: crash loop — "
                    f"{consecutive_no_progress} consecutive launches "
                    f"made zero progress (cause {cause!r}, rc={rc}); "
                    f"giving up before burning the restart budget",
                    report,
                )
            delay = self._backoff(restart)
            event = RestartEvent(
                restart=restart,
                cause=cause,
                exit_code=None if hang else rc,
                at_progress=max(progress, 0),
                backoff_s=delay,
                t_detect=t_fail,
                # the world the RELAUNCH will see (the drill/platform
                # wrote the file before the death was detected)
                world_size=(
                    self._probe_world() if self.elastic else None
                ),
            )
            self.events.append(event)
            pending = event
            self._say(
                f"worker died (cause={cause}, rc={rc}, "
                f"progress={progress}); restart {restart}/"
                f"{self.max_restarts} with resume=True in {delay:.2f}s"
            )
            time.sleep(delay)
            resume = True

    def metrics_txt(self, prefix: str = "tm_train") -> str:
        """Prometheus-style text for the supervision loop (the
        training-side counterpart of the serving exports): restart
        counts by cause, MTTR, the elastic world size and reshard
        count.  Callable mid-run (the events
        list grows live) or after ``run()`` returns."""
        from collections import Counter

        from theanompi_tpu_torch.obs.metrics import render_metrics

        recoveries = [
            e.recovery_s for e in self.events
            if e.recovery_s is not None
        ]
        causes = Counter(e.cause for e in self.events)
        resharded = sum(1 for e in self.events if e.resharded)
        world = (
            self.world_history[-1]
            if self.elastic and self.world_history else None
        )
        p = prefix
        return render_metrics([
            (f"{p}_restarts_total", "counter",
             [(None, len(self.events))]),
            (f"{p}_restart_causes_total", "counter", [
                ({"cause": c}, n) for c, n in sorted(causes.items())
            ]),
            (f"{p}_mttr_seconds", "gauge",
             [(None, sum(recoveries) / len(recoveries)
               if recoveries else None)]),
            (f"{p}_resharded_total", "counter", [(None, resharded)]),
            (f"{p}_world_size", "gauge", [(None, world)]),
            (f"{p}_supervised", "gauge", [(None, True)]),
        ])

    def _report(self, completed: bool, final_hb: dict | None) -> dict:
        if self.tracer is not None and \
                getattr(self, "_run_root", None) is not None:
            self.tracer.end_span(self._run_root, completed=completed)
            self._run_root = None
        recoveries = [
            e.recovery_s for e in self.events if e.recovery_s is not None
        ]
        report = {
            "completed": completed,
            "n_restarts": len(self.events),
            "restarts": [e.as_dict() for e in self.events],
            "mttr_s": (
                sum(recoveries) / len(recoveries) if recoveries else None
            ),
            "final_heartbeat": final_hb,
            "checkpoint_dir": str(self.checkpoint_dir),
        }
        if self.elastic:
            # one entry per launch: the acceptance datum an elastic
            # drill asserts on (e.g. [8, 4] for kill-one → shrink)
            report["elastic"] = True
            report["world_size_history"] = list(self.world_history)
            report["elastic_min_dp"] = self.elastic_min_dp
        return report


def make_worker_cmd_factory(
    worker_module: str,
    devices: Sequence[Any] | None,
    modelfile: str,
    modelclass: str,
    rule_kwargs: dict,
) -> Callable[..., list[str]]:
    """The command of one life: the launcher's rank-group runner over
    the processes ``launch(mode="subprocess")`` would start, each given
    the spec json, parameterized on ``resume`` so the supervisor can
    flip it per relaunch, and on ``n_devices`` so an ELASTIC supervisor
    can resize the world the relaunch runs at (None = the original
    device list).  A resized world is a PREFIX of the caller's device
    list — never devices the run was not given (``None`` devices: the
    cards ``0..n-1``).  An elastic BSP relaunch under the ``"global"``
    batch policy is then fitted to the saved global batch
    (``bsp_worker._elastic_trim_devices``), here, before its ranks
    exist.  The rank commands carry ``{init_method}``, which the
    runner fills with a fresh rendezvous for every life."""

    def cmd_for(resume: bool, n_devices: int | None = None) -> list[str]:
        from theanompi_tpu_torch import launcher

        if n_devices is None:
            devs = list(devices) if devices is not None else None
        elif devices is not None:
            devs = list(devices)[: int(n_devices)]
        else:
            devs = list(range(int(n_devices)))
        kwargs = {**rule_kwargs, "resume": resume}
        return launcher.rank_group_cmd(launcher.rank_cmds(
            worker_module, devs, modelfile, modelclass, kwargs))

    return cmd_for
