"""Deterministic fault injection (SURVEY §5.3 failure recovery).

A copy of ``theanompi_tpu/utils/faults.py`` (stdlib only), with two
changes.  ``corrupt_ckpt`` finds the newest checkpoint through the
port's ``utils/checkpoint.checkpoints`` (npz files and committed
``.shards`` directories).  And a run of the port is one process a rank,
so ``maybe_inject_fault`` takes the caller's ``rank`` and a ``barrier``
over its ranks: every rank fires the same fault at the same boundary,
but only rank 0 touches files (the fired-state line, the corrupted
checkpoint, the world file) — two ranks XOR-ing the same 16 bytes
would leave the checkpoint intact — and the ranks meet at the barrier
after rank 0's writes, before any of them dies or hangs, so a death
never outruns the write its relaunch depends on.

The reference's failure story was "checkpoint every epoch, restart
from the last one"; proving the rebuild honors it — and that the
supervisor (``utils/supervisor.py``) closes the loop without an
operator — needs reproducible mid-run failures of every kind the
fleet actually sees.  ``TM_FAULT_AT`` names them:

    TM_FAULT_AT="<epoch>:<iter>[:<action>][,<epoch>:<iter>[:<action>]...]"

with actions

- ``die`` (default) — ``os._exit(137)``: no atexit, no buffered
  checkpoint flush, indistinguishable from a SIGKILL/preemption,
- ``hang`` — stop making progress forever (a stuck collective /
  dead peer); only the supervisor's stall watchdog can end it,
- ``sigterm`` — raise SIGTERM in-process: the worker's graceful
  preemption handler checkpoints at the boundary and exits cleanly,
- ``corrupt_ckpt`` — flip bytes in the newest COMMITTED checkpoint
  (a post-commit bit-flip / truncated write), then die like a
  preemption: the relaunch must detect, quarantine, and fall back.
- ``die_replica`` — raise :class:`ReplicaDied` out of the calling
  loop.  The SERVING-fleet drill action (``serving/replica.py``):
  the replica's owner loop dies mid-flight (``dead=True``, stale
  heartbeat; a TCP replica's pongs start reporting ``alive=False``)
  and the router's health check must fail over its queued and
  in-flight requests.  For replica drills the ``<epoch>`` field is
  the REPLICA INDEX and ``<iter>`` the replica's BUSY
  engine-iteration count — same machinery, different clock.
- ``lose_device`` / ``shrink_world`` — the ELASTIC drills (a host
  preempted out of the pod, never coming back): write the reduced
  device count (one fewer / half) to the ``TM_WORLD_FILE`` the
  elastic supervisor probes, then die like a preemption
  (``os._exit(137)``) — the relaunch sees a SMALLER world and must
  continue at the new dp by resharding its checkpoint
  (elastic resume).  Fires once, persisted across
  relaunches like every other action.
- ``stall_loader`` — the DATA-PLANE drill (``data/pipeline.py``): the
  streaming loader's producer stops staging for the next
  ``TM_STALL_LOADER_N`` (default 3) batches, as if the host-side
  fetch had hit a slow disk / GC pause.  The consumer must DEGRADE —
  synchronous fetch with the ``starved`` counter ticking — not
  deadlock; the producer realigns and the stream's sample order is
  unchanged (the permutation, not the transport, defines it).
- ``spike_load`` — the AUTOSCALER drill (``serving/autoscaler.py``):
  raise :class:`LoadSpike` out of the autoscaler's policy-loop tick.
  The autoscaler treats the spike as a sustained-backpressure
  certificate and scales up IMMEDIATELY (hysteresis bypassed), so
  the fault matrix can force a fleet through a scale-up — and, with
  a ``die_replica`` aimed at a prefill specialist in the same
  ``TM_FAULT_AT`` list, kill that specialist mid-handoff while the
  spike's traffic is in flight — without shaping real traffic.  For
  this action the ``<epoch>`` field is the AUTOSCALER's index
  (``Autoscaler(index=...)``) and ``<iter>`` its tick count.

A fault fires at most ONCE.  Under a supervisor the relaunched
process would otherwise re-read the same env and re-die at the same
step forever, so fired faults are persisted to the ``TM_FAULT_STATE``
file (one index per line, written BEFORE the fault executes); without
that env the fired set is process-local, preserving the original
single-fault manual-rerun drill.

Workers call ``maybe_inject_fault(epoch, i)`` once per iteration; the
env read is cached so the hot loop pays one comparison
(``reset_fault_cache()`` drops the cache so one process can exercise
several configs, e.g. in tests).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from pathlib import Path

_ENV = "TM_FAULT_AT"
_STATE_ENV = "TM_FAULT_STATE"

ACTIONS = (
    "die", "hang", "sigterm", "corrupt_ckpt", "die_replica",
    "lose_device", "shrink_world", "spike_load", "stall_loader",
)


class ReplicaDied(RuntimeError):
    """Raised by the ``die_replica`` fault action: ends the CALLING
    loop (a serving replica's owner loop), not the whole process —
    the replica reads as dead fleet-side (stale heartbeat /
    ``alive=False``) while its host process stays inspectable."""


class LoadSpike(RuntimeError):
    """Raised by the ``spike_load`` fault action out of the
    autoscaler's policy tick: the autoscaler catches it and scales up
    immediately, as if backpressure had been sustained past the
    hysteresis window — the deterministic scale-up drill."""

#: parsed fault list — ``"unset"`` sentinel until first read, then
#: ``None`` (no faults) or a list of ``(epoch, iter, action)``
_parsed: list[tuple[int, int, str]] | None | str = "unset"
_fired: set[int] = set()


def reset_fault_cache() -> None:
    """Forget the cached ``TM_FAULT_AT`` parse AND the in-process
    fired set, so one process can exercise multiple fault configs
    (tests; parameter sweeps re-entering ``run()``)."""
    global _parsed, _fired, _loader_stall_n
    _parsed = "unset"
    _fired = set()
    with _loader_stall_lock:
        _loader_stall_n = 0


def _parse_one(entry: str) -> tuple[int, int, str]:
    parts = entry.split(":")
    if len(parts) == 2:
        e, i = parts
        action = "die"
    elif len(parts) == 3:
        e, i, action = parts
    else:
        raise ValueError(entry)
    if action not in ACTIONS:
        raise ValueError(entry)
    return (int(e), int(i), action)


def _target() -> list[tuple[int, int, str]] | None:
    global _parsed, _fired
    if _parsed == "unset":
        raw = os.environ.get(_ENV)
        if not raw:
            _parsed = None
        else:
            try:
                _parsed = [
                    _parse_one(s.strip())
                    for s in raw.split(",") if s.strip()
                ]
            except ValueError as err:
                raise ValueError(
                    f"{_ENV} must be "
                    f"'<epoch>:<iter>[:die|hang|sigterm|corrupt_ckpt"
                    f"|die_replica|lose_device|shrink_world"
                    f"|spike_load|stall_loader][,...]', got {raw!r}"
                ) from err
            if not _parsed:
                _parsed = None
            _fired |= _load_state()
    return _parsed  # type: ignore[return-value]


def targets() -> list[tuple[int, int, str]] | None:
    """The parsed ``TM_FAULT_AT`` list (None without drills); a
    malformed value raises ``ValueError`` — the worker calls this before
    its model is built, so a typo fails in milliseconds."""
    return _target()


# -- fired-state persistence (supervised relaunches) -------------------------

def _state_file() -> Path | None:
    p = os.environ.get(_STATE_ENV)
    return Path(p) if p else None


def _load_state() -> set[int]:
    f = _state_file()
    if f is None or not f.exists():
        return set()
    out = set()
    for line in f.read_text().splitlines():
        line = line.strip()
        if line.isdigit():
            out.add(int(line))
    return out


def _mark_fired(idx: int, write: bool = True) -> None:
    """Record BEFORE executing: a die/hang between write and action
    must still count as fired on the next launch.  ``write=False`` (a
    rank other than 0) records it in this process only."""
    _fired.add(idx)
    f = _state_file()
    if f is None or not write:
        return
    f.parent.mkdir(parents=True, exist_ok=True)
    with open(f, "a") as fh:
        fh.write(f"{idx}\n")
        fh.flush()
        os.fsync(fh.fileno())


# -- loader stall (the stall_loader action's channel) ------------------------

#: batches the streaming loader's producer must skip staging for —
#: set by the ``stall_loader`` action, drained by the producer thread
#: via ``consume_loader_stall`` (hence the lock: two threads)
_loader_stall_lock = threading.Lock()
_loader_stall_n = 0


def consume_loader_stall() -> bool:
    """Polled by the streaming loader's producer once per batch: True
    means "do not stage this one" (the ``stall_loader`` drill), and
    one stalled batch is consumed from the pending count."""
    global _loader_stall_n
    if _loader_stall_n <= 0:  # unlocked fast path for the hot loop
        return False
    with _loader_stall_lock:
        if _loader_stall_n <= 0:
            return False
        _loader_stall_n -= 1
        return True


def _stall_loader() -> None:
    global _loader_stall_n
    n = int(os.environ.get("TM_STALL_LOADER_N", "3"))
    with _loader_stall_lock:
        _loader_stall_n += n
    print(f"{_ENV}: loader producer stalled for {n} batches",
          flush=True)


# -- fault actions -----------------------------------------------------------

def _corrupt_file(target: Path) -> None:
    size = target.stat().st_size
    with open(target, "r+b") as f:
        if size < 32:
            f.truncate(max(0, size // 2))  # tiny file: truncate instead
            return
        off = max(0, size // 2 - 8)
        f.seek(off)
        chunk = f.read(16)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _corrupt_latest_checkpoint(checkpoint_dir: str) -> str:
    from theanompi_tpu_torch.utils.checkpoint import checkpoints

    d = Path(checkpoint_dir)
    found = checkpoints(d) if d.is_dir() else []
    path = found[0] if found else None
    if path is None:
        raise RuntimeError(
            f"{_ENV}: corrupt_ckpt fired but {checkpoint_dir!r} holds "
            f"no committed checkpoint to corrupt"
        )
    if path.is_dir():  # .shards: hit the largest data shard
        npys = sorted(
            (p for p in path.iterdir() if p.suffix == ".npy"),
            key=lambda p: p.stat().st_size, reverse=True,
        )
        if not npys:
            raise RuntimeError(f"{_ENV}: no shard files in {path}")
        _corrupt_file(npys[0])
    else:
        _corrupt_file(path)
    return str(path)


def _shrink_world(action: str, world: int | None) -> None:
    """Write the reduced device count to ``TM_WORLD_FILE`` (the
    elastic supervisor's probe), then die preemption-style."""
    _write_world(action, world)
    os._exit(137)


def _write_world(action: str, world: int | None) -> None:
    """The world-file half of ``_shrink_world``.  The baseline is the
    calling worker's own world when the file doesn't exist yet;
    repeated drills compound (8 → 7 → 6 ...)."""
    wf = os.environ.get("TM_WORLD_FILE")
    if not wf:
        raise RuntimeError(
            f"{_ENV}: {action} needs TM_WORLD_FILE (set by the "
            f"elastic supervisor — launch with elastic=... / "
            f"tmlauncher --elastic-min-dp) so the relaunch can see "
            f"the smaller world"
        )
    path = Path(wf)
    cur = None
    try:
        cur = int(path.read_text().strip())
    except (OSError, ValueError):
        cur = None
    if cur is None:
        cur = world
    if cur is None:
        raise RuntimeError(
            f"{_ENV}: {action} has no baseline world size — the "
            f"worker loop must pass world= to maybe_inject_fault, or "
            f"{wf} must already hold the device count"
        )
    new = cur - 1 if action == "lose_device" else max(1, cur // 2)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{new}\n")
    print(f"{_ENV}: world shrunk {cur} -> {new} ({wf})", flush=True)


def _execute(action: str, epoch: int, it: int,
             checkpoint_dir: str | None,
             world: int | None = None, rank: int = 0,
             barrier=None) -> None:
    print(
        f"{_ENV}: injecting fault at epoch {epoch} iter {it}"
        + (f" ({action})" if action != "die" else ""),
        flush=True,
    )
    if action == "corrupt_ckpt" and not checkpoint_dir:
        raise RuntimeError(
            f"{_ENV}: corrupt_ckpt needs the worker's "
            f"checkpoint_dir (pass checkpoint_dir= to "
            f"maybe_inject_fault, or run with a checkpoint_dir)"
        )
    if rank == 0:
        # the file half of the action, on one rank only
        if action == "corrupt_ckpt":
            where = _corrupt_latest_checkpoint(checkpoint_dir)
            print(f"{_ENV}: corrupted committed checkpoint {where}",
                  flush=True)
        elif action in ("lose_device", "shrink_world"):
            _write_world(action, world)
    if barrier is not None:
        barrier()   # rank 0's writes land before any rank acts
    if action in ("die", "corrupt_ckpt", "lose_device", "shrink_world"):
        os._exit(137)
    if action == "hang":
        # a stuck collective: alive but never progressing — only a
        # stall watchdog ends this (SIGKILL; no handler could run)
        while True:
            time.sleep(3600)
    if action == "die_replica":
        raise ReplicaDied(
            f"{_ENV}: die_replica fired at replica {epoch} "
            f"iteration {it}"
        )
    if action == "spike_load":
        raise LoadSpike(
            f"{_ENV}: spike_load fired at autoscaler {epoch} "
            f"tick {it}"
        )
    if action == "stall_loader":
        # the fault returns (like sigterm): the WORKER keeps running;
        # the producer thread observes the stall on its next poll
        _stall_loader()
        return
    if action == "sigterm":
        # planned preemption: the worker's graceful handler (installed
        # by utils/supervisor.install_preemption_handler) sets the
        # flag; the loop checkpoints at this boundary and exits 0
        signal.raise_signal(signal.SIGTERM)
        return
    raise AssertionError(action)


def maybe_inject_fault(
    epoch: int,
    i: int,
    i_last: int | None = None,
    checkpoint_dir: str | None = None,
    world: int | None = None,
    rank: int = 0,
    barrier=None,
) -> None:
    """Fire the first not-yet-fired fault targeting ``epoch`` and an
    iteration in ``[i, i_last]`` (``i_last`` defaults to ``i``;
    chunked dispatch loops pass the whole range so a target inside a
    multi-step chunk still fires).  ``checkpoint_dir`` feeds the
    ``corrupt_ckpt`` action; ``world`` (the caller's device count)
    seeds the ``lose_device``/``shrink_world`` elastic drills.  A rank
    of a multi-process run passes its ``rank`` and a ``barrier`` over
    the ranks (module docstring)."""
    faults = _target()
    if not faults:
        return
    hi = i if i_last is None else i_last
    for idx, (e, it, action) in enumerate(faults):
        if idx in _fired:
            continue
        if e == epoch and i <= it <= hi:
            _mark_fired(idx, write=rank == 0)
            _execute(action, epoch, it, checkpoint_dir, world=world,
                     rank=rank, barrier=barrier)
            return  # sigterm returns; one fault per boundary
