"""Replica layer of the serving fleet: one `Engine` behind a
health-stamped loop, reachable in-process or over TCP.

Port of ``theanompi_tpu/serving/replica.py``, copied with the port's
imports.  A replica takes the device of the decoder it wraps; in one
process several replicas share one card and one GIL, each engine
launching its kernels (K4, the RMS norm) on the current stream of the
thread that steps it — the default stream, as no replica sets one.
Only host data travels on the wire: ids, results, span records, and
KV handoff records as numpy arrays (bf16 K/V as ``uint16`` bits).

The fleet's unit of capacity is a REPLICA: one decoder + one engine
driven by one owner loop that, every iteration,

1. fires any targeted fault drill (``utils/faults.py`` —
   ``TM_FAULT_AT="<replica_index>:<busy_iter>:die_replica"`` kills
   THIS loop the way the fault matrix kills a training worker: same
   env machinery, different clock — the iteration field
   counts BUSY engine iterations, so a drill at iteration k dies
   with requests provably in flight),
2. runs one ``Engine.step()`` (shed → admit → prefill → decode),
3. stamps a supervisor-style heartbeat (monotonic progress + wall
   time) — the router's watchdog judges liveness by FRESH stamps,
   exactly like ``utils/supervisor.py`` judges a training worker.

Two transports share that loop:

- :class:`InProcessReplica` — the loop on a thread in the router's
  process.  Zero wire cost; the deployment shape when replicas share
  one host's cards.  ``pause()``/``resume()`` simulate a
  stalled loop (a stuck collective) for the watchdog drills, and
  ``restart()`` relaunches a dead loop over the same engine — its
  abandoned requests were requeued by the router, so the restart
  sheds their engine-side futures (``Engine.abandon_all``) and the
  fresh heartbeats let the router's monitor REJOIN the replica
  automatically.
- :class:`ReplicaServer` / :class:`TCPReplicaClient` — the same loop
  in another process, reached over the repo's one TCP wire (the
  length-prefixed pickle frames of ``parallel/center_server.py``).
  The client keeps ONE connection: a reader thread resolves result
  frames into local futures (out-of-order safe — frames carry the
  request id), and a pinger thread refreshes a cached heartbeat +
  load snapshot so the router's health check never blocks on the
  network.  A dropped connection marks the client dead; the router
  requeues its in-flight requests — the fleet twin of the engine's
  "every future resolves" guarantee.

``python -m theanompi_tpu_torch.serving.replica --spec-json '{...}'``
hosts a checkpoint-restored decoder as a replica child (the
``serving_fleet`` phase of ``chip_smoke.py`` uses it); it prints
``REPLICA_READY <port>`` once serving.  With ``config["tp"] > 1`` it
is rank 0 of a tensor-parallel model group: it starts the follower
ranks as child processes of its own (one per further entry of the
spec's ``devices``), and only rank 0 serves TCP.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time

from theanompi_tpu_torch.serving.engine import (
    Engine,
    Request,
    Result,
    ServingFuture,
)
from theanompi_tpu_torch.utils.faults import maybe_inject_fault


def result_to_dict(r: Result) -> dict:
    return {
        "status": r.status, "finish_reason": r.finish_reason,
        "tokens": list(r.tokens), "ttft_s": r.ttft_s,
        "tpot_s": r.tpot_s, "queued_s": r.queued_s, "e2e_s": r.e2e_s,
        # numpy KV payloads ride the pickle frames as-is
        "handoff": r.handoff,
        # the request's span flight record (obs/tracer.py) — the
        # router ingests it, so the tree survives this process
        "spans": list(r.spans),
    }


def result_from_dict(d: dict) -> Result:
    d = dict(d)
    d.setdefault("spans", [])   # pre-tracing peers
    return Result(**d)


class InProcessReplica:
    """One engine + its owner loop thread + a heartbeat the router
    watches.  The loop stamps ``{"progress", "time", "status"}`` per
    iteration (idle iterations refresh ``time`` without advancing
    ``progress`` — an idle replica is alive); a loop that raises
    (``ReplicaDied`` from a fault drill, or any real crash) leaves
    ``dead=True`` with the cause recorded and its heartbeat stale.
    """

    #: dispatch roles a replica can declare: "unified"
    #: serves end-to-end; "prefill" specialists take prefill-only
    #: dispatches and ship KV handoffs; "decode" specialists receive
    #: handoffs and run pure decode.  The ROUTER enforces the policy
    #: — the engine underneath is identical, which is what makes the
    #: unified fallback safe.
    ROLES = ("unified", "prefill", "decode")

    def __init__(self, engine: Engine, *, name: str | None = None,
                 index: int = 0, idle_sleep_s: float = 1e-3,
                 role: str = "unified"):
        self.engine = engine
        self.index = int(index)
        self.name = name if name is not None else f"replica{index}"
        self.idle_sleep_s = float(idle_sleep_s)
        if role not in self.ROLES:
            raise ValueError(
                f"role must be one of {self.ROLES}, got {role!r}"
            )
        self.role = role
        self._steps = 0
        self._hb = {"progress": 0, "time": 0.0, "status": "starting"}
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: threading.Thread | None = None
        self.dead = False
        self.death_cause: str | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "InProcessReplica":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"{self.name} already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"tm-{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if self._paused.is_set():
                    # simulated stall: alive thread, NO fresh stamps —
                    # exactly what a stuck collective looks like to
                    # the router's watchdog
                    time.sleep(1e-3)
                    continue
                maybe_inject_fault(self.index, self._steps)
                busy = self.engine.step()
                if busy:
                    # the fault/progress clock counts BUSY iterations
                    # (idle spins tick ~1000/s — a drill targeting
                    # "iteration 3" means the 3rd iteration that did
                    # work, so the dying replica provably has
                    # requests in flight)
                    self._steps += 1
                self._hb = {
                    "progress": self._steps, "time": time.time(),
                    "status": "running",
                }
                if not busy and self.engine.queue_depth() == 0:
                    time.sleep(self.idle_sleep_s)
        except BaseException as e:  # noqa: BLE001 - a dying replica is DATA
            self.dead = True
            self.death_cause = f"{type(e).__name__}: {e}"
            self._hb = dict(self._hb, status="dead")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def restart(self) -> "InProcessReplica":
        """Relaunch a dead (or stopped) replica over the SAME engine
        and decoder.  The router already requeued the dead loop's
        pending requests elsewhere, so their engine-side futures are
        shed (never dangle) and their slots/blocks freed before the
        fresh loop starts; the new loop's heartbeats are what make
        the router's monitor rejoin this replica."""
        if self._thread is not None and self._thread.is_alive() \
                and not self.dead:
            raise RuntimeError(f"{self.name} still running")
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        self.engine.abandon_all(reason="restart")
        self.dead = False
        self.death_cause = None
        self._paused.clear()
        self._thread = None
        return self.start()

    # -- test/ops hooks (simulated stall) ----------------------------------

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    # -- the replica protocol (what the router consumes) -------------------

    def submit(self, request: Request) -> ServingFuture:
        return self.engine.submit(request)

    def load(self) -> int:
        """Queue depth + occupied slots — the least-loaded policy's
        scalar."""
        return self.engine.queue_depth() + self.engine.active_slots()

    def slots(self) -> int:
        """Decode-slot capacity — the autoscaler's denominator when
        it turns fleet-wide outstanding work into a pressure
        signal."""
        return self.engine.decoder.max_slots

    def heartbeat(self) -> dict:
        return dict(self._hb)

    def alive(self) -> bool:
        return (
            not self.dead
            and self._thread is not None
            and self._thread.is_alive()
        )

    def recorder_state(self) -> dict:
        return self.engine.recorder.state_dict()

    def paging_stats(self) -> dict | None:
        return self.engine.paging_stats()

    def trace_state(self) -> list:
        """The engine's span ring (flight-recorder salvage hook: the
        router pulls this when the loop dies, so in-flight requests'
        spans outlive the crash)."""
        tr = self.engine.tracer
        return tr.spans() if tr is not None else []

    def metrics_txt(self) -> str:
        return self.engine.recorder.metrics_txt()

    def reset_stats(self) -> None:
        """Fresh recorder + cleared radix cache — the bench's
        between-arm reset."""
        from theanompi_tpu_torch.utils.recorder import ServingRecorder

        self.engine.recorder = ServingRecorder(
            max_slots=self.engine.decoder.max_slots
        )
        cache = getattr(self.engine.decoder, "prefix_cache", None)
        if cache is not None:
            cache.clear()


# ---------------------------------------------------------------------------
# TCP transport (reuses the center-server frame wire)
# ---------------------------------------------------------------------------


class ReplicaServer:
    """Host an :class:`InProcessReplica` behind the center-server TCP
    frames.  Commands (client → server):

    - ``("submit", {"rid", "prompt", "max_tokens", "temperature",
      "seed", "deadline_s"})`` — no reply frame; the terminal
      ``("result", (rid, result_dict))`` is PUSHED when the engine
      resolves the request's future (out of order across rids).
    - ``("ping", nonce)`` → ``("reply", (nonce, {"hb", "load",
      "alive", "name"}))`` — the health/load snapshot.
    - ``("stats", nonce)`` → recorder state + paging stats.
    - ``("reset", nonce)`` — fresh recorder, cleared radix cache.
    - ``("shutdown", None)`` — stop the engine loop and the server.
    """

    def __init__(self, engine: Engine, *, name: str = "replica",
                 index: int = 0, host: str = "127.0.0.1",
                 port: int = 0, role: str = "unified",
                 send_timeout_s: float = 30.0):
        self.replica = InProcessReplica(engine, name=name, index=index,
                                        role=role)
        self.send_timeout_s = float(send_timeout_s)
        self._stopped = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address = (host, self._sock.getsockname()[1])
        self._accept_thread = threading.Thread(
            target=self._serve, name=f"tm-{name}-srv", daemon=True
        )

    def start(self) -> "ReplicaServer":
        self.replica.start()
        self._accept_thread.start()
        return self

    def _serve(self) -> None:
        while not self._stopped.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._client, args=(conn,), daemon=True
            ).start()

    def _client(self, conn: socket.socket) -> None:
        from theanompi_tpu_torch.parallel.center_server import (
            recv_frame,
            send_frame,
        )

        send_lock = threading.Lock()

        def push(frame) -> None:
            # engine-thread callbacks race the command loop for the
            # socket; a dead connection just drops the frame (the
            # router requeues on the health signal, not on delivery).
            # send_timeout_s bounds the write: a peer that stops
            # READING (wedged client, full TCP buffer) would leave a
            # bare sendall blocked forever while holding send_lock —
            # parking every engine-thread result callback behind it
            # and stalling the replica.
            try:
                with send_lock:
                    send_frame(conn, frame,
                               timeout_s=self.send_timeout_s)
            except (OSError, ConnectionError):
                # a timed-out send may have written PART of a frame —
                # the length-prefixed stream is desynced, so the
                # connection is unusable: close it so the command
                # loop's recv fails and the client's reader marks the
                # wire dead (router requeues), instead of appending
                # the next frame at an arbitrary byte offset
                try:
                    conn.close()
                except OSError:
                    pass

        try:
            with conn:
                while True:
                    cmd, payload = recv_frame(conn)
                    if cmd == "submit":
                        rid = payload["rid"]
                        req = Request(
                            prompt=list(payload["prompt"]),
                            max_tokens=int(payload["max_tokens"]),
                            temperature=float(payload["temperature"]),
                            deadline_s=payload.get("deadline_s"),
                            seed=int(payload.get("seed", 0)),
                            prefill_only=bool(
                                payload.get("prefill_only", False)
                            ),
                            handoff=payload.get("handoff"),
                            trace=payload.get("trace"),
                        )
                        self.replica.submit(req).add_done_callback(
                            lambda r, rid=rid: push(
                                ("result", (rid, result_to_dict(r)))
                            )
                        )
                    elif cmd == "trace":
                        push(("reply", (payload, {
                            "spans": self.replica.trace_state(),
                        })))
                    elif cmd == "metrics":
                        push(("reply", (payload, {
                            "text": self.replica.metrics_txt(),
                        })))
                    elif cmd == "ping":
                        push(("reply", (payload, {
                            "hb": self.replica.heartbeat(),
                            "load": self.replica.load(),
                            "alive": self.replica.alive(),
                            "name": self.replica.name,
                            "role": self.replica.role,
                            "slots": self.replica.slots(),
                        })))
                    elif cmd == "stats":
                        push(("reply", (payload, {
                            "recorder": self.replica.recorder_state(),
                            "paging": self.replica.paging_stats(),
                            "hb": self.replica.heartbeat(),
                        })))
                    elif cmd == "reset":
                        self.replica.reset_stats()
                        push(("reply", (payload, "ok")))
                    elif cmd == "shutdown":
                        self.stop()
                        return
                    else:
                        push(("reply", (payload, f"unknown {cmd!r}")))
        except (ConnectionError, EOFError, OSError):
            return

    def stop(self) -> None:
        self._stopped.set()
        self.replica.stop()
        try:
            self._sock.close()
        except OSError:
            pass

    def wait(self, timeout: float | None = None) -> bool:
        """Block until shutdown (the child entry point's main loop)."""
        return self._stopped.wait(timeout)


class TCPReplicaClient:
    """Router-side handle to a :class:`ReplicaServer` — implements
    the same replica protocol as :class:`InProcessReplica`, so the
    router treats both uniformly.

    ``load()`` and ``heartbeat()`` serve the PINGER's cached
    snapshot (refreshed every ``ping_interval_s``): the health check
    must never block the router on a sick network, and a stale
    snapshot is precisely what "stalled" means.  Any wire failure
    marks the client dead and resolves its outstanding futures as
    shed "replica_dead" — the router requeues them on the spot, and
    a direct caller's ``result()`` never hangs.
    """

    def __init__(self, address: tuple, *, name: str | None = None,
                 connect_timeout: float = 120.0,
                 ping_interval_s: float = 0.05,
                 ping_timeout_s: float = 10.0,
                 send_timeout_s: float = 30.0,
                 role: str = "unified", slots: int = 1):
        self.address = tuple(address)
        self.name = name if name is not None else f"tcp:{address[1]}"
        self.send_timeout_s = float(send_timeout_s)
        self.ping_timeout_s = float(ping_timeout_s)
        # role/slots seed from the caller (who launched the replica
        # and knows its spec); pongs carrying the server's own values
        # overwrite them, so a default-constructed client converges
        # to the truth after one ping round trip
        self.role = role
        self._slots = int(slots)
        self.dead = False
        self._rid = itertools.count()
        self._nonce = itertools.count()
        self._futures: dict[int, ServingFuture] = {}
        self._replies: dict[int, list] = {}   # nonce -> [event, payload]
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()
        self._hb: dict = {"progress": -1, "time": 0.0,
                          "status": "connecting"}
        self._load = 0

        deadline = time.monotonic() + connect_timeout
        delay = 0.1
        while True:
            try:
                self._sock = socket.create_connection(
                    self.address, timeout=60.0
                )
                self._sock.settimeout(None)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 2.0)

        self._reader = threading.Thread(
            target=self._read_loop, name=f"tm-{self.name}-rd",
            daemon=True,
        )
        self._reader.start()
        self._pinger = threading.Thread(
            target=self._ping_loop, args=(float(ping_interval_s),),
            name=f"tm-{self.name}-hb", daemon=True,
        )
        self._pinger.start()

    # -- wire --------------------------------------------------------------

    def _send(self, frame) -> None:
        from theanompi_tpu_torch.parallel.center_server import send_frame

        # send_timeout_s bounds the write (socket.timeout is an
        # OSError): the router dispatches under ITS lock, so an
        # unbounded sendall into a wedged peer would freeze the whole
        # fleet — watchdog included — forever.
        try:
            with self._send_lock:
                send_frame(self._sock, frame,
                           timeout_s=self.send_timeout_s)
        except (OSError, ConnectionError):
            self._mark_dead()
            raise ConnectionError(f"{self.name}: send failed")

    def _read_loop(self) -> None:
        from theanompi_tpu_torch.parallel.center_server import recv_frame

        try:
            while True:
                tag, payload = recv_frame(self._sock)
                if tag == "result":
                    rid, d = payload
                    with self._lock:
                        fut = self._futures.pop(rid, None)
                    if fut is not None:
                        fut._set(result_from_dict(d))
                elif tag == "reply":
                    nonce, data = payload
                    with self._lock:
                        slot = self._replies.get(nonce)
                    if slot is not None:
                        slot[1] = data
                        slot[0].set()
        except (ConnectionError, EOFError, OSError):
            self._mark_dead()

    def _mark_dead(self) -> None:
        self.dead = True
        with self._lock:
            slots = list(self._replies.values())
            futures = list(self._futures.values())
            self._futures.clear()
        for slot in slots:
            slot[0].set()   # unblock command waiters (payload None)
        # Resolve every outstanding submit as "replica_dead" — same
        # shape as the mid-submit death path, so the router requeues
        # immediately instead of waiting out a health-poll interval,
        # and a direct (router-less) caller never hangs on result().
        # MUST run outside self._lock: _set fires the router's
        # done-callback, which takes the router lock — and router
        # paths holding that lock call load(), which takes ours.
        for fut in futures:
            fut._set(Result(status="shed",
                            finish_reason="replica_dead"))

    def _command(self, cmd: str, timeout: float = 30.0,
                 even_if_dead: bool = False):
        """``even_if_dead`` keeps trying the WIRE after the liveness
        verdict went dead: a fault drill that killed the remote
        ENGINE LOOP leaves the frame-serving threads alive, and the
        flight-recorder salvage wants exactly that window.  A truly
        dead socket still fails fast (the send raises)."""
        nonce = next(self._nonce)
        slot = [threading.Event(), None]
        with self._lock:
            self._replies[nonce] = slot
        try:
            self._send((cmd, nonce))
            if not slot[0].wait(timeout) or (
                self.dead and not even_if_dead
            ):
                raise ConnectionError(
                    f"{self.name}: no {cmd} reply"
                )
            if slot[1] is None and self.dead:
                raise ConnectionError(
                    f"{self.name}: wire died before {cmd} reply"
                )
            return slot[1]
        finally:
            with self._lock:
                self._replies.pop(nonce, None)

    def _ping_loop(self, interval: float) -> None:
        while not self.dead:
            try:
                data = self._command("ping",
                                     timeout=self.ping_timeout_s)
            except ConnectionError:
                if self.dead:
                    return
                # transient: the reply timed out but the wire is
                # intact (a GIL-heavy kernel build can stall the
                # replica >10s).  Keep pinging — exiting here would freeze
                # heartbeat() forever, so the router could never see
                # a fresh beat and the member could never rejoin.
                # A truly dead socket fails the ping SEND next pass,
                # which marks the client dead and ends the loop.
                continue
            if not data.get("alive", False):
                # the remote LOOP died while the socket lives: a
                # replica-process fault drill that only killed the
                # engine thread still reads as dead fleet-side
                self.dead = True
                return
            self._hb = data["hb"]
            self._load = data["load"]
            if "role" in data:
                self.role = data["role"]
            if "slots" in data:
                self._slots = int(data["slots"])
            time.sleep(interval)

    # -- the replica protocol ----------------------------------------------

    def submit(self, request: Request) -> ServingFuture:
        rid = next(self._rid)
        fut = ServingFuture()
        with self._lock:
            self._futures[rid] = fut
        try:
            self._send(("submit", {
                "rid": rid, "prompt": list(request.prompt),
                "max_tokens": request.max_tokens,
                "temperature": request.temperature,
                "deadline_s": request.deadline_s,
                "seed": request.seed,
                "prefill_only": request.prefill_only,
                "handoff": request.handoff,
                "trace": request.trace,
            }))
        except ConnectionError:
            with self._lock:
                self._futures.pop(rid, None)
            # resolve SHED rather than raise: the router treats a
            # mid-submit death like any other failover (requeue)
            fut._set(Result(status="shed", finish_reason="replica_dead"))
            return fut
        if self.dead:
            # raced _mark_dead's sweep: our future registered after
            # the snapshot and the send still landed in the local
            # buffer, so nobody else will ever resolve it (_set is
            # first-wins — a no-op if the sweep did catch it)
            with self._lock:
                self._futures.pop(rid, None)
            fut._set(Result(status="shed", finish_reason="replica_dead"))
        return fut

    def load(self) -> int:
        """Load for the least-loaded policy.  The remote snapshot is
        only as fresh as the last pong — during a burst of submits it
        still reads 0, which would send EVERY tie-broken request to
        the same member — so take the max with this client's own
        outstanding (submitted, unresolved) count, which is exact for
        the traffic this router originated and available instantly."""
        with self._lock:
            outstanding = len(self._futures)
        return max(self._load, outstanding)

    def slots(self) -> int:
        return self._slots

    def heartbeat(self) -> dict:
        return dict(self._hb)

    def alive(self) -> bool:
        return not self.dead

    def recorder_state(self, timeout: float = 30.0) -> dict:
        return self._command("stats", timeout)["recorder"]

    def stats(self, timeout: float = 30.0) -> dict:
        return self._command("stats", timeout)

    def trace_state(self, timeout: float = 10.0) -> list:
        """Pull the remote engine's span ring — the router's salvage
        hook, so it tries the wire EVEN AFTER the liveness verdict
        went dead (a die_replica drill kills the engine loop, not the
        frame server).  Short timeout: salvage is best-effort."""
        return self._command("trace", timeout,
                             even_if_dead=True)["spans"]

    def metrics_txt(self, timeout: float = 30.0) -> str:
        return self._command("metrics", timeout)["text"]

    def paging_stats(self, timeout: float = 30.0) -> dict | None:
        return self._command("stats", timeout)["paging"]

    def reset_stats(self, timeout: float = 30.0) -> None:
        self._command("reset", timeout)

    def shutdown(self) -> None:
        try:
            self._send(("shutdown", None))
        except ConnectionError:
            pass

    def close(self) -> None:
        self.dead = True
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# replica child entry point
# ---------------------------------------------------------------------------


def serve_replica_main(argv=None) -> None:
    """``python -m theanompi_tpu_torch.serving.replica --spec-json
    '{...}'`` — build a checkpoint-restored decoder, host it as a TCP
    replica, print ``REPLICA_READY <port>``, serve until ``shutdown``.

    Spec keys: ``config`` (model dict incl. ``tp``), ``checkpoint``
    (dir), ``device`` (tp = 1; default: the card, resolved by
    ``parallel.mesh.resolve_device``; ``"cpu"`` for the CPU),
    ``devices`` (tp > 1: one entry a rank, e.g. ``[0, 1]`` or
    ``["cpu", "cpu"]``), ``backend`` (tp > 1: the device group's,
    ``"nccl"`` by default on cards; ``"gloo"`` for ranks that share a
    card), ``paged`` (bool), ``decoder`` (decoder kwargs), ``engine``
    (Engine kwargs), ``name``/``index``, ``host``/``port``,
    ``role`` (``unified``/``prefill``/``decode``),
    ``trace_sample`` (int, 0 = off — span tracing with this replica's
    name as the Perfetto process lane and its role as the thread
    lane; the router stitches the spans it ships back on Results).

    At tp > 1 this process is rank 0: it starts ranks 1..tp-1 as
    ``--rank r --init-method tcp://...`` children (killed with it),
    which load their shards and follow rank 0's decoder calls; it exits
    when one of them dies first.
    """
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--spec-json", required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init-method", default=None)
    args = ap.parse_args(argv)
    spec = json.loads(args.spec_json)
    config = dict(spec["config"])
    tp = int(config.get("tp", 1))

    from theanompi_tpu_torch.parallel.mesh import resolve_device
    from theanompi_tpu_torch.serving.decoder import decoder_from_checkpoint
    from theanompi_tpu_torch.utils.recorder import ServingRecorder

    group, followers = None, []
    if tp > 1:
        from theanompi_tpu_torch.parallel.mesh import ModelGroup

        devices = list(spec.get("devices") or [])
        if len(devices) != tp:
            raise ValueError(f"tp={tp} needs a devices list of {tp} "
                             f"entries, got {devices}")
        init = args.init_method
        if args.rank > 0:
            _exit_with_parent()
        else:
            init = f"tcp://127.0.0.1:{_free_port()}"
            followers = [_start_follower(args.spec_json, r, init)
                         for r in range(1, tp)]
            released = _exit_with_followers(followers)
        device = resolve_device(devices[args.rank])
        group = ModelGroup.join(device, args.rank, tp, init,
                                backend=spec.get("backend"))
    else:
        device = resolve_device(spec.get("device"))
    dec = decoder_from_checkpoint(
        config, spec["checkpoint"], device=device,
        paged=bool(spec.get("paged", False)), group=group,
        **dict(spec.get("decoder", {})),
    )
    if args.rank > 0:
        dec.follow()
        return
    index = int(spec.get("index", 0))
    tracer = None
    if int(spec.get("trace_sample", 0)) > 0:
        from theanompi_tpu_torch.obs import Tracer

        tracer = Tracer(
            process=spec.get("name", f"replica{index}"),
            lane=spec.get("role", "unified"),
            sample=int(spec["trace_sample"]),
        )
    eng = Engine(
        dec, recorder=ServingRecorder(max_slots=dec.max_slots),
        tracer=tracer,
        **dict(spec.get("engine", {})),
    )
    srv = ReplicaServer(
        eng, name=spec.get("name", f"replica{index}"), index=index,
        host=spec.get("host", "127.0.0.1"),
        port=int(spec.get("port", 0)),
        role=spec.get("role", "unified"),
    ).start()
    print(f"REPLICA_READY {srv.address[1]}", flush=True)
    srv.wait()
    if followers:
        released.set()
        dec.close()                  # releases the followers' loops
        for proc in followers:
            proc.wait(timeout=60)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_follower(spec_json: str, rank: int, init_method: str):
    """Follower rank ``rank`` of a tp > 1 replica as a child process
    (it exits when this process dies: ``_exit_with_parent``)."""
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-m", "theanompi_tpu_torch.serving.replica",
         "--spec-json", spec_json, "--rank", str(rank),
         "--init-method", init_method],
    )


def _exit_with_parent(interval_s: float = 1.0) -> None:
    """A follower's watchdog thread: end this process when the replica
    that started it is gone (its parent changes), so a SIGKILLed
    replica leaves no rank blocked on a header that never comes."""
    import os

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(interval_s)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _exit_with_followers(followers, interval_s: float = 1.0):
    """Rank 0's watchdog thread (tp > 1): end this process when a
    follower rank exits before it is released (it raised, or was
    killed), so rank 0 does not block in a collective that rank never
    joins.  Set the returned event before releasing the followers."""
    import os

    released = threading.Event()

    def watch():
        while not released.wait(interval_s):
            if any(p.poll() is not None for p in followers):
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    return released


if __name__ == "__main__":
    serve_replica_main()
