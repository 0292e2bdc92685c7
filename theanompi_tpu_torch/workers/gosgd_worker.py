"""GoSGD: asynchronous gossip SGD (Blot et al. 2016).

Port of the in-process (single-controller) run of
``theanompi_tpu/workers/gosgd_worker.py``.  Reference:
``theanompi/gosgd_worker.py`` — every iteration each worker trains
locally, then with probability ``p`` sends ``(params, score/2)`` to a
random peer and halves its own score; the receiver merges parameters
weighted by the scores and adds them.

Here the workers are the replicas of a ``ReplicaEngine`` on one
device.  A gossip round is one ``gossip_matrix_round``: a
score-weighted routing contraction over the worker axis whose push mask
and destinations the host draws from numpy's ``default_rng(seed or
model.seed + 101)``, draw for draw as the JAX worker does, so the
routes are the JAX ones.  Parameters and momentum merge together
(merging weights but keeping each worker's velocity makes the
consensus oscillate).  With ``staleness`` D the sender halves its score
at once and its payload (a snapshot) is delivered D rounds later, FIFO;
everything in flight is delivered before an adopt or a checkpoint.

Validation runs per replica, each on its shard of the val set; the
checkpoint and the final model take the highest-score replica (the
first on ties).

Across processes (``world_size`` > 1) each process is one worker on
one device, ``_run_distributed``: pushes are fire-and-forget TCP sends
to a random peer (``parallel/gossip_net.py``), every iteration merges
whatever arrived, and the run ends with a receive-side quiesce so no
score mass is left on the wire.  Both forms carry the JAX worker's
resilience hooks: ``utils/supervisor.begin_resilient_run`` restores the
newest valid checkpoint (inside an epoch at a stamped ``next_iter``);
at each iteration boundary the ``TM_FAULT_AT`` drills fire, the
heartbeat is stamped (by process 0 across processes) and a SIGTERM
ends the loop with a checkpoint stamped ``next_iter`` and
``preempted``.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from theanompi_tpu_torch.data.pipeline import engine_feed
from theanompi_tpu_torch.parallel.exchange import (
    gossip_deliver,
    gossip_matrix_round,
    gossip_send,
    tree_map,
)
from theanompi_tpu_torch.parallel.center_server import bind_host
from theanompi_tpu_torch.parallel.gossip_net import GossipPeer
from theanompi_tpu_torch.parallel.mesh import (
    KVStore,
    destroy_group,
    init_group,
)
from theanompi_tpu_torch.parallel.strategies import (
    get_strategy,
    resolve_compression,
)
from theanompi_tpu_torch.utils import Recorder
from theanompi_tpu_torch.utils import faults as _faults
from theanompi_tpu_torch.utils import supervisor as _sup
from theanompi_tpu_torch.workers.bsp_worker import worker_main
from theanompi_tpu_torch.workers.replica_engine import (
    ReplicaEngine,
    resolve_async_run,
)

#: the launcher runs this rule's workers in one process when they name
#: one device, and one process per worker otherwise
SINGLE_CONTROLLER = True


def _adopt_best(engine: ReplicaEngine, scores: torch.Tensor) -> int:
    """Copy the highest-score replica (the first on ties, as
    ``jnp.argmax``) into the model; returns its index."""
    k = int(torch.argmax(scores))
    engine.adopt([p[k] for p in engine.params],
                 [s[k] for s in engine.net_state],
                 tree_map(lambda x: x[k], engine.opt_state))
    return k


def run(
    devices: Sequence[Any] | None = None,
    modelfile: str = "",
    modelclass: str = "",
    *,
    config: dict | None = None,
    push_prob: float | None = None,
    staleness: int | None = None,
    n_epochs: int | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    print_freq: int = 40,
    verbose: bool = True,
    seed: int | None = None,
    rank: int = 0,
    world_size: int | None = None,
    init_method: str | None = None,
    **extra: Any,
) -> dict:
    """Train ``modelclass`` under GoSGD on ``devices`` (one entry per
    worker, at least two, one device); returns the JAX summary dict
    plus the final ``scores`` and the adopted ``best_worker``.
    ``push_prob`` (default 0.25) is each worker's chance to push each
    iteration; ``staleness`` the rounds a push spends in flight.
    ``world_size`` > 1 makes this process worker ``rank`` of a
    multi-process run on its one device (``_run_distributed``), its
    peers met at ``init_method`` (``tcp://host:port``)."""
    if world_size is not None and int(world_size) > 1:
        if staleness not in (None, 0):
            raise ValueError(
                "staleness= is a single-controller knob (deterministic "
                "delayed delivery); in multi-process mode arrivals are "
                "as stale as the wire made them — drop the argument")
        return _run_distributed(
            devices=devices, rank=rank, world_size=world_size,
            init_method=init_method, modelfile=modelfile,
            modelclass=modelclass, config={**(config or {}), **extra},
            push_prob=push_prob, n_epochs=n_epochs,
            checkpoint_dir=checkpoint_dir, resume=resume,
            print_freq=print_freq, verbose=verbose, seed=seed)
    device, n_workers, Model, cfg = resolve_async_run(
        "GOSGD", devices, modelfile, modelclass, config, extra, n_epochs)
    if n_workers < 2:
        raise ValueError(
            "GoSGD needs >= 2 workers (devices) to gossip between; "
            f"got {n_workers}. Use BSP for single-device training.")
    p_push = float(push_prob if push_prob is not None
                   else cfg.get("push_prob", 0.25))
    delay = int(staleness if staleness is not None
                else cfg.get("staleness", 0))
    if delay < 0:
        raise ValueError(f"staleness must be >= 0, got {delay}")

    model = Model(cfg, device=device)
    model.build_model(n_replicas=n_workers)
    recorder = Recorder(rank=0, size=n_workers, print_freq=print_freq,
                        verbose=verbose)
    # a resumed run restarts every replica from the adopted best one;
    # the scores re-level from uniform
    start_iter, resumed_from = _sup.begin_resilient_run(
        model, recorder, checkpoint_dir, resume,
        verbose=verbose)
    engine = ReplicaEngine(model, n_workers)
    scores = torch.full((n_workers,), 1.0 / n_workers, dtype=torch.float32,
                        device=device)
    in_flight: deque = deque()      # (routing, params+opt snapshot)

    def pair():
        return {"params": engine.params, "opt": engine.opt_state}

    def deliver(scores):
        routing, snap = in_flight.popleft()
        merged, scores = gossip_deliver(pair(), scores, snap, routing)
        engine.params, engine.opt_state = merged["params"], merged["opt"]
        return scores

    def drain(scores):
        """Deliver everything still in flight: the senders halved their
        scores at send time, so a lost payload would be lost score
        mass."""
        while in_flight:
            scores = deliver(scores)
        return scores

    host_rng = np.random.default_rng(
        seed if seed is not None else model.seed + 101)
    data = model.data
    feed = engine_feed(cfg, data, engine, epoch_of=lambda: model.epoch,
                       world=n_workers)
    if verbose:
        print(f"GoSGD: {n_workers} workers on {device}, p={p_push}, "
              f"{data.n_batch_train} train batches x {data.global_batch} "
              f"global batch", flush=True)

    n_rounds = 0
    preempted = False
    i = 0
    try:
        while model.epoch < model.n_epochs:
            epoch = model.epoch
            recorder.start_epoch()
            data.shuffle(epoch)
            for i in range(start_iter, data.n_batch_train):
                recorder.start()
                staged = (feed.next(i) if feed is not None
                          else engine.put_batch(data.train_batch(i)))
                recorder.end("wait")
                recorder.start()
                loss, err = engine.train_step_staged(staged,
                                                     model.current_lr)
                recorder.end("calc")
                recorder.train_error(i, loss, err)

                # Bernoulli(p) pushes to a uniform random peer != self
                push = host_rng.random(n_workers) < p_push
                if push.any():
                    route = host_rng.integers(0, n_workers - 1, n_workers)
                    route += route >= np.arange(n_workers)
                    route_t = torch.as_tensor(route, device=device)
                    push_t = torch.as_tensor(push, dtype=torch.float32,
                                             device=device)
                    recorder.timed_flush()  # the queued step, as calc
                    recorder.start()
                    if not delay:
                        merged, scores = gossip_matrix_round(
                            pair(), scores, route_t, push_t)
                        engine.params = merged["params"]
                        engine.opt_state = merged["opt"]
                    else:
                        # the score halves now; a snapshot of the
                        # payload rides in flight for `delay` rounds
                        scores, routing = gossip_send(scores, route_t,
                                                      push_t)
                        in_flight.append(
                            (routing, tree_map(torch.clone, pair())))
                    float(scores[0])            # fence: the round's time
                    recorder.end("comm")
                    n_rounds += 1
                if delay and len(in_flight) > delay:
                    recorder.start()
                    scores = deliver(scores)
                    float(scores[0])
                    recorder.end("comm")
                recorder.print_train_info(i)
                _faults.maybe_inject_fault(epoch, i,
                                           checkpoint_dir=checkpoint_dir)
                _sup.heartbeat(recorder.n_iter, epoch, i,
                               resumed_from=resumed_from)
                if _sup.preemption_requested():
                    preempted = True
                    break
            start_iter = 0
            if preempted:
                break
            if data.n_batch_val:
                # per replica, each on its shard of the val set
                recorder.flush()
                recorder.val_error(*engine.validate(data))
            recorder.end_epoch(epoch)
            model.adjust_hyperp(epoch + 1)
            if checkpoint_dir:
                scores = drain(scores)
                _adopt_best(engine, scores)
                model.save(checkpoint_dir, recorder)
            model.epoch += 1
    finally:
        if feed is not None:
            feed.stop()
        # an in-process host gets its normal SIGTERM semantics back
        _sup.uninstall_preemption_handler()
    scores = drain(scores)
    best = _adopt_best(engine, scores)
    if preempted:
        if checkpoint_dir:
            model.save(checkpoint_dir, recorder,
                       extra_meta={"next_iter": i + 1, "preempted": True})
        if verbose:
            print(f"preempted: checkpointed epoch {model.epoch} iter "
                  f"{i + 1}, exiting cleanly", flush=True)
        _sup.heartbeat(recorder.n_iter, model.epoch, i, status="preempted")
    else:
        _sup.heartbeat(recorder.n_iter, model.epoch, None,
                       status="completed")

    last_val = recorder.val_records[-1] if recorder.val_records else {}
    return {
        "epochs": model.epoch,
        "iterations": recorder.n_iter,
        "gossip_rounds": n_rounds,
        "final_train_loss": (recorder.train_losses[-1]
                             if recorder.train_losses else None),
        "final_val": last_val,
        "epoch_times": recorder.epoch_times,
        "preempted": preempted,
        "resumed_from": resumed_from,
        "restarts": recorder.restart_events,
        "n_restarts": len(recorder.restart_events),
        "mttr_s": recorder.mttr_s,
        "device": str(device),
        "n_workers": n_workers,
        "scores": scores.tolist(),
        "best_worker": best,
        "recorder": recorder,
        "model": model,
    }


# advances once per _run_distributed call, in lockstep across the
# processes of a run (they all call run() the same number of times in
# a sweep): isolates each run's keys in the store
_DIST_RUN_COUNTER = 0


def _pair_leaves(model) -> list:
    """The optimizer state's leaves, then the parameters: the order of
    the JAX worker's ``{"params", "opt"}`` snapshot (keys sorted)."""
    out: list = []
    tree_map(out.append, model.opt_state)
    return out + list(model.params)


@torch.no_grad()
def _merge(mine: list, theirs: list, a: float) -> None:
    """Score-weighted merge of an arriving snapshot into the local
    leaves, in place: ``a*x + (1-a)*y`` in fp32, cast back (the JAX
    worker's ``merge``, with ``a`` and ``1 - a`` rounded to fp32)."""
    a32 = np.float32(a)
    b32 = np.float32(1.0) - a32
    for x, y in zip(mine, theirs):
        y = torch.as_tensor(y).to(x.device)
        x.copy_((float(a32) * x.float() + float(b32) * y.float())
                .to(x.dtype))


def _run_distributed(
    *,
    devices,
    rank: int,
    world_size: int,
    init_method: str | None,
    modelfile: str,
    modelclass: str,
    config: dict,
    push_prob: float | None,
    n_epochs: int | None,
    checkpoint_dir: str | None,
    resume: bool,
    print_freq: int,
    verbose: bool,
    seed: int | None,
) -> dict:
    """Multi-process GoSGD: this process is gossip worker ``rank`` of
    ``world_size`` on its one device (reference: one worker per MPI
    rank).  Pushes are fire-and-forget TCP sends to a random peer;
    each iteration the worker polls its inbox and merges what arrived,
    score-weighted.  No barrier in training: arrivals are as stale as
    the wire made them.  Peers meet through the run's ``KVStore``; the
    model's own collectives run in a one-rank group of this process."""
    pid, n_procs = int(rank), int(world_size)
    if init_method is None:
        raise ValueError(
            f"a {n_procs}-process GoSGD run needs init_method "
            f"(tcp://host:port) for its key-value store")
    device, _, Model, cfg = resolve_async_run(
        "GOSGD", devices, modelfile, modelclass, config, {}, n_epochs,
        n_procs)
    p_push = float(push_prob if push_prob is not None
                   else cfg.get("push_prob", 0.25))
    # the *16 strategies put bf16 on the gossip wire (half the push
    # bytes and outbox memory); the merge stays fp32.  exch_compression
    # supersedes it with the int8/fp8 per-leaf codec, with no residual:
    # a push's receiver is random and unacknowledged, so no single
    # counterpart's view could be unbiased by one (as in the JAX worker)
    wire = resolve_compression(cfg)[0] or get_strategy(
        cfg.get("exch_strategy", "ici32")).wire_dtype

    global _DIST_RUN_COUNTER
    _DIST_RUN_COUNTER += 1
    tag = f"{os.environ.get('TM_RUN_ID', '0')}_{_DIST_RUN_COUNTER}"
    if device.type == "cpu" and n_procs > 1:
        # processes sharing the host's cores: split them rather than
        # oversubscribe
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_procs))
    created = init_group(device)
    kv = peer = model = None
    try:
        kv = KVStore(pid, n_procs, init_method)
        model = Model(cfg, device=device)
        model.build_model(n_replicas=1)
        model.compile_iter_fns()
        recorder = Recorder(rank=pid, size=n_procs, print_freq=print_freq,
                            verbose=verbose)
        # a shared checkpoint_dir: everyone restarts from the adopted
        # best weights of the previous run
        start_iter, resumed_from = _sup.begin_resilient_run(
            model, recorder, checkpoint_dir, resume,
            verbose=verbose and pid == 0)
        peer = GossipPeer(host=bind_host(kv.host))
        kv.set(f"tm_gosgd_{tag}_peer_{pid}",
               f"{peer.address[0]}:{peer.address[1]}")
        peers: dict[int, tuple[str, int]] = {}
        for r in range(n_procs):
            if r != pid:
                host, port = kv.get(f"tm_gosgd_{tag}_peer_{r}",
                                    60000).rsplit(":", 1)
                peers[r] = (host, int(port))

        host_rng = np.random.default_rng(
            (seed if seed is not None else model.seed + 211) + pid * 7919)
        score = 1.0 / n_procs
        n_pushes = n_merges = 0
        mid_saves: list[dict] = []
        epoch_scores: list[float] = []
        data = model.data
        if verbose and pid == 0:
            print(f"GoSGD(distributed): {n_procs} worker processes, one "
                  f"device each ({device} here), p={p_push}", flush=True)

        def drain_inbox(score):
            nonlocal n_merges
            # reclaim the score of pushes the wire gave up on (dropped
            # under backpressure, dead peer): conservation first
            score += peer.take_refunds()
            for s_in, leaves in peer.poll():
                _merge(_pair_leaves(model), leaves, score / (score + s_in))
                score += s_in
                n_merges += 1
            return score

        def fault_barrier() -> None:
            """A drill's files are process 0's to write (utils/faults.py):
            the others wait for them before acting."""
            key = f"tm_gosgd_{tag}_fault_{model.epoch}_{i}"
            if pid == 0:
                kv.set(key, "1")
            else:
                kv.get(key, 600000)

        preempted = False
        i = 0
        while model.epoch < model.n_epochs:
            epoch = model.epoch
            recorder.start_epoch()
            data.shuffle(epoch + pid * 104729)  # decorrelate worker data
            for i in range(start_iter, data.n_batch_train):
                model.train_iter(i, recorder)
                # Bernoulli(p) push to a uniform random peer != self
                push = host_rng.random() < p_push
                if push:
                    dst = int(host_rng.integers(0, n_procs - 1))
                    dst += dst >= pid
                    recorder.timed_flush()  # the queued step, as calc
                # probe and merge what the wire delivered (reference:
                # the per-iteration MPI probe loop)
                recorder.start()
                score = drain_inbox(score)
                if push:
                    score *= 0.5
                    peer.push(peers[dst], score, _pair_leaves(model),
                              wire=wire)
                    n_pushes += 1
                recorder.end("comm")
                recorder.print_train_info(i)
                _faults.maybe_inject_fault(epoch, i,
                                           checkpoint_dir=checkpoint_dir,
                                           rank=pid, barrier=fault_barrier)
                if pid == 0:
                    _sup.heartbeat(recorder.n_iter, epoch, i,
                                   resumed_from=resumed_from)
                if _sup.preemption_requested():
                    preempted = True
                    break
            start_iter = 0
            if preempted:
                # drain through the normal quiesce, then the best worker
                # checkpoints with next_iter
                break
            if data.n_batch_val:
                vals = [model.val_iter(j, recorder)
                        for j in range(data.n_batch_val)]
                recorder.val_error(*(float(sum(v) / len(v))
                                     for v in zip(*vals)))
            recorder.end_epoch(epoch)
            model.adjust_hyperp(epoch + 1)
            epoch_scores.append(float(score))
            if checkpoint_dir:
                # mid-run best-score checkpoint: everyone publishes its
                # post-epoch score, then reads the peers'; all complete
                # views agree on the argmax, so exactly the best worker
                # saves.  A soft per-epoch sync bounded by
                # TM_GOSGD_CKPT_SYNC_S per missing peer; without a
                # checkpoint_dir training stays barrier-free
                published = f"{score:.9e}"
                kv.set(f"tm_gosgd_{tag}_esc_{epoch}_{pid}", published)
                # compare the PUBLISHED representation on both sides,
                # or two workers could each defer to (or outrank) the
                # other below the wire precision
                best_pid, best_score = pid, float(published)
                complete_view = True
                sync_ms = int(float(os.environ.get(
                    "TM_GOSGD_CKPT_SYNC_S", "60")) * 1000)
                for r in range(n_procs):
                    if r == pid:
                        continue
                    try:
                        s = float(kv.get(f"tm_gosgd_{tag}_esc_{epoch}_{r}",
                                         sync_ms))
                    except TimeoutError:
                        # an incomplete view must not elect itself: two
                        # writers would interleave; the next epoch and
                        # the final save retry
                        complete_view = False
                        continue
                    if s > best_score or (s == best_score and r < best_pid):
                        best_pid, best_score = r, s
                if not complete_view:
                    print(f"[gosgd {pid}] epoch {epoch}: peer score read "
                          f"timed out; skipping mid-run checkpoint "
                          f"election (next epoch retries)", flush=True)
                elif best_pid == pid:
                    model.save(checkpoint_dir, recorder)
                    with open(os.path.join(checkpoint_dir,
                                           "gosgd_best.json"), "w") as f:
                        json.dump({"epoch": epoch, "pid": pid,
                                   "score": score}, f)
                    mid_saves.append({"epoch": epoch, "score": score})
            model.epoch += 1

        # quiesce: ship queued pushes, publish per-destination DELIVERED
        # counts (what left this host), then drain the inbox until it
        # holds exactly what was addressed here — a receive-side ack,
        # so no score mass is abandoned on the wire.  The waits scale
        # with the run (TM_GOSGD_QUIESCE_S overrides)
        wall = sum(recorder.epoch_times) or 60.0
        quiesce_s = float(os.environ.get("TM_GOSGD_QUIESCE_S",
                                         max(600.0, 2.0 * wall)))
        kv_ms = int(quiesce_s * 1000)
        if not peer.flush(timeout=quiesce_s):
            # reclaim the queued payloads' score before publishing, so
            # sent_counts is the exact total
            peer.cancel_pending()
            if verbose:
                print("GoSGD quiesce: flush timed out; pending pushes "
                      "cancelled and refunded", flush=True)
        delivered = {r: peer.sent_counts.get(addr, 0)
                     for r, addr in peers.items()}
        kv.set(f"tm_gosgd_{tag}_sent_{pid}",
               json.dumps({str(r): c for r, c in delivered.items()}))
        expected = 0
        for r in range(n_procs):
            if r != pid:
                counts = json.loads(kv.get(f"tm_gosgd_{tag}_sent_{r}",
                                           kv_ms))
                expected += int(counts.get(str(pid), 0))
        deadline = time.monotonic() + quiesce_s
        score = drain_inbox(score)  # also reclaims refunded mass
        while n_merges < expected and time.monotonic() < deadline:
            time.sleep(0.05)
            score = drain_inbox(score)
        if n_merges < expected and verbose:
            print(f"GoSGD quiesce: received {n_merges}/{expected} pushes "
                  f"before timeout", flush=True)

        kv.set(f"tm_gosgd_{tag}_done_{pid}", f"{score:.9e}")
        final_scores = {r: float(kv.get(f"tm_gosgd_{tag}_done_{r}", kv_ms))
                        for r in range(n_procs)}
        if checkpoint_dir:
            # the highest post-drain score saves the final checkpoint
            if pid == max(final_scores, key=lambda r: final_scores[r]):
                model.save(checkpoint_dir, recorder, extra_meta=(
                    {"next_iter": i + 1, "preempted": True}
                    if preempted else None))
        bytes_sent, bytes_received = peer.bytes_sent, peer.bytes_received
        if pid == 0:
            _sup.heartbeat(recorder.n_iter, model.epoch, None,
                           status="preempted" if preempted else "completed")
    finally:
        _sup.uninstall_preemption_handler()
        if peer is not None:
            peer.close()
        if kv is not None:
            kv.close()
        close = getattr(model, "close_feed", None)
        if close is not None:
            close()
        if created:
            destroy_group()

    last_val = recorder.val_records[-1] if recorder.val_records else {}
    return {
        "epochs": model.epoch,
        "iterations": recorder.n_iter,
        "preempted": preempted,
        "resumed_from": resumed_from,
        "restarts": recorder.restart_events,
        "n_restarts": len(recorder.restart_events),
        "mttr_s": recorder.mttr_s,
        "pushes": n_pushes,
        "delivered": sum(delivered.values()),
        "merges": n_merges,
        "score": score,
        # epochs where this process held the best published score and
        # wrote the mid-run checkpoint
        "mid_saves": mid_saves,
        "epoch_scores": epoch_scores,
        "process_index": pid,
        "final_train_loss": (recorder.train_losses[-1]
                             if recorder.train_losses else None),
        "final_val": last_val,
        "bytes_sent": bytes_sent,
        "bytes_received": bytes_received,
        "epoch_times": recorder.epoch_times,
        "device": str(device),
        "recorder": recorder,
        "model": model,
    }


if __name__ == "__main__":
    worker_main(run)
