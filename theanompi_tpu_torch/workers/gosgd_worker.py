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
first on ties).  The multi-process run (gossip peers over TCP,
``_run_distributed``) and the supervisor hooks are not ported yet
(ROADMAP.md A10, A9).
"""

from __future__ import annotations

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
from theanompi_tpu_torch.utils import Recorder
from theanompi_tpu_torch.workers.bsp_worker import _resume, worker_main
from theanompi_tpu_torch.workers.replica_engine import (
    ReplicaEngine,
    resolve_async_run,
)

#: the launcher runs every worker of this rule in one process
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
    ``world_size`` > 1 (a launcher process per device) is the
    multi-process rule and is refused."""
    del rank, init_method
    device, n_workers, Model, cfg = resolve_async_run(
        "GOSGD", devices, modelfile, modelclass, config, extra, n_epochs,
        world_size)
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
    start_iter, resumed_from = _resume(model, recorder, checkpoint_dir,
                                       resume, verbose)
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
            start_iter = 0
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
    scores = drain(scores)
    best = _adopt_best(engine, scores)

    last_val = recorder.val_records[-1] if recorder.val_records else {}
    return {
        "epochs": model.epoch,
        "iterations": recorder.n_iter,
        "gossip_rounds": n_rounds,
        "final_train_loss": (recorder.train_losses[-1]
                             if recorder.train_losses else None),
        "final_val": last_val,
        "epoch_times": recorder.epoch_times,
        "preempted": False,
        "resumed_from": resumed_from,
        "restarts": recorder.restart_events,
        "n_restarts": len(recorder.restart_events),
        "mttr_s": None,
        "device": str(device),
        "n_workers": n_workers,
        "scores": scores.tolist(),
        "best_worker": best,
        "recorder": recorder,
        "model": model,
    }


if __name__ == "__main__":
    worker_main(run)
