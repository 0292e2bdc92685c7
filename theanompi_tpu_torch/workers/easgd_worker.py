"""EASGD: asynchronous elastic-averaging SGD (Zhang et al. 2015).

Port of the in-process (single-controller) run of
``theanompi_tpu/workers/easgd_worker.py``.  Reference:
``theanompi/easgd_server.py`` + ``easgd_worker.py`` — a server process
holds the center parameters; each worker runs ``tau`` local SGD steps,
then an elastic exchange (``w_i -= a(w_i - w_c)`` worker-side,
``w_c += a(w_i - w_c)`` server-side); the server validates the center
and owns the checkpoint.

Here the center is a list of tensors the controller owns and the W
workers are the replicas of a ``ReplicaEngine`` on one device.  Every
``tau`` batches one ``elastic_center_merge`` runs: each worker pulls
against the same center snapshot, the center adds the summed pushes.
With ``speeds`` (out-of-step mode) worker w steps on a tick when its
speed credit reaches 1 and exchanges when ITS OWN step counter reaches
``tau``.  Validation and the checkpoint use the center, with the
replicas' mean BN statistics and momentum.  The recorder's ``comm``
segment is the exchange's wall time (the queued steps are waited for
first, under ``calc``).

The multi-process run (a TCP center server, ``_run_distributed``) and
the supervisor hooks (heartbeats, preemption) are not ported yet
(ROADMAP.md A10, A9); ``server_device`` is accepted and ignored, as in
JAX.
"""

from __future__ import annotations

import warnings
from typing import Any, Sequence

import numpy as np
import torch

from theanompi_tpu_torch.data.pipeline import engine_feed
from theanompi_tpu_torch.parallel.exchange import (
    elastic_center_merge,
    elastic_center_merge_masked,
)
from theanompi_tpu_torch.utils import Recorder
from theanompi_tpu_torch.workers.bsp_worker import _resume, worker_main
from theanompi_tpu_torch.workers.replica_engine import (
    ReplicaEngine,
    resolve_async_run,
)

#: the launcher runs every worker of this rule in one process
SINGLE_CONTROLLER = True


def _check_stability(alpha: float, n_workers: int,
                     allow_unstable: bool = False) -> None:
    """The synchronous center step is ``c += sum_i alpha*(w_i - c)``: its
    rate ``beta = alpha*N`` must be <= 1 (Zhang et al. 2015, §4) or the
    center diverges.  An error unless ``allow_unstable``, then a
    warning."""
    if alpha * n_workers <= 1.0:
        return
    msg = (
        f"EASGD alpha={alpha} with {n_workers} workers gives "
        f"beta={alpha * n_workers:.2f} > 1: unstable. Use "
        f"alpha <= {1.0 / n_workers:.4f}, or set "
        f"allow_unstable=True to proceed anyway."
    )
    if not allow_unstable:
        raise ValueError(msg)
    warnings.warn(msg, stacklevel=3)


def _fence(tree) -> None:
    """Wait for the device by reading a value of ``tree``'s first leaf."""
    float(tree[0].reshape(-1)[0])


def run(
    devices: Sequence[Any] | None = None,
    modelfile: str = "",
    modelclass: str = "",
    *,
    config: dict | None = None,
    alpha: float | None = None,
    tau: int | None = None,
    server_device: Any = None,
    n_epochs: int | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    print_freq: int = 40,
    verbose: bool = True,
    speeds: Sequence[float] | None = None,
    rank: int = 0,
    world_size: int | None = None,
    init_method: str | None = None,
    **extra: Any,
) -> dict:
    """Train ``modelclass`` under EASGD on ``devices`` (one entry per
    worker, one device: ``["cpu"] * 4``, ``[0, 0]``); returns the JAX
    summary dict.  ``alpha`` defaults to 1/W, ``tau`` to 4; ``speeds``
    (one rate in (0, 1] per worker) selects the out-of-step mode.
    ``world_size`` > 1 (a launcher process per device) is the
    multi-process rule and is refused."""
    del server_device, rank, init_method  # the center lives in-process
    device, n_workers, Model, cfg = resolve_async_run(
        "EASGD", devices, modelfile, modelclass, config, extra, n_epochs,
        world_size)
    alpha = float(alpha if alpha is not None
                  else cfg.get("alpha", 1.0 / n_workers))
    tau = int(tau if tau is not None else cfg.get("tau", 4))
    _check_stability(alpha, n_workers, cfg.get("allow_unstable", False))
    if speeds is not None:
        speeds_arr = np.asarray(speeds, np.float64)
        if speeds_arr.shape != (n_workers,):
            raise ValueError(
                f"speeds must have one entry per worker ({n_workers}); "
                f"got shape {speeds_arr.shape}")
        if np.any(speeds_arr <= 0) or np.any(speeds_arr > 1):
            raise ValueError("speeds must lie in (0, 1]")
        credit = np.zeros(n_workers)
        since_exchange = np.zeros(n_workers, np.int64)
        local_steps = np.zeros(n_workers, np.int64)

    model = Model(cfg, device=device)
    model.build_model(n_replicas=n_workers)
    recorder = Recorder(rank=0, size=n_workers, print_freq=print_freq,
                        verbose=verbose)
    # a resumed run restarts every worker from the restored center
    start_iter, resumed_from = _resume(model, recorder, checkpoint_dir,
                                       resume, verbose)
    engine = ReplicaEngine(model, n_workers)
    center = [p.detach().clone() for p in model.params]
    data = model.data
    feed = engine_feed(cfg, data, engine, epoch_of=lambda: model.epoch,
                       world=n_workers)
    if verbose:
        print(f"EASGD: {n_workers} workers on {device}, alpha={alpha:.4f} "
              f"tau={tau}, {data.n_batch_train} train batches x "
              f"{data.global_batch} global batch", flush=True)

    def adopt_center() -> None:
        """The model's state := the center with the replicas' mean BN
        statistics and momentum."""
        recorder.flush()
        engine.adopt(center, engine.mean_net_state(),
                     engine.mean_opt_state())

    step = n_exchanges = 0
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
                if speeds is None:
                    recorder.start()
                    loss, err = engine.train_step_staged(staged,
                                                         model.current_lr)
                    recorder.end("calc")
                    recorder.train_error(i, loss, err)
                    step += 1
                    exch = None
                    if step % tau == 0:
                        exch = np.ones(n_workers, bool)
                else:
                    # a worker steps when its credit reaches 1 and
                    # exchanges when its own counter reaches tau
                    credit += speeds_arr
                    mask = credit >= 1.0
                    credit -= mask
                    if not mask.any():
                        continue
                    recorder.start()
                    loss, err = engine.train_step_staged(
                        staged, model.current_lr, step_mask=mask)
                    recorder.end("calc")
                    recorder.train_error(i, loss, err)
                    local_steps += mask
                    since_exchange += mask
                    exch = since_exchange >= tau
                    if not exch.any():
                        exch = None
                if exch is not None:
                    recorder.timed_flush()  # the queued steps, as calc
                    recorder.start()
                    if speeds is None:
                        engine.params, center = elastic_center_merge(
                            engine.params, center, alpha)
                    else:
                        engine.params, center = elastic_center_merge_masked(
                            engine.params, center, alpha,
                            torch.as_tensor(exch, dtype=torch.float32,
                                            device=device))
                        since_exchange[exch] = 0
                    _fence(center)
                    recorder.end("comm")
                    n_exchanges += int(exch.sum())
                recorder.print_train_info(i)
            start_iter = 0
            if data.n_batch_val:
                # server semantics: validate the CENTER weights
                recorder.flush()
                recorder.val_error(*engine.validate(
                    data, params=center, net_state=engine.mean_net_state()))
            recorder.end_epoch(epoch)
            model.adjust_hyperp(epoch + 1)
            if checkpoint_dir:
                adopt_center()      # the center owns the checkpoint
                model.save(checkpoint_dir, recorder)
            model.epoch += 1
    finally:
        if feed is not None:
            feed.stop()
    adopt_center()

    last_val = recorder.val_records[-1] if recorder.val_records else {}
    out = {
        "epochs": model.epoch,
        "iterations": recorder.n_iter,
        "exchanges": n_exchanges,
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
        "recorder": recorder,
        "model": model,
    }
    if speeds is not None:
        out["local_steps"] = local_steps.tolist()
    return out


if __name__ == "__main__":
    worker_main(run)
