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

Across processes (``world_size`` > 1: a launcher process per device,
or the CLI's ``--coordinator/--num-hosts/--host-id``) each process is
one worker on one device and process 0 also hosts the TCP center
server (``parallel/center_server.py``): ``_run_distributed``.  Every
``tau`` steps a worker copies its parameters to the host, exchanges
them with the center at its own pace, and copies the result back into
the same parameter tensors.  Both forms carry the JAX worker's
resilience hooks: ``utils/supervisor.begin_resilient_run`` restores the
newest valid checkpoint (inside an epoch at a stamped ``next_iter``);
at each iteration boundary the ``TM_FAULT_AT`` drills fire, the
heartbeat is stamped (by process 0 across processes) and a SIGTERM
ends the loop with a checkpoint of the center stamped ``next_iter`` and
``preempted``.  ``server_device`` is accepted and ignored, as in JAX.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Sequence

import numpy as np
import torch

from theanompi_tpu_torch.data.pipeline import engine_feed
from theanompi_tpu_torch.parallel.center_server import (
    EASGDCenterClient,
    EASGDCenterServer,
    bind_host,
)
from theanompi_tpu_torch.parallel.exchange import (
    elastic_center_merge,
    elastic_center_merge_masked,
)
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
    load_leaves,
    resolve_async_run,
)

#: the launcher runs this rule's workers in one process when they name
#: one device, and one process per worker otherwise
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
    center_addr: str | None = None,
    rank: int = 0,
    world_size: int | None = None,
    init_method: str | None = None,
    **extra: Any,
) -> dict:
    """Train ``modelclass`` under EASGD on ``devices`` (one entry per
    worker, one device: ``["cpu"] * 4``, ``[0, 0]``); returns the JAX
    summary dict.  ``alpha`` defaults to 1/W, ``tau`` to 4; ``speeds``
    (one rate in (0, 1] per worker) selects the out-of-step mode.
    ``world_size`` > 1 makes this process worker ``rank`` of a
    multi-process run on its one device (``_run_distributed``), its
    peers met at ``init_method`` (``tcp://host:port``); ``center_addr``
    ("host:port") pins the center server's address."""
    del server_device  # the center lives in a process, not on a device
    if world_size is not None and int(world_size) > 1:
        if speeds is not None:
            raise ValueError(
                "speeds= is a single-controller knob (masked replicas); "
                "in multi-process mode each process already runs at its "
                "own natural pace — drop the argument")
        return _run_distributed(
            devices=devices, rank=rank, world_size=world_size,
            init_method=init_method, modelfile=modelfile,
            modelclass=modelclass, config={**(config or {}), **extra},
            alpha=alpha, tau=tau, n_epochs=n_epochs,
            checkpoint_dir=checkpoint_dir, resume=resume,
            print_freq=print_freq, verbose=verbose, center_addr=center_addr)
    device, n_workers, Model, cfg = resolve_async_run(
        "EASGD", devices, modelfile, modelclass, config, extra, n_epochs)
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
    start_iter, resumed_from = _sup.begin_resilient_run(
        model, recorder, checkpoint_dir, resume,
        verbose=verbose)
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
        # an in-process host gets its normal SIGTERM semantics back
        _sup.uninstall_preemption_handler()
    adopt_center()  # final/preempted weights = center + momentum
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
    out = {
        "epochs": model.epoch,
        "iterations": recorder.n_iter,
        "exchanges": n_exchanges,
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
        "recorder": recorder,
        "model": model,
    }
    if speeds is not None:
        out["local_steps"] = local_steps.tolist()
    return out


def _run_distributed(
    *,
    devices,
    rank: int,
    world_size: int | None,
    init_method: str | None,
    modelfile: str,
    modelclass: str,
    config: dict,
    alpha: float | None,
    tau: int | None,
    n_epochs: int | None,
    checkpoint_dir: str | None,
    resume: bool,
    print_freq: int,
    verbose: bool,
    center_addr: str | None,
) -> dict:
    """Multi-process EASGD: this process is worker ``rank`` of
    ``world_size`` on its one device; process 0 also hosts the TCP
    center server.  No barrier in the training loop: each process
    trains and exchanges at its own pace (the reference's
    server/worker split).  The center's address comes from
    ``center_addr`` or, else, through the run's ``KVStore``.  The
    model's own collectives run in a one-rank group of this process."""
    pid, n_procs = int(rank), int(world_size or 1)
    if n_procs > 1 and init_method is None:
        raise ValueError(
            f"a {n_procs}-process EASGD run needs init_method "
            f"(tcp://host:port) for its key-value store")
    device, _, Model, cfg = resolve_async_run(
        "EASGD", devices, modelfile, modelclass, config, {}, n_epochs,
        n_procs)
    alpha = float(alpha if alpha is not None
                  else cfg.get("alpha", 1.0 / n_procs))
    tau = int(tau if tau is not None else cfg.get("tau", 4))
    _check_stability(alpha, n_procs, cfg.get("allow_unstable", False))
    # the strategy's wire dtype applies to the TCP exchange: the *16
    # strategies ship bf16 leaves both ways, the elastic math stays fp32;
    # exch_compression supersedes it with the int8/fp8 per-leaf codec,
    # the client carrying the push leg's residual (error_feedback)
    comp, use_ef = resolve_compression(cfg)
    wire = comp or get_strategy(cfg.get("exch_strategy", "ici32")).wire_dtype

    if device.type == "cpu" and n_procs > 1:
        # processes sharing the host's cores: split them rather than
        # oversubscribe
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_procs))
    created = init_group(device)
    kv = server = tcp = model = None
    try:
        if n_procs > 1:
            kv = KVStore(pid, n_procs, init_method)
        model = Model(cfg, device=device)
        model.build_model(n_replicas=1)
        model.compile_iter_fns()
        recorder = Recorder(rank=pid, size=n_procs, print_freq=print_freq,
                            verbose=verbose)
        # every process loads (a shared checkpoint_dir), so all workers
        # agree on the restored epoch and start from the center weights
        start_iter, resumed_from = _sup.begin_resilient_run(
            model, recorder, checkpoint_dir, resume,
            verbose=verbose and pid == 0)
        if pid == 0:
            host, port = bind_host(kv.host if kv else "127.0.0.1"), 0
            if center_addr:
                host, port = center_addr.rsplit(":", 1)
            server = EASGDCenterServer(model.params, alpha, host=host,
                                       port=int(port), n_workers=n_procs)
            addr = f"{server.address[0]}:{server.address[1]}"
        if center_addr:
            addr = center_addr
        elif kv is not None:
            if pid == 0:
                kv.set("tm_easgd_center", addr)
            else:
                addr = kv.get("tm_easgd_center", 60000)
        host, port = addr.rsplit(":", 1)
        tcp = EASGDCenterClient((host, int(port)), wire=wire,
                                error_feedback=use_ef)

        data = model.data
        if verbose and pid == 0:
            print(f"EASGD(distributed): {n_procs} worker processes, one "
                  f"device each ({device} here), alpha={alpha:.4f} "
                  f"tau={tau}", flush=True)

        def with_center(fn):
            """``fn()`` with the center's weights in the model's
            parameters (process 0 holds the center in-process)."""
            local = [p.detach().clone() for p in model.params]
            load_leaves(model.params, server.center_tree())
            try:
                return fn()
            finally:
                load_leaves(model.params, local)

        def fault_barrier() -> None:
            """A drill's files are process 0's to write (utils/faults.py):
            the others wait for them before acting."""
            if kv is None:
                return
            key = f"tm_fault_{model.epoch}_{i}"
            if pid == 0:
                kv.set(key, "1")
            else:
                kv.get(key, 600000)

        step = n_exchanges = 0
        preempted = False
        i = 0
        center_vals: list[dict] = []
        center_stats = None
        while model.epoch < model.n_epochs:
            epoch = model.epoch
            recorder.start_epoch()
            data.shuffle(epoch + pid * 7919)  # decorrelate worker data
            for i in range(start_iter, data.n_batch_train):
                model.train_iter(i, recorder)
                step += 1
                if step % tau == 0:
                    recorder.timed_flush()  # the queued step, as calc
                    recorder.start()
                    load_leaves(model.params,
                                tcp.exchange(model.params, alpha))
                    recorder.end("comm")
                    n_exchanges += 1
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
                # drain through the normal teardown: announce stop to
                # the center, which checkpoints the center weights with
                # next_iter so the relaunch continues mid-epoch
                break
            if data.n_batch_val:
                vals = [model.val_iter(j, recorder)
                        for j in range(data.n_batch_val)]
                recorder.val_error(*(float(sum(v) / len(v))
                                     for v in zip(*vals)))
            if data.n_batch_val and server is not None:
                # the reference's server validates the CENTER; a
                # throwaway recorder keeps the sweep out of process 0's
                # timings
                center_rec = Recorder(verbose=False)
                cvals = with_center(lambda: [
                    model.val_iter(j, center_rec)
                    for j in range(data.n_batch_val)])
                cl, ce, ce5 = (float(sum(v) / len(v)) for v in zip(*cvals))
                center_vals.append({"epoch": epoch, "loss": cl, "err": ce,
                                    "err5": ce5})
                if verbose:
                    print(f"EASGD center val: epoch {epoch} loss {cl:.4f} "
                          f"err {ce:.4f}", flush=True)
            recorder.end_epoch(epoch)
            model.adjust_hyperp(epoch + 1)
            if server is not None and checkpoint_dir:
                # the center is the authoritative weights
                with_center(lambda: model.save(checkpoint_dir, recorder))
            model.epoch += 1

        # every worker announces completion; process 0 keeps the server
        # up until all have (exiting earlier would cut slower workers'
        # exchanges)
        tcp.close()
        bytes_sent, bytes_received = tcp.bytes_sent, tcp.bytes_received
        tcp = None
        if server is not None:
            # TM_EASGD_STOP_TIMEOUT_S bounds how long a dead worker can
            # hold the shutdown
            stop_timeout = float(
                os.environ.get("TM_EASGD_STOP_TIMEOUT_S", "600"))
            if not server.wait_all_stopped(timeout=stop_timeout) \
                    and verbose:
                print("EASGD center: timed out waiting for all workers to "
                      "stop; shutting down anyway", flush=True)
            # the center owns the final weights and checkpoint
            load_leaves(model.params, server.center_tree())
            if checkpoint_dir:
                model.save(checkpoint_dir, recorder, extra_meta=(
                    {"next_iter": i + 1, "preempted": True}
                    if preempted else None))
            center_stats = server.stats()
            if verbose:
                print(f"EASGD center: {center_stats['exchanges']} exchanges,"
                      f" mean wait {center_stats['mean_wait_s'] * 1e3:.1f}ms"
                      f" (max {center_stats['max_wait_s'] * 1e3:.1f}ms), "
                      f"mean hold {center_stats['mean_hold_s'] * 1e3:.1f}ms",
                      flush=True)
        if pid == 0:
            _sup.heartbeat(recorder.n_iter, model.epoch, None,
                           status="preempted" if preempted else "completed")
    finally:
        _sup.uninstall_preemption_handler()
        if tcp is not None:
            tcp.close()
        if server is not None:
            server.stop()
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
        "exchanges": n_exchanges,
        "preempted": preempted,
        "resumed_from": resumed_from,
        "restarts": recorder.restart_events,
        "n_restarts": len(recorder.restart_events),
        "mttr_s": recorder.mttr_s,
        "process_index": pid,
        "final_train_loss": (recorder.train_losses[-1]
                             if recorder.train_losses else None),
        "final_val": last_val,
        # per-epoch validation of the CENTER (process 0 only)
        "center_vals": center_vals,
        "center_val": center_vals[-1] if center_vals else None,
        # the server's backpressure snapshot (process 0 only)
        "center_stats": center_stats,
        "bytes_sent": bytes_sent,
        "bytes_received": bytes_received,
        "epoch_times": recorder.epoch_times,
        "device": str(device),
        "recorder": recorder,
        "model": model,
    }


if __name__ == "__main__":
    worker_main(run)
