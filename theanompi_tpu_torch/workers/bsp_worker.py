"""BSP worker: synchronous data-parallel training loop.

Port of ``theanompi_tpu/workers/bsp_worker.py``.  Where the JAX worker
is one controller driving every chip through a mesh, this one is one
process per device: rank ``r`` of the process group (NCCL on cards,
gloo on the CPU) owns device ``r`` and takes rows ``[r*B, (r+1)*B)`` of
each global batch.  The loop is the JAX one: per epoch
``data.shuffle(epoch)``, ``train_iter`` over the batches (forward,
backward, allreduce-mean by the named strategy, optimizer update), the
val pass, the replica check (``TM_DEBUG_SYNC=1``), ``adjust_hyperp``,
``save``; ``resume`` restarts from the newest checkpoint (after its
epoch, or inside it at a stamped ``next_iter``).  The streaming feed's
cursor is read and its producer thread stopped when the run ends, on
an exception too; the cursor is the summary's ``loader``.

A run in this process uses one device; ``launcher.launch(mode=
"subprocess")`` starts one process per device and hands each its rank.
Config knobs of features not ported yet raise ``NotImplementedError``
naming their ROADMAP item before anything is built.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Sequence

import torch

from theanompi_tpu_torch.models.base import refuse_unported
from theanompi_tpu_torch.parallel.debug import check_replicas_synced
from theanompi_tpu_torch.parallel.mesh import (
    destroy_group,
    init_group,
    resolve_devices,
)
from theanompi_tpu_torch.parallel.strategies import (
    get_strategy,
    resolve_bucket_mb,
    resolve_compression,
)
from theanompi_tpu_torch.utils import Recorder


def _resolve_model(modelfile: str, modelclass: str):
    mod = importlib.import_module(modelfile)
    return getattr(mod, modelclass)


def _resume(model, recorder, checkpoint_dir, resume, verbose):
    """(start_iter, resumed_from): restore the newest checkpoint, past
    its epoch, or inside it at a stamped ``next_iter``."""
    if not (resume and checkpoint_dir
            and model.load(checkpoint_dir, recorder)):
        return 0, None
    nxt = model.restored_meta.get("next_iter")
    if nxt is None:
        model.epoch += 1            # saved after finishing that epoch
        if verbose:
            print(f"resumed from epoch {model.epoch - 1}", flush=True)
        return 0, [model.epoch - 1, None]
    if verbose:
        print(f"resumed mid-epoch {model.epoch} at iter {nxt}", flush=True)
    return int(nxt), [model.epoch, int(nxt)]


def run(
    devices: Sequence[Any] | None = None,
    modelfile: str = "",
    modelclass: str = "",
    *,
    config: dict | None = None,
    exch_strategy: str | None = None,
    n_epochs: int | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    print_freq: int = 40,
    verbose: bool = True,
    rank: int = 0,
    world_size: int | None = None,
    init_method: str | None = None,
    **extra: Any,
) -> dict:
    """Train ``modelclass`` under BSP as rank ``rank`` of ``devices``
    (None: every card; ``["cpu"]``: the CPU); returns a summary dict.
    ``world_size``/``init_method`` are set by the launcher for a run of
    several processes; alone, the run takes one device."""
    Model = _resolve_model(modelfile, modelclass)
    cfg = dict(config or {})
    cfg.update(extra)
    # a bad value fails here, before the (possibly minutes-long) build
    strat = get_strategy(exch_strategy or cfg.get("exch_strategy", "ici32"))
    bucket_mb = resolve_bucket_mb(cfg)
    resolve_compression(cfg)
    refuse_unported(cfg)            # loader_pipeline is validated here
    devs = resolve_devices(devices)
    world = len(devs) if world_size is None else int(world_size)
    if world != len(devs):
        raise ValueError(f"world_size {world} != {len(devs)} devices")
    if world > 1 and init_method is None:
        raise ValueError(
            f"{world} devices: a run in this process drives one; use "
            f"launcher.launch(mode='subprocess') for one process per device"
        )
    if n_epochs is not None:
        cfg["n_epochs"] = n_epochs
    device = devs[rank]
    if device.type == "cpu" and world > 1:
        # ranks sharing the host's cores: split them rather than
        # oversubscribe
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    created = init_group(device, rank, world, init_method)
    model = None
    try:
        model = Model(cfg, device=device)
        model.build_model(n_replicas=world)
        model.compile_iter_fns(exch_strategy=strat.name)
        recorder = Recorder(rank=rank, size=world, print_freq=print_freq,
                            verbose=verbose)
        start_iter, resumed_from = _resume(model, recorder, checkpoint_dir,
                                           resume, verbose)
        data = model.data
        if verbose and rank == 0:
            print(
                f"BSP: {world} replicas on {device.type}, "
                f"{data.n_batch_train} train batches x {data.global_batch} "
                f"global batch, exchange={strat.name}"
                + (f", buckets {bucket_mb:g} MiB" if bucket_mb
                   else ", monolithic exchange"),
                flush=True,
            )
        while model.epoch < model.n_epochs:
            epoch = model.epoch
            recorder.start_epoch()
            data.shuffle(epoch)   # same epoch -> same permutation
            i = start_iter
            start_iter = 0
            while i < data.n_batch_train:
                model.train_iter(i, recorder)
                recorder.print_train_info(i)
                i += 1
            if data.n_batch_val:
                tot = [0.0, 0.0, 0.0]
                for j in range(data.n_batch_val):
                    for k, v in enumerate(model.val_iter(j, recorder)):
                        tot[k] += v
                recorder.val_error(*(t / data.n_batch_val for t in tot))
            recorder.end_epoch(epoch)
            if os.environ.get("TM_DEBUG_SYNC") == "1":
                # the ranks must hold equal params after an epoch of
                # exchanges
                spread = check_replicas_synced(model.params, strict=True)
                if verbose:
                    print(f"debug-sync epoch {epoch}: spread={spread:g}",
                          flush=True)
            model.adjust_hyperp(epoch + 1)
            if checkpoint_dir:
                model.save(checkpoint_dir, recorder)
            model.epoch += 1
        # the stream cursor (staged/starved counts), read before the
        # producer is parked below
        feed = getattr(model, "_feed", None)
        loader = feed.cursor() if feed is not None else None
        last_val = recorder.val_records[-1] if recorder.val_records else {}
        return {
            "epochs": model.epoch,
            "exch_strategy": strat.name,
            "exchange_bucket_mb": bucket_mb,
            "exch_compression": "none",
            "iterations": recorder.n_iter,
            "final_train_loss": (recorder.train_losses[-1]
                                 if recorder.train_losses else None),
            "final_val": last_val,
            "epoch_times": recorder.epoch_times,
            "resumed_from": resumed_from,
            "world_size": world,
            "rank": rank,
            "device": str(device),
            "loader": loader,
            "recorder": recorder,
            "model": model,
        }
    finally:
        # no producer thread outlives the run, on an exception too
        close = getattr(model, "close_feed", None)
        if close is not None:
            close()
        if created:
            destroy_group()


def worker_main(run_fn=None) -> None:
    """Entry for ``python -m theanompi_tpu_torch.workers.bsp_worker
    --spec-json ... --rank r --world-size n --init-method tcp://...``
    (one process of a ``launcher`` subprocess run); ``run_fn`` is the
    worker module's ``run`` (default: this one)."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--spec-json", required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ns = ap.parse_args()
    spec = json.loads(ns.spec_json)
    (run_fn or run)(devices=spec.get("devices"), modelfile=spec["modelfile"],
                    modelclass=spec["modelclass"], rank=ns.rank,
                    world_size=ns.world_size, init_method=ns.init_method,
                    **spec.get("kwargs", {}))


if __name__ == "__main__":
    worker_main()
