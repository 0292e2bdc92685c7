"""BSP worker: synchronous data-parallel training loop.

Port of ``theanompi_tpu/workers/bsp_worker.py``.  Where the JAX worker
is one controller driving every chip through a mesh, this one is one
process per device: rank ``r`` of the process group (NCCL on cards,
gloo on the CPU) owns device ``r`` and takes rows ``[r*B, (r+1)*B)`` of
each global batch.  The loop is the JAX one: per epoch
``data.shuffle(epoch)``, the batches in chunks of
``model.preferred_chunk(remaining)`` steps (``train_chunk``: K steps a
call on a device-resident path with ``steps_per_call``, else one
``train_iter`` each: forward, backward, allreduce-mean by the named
strategy, optimizer update), the val pass, the replica check
(``TM_DEBUG_SYNC=1``), ``adjust_hyperp``, ``save``; ``resume`` restarts
from the newest valid checkpoint (after its epoch, or inside it at a
stamped ``next_iter``).  The streaming feed's cursor is read and its
producer thread stopped when the run ends, on an exception too; the
cursor is the summary's ``loader``.

Resilience, as in the JAX worker: ``utils/supervisor.
begin_resilient_run`` restores and installs the graceful-SIGTERM
handler; at each chunk boundary the ``TM_FAULT_AT`` drills fire
(``utils/faults.py``; rank 0 alone touches files), rank 0 stamps the
heartbeat, and a requested preemption ends the epoch loop: the run
checkpoints with ``next_iter`` and ``preempted`` stamped and exits 0.
Under a supervisor at more than one rank the ranks agree on the
preemption flag at every boundary (a one-element max allreduce), so no
rank checkpoints and leaves while another enters the next exchange.
``config["elastic"]`` resumes across a world change:
``_apply_elastic_policy`` rescales the batch (or the lr) over the data
replicas before the model is built and ``load`` reshards the flat
exchange state; the world itself is fitted to the saved global batch
by the launcher
(``_elastic_trim_devices``), since here it is the number of processes.
A resume validates its checkpoint once a life: rank 0 picks it and the
ranks load that one (``models.base.resume_checkpoint``).

The Llama config's parallel knobs (``tp``, ``sp``, ``pp``, ``ep``) lay
the world out as pipe × expert × data × tp × sp (``parallel.mesh.
Layout``, seq fastest, as the JAX ``make_mesh``): the layout's groups
are built before the model (at tp·sp·pp·ep > 1, and for MoE at any
world > 1: its aux moments mean over the data ranks too, as JAX's over
``batch_axes``), the model shards over its axes, and the
exchange, the batch rows and the checkpoint's ``world_size`` are the
data replicas' (``n_replicas = world // (tp·sp·pp)``, the JAX ``expert
× data``).  ``TM_DEBUG_SYNC`` checks each leaf over the ranks that must
hold it equal (``model.replica_groups()``).

Observability, as the JAX worker wires it: ``config["trace"]`` records
each sampled iteration (``trace_sample``, default 1) as one trace of
load/step spans (``Recorder.attach_tracer``) and ``trace_export`` writes
them, with the step profile's spans and counter tracks, as one Perfetto
JSON (rank 0); ``config["step_profile"]`` runs one profiled window after
training, on the final parameters, against a throwaway ``Recorder``
(``obs.step_profile``: legs, coverage, MFU, the gap attribution; one
chunk when the model runs K > 1 steps a call).  The summary carries
``trace_spans`` and ``step_profile`` (a failed profile is ``{"error":
...}``, not a failed run).  Each rank profiles its own device.

A run in this process uses one device; ``launcher.launch(mode=
"subprocess")`` starts one process per device and hands each its rank.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

from theanompi_tpu_torch.data.pipeline import resolve_loader_depth
from theanompi_tpu_torch.models.base import (
    refuse_layout_exchange,
    resume_checkpoint,
)
from theanompi_tpu_torch.parallel.debug import check_replicas_synced
from theanompi_tpu_torch.parallel.mesh import (
    Layout,
    check_layout,
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
from theanompi_tpu_torch.utils.checkpoint import checkpoint_meta
from theanompi_tpu_torch.utils import faults as _faults
from theanompi_tpu_torch.utils import supervisor as _sup


def _resolve_model(modelfile: str, modelclass: str):
    mod = importlib.import_module(modelfile)
    return getattr(mod, modelclass)


ELASTIC_BATCH_POLICIES = ("global", "per_replica")


def _peek_resume_meta(cfg: dict, checkpoint_dir: str) -> dict:
    """Metadata of the checkpoint the resume will ACTUALLY load —
    validated with the same setting ``model.load`` uses, so a corrupt
    newest checkpoint (quarantined here, exactly as load() would) cannot
    make the elastic batch/LR policy read a different world than the
    one the restore falls back to."""
    from theanompi_tpu_torch.utils.checkpoint import latest_checkpoint

    path = latest_checkpoint(
        checkpoint_dir,
        validate=bool(cfg.get("validate_checkpoint", True)),
    )
    return checkpoint_meta(path) if path is not None else {}


def _elastic_trim_devices(devices, cfg: dict, checkpoint_dir: str,
                          verbose: bool, meta: dict | None = None):
    """Fit the elastic world to the batch constraint before the ranks
    start (``launcher.rank_cmds`` calls this): under the ``"global"``
    policy the saved global batch must divide the new replica count, so
    after e.g. ``lose_device`` (8 → 7) the run continues at the LARGEST
    width that divides it (7 → dp=4, idling 3 devices) instead of
    crash-looping on the divisibility refusal.  ``meta``: the resume
    checkpoint's metadata when the caller already chose it (None: peek
    it here)."""
    if str(cfg.get("elastic_batch_policy", "global")) != "global":
        return devices
    if meta is None:
        meta = _peek_resume_meta(cfg, checkpoint_dir)
    saved_global = meta.get("global_batch")
    if saved_global is None and meta.get("world_size") \
            and cfg.get("batch_size") is not None:
        saved_global = int(meta["world_size"]) * int(cfg["batch_size"])
    if not saved_global:
        return devices
    prod = 1
    for k in ("tp", "sp", "pp", "ep"):
        prod *= int(cfg.get(k, 1))
    n_avail = len(devices) if devices is not None \
        else len(resolve_devices(None))
    dp_avail = n_avail // prod
    if dp_avail < 1 or saved_global % dp_avail == 0:
        return devices
    dp_fit = next(
        d for d in range(dp_avail, 0, -1) if saved_global % d == 0
    )
    n_use = dp_fit * prod
    if verbose:
        print(
            f"elastic resume: global batch {saved_global} does not "
            f"divide over {dp_avail} replicas — using {n_use} of "
            f"{n_avail} available devices (dp={dp_fit})",
            flush=True,
        )
    return (
        list(devices)[:n_use] if devices is not None
        else list(range(n_use))
    )


def _apply_elastic_policy(
    cfg: dict, n_replicas: int, checkpoint_dir: str, verbose: bool,
    meta: dict | None = None,
) -> dict | None:
    """Elastic resume across a world change: peek the newest valid
    checkpoint's world stamp and rescale the batch/LR per
    ``elastic_batch_policy`` BEFORE the model builds its pipeline.

    - ``"global"`` (default): keep the GLOBAL batch — the per-replica
      batch grows/shrinks by old_world/new_world, so the optimization
      trajectory matches an uninterrupted equal-batch run.  Needs the
      global batch to divide the new replica count.
    - ``"per_replica"``: keep the per-replica batch — the global batch
      scales with the world, and the LR linear-scales with it (Goyal et
      al. 2017): ``lr *= new/old``, applied to ``lr`` and any dict
      ``lr_schedule`` entries present in the config.

    ``meta``: the resume checkpoint's metadata when the caller already
    chose it (None: peek it here).  Returns a summary note (or None when
    no world change applies)."""
    policy = str(cfg.get("elastic_batch_policy", "global"))
    if policy not in ELASTIC_BATCH_POLICIES:
        raise ValueError(
            f"elastic_batch_policy must be one of "
            f"{ELASTIC_BATCH_POLICIES} ('global' keeps the global "
            f"batch by growing the per-replica batch; 'per_replica' "
            f"keeps the per-replica batch and linear-scales the LR), "
            f"got {policy!r}"
        )
    if meta is None:
        meta = _peek_resume_meta(cfg, checkpoint_dir)
    saved_world = meta.get("world_size")
    if not saved_world or int(saved_world) == n_replicas:
        return None
    saved_world = int(saved_world)
    saved_global = meta.get("global_batch")
    if saved_global is None and cfg.get("batch_size") is not None:
        saved_global = saved_world * int(cfg["batch_size"])
    note = {
        "policy": policy,
        "saved_world": saved_world,
        "saved_global": saved_global,
    }
    if policy == "global":
        if saved_global is None:
            raise ValueError(
                "elastic_batch_policy='global' needs the checkpoint's "
                "global_batch stamp (pre-elastic checkpoint) or an "
                "explicit batch_size in the config"
            )
        if saved_global % n_replicas:
            raise ValueError(
                f"elastic_batch_policy='global': global batch "
                f"{saved_global} does not divide over the new world "
                f"of {n_replicas} replicas — resume at a width that "
                f"divides it, or use elastic_batch_policy="
                f"'per_replica'"
            )
        cfg["batch_size"] = saved_global // n_replicas
        note["batch_size"] = cfg["batch_size"]
    else:
        scale = n_replicas / float(saved_world)
        if "lr" in cfg:
            cfg["lr"] = float(cfg["lr"]) * scale
        sched = cfg.get("lr_schedule")
        if isinstance(sched, dict):
            cfg["lr_schedule"] = {
                k: float(v) * scale for k, v in sched.items()
            }
        note["lr_scale"] = scale
    if verbose:
        print(
            f"elastic resume: world {saved_world} -> {n_replicas}, "
            f"policy={policy} ({note})",
            flush=True,
        )
    return note


def _preempt_agreed(flag, world: int, supervised: bool) -> bool:
    """This boundary's preemption decision: the SIGTERM flag, or at more
    than one supervised rank its max over the ranks (a one-element
    allreduce), so every rank leaves at the same boundary."""
    stop = _sup.preemption_requested()
    if world > 1 and supervised:
        flag.fill_(float(stop))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        stop = bool(flag.item())
    return stop


def _profile_step_phase(model, world: int, verbose: bool) -> dict:
    """One profiled training window through ``obs.step_profile``: the
    legs from the trace's ranges, FLOPs from ``train_step_flops`` (this
    rank's, times the world: each rank runs a like step), the peak from
    the card's name (None on the CPU: the time decomposition without an
    absolute MFU)."""
    from theanompi_tpu_torch.obs import format_profile, step_profile
    from theanompi_tpu_torch.utils.scaling_model import peak_flops_per_chip

    peak = peak_flops_per_chip([model.device])
    nb = model.data.n_batch_train
    k = model.preferred_chunk(nb)
    prof_rec = Recorder(verbose=False)
    # the window walks SEQUENTIAL in-epoch indices: a streaming feed only
    # overlaps on a sequential stream
    cursor = {"i": 0}

    def window():
        i = cursor["i"]
        model.train_chunk(i, k, prof_rec)
        cursor["i"] = 0 if i + 2 * k > nb else i + k
        prof_rec.flush()

    window()    # warm: the profiled window is not the first of its kind
    flops = None
    try:
        flops = model.train_step_flops() * world
    except Exception as e:   # the time decomposition stands without MFU
        if verbose:
            print(f"step_profile: no FLOP count ({type(e).__name__}: {e})",
                  flush=True)
    prof = step_profile(
        window, n_steps=k, n_devices=world, name=type(model).__name__,
        peak_flops=peak, step_flops=flops or None,
    )
    if verbose:
        print(format_profile(prof), flush=True)
    return {
        "profile": prof.as_dict(),
        "profile_spans": prof.spans(process="bsp_worker"),
        "profile_counters": prof.counter_tracks(process="bsp_worker"),
    }


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
    comp, _ = resolve_compression(cfg)
    resolve_loader_depth(cfg)       # a bad loader_pipeline fails here
    _faults.targets()               # and a malformed TM_FAULT_AT
    if str(cfg.get("elastic_batch_policy", "global")) \
            not in ELASTIC_BATCH_POLICIES:
        raise ValueError(
            f"elastic_batch_policy must be one of "
            f"{ELASTIC_BATCH_POLICIES}, got "
            f"{cfg.get('elastic_batch_policy')!r}"
        )
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
    # the model's parallel layout: the data axis is what tp x sp x pp x
    # ep leaves; the replicas are expert x data
    tp, sp, pp, ep = (int(cfg.get(k, 1)) for k in ("tp", "sp", "pp", "ep"))
    n_replicas = ep * check_layout(world, tp, sp, pp, ep)
    refuse_layout_exchange(cfg, strat.zero1, comp)
    device = devs[rank]
    if device.type == "cpu" and world > 1:
        # ranks sharing the host's cores: split them rather than
        # oversubscribe
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    created = init_group(device, rank, world, init_method)
    model = None
    try:
        # MoE's aux moments mean over the token-sharding ranks, which
        # the layout names: it is built for experts at any world > 1
        moe = int(cfg.get("n_experts", 0)) > 0
        layout = (Layout.build(tp, sp, pp, ep)
                  if tp * sp * pp * ep > 1 or (moe and world > 1) else None)
        # the checkpoint this life resumes from, validated once: rank 0
        # picks it and every rank loads that one
        ckpt_path = (resume_checkpoint(
            checkpoint_dir, bool(cfg.get("validate_checkpoint", True)),
            device) if resume and checkpoint_dir else None)
        # elastic resume (config['elastic']): rescale batch/LR per
        # elastic_batch_policy BEFORE the pipeline is sized; model.load
        # reshards the flat exchange state onto the new layout
        elastic = bool(cfg.get("elastic"))
        elastic_note = (
            _apply_elastic_policy(
                cfg, n_replicas, checkpoint_dir, verbose,
                meta=checkpoint_meta(ckpt_path) if ckpt_path else {})
            if elastic and resume and checkpoint_dir else None
        )
        model = Model(cfg, device=device)
        model.build_model(n_replicas=n_replicas)
        model.compile_iter_fns(exch_strategy=strat.name)
        recorder = Recorder(rank=rank, size=n_replicas, print_freq=print_freq,
                            verbose=verbose)
        # span tracing (config knob "trace"): each sampled iteration is
        # one trace of load/step spans, dumped to config["trace_export"]
        tracer = None
        if cfg.get("trace"):
            from theanompi_tpu_torch.obs import Tracer

            tracer = Tracer(process="bsp_worker",
                            sample=int(cfg.get("trace_sample", 1)))
            recorder.attach_tracer(tracer)
            recorder.trace_boundary()   # labels default to n_iter
        # graceful preemption: SIGTERM → checkpoint at the next
        # iteration boundary (meta stamps next_iter) and exit 0
        start_iter, resumed_from = _sup.begin_resilient_run(
            model, recorder, checkpoint_dir, ckpt_path is not None,
            verbose=verbose and rank == 0, path=ckpt_path)
        resharded = getattr(model, "resharded_from", None)
        if (elastic_note and elastic_note.get("lr_scale")
                and resumed_from is not None):
            # load() restored the OLD world's lr from the checkpoint
            # meta: re-apply the linear rule to the restored value
            model.current_lr = float(model.current_lr) * float(
                elastic_note["lr_scale"])
        data = model.data
        if elastic_note and start_iter and elastic_note.get("saved_global"):
            # a mid-epoch next_iter was stamped in the OLD global-batch
            # grid; continue at the same SAMPLE offset in the new grid
            old_gb = int(elastic_note["saved_global"])
            new_gb = int(data.global_batch)
            if old_gb != new_gb:
                start_iter = (start_iter * old_gb) // new_gb
                resumed_from = [model.epoch, start_iter]
        if verbose and rank == 0:
            print(
                f"BSP: {world} replicas on {device.type}, "
                f"{data.n_batch_train} train batches x {data.global_batch} "
                f"global batch, exchange={strat.name}"
                + (f", buckets {bucket_mb:g} MiB" if bucket_mb
                   else ", monolithic exchange"),
                flush=True,
            )
        supervised = bool(os.environ.get(_sup.HEARTBEAT_ENV))
        flag = torch.zeros(1, device=device)
        barrier = dist.barrier if world > 1 else None
        preempted = False
        i = 0
        while model.epoch < model.n_epochs:
            epoch = model.epoch
            recorder.start_epoch()
            data.shuffle(epoch)   # same epoch -> same permutation, so a
            # mid-epoch resume continues the identical batch sequence
            i = start_iter
            start_iter = 0
            while i < data.n_batch_train:
                # a device-resident model takes K steps a call
                # (steps_per_call); else one step each
                k = model.preferred_chunk(data.n_batch_train - i)
                model.train_chunk(i, k, recorder)
                i += k
                recorder.print_train_info(i - 1)
                _faults.maybe_inject_fault(
                    epoch, i - k, i - 1, checkpoint_dir=checkpoint_dir,
                    world=world, rank=rank, barrier=barrier)
                recorder.trace_boundary()
                if rank == 0:
                    _sup.heartbeat(recorder.n_iter, epoch, i - 1,
                                   resumed_from=resumed_from,
                                   world_size=world,
                                   resharded=bool(resharded))
                if _preempt_agreed(flag, world, supervised):
                    preempted = True
                    break
            if preempted:
                break
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
                spread = (check_replicas_synced(model.params, strict=True)
                          if layout is None else max(
                              check_replicas_synced(tree, group=g)
                              for tree, g in model.replica_groups()))
                if verbose:
                    print(f"debug-sync epoch {epoch}: spread={spread:g}",
                          flush=True)
            model.adjust_hyperp(epoch + 1)
            if checkpoint_dir:
                model.save(checkpoint_dir, recorder)
            model.epoch += 1
        if preempted:
            if checkpoint_dir:
                recorder.flush()  # fence in-flight steps before the save
                model.save(checkpoint_dir, recorder,
                           extra_meta={"next_iter": i, "preempted": True})
            if verbose and rank == 0:
                print(f"preempted: checkpointed epoch {model.epoch} iter "
                      f"{i}, exiting cleanly", flush=True)
        if rank == 0:
            _sup.heartbeat(recorder.n_iter, model.epoch,
                           i if preempted else None,
                           status="preempted" if preempted else "completed",
                           world_size=world, resharded=bool(resharded))
        # step-phase profiler (config knob "step_profile"): one
        # profiled window after training, on the final parameters,
        # against a throwaway recorder.  A failure is reported, not
        # fatal: it must not cost a completed run its summary.
        step_prof = None
        if cfg.get("step_profile") and not preempted:
            try:
                step_prof = _profile_step_phase(model, world,
                                                verbose and rank == 0)
            except Exception as e:
                step_prof = {"error": f"{type(e).__name__}: {e}"}
                if verbose:
                    print(f"step_profile failed: {e}", flush=True)
        trace_spans = None
        if tracer is not None:
            recorder.finish_trace()
            trace_spans = tracer.stats()["n_spans"]
            if cfg.get("trace_export") and rank == 0:
                from theanompi_tpu_torch.obs import write_chrome_trace

                # the profile rides the same export as the iteration
                # spans: phase tree and counter tracks in one view
                spans, counters = tracer.spans(), None
                if isinstance(step_prof, dict) and "profile" in step_prof:
                    spans = spans + step_prof["profile_spans"]
                    counters = step_prof["profile_counters"]
                write_chrome_trace(spans, cfg["trace_export"],
                                   counters=counters)
                if verbose:
                    print(f"trace: {trace_spans} spans -> "
                          f"{cfg['trace_export']}", flush=True)
        if isinstance(step_prof, dict):
            # the span/counter payloads only ride the export file
            step_prof = step_prof.get("profile", step_prof)
        # the stream cursor (staged/starved counts), read before the
        # producer is parked below
        feed = getattr(model, "_feed", None)
        loader = feed.cursor() if feed is not None else None
        last_val = recorder.val_records[-1] if recorder.val_records else {}
        return {
            "epochs": model.epoch,
            "exch_strategy": strat.name,
            "exchange_bucket_mb": bucket_mb,
            "exch_compression": comp or "none",
            "iterations": recorder.n_iter,
            "final_train_loss": (recorder.train_losses[-1]
                                 if recorder.train_losses else None),
            "final_val": last_val,
            "epoch_times": recorder.epoch_times,
            "preempted": preempted,
            "resumed_from": resumed_from,
            "restarts": recorder.restart_events,
            "n_restarts": len(recorder.restart_events),
            "mttr_s": recorder.mttr_s,
            "world_size": world,
            "n_devices": world,
            "elastic": elastic,
            "elastic_batch_policy": (
                str(cfg.get("elastic_batch_policy", "global"))
                if elastic else None),
            "elastic_resume": elastic_note,
            "resharded": bool(resharded),
            "trace_spans": trace_spans,
            "step_profile": step_prof,
            "rank": rank,
            "device": str(device),
            "loader": loader,
            "recorder": recorder,
            "model": model,
        }
    finally:
        # an in-process host gets its normal SIGTERM semantics back
        _sup.uninstall_preemption_handler()
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
    from theanompi_tpu_torch.launcher import finish_distributed

    finish_distributed(ok=True, rank=ns.rank, world_size=ns.world_size or 1)


if __name__ == "__main__":
    worker_main()
