"""Training and serving telemetry.

- ``Recorder`` — the training recorder of
  ``theanompi_tpu/utils/recorder.py``, the subset the BSP worker
  calls: wall-clock segments (``calc``/``comm``/``wait``), per-step
  (loss, err) kept as device scalars and read at the next print window
  or epoch end (the read is the fence), val records, epoch times, and
  ``state_dict``/``load_state_dict`` in the JAX layout, so a checkpoint's
  recorder state crosses between the packages; ``record_restart`` and
  ``mttr_s``, the restart accounting of a supervised run; span
  tracing (``attach_tracer``: each sampled iteration one trace whose
  load/step/exchange spans are the ``start()``/``end(mode)`` segments),
  ``metrics_txt`` (the ``tm_train_*`` families over ``obs/metrics.py``)
  and ``start_profiler``/``stop_profiler`` on ``torch.profiler``.
- ``Reservoir``/``ServingRecorder`` — copies of the serving section
  (numpy only): per-request TTFT/TPOT, tokens/s, slot occupancy, queue
  depth, KV-block gauges, the speculative accept rate, the tokenize
  sweeps, and ``metrics_txt`` over ``obs/metrics.py``.
- ``FleetRecorder`` — a copy of the serving fleet's recorder: the
  router-side request stream, requeue/failover/rejoin/handoff counts,
  dispatches per replica, the spawn/retire log and
  ``replica_seconds``, per-replica ``ServingRecorder`` states merged
  through ``attach_replica``, ``summary`` and ``metrics_txt``.
"""

from __future__ import annotations

import os
import random
import time
from collections import Counter, deque

import numpy as np


MODES = ("calc", "comm", "wait")

#: recorder segment -> span name in the training trace (the phases
#: Theano-MPI's per-iteration breakdown named: load the batch, run
#: the step, exchange the gradients)
_MODE_SPAN = {"calc": "step", "comm": "exchange", "wait": "load"}


class Recorder:
    """Training metrics and wall-clock segments (see module
    docstring)."""

    def __init__(self, rank: int = 0, size: int = 1, print_freq: int = 40,
                 verbose: bool = True):
        self.rank = rank
        self.size = size
        self.print_freq = print_freq
        self.verbose = verbose and rank == 0
        self._t0: float | None = None
        self.segments = {m: 0.0 for m in MODES}        # this print window
        self.epoch_segments = {m: 0.0 for m in MODES}
        self.total_segments = {m: 0.0 for m in MODES}  # whole run
        self._train_losses: list[float] = []
        self._train_errors: list[float] = []
        self.val_records: list[dict] = []
        self.epoch_times: list[float] = []
        self._epoch_start: float | None = None
        self._window: list[tuple[float, float]] = []
        self._pending: list[tuple] = []
        self.n_iter = 0
        self._last_print = 0
        self.window_marks: list[tuple[int, float]] = []
        self.restart_events: list[dict] = []
        # span tracing (obs/tracer.py): attach_tracer() turns the
        # per-iteration segments into load/step/exchange spans
        self._tracer = None
        self._iter_ctx: dict | None = None
        self._iter_root: dict | None = None
        self._t0_trace: float | None = None
        self._profiler = None

    # -- span tracing (obs/tracer.py) -------------------------------------

    def attach_tracer(self, tracer) -> None:
        """Record each sampled ITERATION as one trace (root span
        ``iteration``) whose children are the load/step/exchange phase
        spans the ``start()``/``end(mode)`` segments measure.  The
        tracer's own ``sample`` knob decides which iterations trace;
        call :meth:`trace_boundary` at the iteration boundary."""
        self._tracer = tracer

    def trace_boundary(self, iteration: int | None = None) -> None:
        """Close the current iteration's trace and open the next (the
        BSP worker calls this where it stamps its heartbeat)."""
        if self._tracer is None:
            return
        if self._iter_root is not None:
            self._tracer.end_span(self._iter_root)
        self._iter_ctx = self._tracer.new_context()
        self._iter_root = self._tracer.start_span(
            self._iter_ctx, "iteration",
            iteration=int(iteration if iteration is not None
                          else self.n_iter),
        )

    def finish_trace(self) -> None:
        """Close the trailing open iteration span (end of run)."""
        if self._tracer is not None and self._iter_root is not None:
            self._tracer.end_span(self._iter_root)
            self._iter_root = self._iter_ctx = None

    # -- wall-clock segments ----------------------------------------------

    def start(self) -> None:
        self._t0 = time.perf_counter()
        if self._tracer is not None and self._iter_root is not None:
            self._t0_trace = self._tracer.clock()

    def end(self, mode: str) -> None:
        assert mode in MODES, mode
        if self._t0 is None:
            return
        self._add(mode, time.perf_counter() - self._t0)
        self._t0 = None
        if (self._tracer is not None and self._iter_root is not None
                and self._t0_trace is not None):
            self._tracer.record_span(
                self._iter_ctx, _MODE_SPAN[mode], self._t0_trace,
                self._tracer.clock(),
                parent_id=self._iter_root["span_id"],
            )
            self._t0_trace = None

    def _add(self, mode: str, dt: float) -> None:
        for seg in (self.segments, self.epoch_segments,
                    self.total_segments):
            seg[mode] += dt

    def start_epoch(self) -> None:
        self._epoch_start = time.perf_counter()
        self.epoch_segments = {m: 0.0 for m in MODES}

    def train_error(self, count: int, loss, err) -> None:
        """One step's (loss, err), or a chunk's: length-K device vectors
        (``train_chunk``'s K steps, one record and one read for the
        chunk), read lazily (see :meth:`flush`)."""
        del count
        self._pending.append((loss, err))
        self.n_iter += loss.shape[0] if getattr(loss, "ndim", 0) else 1

    def flush(self) -> None:
        """Read the pending device values (this is the fence)."""
        for loss, err in self._pending:
            if getattr(loss, "ndim", 0):
                pairs = zip(loss.tolist(), err.tolist())
            else:
                pairs = [(float(loss), float(err))]
            for pair in pairs:
                self._train_losses.append(pair[0])
                self._train_errors.append(pair[1])
                self._window.append(pair)
        self._pending = []

    @property
    def train_losses(self) -> list[float]:
        self.flush()
        return self._train_losses

    @property
    def train_errors(self) -> list[float]:
        self.flush()
        return self._train_errors

    def timed_flush(self) -> None:
        """Flush and charge the wait for the device to ``calc``."""
        t0 = time.perf_counter()
        self.flush()
        self._add("calc", time.perf_counter() - t0)

    def print_train_info(self, count: int) -> None:
        """Close the print window every ``print_freq`` iterations, on
        every rank: fence (``timed_flush``), append ``(n_iter, time)``
        to ``window_marks``, and, verbose on rank 0, print the window's
        mean loss and error and its segments.  With ``print_freq=1`` the
        marks time each iteration, the device's work included."""
        if self.n_iter < self._last_print + self.print_freq:
            return
        self._last_print = self.n_iter
        self.timed_flush()
        self.window_marks.append((self.n_iter, time.perf_counter()))
        window, self._window = self._window, []
        seg, self.segments = self.segments, {m: 0.0 for m in MODES}
        if not (self.verbose and window):
            return
        losses, errs = zip(*window)
        print(
            f"iter {count}: loss {np.mean(losses):.4f} err "
            f"{np.mean(errs):.4f} | calc {seg['calc']:.3f}s comm "
            f"{seg['comm']:.3f}s wait {seg['wait']:.3f}s",
            flush=True,
        )

    def val_error(self, loss: float, err: float,
                  err_top5: float | None = None) -> None:
        rec = {"loss": float(loss), "err": float(err)}
        if err_top5 is not None:
            rec["err_top5"] = float(err_top5)
        self.val_records.append(rec)

    def end_epoch(self, epoch: int) -> None:
        if self._epoch_start is None:
            return
        self.timed_flush()   # epoch wall time includes all device work
        wall = time.perf_counter() - self._epoch_start
        self.epoch_times.append(wall)
        if self.verbose:
            seg = self.epoch_segments
            val = self.val_records[-1] if self.val_records else {}
            val_str = (f" | val loss {val['loss']:.4f} err {val['err']:.4f}"
                       if val else "")
            print(
                f"epoch {epoch}: {wall:.1f}s (calc {seg['calc']:.1f}s comm "
                f"{seg['comm']:.1f}s wait {seg['wait']:.1f}s){val_str}",
                flush=True,
            )

    def record_restart(
        self,
        cause: str,
        resumed_epoch: int | None = None,
        resumed_iter: int | None = None,
        recovery_s: float | None = None,
        restart: int | None = None,
        world_size: int | None = None,
        resharded: bool | None = None,
    ) -> None:
        """One supervised relaunch: why the previous life died, where
        this one resumed, and the worker-side recovery latency (failure
        detection → restored and ready to train).  ``world_size`` and
        ``resharded`` (elastic runs) record the DP width this life trains
        at and whether the resume re-laid the flat exchange state; kept
        through ``state_dict``, so the history survives later
        checkpointed restarts."""
        self.restart_events.append({
            "restart": (restart if restart is not None
                        else len(self.restart_events) + 1),
            "cause": cause,
            "resumed_epoch": resumed_epoch,
            "resumed_iter": resumed_iter,
            "recovery_s": recovery_s,
            "world_size": world_size,
            "resharded": resharded,
        })
        if self.verbose:
            at = (f"epoch {resumed_epoch}"
                  + (f" iter {resumed_iter}" if resumed_iter else "")
                  if resumed_epoch is not None else "scratch")
            rec = f" after {recovery_s:.1f}s" if recovery_s else ""
            print(f"restart #{self.restart_events[-1]['restart']}: "
                  f"cause={cause}, resumed from {at}{rec}", flush=True)

    @property
    def mttr_s(self) -> float | None:
        """Mean time-to-recovery over recorded restarts (None until a
        recovery has been measured)."""
        rs = [e["recovery_s"] for e in self.restart_events
              if e.get("recovery_s") is not None]
        return sum(rs) / len(rs) if rs else None

    def metrics_txt(self, prefix: str = "tm_train",
                    world_size: int | None = None) -> str:
        """Prometheus-style text for the training loop: step rate over
        cumulative calc time, per-mode wall totals, restart/MTTR/reshard
        accounting from the restart events, latest loss.
        ``world_size`` — the current DP width (the worker passes it;
        falls back to the newest restart event's stamp)."""
        from theanompi_tpu_torch.obs.metrics import render_metrics

        self.flush()
        calc = self.total_segments["calc"]
        if world_size is None:
            stamps = [e.get("world_size") for e in self.restart_events
                      if e.get("world_size") is not None]
            world_size = stamps[-1] if stamps else None
        resharded = sum(1 for e in self.restart_events if e.get("resharded"))
        p = prefix
        return render_metrics([
            (f"{p}_iterations_total", "counter", [(None, self.n_iter)]),
            (f"{p}_epochs_total", "counter",
             [(None, len(self.epoch_times))]),
            (f"{p}_seconds_total", "counter", [
                ({"mode": m}, self.total_segments[m]) for m in MODES
            ]),
            (f"{p}_steps_per_sec", "gauge",
             [(None, self.n_iter / calc if calc else None)]),
            (f"{p}_loss", "gauge",
             [(None, self._train_losses[-1]
               if self._train_losses else None)]),
            (f"{p}_restarts_total", "counter",
             [(None, len(self.restart_events))]),
            (f"{p}_resharded_total", "counter", [(None, resharded)]),
            (f"{p}_mttr_seconds", "gauge", [(None, self.mttr_s)]),
            (f"{p}_world_size", "gauge", [(None, world_size)]),
        ])

    # -- profiler handoff -------------------------------------------------

    def start_profiler(self, logdir: str) -> None:
        """Start a ``torch.profiler`` trace (CPU, and the card when one
        is available) that :meth:`stop_profiler` writes under
        ``logdir`` as a Chrome trace (``utils/trace_comm.comm_report``
        reads it)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._profiler_dir = logdir
        self._profiler = profile(activities=acts)
        self._profiler.start()

    def stop_profiler(self) -> None:
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        prof.stop()
        os.makedirs(self._profiler_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self._profiler_dir, f"trace_{time.time_ns()}.pt.trace.json"))

    def state_dict(self) -> dict:
        self.flush()
        return {
            "train_losses": self._train_losses,
            "train_errors": self._train_errors,
            "val_records": self.val_records,
            "epoch_times": self.epoch_times,
            "n_iter": self.n_iter,
            "restart_events": self.restart_events,
            "total_segments": dict(self.total_segments),
        }

    def load_state_dict(self, d: dict) -> None:
        self._pending = []
        self._train_losses = list(d["train_losses"])
        self._train_errors = list(d["train_errors"])
        self.val_records = list(d["val_records"])
        self.epoch_times = list(d["epoch_times"])
        self.n_iter = int(d["n_iter"])
        self.restart_events = list(d.get("restart_events", []))
        tot = d.get("total_segments") or {
            "calc": float(sum(self.epoch_times))}
        self.total_segments = {m: float(tot.get(m, 0.0)) for m in MODES}
        self._last_print = self.n_iter


def _percentile(xs: list[float], q: float) -> float | None:
    """p-th percentile or None on empty input (shed-only runs must
    not crash the summary)."""
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else None


class Reservoir:
    """Bounded uniform sample of an unbounded stream (Vitter's
    algorithm R) — the fix for the ServingRecorder's per-request
    latency lists growing without limit over a long-running fleet.
    Exact (= the full sample) below ``cap``; past it, each stream
    element survives with probability cap/n, so percentiles stay
    unbiased estimates.  ``merge`` folds another reservoir in with
    draws weighted by the two streams' true counts, so merged fleet
    percentiles track the pooled distribution (tolerance asserted in
    the JAX package's tests/test_tracing.py).  Deterministic: seeded
    ``random.Random``, no global RNG."""

    __slots__ = ("cap", "n", "xs", "_rng")

    def __init__(self, cap: int = 2048, seed: int = 0):
        self.cap = max(1, int(cap))
        self.n = 0
        self.xs: list[float] = []
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        self.n += 1
        if len(self.xs) < self.cap:
            self.xs.append(float(x))
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self.xs[j] = float(x)

    def merge(self, other_xs, other_n: int) -> None:
        """Fold a foreign sample of a stream of ``other_n`` items."""
        b_xs = [float(x) for x in other_xs]
        b_n = int(other_n)
        if b_n <= 0 or not b_xs:
            return
        if not self.xs:
            keep = b_xs if len(b_xs) <= self.cap else \
                self._rng.sample(b_xs, self.cap)
            self.xs = list(keep)
            self.n = b_n
            return
        a_xs, a_n = self.xs, self.n
        if len(a_xs) + len(b_xs) <= self.cap:
            self.xs = a_xs + b_xs
            self.n = a_n + b_n
            return
        a_sh = a_xs[:]
        b_sh = b_xs[:]
        self._rng.shuffle(a_sh)
        self._rng.shuffle(b_sh)
        out: list[float] = []
        ai = bi = 0
        p_a = a_n / (a_n + b_n)
        while len(out) < self.cap and (ai < len(a_sh) or bi < len(b_sh)):
            take_a = (
                ai < len(a_sh)
                and (bi >= len(b_sh) or self._rng.random() < p_a)
            )
            if take_a:
                out.append(a_sh[ai])
                ai += 1
            else:
                out.append(b_sh[bi])
                bi += 1
        self.xs = out
        self.n = a_n + b_n

    def percentile(self, q: float) -> float | None:
        return _percentile(self.xs, q)

    def state(self) -> dict:
        return {"cap": self.cap, "n": self.n, "xs": list(self.xs)}

    @classmethod
    def from_state(cls, d: dict, seed: int = 0) -> "Reservoir":
        r = cls(cap=d["cap"], seed=seed)
        r.n = int(d["n"])
        r.xs = [float(x) for x in d["xs"]]
        return r


class ServingRecorder:
    """Telemetry sink for the continuous-batching engine: per-request
    TTFT/TPOT, aggregate tokens/s over decode time, slot occupancy,
    and queue depth.  The training ``Recorder`` measures a step loop;
    this measures a request loop — separate class, same module, so
    every wall-clock datum in the repo lives in one place.

    Per-request fields (``record_request``): ``status`` "ok"/"shed",
    ``finish_reason``, prompt/generated token counts, ``ttft_s``
    (submit → first token), ``tpot_s`` (mean inter-token seconds
    after the first), ``queued_s``, ``e2e_s``, ``n_prefix_hit``
    (prompt tokens adopted from the radix prefix cache — 0 over the
    v1 slot-contiguous decoder).

    Per-step fields (``record_step``): slots that decoded, queue
    depth at the step, step seconds, tokens emitted, and — paged
    serving only — the block gauges ``blocks_in_use``/``blocks_free``
    at the step.

    **Bounded memory** (a long-running fleet must not grow without
    limit): the raw ``requests``/``steps`` lists are rolling windows
    of the last ``max_samples`` entries, every aggregate the summary
    reports is maintained EXACTLY in incremental counters, and the
    TTFT/TPOT percentiles come from seeded :class:`Reservoir`
    samples — exact below ``max_samples``, unbiased estimates past
    it, and mergeable fleet-wide with count-weighted draws.
    """

    def __init__(self, max_slots: int = 1, *,
                 max_samples: int = 4096, seed: int = 0):
        self.max_slots = int(max_slots)
        self.max_samples = int(max_samples)
        self.requests: deque = deque(maxlen=self.max_samples)
        self.steps: deque = deque(maxlen=self.max_samples)
        self.blocks_in_use_max: int | None = None
        self.blocks_free_min: int | None = None
        self._ttft = Reservoir(self.max_samples, seed)
        self._tpot = Reservoir(self.max_samples, seed + 1)
        self._agg = self._zero_agg()

    @staticmethod
    def _zero_agg() -> dict:
        return {
            "n_ok": 0, "n_shed": 0,
            "shed_reasons": Counter(), "finish_reasons": Counter(),
            "tokens_completed": 0, "hit_tokens": 0, "prompt_tokens": 0,
            "decode_s": 0.0, "tokens": 0,
            "cap_slot_s": 0.0, "act_slot_s": 0.0,
            "depth_sum": 0, "depth_n": 0, "depth_max": None,
            "drafted": 0, "accepted": 0, "slot_steps": 0,
            # batched tokenize/detokenize front door (the JAX
            # package's serving/tokenize.py): sweeps = worker drains,
            # items = requests encoded/decoded, wait = summed queue
            # seconds
            "tok_sweeps": 0, "tok_items": 0, "tok_tokens": 0,
            "tok_wait_s": 0.0,
        }

    def record_request(
        self,
        *,
        status: str,
        finish_reason: str,
        n_prompt: int,
        n_generated: int,
        ttft_s: float | None = None,
        tpot_s: float | None = None,
        queued_s: float | None = None,
        e2e_s: float | None = None,
        n_prefix_hit: int = 0,
    ) -> None:
        r = {
            "status": status,
            "finish_reason": finish_reason,
            "n_prompt": int(n_prompt),
            "n_generated": int(n_generated),
            "ttft_s": ttft_s,
            "tpot_s": tpot_s,
            "queued_s": queued_s,
            "e2e_s": e2e_s,
            "n_prefix_hit": int(n_prefix_hit),
        }
        self.requests.append(r)
        self._fold_request(r)

    def _fold_request(self, r: dict) -> None:
        a = self._agg
        if r["status"] == "ok":
            a["n_ok"] += 1
            a["finish_reasons"][r["finish_reason"]] += 1
            a["tokens_completed"] += int(r["n_generated"])
            a["hit_tokens"] += int(r.get("n_prefix_hit", 0) or 0)
            a["prompt_tokens"] += int(r["n_prompt"])
            if r.get("ttft_s") is not None:
                self._ttft.add(r["ttft_s"])
            if r.get("tpot_s") is not None:
                self._tpot.add(r["tpot_s"])
        else:
            a["n_shed"] += 1
            a["shed_reasons"][r["finish_reason"]] += 1

    def record_tokenize(
        self,
        *,
        n_items: int,
        n_tokens: int,
        wait_s: float = 0.0,
    ) -> None:
        """Fold one tokenize-service sweep (``serving/tokenize.py``):
        how many encode/decode requests the worker drained in one
        codec call, the tokens they produced/consumed, and their
        summed queue wait.  items/sweeps is the amortization factor
        the batching exists for."""
        a = self._agg
        a["tok_sweeps"] += 1
        a["tok_items"] += int(n_items)
        a["tok_tokens"] += int(n_tokens)
        a["tok_wait_s"] += float(wait_s)

    def record_step(
        self,
        *,
        active_slots: int,
        queue_depth: int,
        dt_s: float,
        tokens: int,
        blocks_in_use: int | None = None,
        blocks_free: int | None = None,
        drafted: int | None = None,
        accepted: int | None = None,
    ) -> None:
        s = {
            # wall stamp: what anchors this step's gauges on the
            # Perfetto counter tracks (counter_tracks below) — the
            # tracer's span stamps are wall-shifted monotonic, so
            # time.time() lands the gauges on the same timeline
            "t": time.time(),
            "active_slots": int(active_slots),
            "queue_depth": int(queue_depth),
            "dt_s": float(dt_s),
            "tokens": int(tokens),
            "blocks_in_use": blocks_in_use,
            "blocks_free": blocks_free,
            # speculative decoding (serving v5): draft tokens offered
            # to / reproduced by this verify step — None on the
            # non-speculative path
            "drafted": drafted,
            "accepted": accepted,
        }
        self.steps.append(s)
        self._fold_step(s)
        self.record_block_gauges(
            blocks_in_use=blocks_in_use, blocks_free=blocks_free
        )

    def _fold_step(self, s: dict) -> None:
        a = self._agg
        dt = float(s["dt_s"])
        a["decode_s"] += dt
        a["tokens"] += int(s["tokens"])
        # merged steps carry their OWN recorder's max_slots stamp
        # (see merge()); local steps use ours
        a["cap_slot_s"] += s.get("max_slots", self.max_slots) * dt
        a["act_slot_s"] += int(s["active_slots"]) * dt
        a["depth_sum"] += int(s["queue_depth"])
        a["depth_n"] += 1
        a["depth_max"] = (
            int(s["queue_depth"]) if a["depth_max"] is None
            else max(a["depth_max"], int(s["queue_depth"]))
        )
        a["drafted"] += int(s.get("drafted") or 0)
        a["accepted"] += int(s.get("accepted") or 0)
        if s["tokens"] > 0:
            a["slot_steps"] += int(s["active_slots"])

    def record_block_gauges(
        self,
        *,
        blocks_in_use: int | None = None,
        blocks_free: int | None = None,
    ) -> None:
        """Fold one pool observation into the running extremes —
        callable OUTSIDE decode steps too, because a prefill-only
        engine iteration (large admit, CoW burst, mid-prefill abort)
        can hit the allocation peak with no decode step to attach
        it to."""
        if blocks_in_use is not None:
            self.blocks_in_use_max = (
                int(blocks_in_use) if self.blocks_in_use_max is None
                else max(self.blocks_in_use_max, int(blocks_in_use))
            )
        if blocks_free is not None:
            self.blocks_free_min = (
                int(blocks_free) if self.blocks_free_min is None
                else min(self.blocks_free_min, int(blocks_free))
            )

    # -- aggregation (fleet serving, utils/recorder.FleetRecorder) ---------

    def state_dict(self) -> dict:
        """JSON-able state — what a TCP replica ships to the router's
        ``FleetRecorder``: exact aggregates + reservoir samples (and
        the rolling raw windows for inspection), so fleet percentiles
        merge from count-weighted samples, never from re-aggregated
        per-replica medians."""
        agg = dict(self._agg)
        agg["shed_reasons"] = dict(agg["shed_reasons"])
        agg["finish_reasons"] = dict(agg["finish_reasons"])
        return {
            "max_slots": self.max_slots,
            "requests": [dict(r) for r in self.requests],
            "steps": [dict(s) for s in self.steps],
            "blocks_in_use_max": self.blocks_in_use_max,
            "blocks_free_min": self.blocks_free_min,
            "agg": agg,
            "ttft_res": self._ttft.state(),
            "tpot_res": self._tpot.state(),
        }

    def _adopt_agg(self, d: dict) -> None:
        a = self._zero_agg()
        for k, v in d.items():
            if k in ("shed_reasons", "finish_reasons"):
                a[k] = Counter(v)
            else:
                a[k] = v
        self._agg = a

    def load_state_dict(self, d: dict) -> None:
        self.max_slots = int(d["max_slots"])
        self.requests = deque(
            (dict(r) for r in d["requests"]), maxlen=self.max_samples
        )
        self.steps = deque(
            (dict(s) for s in d["steps"]), maxlen=self.max_samples
        )
        self.blocks_in_use_max = d.get("blocks_in_use_max")
        self.blocks_free_min = d.get("blocks_free_min")
        self._ttft = Reservoir(self.max_samples, 0)
        self._tpot = Reservoir(self.max_samples, 1)
        self._agg = self._zero_agg()
        if "agg" in d:
            self._adopt_agg(d["agg"])
            self._ttft.merge(d["ttft_res"]["xs"], d["ttft_res"]["n"])
            self._tpot.merge(d["tpot_res"]["xs"], d["tpot_res"]["n"])
        else:
            # pre-bounding state (old checkpoints/peers): the lists
            # ARE the full sample — rebuild the aggregates exactly
            # from the SOURCE lists, not the bounded deques (a state
            # larger than max_samples already lost its head there)
            for r in d["requests"]:
                self._fold_request(dict(r))
            for s in d["steps"]:
                self._fold_step(dict(s))

    def merge(self, other) -> "ServingRecorder":
        """Fold another recorder (or its ``state_dict()``) into this
        one: aggregates add exactly, reservoirs merge count-weighted,
        raw windows append (bounded), block gauges take the extremes.
        Merged steps are stamped with THEIR recorder's ``max_slots``
        so the combined ``slot_occupancy`` stays a slot-seconds-
        weighted mean even when replicas differ in slot count.
        Returns ``self`` (chainable)."""
        d = other.state_dict() if isinstance(other, ServingRecorder) \
            else other
        slots = int(d["max_slots"])
        stamped = []
        for s in d["steps"]:
            s = dict(s)
            s.setdefault("max_slots", slots)
            stamped.append(s)
        self.requests.extend(dict(r) for r in d["requests"])
        self.steps.extend(stamped)
        if "agg" in d:
            a, b = self._agg, d["agg"]
            for k in ("n_ok", "n_shed", "tokens_completed",
                      "hit_tokens", "prompt_tokens", "decode_s",
                      "tokens", "cap_slot_s", "act_slot_s",
                      "depth_sum", "depth_n", "drafted", "accepted",
                      "slot_steps", "tok_sweeps", "tok_items",
                      "tok_tokens", "tok_wait_s"):
                # .get: a peer snapshotted before a counter existed
                # (older replica build) contributes zero, not a crash
                a[k] += b.get(k, 0)
            a["shed_reasons"].update(b["shed_reasons"])
            a["finish_reasons"].update(b["finish_reasons"])
            if b.get("depth_max") is not None:
                a["depth_max"] = (
                    b["depth_max"] if a["depth_max"] is None
                    else max(a["depth_max"], b["depth_max"])
                )
            self._ttft.merge(d["ttft_res"]["xs"], d["ttft_res"]["n"])
            self._tpot.merge(d["tpot_res"]["xs"], d["tpot_res"]["n"])
        else:
            # old-format peer: its lists are the full sample
            for r in d["requests"]:
                self._fold_request(dict(r))
            for s in stamped:
                self._fold_step(s)
        self.record_block_gauges(
            blocks_in_use=d.get("blocks_in_use_max"),
            blocks_free=d.get("blocks_free_min"),
        )
        return self

    def summary(self) -> dict:
        """One dict the bench row emits: throughput, latency
        percentiles, occupancy, queue pressure, shed accounting.
        Every counter is exact (incremental aggregates); the
        TTFT/TPOT percentiles come from the bounded reservoirs."""
        a = self._agg
        decode_s = a["decode_s"]
        tokens = a["tokens"]
        occ = (
            a["act_slot_s"] / a["cap_slot_s"] if a["cap_slot_s"]
            else None
        )
        # speculative decoding: accept-rate over offered drafts and
        # tokens committed per SLOT-STEP (one slot, one decode/verify
        # dispatch) — exactly 1.0 when speculation is off or every
        # draft missed, > 1 when verify windows land; dividing by
        # slot-steps rather than steps keeps batch width out of the
        # speculation datum
        drafted, accepted = a["drafted"], a["accepted"]
        return {
            "n_requests": a["n_ok"] + a["n_shed"],
            "n_completed": a["n_ok"],
            "n_shed": a["n_shed"],
            "shed_reasons": dict(a["shed_reasons"]),
            "tokens_generated": tokens,   # decode-step tokens only
            # all tokens delivered to completed requests (includes
            # each request's prefill-sampled first token)
            "tokens_completed": a["tokens_completed"],
            "decode_s": decode_s,
            "tokens_per_sec": tokens / decode_s if decode_s else None,
            "ttft_p50_s": self._ttft.percentile(50),
            "ttft_p95_s": self._ttft.percentile(95),
            "tpot_p50_s": self._tpot.percentile(50),
            "tpot_p95_s": self._tpot.percentile(95),
            "slot_occupancy": occ,
            "queue_depth_mean": (
                a["depth_sum"] / a["depth_n"] if a["depth_n"] else None
            ),
            "queue_depth_max": a["depth_max"],
            "finish_reasons": dict(a["finish_reasons"]),
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "accept_rate": accepted / drafted if drafted else None,
            "tokens_per_step": (
                tokens / a["slot_steps"] if a["slot_steps"] else None
            ),
            "prefix_hit_tokens": a["hit_tokens"],
            "prefix_hit_rate": (
                a["hit_tokens"] / a["prompt_tokens"]
                if a["prompt_tokens"] else None
            ),
            "blocks_in_use_max": self.blocks_in_use_max,
            "blocks_free_min": self.blocks_free_min,
            # tokenize front door (serving/tokenize.py): items per
            # sweep is the batching amortization — 1.0 means the
            # service degenerated to per-request encoding
            "tokenize_items": a.get("tok_items", 0),
            "tokenize_tokens": a.get("tok_tokens", 0),
            "tokenize_wait_s": a.get("tok_wait_s", 0.0),
            "tokenize_items_per_sweep": (
                a["tok_items"] / a["tok_sweeps"]
                if a.get("tok_sweeps") else None
            ),
        }

    def counter_tracks(self, process: str = "serving") -> list:
        """Chrome-trace counter samples from the rolling step window
        (``obs/export.chrome_trace``'s ``counters=``): queue depth +
        active slots on one track, KV block gauges on another — the
        lanes that open in the SAME Perfetto view as the request
        spans and a StepProfile's phase tracks.  Steps recorded by a
        pre-stamp peer (no ``t``) are skipped."""
        out = []
        for s in list(self.steps):
            t = s.get("t")
            if t is None:
                continue
            out.append({
                "process": process, "name": "slots", "t": t,
                "values": {
                    "active_slots": s["active_slots"],
                    "queue_depth": s["queue_depth"],
                },
            })
            if s.get("blocks_in_use") is not None \
                    or s.get("blocks_free") is not None:
                out.append({
                    "process": process, "name": "kv_blocks", "t": t,
                    "values": {
                        "in_use": s.get("blocks_in_use"),
                        "free": s.get("blocks_free"),
                    },
                })
        return out

    def metrics_txt(self, prefix: str = "tm_serving") -> str:
        """Prometheus-style text exposition of the summary, the JAX
        package's names and families (``obs/metrics.py``)."""
        from theanompi_tpu_torch.obs.metrics import (
            quantile_samples,
            render_metrics,
        )

        s = self.summary()
        p = prefix
        return render_metrics([
            (f"{p}_requests_total", "counter", [
                ({"status": "ok"}, s["n_completed"]),
                ({"status": "shed"}, s["n_shed"]),
            ]),
            (f"{p}_sheds_total", "counter", [
                ({"reason": r}, n)
                for r, n in sorted(s["shed_reasons"].items())
            ]),
            (f"{p}_finish_total", "counter", [
                ({"reason": r}, n)
                for r, n in sorted(s["finish_reasons"].items())
            ]),
            (f"{p}_tokens_generated_total", "counter",
             [(None, s["tokens_generated"])]),
            (f"{p}_tokens_completed_total", "counter",
             [(None, s["tokens_completed"])]),
            (f"{p}_decode_seconds_total", "counter",
             [(None, s["decode_s"])]),
            (f"{p}_ttft_seconds", "summary", quantile_samples(
                {"0.5": s["ttft_p50_s"], "0.95": s["ttft_p95_s"]})),
            (f"{p}_tpot_seconds", "summary", quantile_samples(
                {"0.5": s["tpot_p50_s"], "0.95": s["tpot_p95_s"]})),
            (f"{p}_tokens_per_sec", "gauge",
             [(None, s["tokens_per_sec"])]),
            (f"{p}_slot_occupancy", "gauge",
             [(None, s["slot_occupancy"])]),
            (f"{p}_queue_depth_max", "gauge",
             [(None, s["queue_depth_max"])]),
            (f"{p}_prefix_hit_rate", "gauge",
             [(None, s["prefix_hit_rate"])]),
            (f"{p}_accept_rate", "gauge", [(None, s["accept_rate"])]),
            (f"{p}_blocks_in_use_max", "gauge",
             [(None, s["blocks_in_use_max"])]),
            (f"{p}_blocks_free_min", "gauge",
             [(None, s["blocks_free_min"])]),
            (f"{p}_tokenize_items_total", "counter",
             [(None, s["tokenize_items"])]),
            (f"{p}_tokenize_items_per_sweep", "gauge",
             [(None, s["tokenize_items_per_sweep"])]),
        ])


class FleetRecorder:
    """Telemetry sink for the multi-replica serving router
    (``serving/router.py``).

    Two independent data streams, merged honestly:

    - **Router-side request stream** — every terminal result the
      router delivers (completions AND router-level sheds), recorded
      as it resolves.  Fleet TTFT/TPOT percentiles, shed breakdown
      and token accounting come from HERE, so they stay complete
      even when a replica dies and takes its own recorder with it
      (the failed replica's earlier completions were already
      recorded at the router).
    - **Per-replica summaries** — each replica's ``ServingRecorder``
      state (``attach_replica``), merged via
      ``ServingRecorder.merge`` for step-level facts the router
      cannot see: per-replica tokens/s, slot occupancy, prefix-cache
      hit rate, replica-side shed reasons.  Replicas run
      CONCURRENTLY, so the fleet aggregate rate is the SUM of
      per-replica ``tokens_per_sec`` (their decode seconds overlap
      in wall time — summing decode_s would understate throughput);
      occupancy is the slot-seconds-weighted mean the merge
      computes.

    Router lifecycle counters (``record_requeue`` /
    ``record_failover`` / ``record_rejoin`` / ``record_dispatch``)
    land in the summary as the failover-accounting datum the bench's
    kill-one-replica arm asserts on."""

    def __init__(self):
        self.router = ServingRecorder(max_slots=0)
        self.replica_states: dict[str, dict] = {}
        self.replica_paging: dict[str, dict | None] = {}
        self.n_requeues = 0
        self.n_failovers = 0
        self.n_rejoins = 0
        self.n_handoffs = 0
        self.dispatched = Counter()
        # autoscaler event log: one entry per membership
        # change, the ground truth replica-seconds accounting is
        # computed from.  Spawn/retire pair up per replica name;
        # multiple lives (retire then re-spawn) stack.
        self.scale_events: list[dict] = []

    # -- router-side events ------------------------------------------------

    def record_request(self, **kw) -> None:
        self.router.record_request(**kw)

    def record_dispatch(self, replica: str) -> None:
        self.dispatched[str(replica)] += 1

    def record_requeue(self, n: int = 1) -> None:
        self.n_requeues += int(n)

    def record_failover(self, replica: str) -> None:
        self.n_failovers += 1

    def record_rejoin(self, replica: str) -> None:
        self.n_rejoins += 1

    def record_handoff(self, n: int = 1) -> None:
        """One prefill→decode KV handoff carried router-side."""
        self.n_handoffs += int(n)

    # -- autoscaler events (replica-seconds accounting) --------------------

    def record_spawn(self, replica: str, t: float | None = None,
                     reason: str = "") -> None:
        """A replica entered the serving fleet (scale-up, or the
        initially provisioned members at fleet start)."""
        self.scale_events.append({
            "event": "spawn", "replica": str(replica),
            "t": float(t if t is not None else time.monotonic()),
            "reason": str(reason),
        })

    def record_retire(self, replica: str, t: float | None = None,
                      reason: str = "") -> None:
        """A replica left the fleet (drained scale-down)."""
        self.scale_events.append({
            "event": "retire", "replica": str(replica),
            "t": float(t if t is not None else time.monotonic()),
            "reason": str(reason),
        })

    def replica_seconds(self, now: float | None = None) -> float:
        """Integrated capacity cost: Σ over fleet lives of
        (retire_t − spawn_t), open lives closing at ``now``.  THE
        autoscaler headline denominator — the diurnal bench's claim
        is SLOs held at fewer replica-seconds than a statically
        provisioned fleet, and this is where that number comes
        from."""
        now = float(now if now is not None else time.monotonic())
        open_lives: dict[str, list[float]] = {}
        total = 0.0
        for ev in self.scale_events:
            name = ev["replica"]
            if ev["event"] == "spawn":
                open_lives.setdefault(name, []).append(ev["t"])
            elif open_lives.get(name):
                total += max(0.0, ev["t"] - open_lives[name].pop())
        for starts in open_lives.values():
            total += sum(max(0.0, now - t) for t in starts)
        return total

    # -- replica summaries -------------------------------------------------

    def attach_replica(self, name: str, state: dict,
                       paging: dict | None = None) -> None:
        """Adopt one replica's ``ServingRecorder.state_dict()`` (and
        optional ``Engine.paging_stats()``) — latest attach per name
        wins, so the router can refresh mid-run."""
        self.replica_states[str(name)] = state
        self.replica_paging[str(name)] = paging

    def summary(self) -> dict:
        out = {
            k: v for k, v in self.router.summary().items()
            if k in (
                "n_requests", "n_completed", "n_shed", "shed_reasons",
                "tokens_completed", "ttft_p50_s", "ttft_p95_s",
                "tpot_p50_s", "tpot_p95_s", "finish_reasons",
            )
        }
        out.update(
            n_requeues=self.n_requeues,
            n_failovers=self.n_failovers,
            n_rejoins=self.n_rejoins,
            n_handoffs=self.n_handoffs,
            dispatched=dict(self.dispatched),
            n_spawns=sum(
                e["event"] == "spawn" for e in self.scale_events
            ),
            n_retires=sum(
                e["event"] == "retire" for e in self.scale_events
            ),
            replica_seconds=(
                self.replica_seconds() if self.scale_events else None
            ),
        )
        per, merged = {}, ServingRecorder(max_slots=0)
        for name, state in self.replica_states.items():
            r = ServingRecorder()
            r.load_state_dict(state)
            s = r.summary()
            per[name] = {
                k: s[k] for k in (
                    "tokens_per_sec", "slot_occupancy",
                    "prefix_hit_rate", "shed_reasons", "n_completed",
                    "tokens_generated", "decode_s", "accept_rate",
                    "tokens_per_step",
                )
            }
            merged.merge(state)
        ms = merged.summary()
        out["per_replica"] = per
        out["slot_occupancy"] = ms["slot_occupancy"]
        out["prefix_hit_rate"] = ms["prefix_hit_rate"]
        out["tokens_generated"] = ms["tokens_generated"]
        # speculation telemetry survives the fleet merge: drafted/
        # accepted sum across replicas, so the fleet accept-rate is
        # the draft-weighted mean
        out["accept_rate"] = ms["accept_rate"]
        out["tokens_per_step"] = ms["tokens_per_step"]
        # concurrent replicas: aggregate rate is the sum of rates
        rates = [
            p["tokens_per_sec"] for p in per.values()
            if p["tokens_per_sec"]
        ]
        out["aggregate_tokens_per_sec"] = sum(rates) if rates else None
        return out

    def metrics_txt(self, prefix: str = "tm_fleet") -> str:
        """Prometheus-style text for the fleet: the router-side
        request stream plus control-plane counters and per-replica
        rate/occupancy gauges (labelled ``replica="name"``)."""
        from theanompi_tpu_torch.obs.metrics import (
            quantile_samples,
            render_metrics,
        )

        s = self.summary()
        p = prefix
        per = s.get("per_replica", {})
        return render_metrics([
            (f"{p}_requests_total", "counter", [
                ({"status": "ok"}, s["n_completed"]),
                ({"status": "shed"}, s["n_shed"]),
            ]),
            (f"{p}_sheds_total", "counter", [
                ({"reason": r}, n)
                for r, n in sorted(s["shed_reasons"].items())
            ]),
            (f"{p}_tokens_completed_total", "counter",
             [(None, s["tokens_completed"])]),
            (f"{p}_ttft_seconds", "summary", quantile_samples(
                {"0.5": s["ttft_p50_s"], "0.95": s["ttft_p95_s"]})),
            (f"{p}_tpot_seconds", "summary", quantile_samples(
                {"0.5": s["tpot_p50_s"], "0.95": s["tpot_p95_s"]})),
            (f"{p}_requeues_total", "counter",
             [(None, s["n_requeues"])]),
            (f"{p}_failovers_total", "counter",
             [(None, s["n_failovers"])]),
            (f"{p}_rejoins_total", "counter", [(None, s["n_rejoins"])]),
            (f"{p}_handoffs_total", "counter",
             [(None, s["n_handoffs"])]),
            (f"{p}_spawns_total", "counter", [(None, s["n_spawns"])]),
            (f"{p}_retires_total", "counter", [(None, s["n_retires"])]),
            (f"{p}_replica_seconds", "gauge",
             [(None, s["replica_seconds"])]),
            (f"{p}_dispatched_total", "counter", [
                ({"replica": name}, n)
                for name, n in sorted(s["dispatched"].items())
            ]),
            (f"{p}_slot_occupancy", "gauge",
             [(None, s["slot_occupancy"])]),
            (f"{p}_aggregate_tokens_per_sec", "gauge",
             [(None, s["aggregate_tokens_per_sec"])]),
            (f"{p}_replica_tokens_per_sec", "gauge", [
                ({"replica": name}, v["tokens_per_sec"])
                for name, v in sorted(per.items())
            ]),
            (f"{p}_replica_slot_occupancy", "gauge", [
                ({"replica": name}, v["slot_occupancy"])
                for name, v in sorted(per.items())
            ]),
        ])
