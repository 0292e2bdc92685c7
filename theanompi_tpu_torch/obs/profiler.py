"""Step-phase profiler: a training step split into named legs, with
MFU and a gap attribution against the speed of light (port of
``theanompi_tpu/obs/profiler.py`` onto ``torch.profiler``).

``utils/trace_comm`` answers one question, how much collective time
is exposed; this module files every second of a measured step under a
named leg:

- ``compute``       — the model's forward and backward (the busy time
  no registered range claims),
- ``exchange_b{i}`` — the gradient exchange, one leg per bucket,
- ``quantize``      — the compressed wire's codec
  (``quantize_wire``/``dequantize_wire``),
- ``optimizer``     — the ``opt_update`` range,
- ``exchange_other`` — collectives outside every exchange range (the
  loss mean over the ranks),
- ``host_gap``      — wall time no device work covers (launch latency,
  host-side staging, Python),

each with its measured time and, where the caller prices it, FLOPs
and bytes, which give a measured MFU and an arithmetic intensity.

The legs are the trace's own ``record_function`` labels (where the JAX
package reads ``jax.named_scope`` labels out of the optimized HLO):
``profile_scope_sets`` maps the labels a trace holds to legs through
``analysis/registry.PROFILE_SCOPES``, in JAX's leg order (exact labels'
legs first, then ``exchange_b{i}`` in numeric order), and the innermost
registered range of a piece of work wins (``trace_comm.comm_report``).
``scope(label)`` is the range the port's code opens: a
``record_function`` while a profiler is active and nothing otherwise,
so the ranges cost nothing on an unprofiled path.

``gap_attribution`` splits the gap between the measured step and
``ideal_s = flops / (n_devices * peak)`` into ``geometry`` (compute
beyond the ideal), ``exposed_comm``, the priced overheads
(``quantize``, ``optimizer``) and ``host``.  Every leg is measured, so
the legs sum to the step: ``coverage`` is about 1.

``StepProfile.spans()`` and ``counter_tracks()`` put the profile into
the ``obs/export`` Chrome trace beside the iteration spans, one
Perfetto view.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from theanompi_tpu_torch.analysis.registry import (
    PROFILE_SCOPE_PREFIXES,
    PROFILE_SCOPES,
)

#: profile span-id allocator: (pid-tagged counter) << 12 leaves room
#: for 4095 leg ids under each root — wall-clock-derived ids collide
#: when two profiles are built in the same microsecond
_PROFILE_IDS = itertools.count(1)


def _new_profile_id() -> int:
    return (
        ((os.getpid() & 0xFFFF) << 32)
        | ((next(_PROFILE_IDS) & 0xFFFFF) << 12)
    )


def scope(label: str):
    """The profiler range ``label`` (registered in ``analysis/
    registry``): ``torch.profiler.record_function(label)`` while a
    profiler is active on this thread, else a no-op context, so a range
    on a host-bound path costs one check when nobody profiles."""
    import torch

    if torch.autograd._profiler_enabled():
        # the label is the caller's: TM107 checks it at each scope() site
        return torch.profiler.record_function(label)  # tmcheck: disable=TM107
    return contextlib.nullcontext()


def _label_leg(label: str) -> str | None:
    """The leg a range label files under: its registered exact leg, the
    label itself for a prefix family (``exchange_b3``), else None."""
    if label in PROFILE_SCOPES:
        return PROFILE_SCOPES[label]
    for p in PROFILE_SCOPE_PREFIXES:
        if re.fullmatch(re.escape(p) + r"\d+", label):
            return label
    return None


def profile_scope_sets(labels) -> "OrderedDict[str, set]":
    """Ordered ``{leg_name: set(range labels)}`` of the registered
    labels among ``labels`` (``trace_comm.range_labels`` of a trace) —
    the ``scopes=`` argument of ``trace_comm.comm_report``.

    Exact labels group under their registered leg (both codec halves
    land in ``quantize``); prefix-family labels keep the full label as
    the leg name (``exchange_b0``, ``exchange_b1``, ...).  Exact legs
    come first, in registry order, then the prefix legs in numeric
    order.  The innermost registered range of a piece of work decides
    its leg (``comm_report``), so ``exchange_b0/quantize_wire`` work
    counts as ``quantize``."""
    exact_legs: OrderedDict[str, set] = OrderedDict(
        (leg, set()) for leg in dict.fromkeys(PROFILE_SCOPES.values())
    )
    prefix_legs: OrderedDict[str, set] = OrderedDict()
    for label in labels:
        leg = _label_leg(label)
        if leg is None:
            continue
        if label in PROFILE_SCOPES:
            exact_legs[leg].add(label)
        else:
            prefix_legs.setdefault(leg, set()).add(label)
    out: OrderedDict[str, set] = OrderedDict(
        (leg, ops) for leg, ops in exact_legs.items() if ops
    )
    for label in sorted(prefix_legs, key=_bucket_sort_key):
        out[label] = prefix_legs[label]
    return out


def _bucket_sort_key(label: str):
    m = re.search(r"(\d+)$", label)
    return (label[: m.start()] if m else label,
            int(m.group(1)) if m else -1)


@dataclass
class StepProfile:
    """One profiled training-step decomposition (see module doc).

    Times are PER STEP: ``legs[name]["time_s"]`` is the per-core
    average (core-seconds / n_cores / n_steps), so the legs sum to
    the measured step wall; ``core_s`` keeps the raw core-seconds."""

    name: str
    n_steps: int
    n_devices: int
    n_cores: int
    step_s: float                     # measured wall per step
    device_busy_s: float              # core-seconds over the window
    legs: "OrderedDict[str, dict]"
    exposed_comm_s: float = 0.0       # per step, per-core average
    collective_s: float = 0.0         # per step, per-core average
    peak_flops: float | None = None   # per device
    step_flops: float | None = None   # per step, all devices
    step_bytes: float | None = None
    measured_mfu: float | None = None
    gap: dict | None = None
    trace_report: dict = field(default_factory=dict, repr=False)

    @property
    def coverage(self) -> float:
        """Σ legs / measured step wall (≈ 1.0 — the 5% acceptance
        bar; host_gap is a measured remainder, never negative, so
        over-1 coverage means trace events exceeded the wall)."""
        total = sum(v["time_s"] for v in self.legs.values())
        return total / self.step_s if self.step_s else 0.0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "n_steps": self.n_steps,
            "n_devices": self.n_devices,
            "n_cores": self.n_cores,
            "step_s": self.step_s,
            "device_busy_s": self.device_busy_s,
            "legs": {k: dict(v) for k, v in self.legs.items()},
            "coverage": self.coverage,
            "exposed_comm_s": self.exposed_comm_s,
            "collective_s": self.collective_s,
            "measured_mfu": self.measured_mfu,
            "step_flops": self.step_flops,
            "step_bytes": self.step_bytes,
            "gap": self.gap,
        }

    # -- Perfetto export (obs/export.py) -----------------------------------

    def spans(self, *, process: str = "profiler",
              t0: float | None = None) -> list:
        """The decomposition as one span tree (plain span dicts, the
        tracer's schema): a ``step_profile:<name>`` root spanning one
        measured step, with each leg a child laid out serially in
        report order — so the profile opens in the SAME Perfetto view
        as the request traces (``chrome_trace(spans + profile.spans()
        , counters=profile.counter_tracks())``)."""
        t0 = time.time() if t0 is None else float(t0)
        tid = _new_profile_id()
        root = {
            "trace_id": tid, "span_id": tid, "parent_id": None,
            "name": f"step_profile:{self.name}",
            "t0": t0, "t1": t0 + self.step_s,
            "process": process, "lane": self.name,
            "attrs": {
                "coverage": round(self.coverage, 4),
                "measured_mfu": self.measured_mfu,
                "n_steps": self.n_steps,
            },
        }
        out = [root]
        cur = t0
        for i, (leg, v) in enumerate(self.legs.items()):
            out.append({
                "trace_id": tid, "span_id": tid + i + 1,
                "parent_id": tid, "name": leg,
                "t0": cur, "t1": cur + v["time_s"],
                "process": process, "lane": self.name,
                "attrs": {
                    k: v[k] for k in ("mfu", "intensity", "flops",
                                      "bytes", "comm_s")
                    if v.get(k) is not None
                },
            })
            cur += v["time_s"]
        return out

    def counter_tracks(self, *, process: str = "profiler",
                       t: float | None = None) -> list:
        """Chrome-trace counter samples (``obs/export.chrome_trace``'s
        ``counters=``): one ``step_phase_s`` track with a series per
        leg, plus ``mfu`` tracks for the legs that price one — the
        gauges that ride next to the serving recorder's queue/block
        tracks in the single-view export."""
        t = time.time() if t is None else float(t)
        out = [{
            "process": process,
            "name": f"step_phase_s:{self.name}",
            "t": t,
            "values": {
                leg: round(v["time_s"], 6)
                for leg, v in self.legs.items()
            },
        }]
        mfus = {
            leg: round(v["mfu"], 4)
            for leg, v in self.legs.items() if v.get("mfu") is not None
        }
        if self.measured_mfu is not None:
            mfus["step"] = round(self.measured_mfu, 4)
        if mfus:
            out.append({
                "process": process,
                "name": f"mfu:{self.name}",
                "t": t,
                "values": mfus,
            })
        return out


def _normalize_leg_costs(leg_costs: dict | None,
                         step_flops: float | None,
                         step_bytes: float | None) -> dict:
    """Deep-copy the caller's per-leg cost dict and inject the step's
    FLOPs/bytes as the compute leg's defaults.  The COPY is the
    contract: an A/B harness reusing one dict across profiles must
    never see model A's flops priced into model B's compute leg."""
    out = {k: dict(v) for k, v in (leg_costs or {}).items()}
    if step_flops is not None:
        out.setdefault("compute", {})
        out["compute"].setdefault("flops", step_flops)
        if step_bytes is not None:
            out["compute"].setdefault("bytes", step_bytes)
    return out


def step_profile(
    run_fn,
    *,
    n_steps: int,
    n_devices: int,
    name: str = "train_step",
    peak_flops: float | None = None,
    step_flops: float | None = None,
    step_bytes: float | None = None,
    leg_costs: dict | None = None,
    predicted: dict | None = None,
    trace_dir: str | None = None,
) -> StepProfile:
    """Capture ONE profiled window of ``run_fn`` (which must run
    ``n_steps`` training steps and fence its own device work, e.g. by
    reading the loss) under ``trace_comm.capture_trace`` and decompose
    it.

    The legs are the registered range labels the trace holds
    (``profile_scope_sets``).  ``peak_flops`` — per-device peak (the
    MFU denominator); ``step_flops``/``step_bytes`` — one step's total
    FLOPs/bytes across devices (the models' ``train_step_flops()``).
    ``n_devices`` — the devices the flops run on (a run of one process
    per device profiles its own device: ``n_cores`` is 1 there).

    ``leg_costs`` — optional ``{leg: {"flops": f, "bytes": b}}``
    pricing individual legs (wire bytes from
    ``scaling_model.exchange_wire_bytes``); the ``compute`` leg
    defaults to ``step_flops``/``step_bytes``.

    ``predicted`` — a ``scaling_model`` row to attribute the gap
    against; recognized keys: ``t_exposed_ms`` (``bsp_efficiency`` /
    ``bucketed_overlap``'s ``t_exposed_bucketed_ms``) and ``mfu``.
    """
    import tempfile

    from theanompi_tpu_torch.utils import trace_comm

    wall_box: list[float] = []

    def timed():
        t0 = time.perf_counter()
        out = run_fn()
        wall_box.append(time.perf_counter() - t0)
        return out

    def report(d):
        trace_comm.capture_trace(timed, d)
        scopes = profile_scope_sets(trace_comm.range_labels(d))
        return scopes, trace_comm.comm_report(d, scopes=scopes)

    if trace_dir is not None:
        scopes, rep = report(trace_dir)
    else:
        with tempfile.TemporaryDirectory() as td:
            scopes, rep = report(td)

    wall = wall_box[0]
    step_s = wall / n_steps
    n_cores = max(1, rep["n_cores"])
    per_step_core = 1.0 / (n_cores * n_steps)

    legs: OrderedDict[str, dict] = OrderedDict()
    leg_costs = _normalize_leg_costs(leg_costs, step_flops, step_bytes)

    def _leg(leg_name, time_s, comm_s=None, core_s=None):
        c = leg_costs.get(leg_name, {})
        flops, bts = c.get("flops"), c.get("bytes")
        row = {
            "time_s": time_s,
            "core_s": core_s if core_s is not None
            else time_s * n_cores * n_steps,
        }
        if comm_s is not None:
            row["comm_s"] = comm_s
        if flops is not None:
            row["flops"] = flops
            if peak_flops and time_s > 0:
                # scope flops are per step across devices; scope time
                # is per-core-average — MFU over the whole slice
                row["mfu"] = flops / (time_s * n_devices * peak_flops)
        if bts is not None:
            row["bytes"] = bts
        if flops is not None and bts:
            row["intensity"] = flops / bts
        return row

    scoped_core_s = 0.0
    for leg_name in scopes:
        core_s = rep["scope_s"].get(leg_name, 0.0)
        scoped_core_s += core_s
        legs[leg_name] = _leg(
            leg_name,
            core_s * per_step_core,
            comm_s=rep["scope_comm_s"].get(leg_name, 0.0)
            * per_step_core,
            core_s=core_s,
        )

    # collectives OUTSIDE any exchange scope (loss/err pmean, BN-stat
    # sync) — their own leg so the exchange buckets stay pure
    unscoped_comm = rep["collective_s"] - sum(
        rep["scope_comm_s"].values()
    )
    if unscoped_comm > 1e-12:
        legs["exchange_other"] = _leg(
            "exchange_other", unscoped_comm * per_step_core,
            comm_s=unscoped_comm * per_step_core, core_s=unscoped_comm,
        )
        scoped_core_s += unscoped_comm

    # the model body: busy time no scope (and no bare collective)
    # claimed — the leg the step's FLOPs live in (cost injection
    # happened in _normalize_leg_costs)
    compute_core_s = max(0.0, rep["device_busy_s"] - scoped_core_s)
    compute = _leg("compute", compute_core_s * per_step_core,
                   core_s=compute_core_s)
    # wall no device op covers: dispatch latency, host staging
    host_s = max(0.0, step_s - rep["device_busy_s"] * per_step_core)
    ordered: OrderedDict[str, dict] = OrderedDict()
    ordered["compute"] = compute
    for k, v in legs.items():
        ordered[k] = v
    ordered["host_gap"] = _leg("host_gap", host_s, core_s=host_s)

    exposed = rep["exposed_comm_s"] * per_step_core
    prof = StepProfile(
        name=name,
        n_steps=n_steps,
        n_devices=n_devices,
        n_cores=n_cores,
        step_s=step_s,
        device_busy_s=rep["device_busy_s"],
        legs=ordered,
        exposed_comm_s=exposed,
        collective_s=rep["collective_s"] * per_step_core,
        peak_flops=peak_flops,
        step_flops=step_flops,
        step_bytes=step_bytes,
        trace_report=rep,
    )
    if step_flops and peak_flops:
        prof.measured_mfu = step_flops / (
            step_s * n_devices * peak_flops
        )
    prof.gap = gap_attribution(prof, predicted=predicted)
    return prof


def gap_attribution(profile: StepProfile,
                    predicted: dict | None = None) -> dict | None:
    """Split the measured step's gap against the speed-of-light into
    named legs (module doc): geometry vs exposed comm vs priced
    overheads vs host.  Needs ``step_flops`` + ``peak_flops`` (the
    ideal-time denominator); returns None without them."""
    if not (profile.step_flops and profile.peak_flops):
        return None
    ideal = profile.step_flops / (
        profile.n_devices * profile.peak_flops
    )
    overhead_legs = {
        leg: v["time_s"] for leg, v in profile.legs.items()
        if leg in ("quantize", "optimizer")
    }
    host = profile.legs.get("host_gap", {}).get("time_s", 0.0)
    exposed = profile.exposed_comm_s
    compute_s = profile.legs.get("compute", {}).get("time_s", 0.0)
    # hidden comm overlaps compute on the same core and never extends
    # the wall; geometry is the compute leg's excess over ideal
    geometry = max(0.0, compute_s - ideal)
    legs = {
        "geometry_s": geometry,
        "exposed_comm_s": exposed,
        **{f"{k}_s": v for k, v in overhead_legs.items()},
        "host_s": host,
    }
    attributed = ideal + sum(legs.values())
    out = {
        "measured_step_s": profile.step_s,
        "ideal_step_s": ideal,
        "measured_mfu": profile.measured_mfu,
        "gap_s": profile.step_s - ideal,
        "legs": legs,
        "coverage": attributed / profile.step_s
        if profile.step_s else None,
    }
    if predicted:
        if predicted.get("t_exposed_ms") is not None:
            out["predicted_exposed_comm_s"] = (
                predicted["t_exposed_ms"] / 1e3
            )
        for k in ("t_exposed_bucketed_ms",):
            if predicted.get(k) is not None:
                out["predicted_exposed_comm_s"] = predicted[k] / 1e3
        if predicted.get("mfu") is not None:
            out["predicted_mfu"] = predicted["mfu"]
        out["predicted"] = dict(predicted)
    return out


def format_profile(profile: StepProfile) -> str:
    """Human-readable one-leg-per-line rendering."""
    lines = [
        f"step profile {profile.name}: {profile.step_s * 1e3:.2f} ms/"
        f"step x {profile.n_steps} steps, {profile.n_cores} op "
        f"timelines, coverage {profile.coverage:.3f}"
        + (f", MFU {profile.measured_mfu:.4f}"
           if profile.measured_mfu is not None else "")
    ]
    for leg, v in profile.legs.items():
        extra = ""
        if v.get("mfu") is not None:
            extra += f"  mfu={v['mfu']:.4f}"
        if v.get("intensity") is not None:
            extra += f"  flops/byte={v['intensity']:.1f}"
        if v.get("comm_s") is not None:
            extra += f"  comm={v['comm_s'] * 1e3:.3f}ms"
        lines.append(
            f"  {v['time_s'] * 1e3:9.3f} ms  "
            f"{v['time_s'] / profile.step_s if profile.step_s else 0:6.1%}"
            f"  {leg}{extra}"
        )
    gap = profile.gap
    if gap:
        lines.append(
            f"gap vs speed-of-light: ideal "
            f"{gap['ideal_step_s'] * 1e3:.3f} ms, gap "
            f"{gap['gap_s'] * 1e3:.3f} ms"
        )
        for leg, v in gap["legs"].items():
            lines.append(f"  {v * 1e3:9.3f} ms  {leg}")
    return "\n".join(lines)
