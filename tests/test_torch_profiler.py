"""The port's step-phase profiler (``obs/profiler.py``), the training
``Recorder``'s ``metrics_txt`` and the BSP worker's ``trace`` /
``step_profile`` knobs against the JAX package's.

- Profile math: ``step_profile``, ``gap_attribution`` and
  ``format_profile`` of both packages on the same canned trace report
  (each package's ``capture_trace``/``comm_report`` and its clock
  monkeypatched here; the JAX one reads its legs out of an HLO text in
  the style of ``tests/test_profiler.py``, the port out of the trace's
  range labels): equal ``as_dict()``, equal text, equal span and counter
  shapes (ids aside).  Exact: the same float arithmetic.
- ``TestTrainMetricsTxt``'s cases of the JAX package through both
  Recorders under one fixed clock: equal text.
- A small fp32 Llama (2 layers, dim 32) trained by the BSP worker with
  ``step_profile`` and ``trace`` on, at one rank and at two gloo ranks,
  against the JAX worker on one and two CPU devices: the same leg
  names in the same order, coverage within 5% of the JAX run's, the
  same ``trace_spans``, and an export holding the iteration spans and
  the profile's counter tracks.
- The range registry: equal to the JAX package's, and every
  ``record_function``/``scope`` label in the port resolves in it; a
  serving range is entered only while a profiler is active.
"""

import ast
import json
import os
import socket
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import pytest
import torch

from theanompi_tpu.analysis import registry as jax_registry
from theanompi_tpu.obs import profiler as jax_prof
from theanompi_tpu.utils import trace_comm as jax_tc
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder
from theanompi_tpu_torch.analysis import registry as port_registry
from theanompi_tpu_torch.obs import profiler as port_prof
from theanompi_tpu_torch.utils import trace_comm as port_tc
from theanompi_tpu_torch.utils.recorder import Recorder as PortRecorder
from theanompi_tpu_torch.utils import recorder as port_recorder_mod
from theanompi_tpu.utils import recorder as jax_recorder_mod

ROOT = Path(__file__).resolve().parent.parent
PORT_PKG = ROOT / "theanompi_tpu_torch"

# the JAX fixture's HLO: one instruction per registered scope
_HLO = """
  %fusion.1 = f32[8]{0} fusion(...), metadata={op_name="jit(step)/fwd/dot_general"}
  %reduce-scatter.1 = f32[4]{0} reduce-scatter(...), metadata={op_name="jit(step)/exchange_b0/psum_scatter"}
  %reduce-scatter.2 = f32[4]{0} reduce-scatter(...), metadata={op_name="jit(step)/exchange_b1/psum_scatter"}
  %fusion.7 = f32[4]{0} fusion(...), metadata={op_name="jit(step)/exchange_b0/quantize_wire/mul"}
  %fusion.8 = f32[4]{0} fusion(...), metadata={op_name="jit(step)/exchange_b1/dequantize_wire/convert"}
  %fusion.9 = f32[4]{0} fusion(...), metadata={op_name="jit(step)/opt_update/adam/mul"}
  %fusion.12 = f32[4]{0} fusion(...), metadata={op_name="jit(step)/exchange_b12/psum_scatter"}
"""
# the same scopes as the port's trace holds them: range labels
_LABELS = {"exchange_b0", "exchange_b1", "exchange_b12", "quantize_wire",
           "dequantize_wire", "opt_update", "train_step"}

CANNED = {
    "device_busy_s": 0.300, "collective_s": 0.040, "exposed_comm_s": 0.025,
    "hidden_comm_s": 0.015, "overlapped_comm_s": 0.015, "quant_s": 0.0,
    "quant_frac": 0.0, "comm_frac": 0.04 / 0.3,
    "exposed_comm_frac": 0.025 / 0.3, "overlapped_comm_frac": 0.375,
    "n_cores": 2,
    "scope_s": {"quantize": 0.012, "optimizer": 0.030,
                "exchange_b0": 0.020, "exchange_b1": 0.011,
                "exchange_b12": 0.004},
    "scope_comm_s": {"quantize": 0.0, "optimizer": 0.0,
                     "exchange_b0": 0.018, "exchange_b1": 0.010,
                     "exchange_b12": 0.004},
    "top_collectives": [], "top_ops": [],
}


class FixedClock:
    """``time`` stand-in: ``perf_counter`` steps by ``dt`` each call."""

    def __init__(self, dt: float = 0.0625):
        self.t, self.dt = 0.0, dt

    def perf_counter(self):
        self.t += self.dt
        return self.t

    def time(self):
        return 1000.0


def canned(monkeypatch, mod_prof, mod_tc):
    monkeypatch.setattr(mod_prof, "time", FixedClock(0.0625))
    monkeypatch.setattr(mod_tc, "capture_trace",
                        lambda fn, d, **kw: fn())
    monkeypatch.setattr(mod_tc, "comm_report",
                        lambda d, top_n=15, quant_ops=None, scopes=None:
                        json.loads(json.dumps(CANNED)))


def strip_ids(spans):
    return [{k: v for k, v in s.items()
             if k not in ("trace_id", "span_id", "parent_id")}
            for s in spans]


@pytest.mark.parametrize("flops,peak,predicted", [
    (2.5e9, 1e12, None),
    (2.5e9, 1e12, {"t_exposed_ms": 7.5, "mfu": 0.4}),
    (None, None, None),
    (4e11, 197e12, {"t_exposed_bucketed_ms": 3.0}),
])
def test_profile_math_matches_jax(monkeypatch, flops, peak, predicted):
    canned(monkeypatch, jax_prof, jax_tc)
    canned(monkeypatch, port_prof, port_tc)
    monkeypatch.setattr(port_tc, "range_labels", lambda d: set(_LABELS))
    kw = dict(n_steps=2, n_devices=4, name="toy", peak_flops=peak,
              step_flops=flops, step_bytes=None if flops is None else 1e8,
              leg_costs={"optimizer": {"flops": 1e6, "bytes": 4e6}},
              predicted=predicted)
    want = jax_prof.step_profile(lambda: None, hlo_text=_HLO, **kw)
    got = port_prof.step_profile(lambda: None, **kw)
    assert list(got.legs) == list(want.legs)
    assert got.as_dict() == want.as_dict()
    assert port_prof.format_profile(got) == jax_prof.format_profile(want)
    assert got.gap == jax_prof.gap_attribution(want, predicted=predicted)
    assert port_prof.gap_attribution(got) == jax_prof.gap_attribution(want)
    assert strip_ids(got.spans(t0=5.0)) == strip_ids(want.spans(t0=5.0))
    assert got.counter_tracks(t=5.0) == want.counter_tracks(t=5.0)


def test_scope_sets_match_jax_legs():
    """The legs the port reads out of range labels are the legs (and
    order) the JAX package reads out of the HLO's scope names."""
    want = jax_prof.profile_scope_sets(_HLO)
    got = port_prof.profile_scope_sets(_LABELS)
    assert list(got) == list(want)
    assert got["quantize"] == {"quantize_wire", "dequantize_wire"}
    assert port_prof.profile_scope_sets(()) == OrderedDict()


def test_normalize_leg_costs_matches_jax():
    costs = {"optimizer": {"flops": 10.0}}
    for args in ((costs, 1e9, 1e6), (costs, 2e9, None),
                 ({"compute": {"flops": 7.0}}, 1e9, None), (None, None, None)):
        assert port_prof._normalize_leg_costs(*args) == \
            jax_prof._normalize_leg_costs(*args)
    assert "compute" not in costs


# -- metrics_txt ---------------------------------------------------------------

def both_recorders(monkeypatch):
    monkeypatch.setattr(jax_recorder_mod, "time", FixedClock(0.25))
    monkeypatch.setattr(port_recorder_mod, "time", FixedClock(0.25))
    return JaxRecorder(verbose=False), PortRecorder(verbose=False)


def drive_families(r):
    r.start()
    r.end("calc")
    r.train_error(0, 1.25, 0.5)
    r.record_restart("crash", resumed_epoch=1, recovery_s=2.0,
                     world_size=8, resharded=True)


def drive_world_size(r):
    pass


def drive_wait(r):
    r.start()
    r.end("wait")
    r.load_state_dict(json.loads(json.dumps(r.state_dict())))


def drive_old_checkpoint(r):
    r.load_state_dict({
        "train_losses": [1.0] * 1000, "train_errors": [0.5] * 1000,
        "val_records": [], "epoch_times": [50.0, 50.0], "n_iter": 1000,
    })


@pytest.mark.parametrize("drive,kw", [
    (drive_families, {}),
    (drive_world_size, {"world_size": 4}),
    (drive_wait, {}),
    (drive_old_checkpoint, {}),
    (drive_families, {"prefix": "tm_x", "world_size": 2}),
])
def test_train_metrics_txt_matches_jax(monkeypatch, drive, kw):
    jr, pr = both_recorders(monkeypatch)
    drive(jr)
    drive(pr)
    want = jr.metrics_txt(**kw)
    assert pr.metrics_txt(**kw) == want
    assert pr.total_segments == jr.total_segments


def test_recorder_spans_match_jax(monkeypatch):
    """The iteration/load/step spans the two Recorders record under one
    tracer clock."""
    from theanompi_tpu.obs import Tracer as JaxTracer
    from theanompi_tpu_torch.obs import Tracer as PortTracer

    out = []
    for rec, Tracer in zip(both_recorders(monkeypatch),
                           (JaxTracer, PortTracer)):
        tick = iter(range(1000))
        tr = Tracer(process="bsp_worker", sample=2,
                    clock=lambda: float(next(tick)))
        rec.attach_tracer(tr)
        rec.trace_boundary()
        for i in range(5):
            rec.start()
            rec.end("wait")
            rec.start()
            rec.end("calc")
            rec.train_error(i, 1.0, 0.5)
            rec.trace_boundary()
        rec.finish_trace()
        out.append((tr.stats()["n_spans"],
                    strip_ids([dict(s, t0=None, t1=None)
                               for s in tr.spans()])))
    assert out[0] == out[1]
    assert out[0][0] > 0


def test_recorder_profiler_handoff_writes_a_readable_trace(tmp_path):
    """``start_profiler``/``stop_profiler`` on ``torch.profiler``: the
    trace lands under the logdir and ``comm_report`` reads it."""
    rec = PortRecorder(verbose=False)
    rec.start_profiler(str(tmp_path))
    a = torch.randn(64, 64)
    float((a @ a).sum())
    rec.stop_profiler()
    rec.stop_profiler()          # a second stop is a no-op
    rep = port_tc.comm_report(str(tmp_path))
    assert rep["n_cores"] == 1 and rep["device_busy_s"] > 0
    assert "aten::matmul" in dict(rep["top_ops"])


# -- the BSP worker's knobs against the JAX worker -----------------------------

CFG = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
           vocab=64, seq_len=16, batch_size=4, n_train=32, n_val=8,
           compute_dtype="float32", seed=3, lr=1e-2, optimizer="adam",
           exch_strategy="ici32", step_profile=True, trace=True,
           trace_sample=2)
COVERAGE_TOL = 0.05


def jax_summary(n_dev, export):
    import jax

    from theanompi_tpu.workers import bsp_worker

    cfg = dict(CFG, batch_size=CFG["batch_size"] // n_dev,
               trace_export=str(export))
    out = bsp_worker.run(devices=jax.devices("cpu")[:n_dev],
                         modelfile="theanompi_tpu.models.llama",
                         modelclass="Llama", config=cfg, n_epochs=1,
                         verbose=False)
    return {"legs": list(out["step_profile"]["legs"]),
            "coverage": out["step_profile"]["coverage"],
            "trace_spans": out["trace_spans"]}


RANK_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group
from theanompi_tpu_torch.workers import bsp_worker
rank, init, cfg, out = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3]), sys.argv[4]
init_group(torch.device("cpu"), rank, 2, init)
res = bsp_worker.run(devices=["cpu", "cpu"], rank=rank, world_size=2,
                     init_method=init, modelfile="theanompi_tpu_torch.models.llama",
                     modelclass="Llama", config=cfg, n_epochs=1, verbose=False)
destroy_group()
if rank == 0:
    p = res["step_profile"]
    json.dump({{"legs": list(p["legs"]), "coverage": p["coverage"],
               "trace_spans": res["trace_spans"], "n_cores": p["n_cores"],
               "n_devices": p["n_devices"], "error": p.get("error")}},
              open(out, "w"))
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_summary(n_ranks, export, tmp_path):
    cfg = dict(CFG, batch_size=CFG["batch_size"] // n_ranks,
               trace_export=str(export))
    if n_ranks == 1:
        from theanompi_tpu_torch.workers import bsp_worker

        out = bsp_worker.run(devices=["cpu"],
                             modelfile="theanompi_tpu_torch.models.llama",
                             modelclass="Llama", config=cfg, n_epochs=1,
                             verbose=False)
        p = out["step_profile"]
        return {"legs": list(p["legs"]), "coverage": p["coverage"],
                "trace_spans": out["trace_spans"], "n_cores": p["n_cores"],
                "n_devices": p["n_devices"], "error": p.get("error")}
    init = f"tcp://127.0.0.1:{free_port()}"
    res = tmp_path / "rank0.json"
    script = RANK_SCRIPT.format(root=str(ROOT))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), init,
                               json.dumps(cfg), str(res)], env=env)
             for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    return json.loads(res.read_text())


@pytest.mark.parametrize("n", [1, 2])
def test_bsp_knobs_match_the_jax_worker(tmp_path, n):
    want = jax_summary(n, tmp_path / "jax.json")
    got = port_summary(n, tmp_path / "port.json", tmp_path)
    assert got["error"] is None
    assert got["legs"] == want["legs"]
    assert got["legs"][0] == "compute" and got["legs"][-1] == "host_gap"
    assert "optimizer" in got["legs"] and "exchange_b0" in got["legs"]
    assert abs(got["coverage"] - want["coverage"]) <= COVERAGE_TOL
    assert got["trace_spans"] == want["trace_spans"]
    # each rank profiles its own device: one timeline, the world's flops
    assert (got["n_cores"], got["n_devices"]) == (1, n)
    doc = json.loads((tmp_path / "port.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"iteration", "load", "step"} <= names
    assert "step_profile:Llama" in names
    assert "step_phase_s:Llama" in names


def test_profile_failure_is_reported_not_raised(monkeypatch):
    from theanompi_tpu_torch.workers import bsp_worker

    def boom(*a, **k):
        raise RuntimeError("no trace")

    monkeypatch.setattr(bsp_worker, "_profile_step_phase", boom)
    out = bsp_worker.run(devices=["cpu"],
                         modelfile="theanompi_tpu_torch.models.llama",
                         modelclass="Llama", config=dict(CFG, trace=False),
                         n_epochs=1, verbose=False)
    assert out["step_profile"] == {"error": "RuntimeError: no trace"}
    assert out["trace_spans"] is None


def test_train_step_flops_leaves_the_model_as_it_was():
    """``train_step_flops`` counts a step's products without running the
    exchange or the update: the parameters and Adam's state are
    unchanged; on the CPU it equals the counter's own count of the
    forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group

    created = init_group(torch.device("cpu"), 0, 1, None)
    try:
        m = Llama(dict(CFG, step_profile=False), device="cpu")
        m.build_model()
        m.compile_iter_fns()
        before = [t.clone() for t in m._leaves()]
        flops = m.train_step_flops()
        assert all(torch.equal(a, b) for a, b in zip(before, m._leaves()))
        with FlopCounterMode(display=False) as fc:
            loss, leaves = m._step_loss(0)
            torch.autograd.grad(loss, leaves)
        assert flops == fc.get_total_flops() > 0
    finally:
        if created:
            destroy_group()


# -- the range registry --------------------------------------------------------

def test_registry_equals_jax():
    assert port_registry.PROFILE_SCOPES == jax_registry.PROFILE_SCOPES
    assert port_registry.PROFILE_SCOPE_PREFIXES == \
        jax_registry.PROFILE_SCOPE_PREFIXES


def range_labels_in_port():
    """Every literal label (and f-string literal head) of a
    ``record_function(...)`` or ``scope(...)`` call in the port (but
    ``scope``'s own body, which passes its argument on)."""
    out = []
    for path in sorted(PORT_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name not in ("record_function", "scope"):
                continue
            arg = node.args[0]
            if path.name == "profiler.py" and isinstance(arg, ast.Name) \
                    and arg.id == "label":
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((path, arg.value, False))
            elif isinstance(arg, ast.JoinedStr):
                head = arg.values[0] if arg.values else None
                out.append((path, head.value if isinstance(head, ast.Constant)
                            else "", True))
            else:
                out.append((path, None, False))
    return out


def test_every_range_label_in_the_port_is_registered():
    found = range_labels_in_port()
    labels = {label for _, label, _ in found}
    # the ranges this port opens: the exchange buckets, the codec, the
    # update, the serving decode's three and the batch staging
    assert {"exchange_b", "quantize_wire", "dequantize_wire", "opt_update",
            "serving_sample", "paged_attend", "kv_write",
            "host_load"} <= labels
    for path, label, is_prefix in found:
        where = path.relative_to(ROOT)
        assert label is not None, f"{where}: a range label that is not a " \
            f"literal"
        if is_prefix:
            assert any(label.startswith(p) for p in
                       port_registry.PROFILE_SCOPE_PREFIXES), (where, label)
        else:
            assert port_prof._label_leg(label) is not None, (where, label)


def test_serving_ranges_only_under_a_profiler(monkeypatch):
    """A paged decode opens no ``record_function`` range while no
    profiler is active, and opens ``paged_attend``, ``kv_write`` and
    ``serving_sample`` under one."""
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.models.llama import Llama
    from theanompi_tpu_torch.serving import Engine

    opened = []
    real = torch.profiler.record_function

    def spy(label, *a, **k):
        opened.append(label)
        return real(label, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    cfg = dict(CFG, n_layers=1, step_profile=False, trace=False)
    model = Llama(cfg, device="cpu")
    dec = model.make_decoder(paged=True, max_slots=2, max_seq=32,
                             block_size=4, prefill_chunk=8)

    def serve():
        eng = Engine(dec)
        fut = eng.submit([1, 2, 3, 4, 5], max_tokens=4)
        while not fut.done():
            eng.step()
        return fut.result()

    serve()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        serve()
    assert {"paged_attend", "kv_write", "serving_sample"} <= set(opened)
