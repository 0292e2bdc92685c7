"""The port's ``utils/trace_comm`` against the JAX package's.

- ``_merge_intervals``, ``_span`` and ``_subtract`` are bitwise the JAX
  functions on seeded random interval sets;
- ``comm_report`` on hand-written kineto-format Chrome traces gives the
  hidden and exposed figures the JAX package's ``TestOverlapMath``
  layouts assert (``tests/test_trace_comm.py``; those are picoseconds on
  an xplane, these microseconds on a Chrome trace, so every figure is
  the JAX one times 1e6), on a card's timeline (kernels found through
  their launches' correlation ids) and on the CPU's (the profiled
  thread's top-level ops, gloo's collective lanes);
- a kernel goes to the innermost registered range open at its launch,
  nested ranges included;
- NCCL kernel names are collectives;
- a real capture of a gloo all-reduce on the CPU, and a card run's
  trace with no device events raising.
"""

import json

import numpy as np
import pytest
import torch

from theanompi_tpu.utils import trace_comm as jax_tc
from theanompi_tpu_torch.utils import trace_comm as tc

US = 1e-6          # the Chrome trace's time unit, in seconds
HOST, DEV = 1000, 0


def intervals(rng, n):
    s = rng.integers(0, 10_000, size=n)
    return [(int(a), int(a + d)) for a, d in zip(s, rng.integers(1, 500,
                                                                  size=n))]


@pytest.mark.parametrize("seed", range(6))
def test_interval_helpers_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = intervals(rng, 40), intervals(rng, 25)
    ma, mb = tc._merge_intervals(list(a)), tc._merge_intervals(list(b))
    assert ma == jax_tc._merge_intervals(list(a))
    assert mb == jax_tc._merge_intervals(list(b))
    assert tc._span(ma) == jax_tc._span(ma)
    assert tc._subtract(ma, mb) == jax_tc._subtract(ma, mb)
    assert tc._merge_intervals([]) == jax_tc._merge_intervals([]) == []


class Trace:
    """A kineto-format Chrome trace built by hand: host ranges
    (``user_annotation``), host ops (``cpu_op``), and device kernels
    each launched by a ``cudaLaunchKernel`` with its correlation id."""

    def __init__(self):
        self.events = []
        self._corr = 0

    def range(self, name, ts, dur, tid=HOST):
        self.events.append(dict(ph="X", cat="user_annotation", name=name,
                                pid=HOST, tid=tid, ts=ts, dur=dur))

    def op(self, name, ts, dur, tid=HOST, cat="cpu_op"):
        self.events.append(dict(ph="X", cat=cat, name=name, pid=HOST,
                                tid=tid, ts=ts, dur=dur))

    def kernel(self, name, ts, dur, launch_ts=None, device=DEV, stream=7,
               cat="kernel"):
        self._corr += 1
        self.events.append(dict(
            ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=HOST,
            tid=HOST, ts=ts if launch_ts is None else launch_ts, dur=0.5,
            args={"correlation": self._corr}))
        self.events.append(dict(
            ph="X", cat=cat, name=name, pid=device, tid=stream, ts=ts,
            dur=dur, args={"correlation": self._corr, "device": device,
                           "stream": stream}))

    def write(self, d, **capture):
        d.mkdir(parents=True, exist_ok=True)
        doc = {"traceEvents": self.events}
        if capture:
            doc[tc.CAPTURE_KEY] = capture
        (d / "trace_1.pt.trace.json").write_text(json.dumps(doc))
        return str(d)


def card(layout, tmp_path):
    """A card's trace: each core of ``layout`` one device."""
    t = Trace()
    for dev, events in enumerate(layout):
        for name, start, dur in events:
            t.kernel(name, start, dur, device=dev)
    return t.write(tmp_path, cuda=True)


def cpu(layout, tmp_path):
    """The CPU's trace: collectives on gloo's worker lane, compute as
    the profiled thread's ops."""
    t = Trace()
    (events,) = layout
    for name, start, dur in events:
        if tc.is_collective(name):
            t.op(name, start, dur, tid=HOST + 7, cat="user_annotation")
        else:
            t.op(name, start, dur)
    return t.write(tmp_path, tid=HOST, cuda=False)


# the JAX package's TestOverlapMath layouts with their own op names
# swapped for a card's (an NCCL kernel for a collective) and the CPU's
# (gloo's lane; one timeline only: the CPU has no second core)
HIDDEN_EXPOSED = [[("gemm_1", 0, 1000), ("ncclDevKernel_AllReduce", 500, 1000),
                   ("ncclDevKernel_AllGather", 200, 500)]]
HIDDEN_EXPOSED_CPU = [[("aten::mm", 0, 1000), ("gloo:all_reduce", 500, 1000),
                       ("gloo:all_gather", 200, 500)]]


@pytest.mark.parametrize("build,layout", [(card, HIDDEN_EXPOSED),
                                          (cpu, HIDDEN_EXPOSED_CPU)],
                         ids=["card", "cpu"])
def test_hidden_and_exposed_comm(tmp_path, build, layout):
    rep = tc.comm_report(build(layout, tmp_path))
    assert rep["n_cores"] == 1
    assert rep["device_busy_s"] == pytest.approx(1500 * US)
    assert rep["collective_s"] == pytest.approx(1300 * US)
    assert rep["exposed_comm_s"] == pytest.approx(500 * US)
    assert rep["hidden_comm_s"] == pytest.approx(800 * US)
    assert rep["exposed_comm_frac"] == pytest.approx(500 / 1500)
    assert rep["comm_frac"] == pytest.approx(1300 / 1500)
    assert rep["overlapped_comm_s"] == pytest.approx(800 * US)
    assert rep["overlapped_comm_frac"] == pytest.approx(800 / 1300)
    assert rep["top_collectives"][0][0] == layout[0][1][0]


def test_collective_stall_on_one_device_is_exposed(tmp_path):
    rep = tc.comm_report(card([[("ncclDevKernel_AllReduce", 0, 1000)],
                               [("gemm_1", 0, 1000)]], tmp_path))
    assert rep["n_cores"] == 2
    assert rep["device_busy_s"] == pytest.approx(2000 * US)
    assert rep["exposed_comm_s"] == pytest.approx(1000 * US)
    assert rep["exposed_comm_frac"] == pytest.approx(0.5)


def test_pure_compute(tmp_path):
    rep = tc.comm_report(card([[("gemm_1", 0, 1000)]], tmp_path))
    assert rep["collective_s"] == 0.0
    assert rep["exposed_comm_frac"] == 0.0
    assert rep["overlapped_comm_frac"] == 0.0


@pytest.mark.parametrize("build,names", [
    (card, ("gemm_1", "ncclDevKernel_AllReduce")),
    (cpu, ("aten::mm", "gloo:all_reduce")),
], ids=["card", "cpu"])
def test_fully_serialized_tail_vs_fully_hidden(tmp_path, build, names):
    comp, coll = names
    rep = tc.comm_report(build([[(comp, 0, 1000), (coll, 1000, 500)]],
                               tmp_path / "tail"))
    assert rep["overlapped_comm_frac"] == 0.0
    assert rep["exposed_comm_s"] == pytest.approx(500 * US)
    rep = tc.comm_report(build([[(comp, 0, 1000), (coll, 200, 500)]],
                               tmp_path / "hidden"))
    assert rep["overlapped_comm_frac"] == 1.0
    assert rep["exposed_comm_s"] == 0.0


def test_streams_of_one_device_are_one_timeline(tmp_path):
    """A copy stream's transfer under a kernel is not busy twice."""
    t = Trace()
    t.kernel("gemm_1", 0, 1000, stream=7)
    t.kernel("Memcpy HtoD (Pinned -> Device)", 100, 300, stream=9,
             cat="gpu_memcpy")
    rep = tc.comm_report(t.write(tmp_path, cuda=True))
    assert rep["n_cores"] == 1
    assert rep["device_busy_s"] == pytest.approx(1000 * US)


def test_no_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tc.comm_report(str(tmp_path))


def test_card_trace_without_device_events_raises(tmp_path):
    t = Trace()
    t.op("aten::mm", 0, 100)
    with pytest.raises(RuntimeError, match="no device events"):
        tc.comm_report(t.write(tmp_path, tid=HOST, cuda=True))


SCOPES = {"quantize": {"quantize_wire", "dequantize_wire"},
          "optimizer": {"opt_update"},
          "exchange_b0": {"exchange_b0"}, "exchange_b1": {"exchange_b1"}}


def test_kernels_go_to_the_innermost_range_of_their_launch(tmp_path):
    """exchange_b0 holds a quantize_wire range: the codec's kernel is
    quantize, the NCCL kernel exchange_b0; a kernel that RUNS inside a
    range's span but was launched before it opened is compute (the
    launch decides, not the device-side time); an unregistered outer
    range changes nothing."""
    t = Trace()
    t.range("train_step", 0, 5000)
    t.range("exchange_b0", 1000, 1000)
    t.range("quantize_wire", 1100, 100)
    t.range("exchange_b1", 2000, 500)
    t.range("opt_update", 2600, 400)
    t.kernel("gemm_fwd", 1200, 900, launch_ts=500)     # queued early
    t.kernel("quantize_kernel", 2100, 50, launch_ts=1150)
    t.kernel("ncclDevKernel_AllReduce", 2150, 200, launch_ts=1500)
    t.kernel("ncclDevKernel_AllReduce", 2400, 100, launch_ts=2100)
    t.kernel("adam_kernel", 2700, 300, launch_ts=2650)
    rep = tc.comm_report(t.write(tmp_path, cuda=True), scopes=SCOPES,
                         quant_ops={"quantize_wire", "dequantize_wire"})
    assert rep["scope_s"] == pytest.approx({
        "quantize": 50 * US, "optimizer": 300 * US,
        "exchange_b0": 200 * US, "exchange_b1": 100 * US})
    assert rep["scope_comm_s"] == pytest.approx({
        "quantize": 0.0, "optimizer": 0.0, "exchange_b0": 200 * US,
        "exchange_b1": 100 * US})
    assert rep["quant_s"] == pytest.approx(50 * US)
    assert rep["device_busy_s"] == pytest.approx(1550 * US)


def test_cpu_ops_go_to_the_profiled_threads_ranges(tmp_path):
    """On the CPU: top-level ops only (an op inside another is not
    counted twice), other threads' ops are not the device's, and gloo's
    lane takes the profiled thread's open range."""
    t = Trace()
    t.range("exchange_b0", 1000, 1000)
    t.range("quantize_wire", 1100, 200)
    t.op("aten::matmul", 0, 900)
    t.op("aten::mm", 10, 800)                          # inside matmul
    t.op("aten::abs", 1120, 100)
    t.op("c10d::allreduce_", 1400, 20)
    t.op("gloo:all_reduce", 1430, 300, tid=HOST + 7, cat="user_annotation")
    t.op("aten::copy_", 1000, 500, tid=HOST + 3)       # a feed thread
    rep = tc.comm_report(t.write(tmp_path, tid=HOST, cuda=False),
                         scopes=SCOPES)
    assert rep["n_cores"] == 1
    assert rep["device_busy_s"] == pytest.approx((900 + 100 + 20 + 300)
                                                 * US)
    assert rep["scope_s"]["quantize"] == pytest.approx(100 * US)
    assert rep["scope_s"]["exchange_b0"] == pytest.approx(320 * US)
    assert rep["scope_comm_s"]["exchange_b0"] == pytest.approx(320 * US)


@pytest.mark.parametrize("name,want", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     True),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", True),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL", True),
    ("gloo:all_reduce", True),
    ("c10d::allreduce_", True),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", False),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NNT", False),
    ("flash_fwd_tc_kernel", False),
    ("aten::mm", False),
])
def test_collective_names(name, want):
    assert tc.is_collective(name) is want


def test_real_cpu_capture_of_a_gloo_allreduce(tmp_path):
    """A real trace: a matmul, then a gloo all-reduce under
    ``exchange_b0`` in a one-rank group; the registered range is found
    and its collective is collective time."""
    import torch.distributed as dist

    from theanompi_tpu_torch.obs import profile_scope_sets, scope
    from theanompi_tpu_torch.parallel.mesh import destroy_group, init_group

    created = init_group(torch.device("cpu"), 0, 1, None)
    try:
        a = torch.randn(64, 64)

        def run():
            b = a @ a
            with scope("exchange_b0"):
                dist.all_reduce(b)
            return float(b[0, 0])

        tc.capture_trace(run, str(tmp_path))
    finally:
        if created:
            destroy_group()
    labels = tc.range_labels(str(tmp_path))
    assert "exchange_b0" in labels
    scopes = profile_scope_sets(labels)
    assert list(scopes) == ["exchange_b0"]
    rep = tc.comm_report(str(tmp_path), scopes=scopes)
    assert rep["n_cores"] == 1 and rep["device_busy_s"] > 0
    assert rep["collective_s"] > 0
    assert rep["scope_comm_s"]["exchange_b0"] > 0
    assert rep["top_ops"]
