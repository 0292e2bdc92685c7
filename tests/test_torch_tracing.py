"""Span tracing in the port against the JAX package.  The copied tracer,
exporters and metrics renderer give the JAX functions' outputs on the
same operations under a fixed clock; an engine's span names, parents
and attributes equal the JAX engine's for the same traffic (paged with
chunks, prefix hits and copy-on-write, speculative windows, v1); each
request is one connected tree, chunk spans sit under their prefill, a
shed is force-sampled, an untraced engine records nothing; and
``ServingRecorder.metrics_txt`` gives the JAX text for the same
recorded data."""

import itertools

import pytest

from theanompi_tpu.obs import export as jax_export
from theanompi_tpu.obs import metrics as jax_metrics
from theanompi_tpu.obs import tracer as jax_tracer
from theanompi_tpu.serving import Engine as JaxEngine
from theanompi_tpu.utils.recorder import ServingRecorder as JaxRecorder
from theanompi_tpu_torch.obs import (
    chrome_trace,
    critical_path,
    format_critical_path,
    render_metrics,
    span_tree,
)
from theanompi_tpu_torch.obs import export, metrics, tracer
from theanompi_tpu_torch.serving import Engine
from theanompi_tpu_torch.utils.recorder import ServingRecorder

from test_torch_decoder import jax_model, port_model

pytestmark = pytest.mark.serving

PROMPTS = [[1 + i, 5, 9, 3 + i, 17, 2, 4, 8, 6, 11 + i] for i in range(4)]
SYSTEM = [7, 3, 9, 12, 5, 6, 1, 2]
DEC_KW = dict(max_slots=2, max_seq=48, block_size=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def models(devices8):
    jm = jax_model(devices8)
    return jm, port_model(jm)


def fixed_tracer(module, **kw):
    """A tracer on a counting clock, with its id tag and wall offset
    zeroed, so two packages' tracers stamp and number alike."""
    ticks = itertools.count()
    tr = module.Tracer(clock=lambda: float(next(ticks)), **kw)
    tr._tag = 0
    tr._wall_offset = 0.0
    return tr


def tracer_script(module):
    """The same operations on one package's tracer; returns what each
    reported, the ring's spans and its stats."""
    tr = fixed_tracer(module, process="p", capacity=12, sample=2)
    out = []
    for i in range(5):
        ctx = tr.new_context()
        out.append(dict(ctx))
        root = tr.start_span(ctx, "request", n=i)
        with tr.span(ctx, "engine_queue", parent_id=root["span_id"]):
            pass
        out.append(tr.record_span(ctx, "prefill_chunk", 1.0, 2.0,
                                  parent_id=root["span_id"], pos=i))
        if i == 3:
            module.force_sample(ctx)
        out.append(tr.end_span(root, status="ok"))
    forced = tr.new_context(force=True)
    out.append(tr.record_span(forced, "shed", 0.0, 1.0, force=True))
    out.append(module.child_context(forced, 7))
    out.append(tr.ingest(tr.spans()[:2]))
    return out, tr.spans(), tr.trace_ids(), tr.stats()


def test_tracer_copy_equals_jax():
    assert tracer_script(tracer) == tracer_script(jax_tracer)
    assert tracer.DEFAULT_TRACE_SAMPLE == jax_tracer.DEFAULT_TRACE_SAMPLE


def export_spans():
    tr = fixed_tracer(tracer, process="engine", capacity=64)
    for _ in range(3):
        ctx = tr.new_context()
        root = tr.start_span(ctx, "request")
        q = tr.start_span(ctx, "engine_queue", parent_id=root["span_id"])
        tr.end_span(q)
        pf = tr.start_span(ctx, "prefill", parent_id=root["span_id"])
        tr.record_span(ctx, "prefill_chunk", 5.0, 6.0,
                       parent_id=pf["span_id"], pos=0)
        tr.end_span(pf)
        with tr.span(ctx, "decode", parent_id=root["span_id"],
                     lane="decode"):
            pass
        tr.end_span(root)
    spans = tr.spans()
    spans.append(dict(spans[-1], span_id=999, parent_id=12345))  # orphan
    return spans


def test_export_copy_equals_jax(tmp_path):
    spans = export_spans()
    counters = [{"process": "engine", "name": "slots", "t": 1.5,
                 "values": {"active_slots": 2, "queue_depth": None}}]
    assert chrome_trace(spans, counters=counters) == \
        jax_export.chrome_trace(spans, counters=counters)
    tids = sorted({s["trace_id"] for s in spans})
    for tid in tids:
        assert span_tree(spans, tid) == jax_export.span_tree(spans, tid)
        cp = critical_path(spans, tid)
        assert cp == jax_export.critical_path(spans, tid)
        assert format_critical_path(cp) == \
            jax_export.format_critical_path(cp)
    assert not span_tree(spans, tids[-1])["connected"]
    a = export.write_chrome_trace(spans, tmp_path / "a.json")
    b = jax_export.write_chrome_trace(spans, tmp_path / "b.json")
    assert open(a).read() == open(b).read()


def test_metrics_copy_equals_jax():
    families = [
        ("tm_x_total", "counter", [({"r": 'a"b\\c\n'}, 2), (None, None)]),
        ("tm_gone", "gauge", [(None, None)]),
        ("tm_flag", "gauge", [(None, True), ({"z": 1, "a": 2}, 0.25)]),
        ("tm_lat", "summary", metrics.quantile_samples(
            {"0.5": 0.1, "0.95": None}, {"replica": "r0"})),
    ]
    assert render_metrics(families) == jax_metrics.render_metrics(families)
    assert render_metrics([]) == jax_metrics.render_metrics([]) == ""


def fill(rec):
    for i in range(5):
        rec.record_request(status="ok", finish_reason="eos", n_prompt=4 + i,
                           n_generated=3, ttft_s=0.1 * i, tpot_s=0.01,
                           e2e_s=0.5, n_prefix_hit=i)
    rec.record_request(status="shed", finish_reason="queue_full",
                       n_prompt=4, n_generated=0)
    rec.record_step(active_slots=2, queue_depth=1, dt_s=0.5, tokens=5,
                    blocks_in_use=3, blocks_free=5, drafted=6, accepted=3)
    rec.record_block_gauges(blocks_in_use=4, blocks_free=4)
    rec.record_tokenize(n_items=3, n_tokens=30, wait_s=0.01)


def test_metrics_txt_equals_jax():
    ours, theirs = ServingRecorder(max_slots=2), JaxRecorder(max_slots=2)
    fill(ours)
    fill(theirs)
    txt = ours.metrics_txt()
    assert txt == theirs.metrics_txt()
    assert 'tm_serving_sheds_total{reason="queue_full"} 1' in txt
    assert "tm_serving_accept_rate 0.5" in txt
    assert ours.metrics_txt("tm_x") == theirs.metrics_txt("tm_x")


# -- the engine's spans -------------------------------------------------------

def shape(spans) -> list:
    """A trace as sorted (name, parent's name, attrs): its structure
    without ids and stamps."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted(
        (s["name"], by_id.get(s["parent_id"]),
         tuple(sorted((k, repr(v)) for k, v in s["attrs"].items())))
        for s in spans)


def traced_run(engine_cls, model, tracer_mod, *, paged=True, **ekw):
    """Two rounds on one decoder: four prompts behind a shared system
    prompt (prefix hits and copy-on-write), then the same traffic
    again; returns each result's trace shape and the results."""
    kw = DEC_KW if paged else dict(max_slots=2, max_seq=48)
    dec = model.make_decoder(paged=paged, **kw)
    shapes, results = [], []
    for _ in range(2):
        tr = tracer_mod.Tracer(process="engine", sample=1)
        eng = engine_cls(dec, tracer=tr, **ekw)
        futs = [eng.submit(SYSTEM + p, max_tokens=5, seed=i)
                for i, p in enumerate(PROMPTS)]
        eng.run_until_idle()
        for f in futs:
            r = f.result(timeout=5)
            assert r.status == "ok"
            results.append(r)
            shapes.append(shape(r.spans))
    return shapes, results


@pytest.mark.parametrize("mode", ["paged", "speculative", "v1"])
def test_engine_spans_equal_jax(models, mode):
    jm, tm = models
    ekw = dict(paged=mode != "v1")
    if mode == "speculative":
        ekw["speculate_k"] = 4
    got, results = traced_run(Engine, tm, tracer, **ekw)
    want, jresults = traced_run(JaxEngine, jm, jax_tracer, **ekw)
    assert got == want
    assert [r.tokens for r in results] == [r.tokens for r in jresults]
    names = {n for s in got for n, _, _ in s}
    if mode == "paged":
        assert {"kv_cow", "prefill_chunk", "kv_grow"} <= names
    if mode == "speculative":
        assert "spec_window" in names
    for r in results:
        tid = r.spans[0]["trace_id"]
        rep = span_tree(r.spans, tid)
        assert rep["connected"] and rep["root_name"] == "request", rep
        assert critical_path(r.spans, tid)["coverage"] >= 0.95


def test_chunk_spans_parent_under_prefill(models):
    _, tm = models
    eng = Engine(tm.make_decoder(paged=True, **DEC_KW), trace_sample=1)
    fut = eng.submit(PROMPTS[0], max_tokens=3)
    eng.run_until_idle()
    spans = fut.result(5).spans
    pf = next(s for s in spans if s["name"] == "prefill")
    chunks = [s for s in spans if s["name"] == "prefill_chunk"]
    assert len(chunks) == 2           # 10 tokens in chunks of 8
    assert all(c["parent_id"] == pf["span_id"] for c in chunks)
    assert len([s for s in eng.tracer.spans()
                if s["parent_id"] is None]) == 1


def test_shed_is_force_sampled_and_untraced_records_nothing(models):
    _, tm = models
    eng = Engine(tm.make_decoder(paged=True, **DEC_KW), trace_sample=10_000)
    first = eng.submit(PROMPTS[1], max_tokens=2)    # sampled: 1 of 10k
    shed = eng.submit([1] * 100, max_tokens=2)      # sheds at submit
    r = shed.result(timeout=5)
    assert r.status == "shed" and r.finish_reason == "prompt_too_long"
    assert {s["name"] for s in r.spans} == {"request", "engine_queue"}
    eng.run_until_idle()
    assert first.result(5).spans
    quiet = eng.submit(PROMPTS[2], max_tokens=2)    # unsampled
    eng.run_until_idle()
    assert quiet.result(5).spans == []
    plain = Engine(tm.make_decoder(paged=True, **DEC_KW))
    fut = plain.submit(PROMPTS[0], max_tokens=3)
    plain.run_until_idle()
    assert fut.result(5).spans == [] and plain.tracer is None
