"""Engine parity: ``Engine.run_until_idle`` in both packages returns
equal greedy ids for a handful of requests (v1 and paged decoders,
slots evicting and refilling mid-run), and a checkpoint saved by the
JAX model loads through the port's ``decoder_from_checkpoint`` and
serves the same ids.  Speculation, tracing, the tokenizer front door
and KV handoffs serve the JAX engine's ids too.  Also the port's own
serving guarantees: sampled requests batched equal the same requests
alone."""

import json

import numpy as np
import pytest

from theanompi_tpu.serving import Engine as JaxEngine
from theanompi_tpu_torch.obs import Tracer
from theanompi_tpu_torch.serving import (
    ByteTokenizer,
    Engine,
    decoder_from_checkpoint,
)

from test_torch_decoder import PAGED_KW, SMALL, V1_KW, jax_model, port_model

pytestmark = pytest.mark.serving

REQUESTS = [
    ([1 + i, 5, 9, 3 + i, 17] * (1 + i % 3), 4 + i) for i in range(6)
]


@pytest.fixture(scope="module")
def models(devices8):
    jm = jax_model(devices8)
    return jm, port_model(jm)


def run_all(engine_cls, dec, requests, handoffs=None, **kw):
    eng = engine_cls(dec)
    futs = [eng.submit(p, max_tokens=n,
                       **(dict(handoff=handoffs[i]) if handoffs else {}),
                       **kw)
            for i, (p, n) in enumerate(requests)]
    eng.run_until_idle()
    results = [f.result(timeout=0) for f in futs]
    assert all(r.status == "ok" for r in results)
    return [r.tokens for r in results], eng


@pytest.mark.parametrize("paged", [False, True])
def test_engine_greedy_ids_match_jax(models, paged):
    jm, tm = models
    kw = PAGED_KW if paged else V1_KW
    want, _ = run_all(JaxEngine, jm.make_decoder(paged=paged, **kw),
                      REQUESTS)
    got, eng = run_all(Engine, tm.make_decoder(paged=paged, **kw),
                       REQUESTS)
    assert got == want
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    summ = eng.recorder.summary()
    assert summ["n_completed"] == len(REQUESTS) and summ["n_shed"] == 0
    if paged:
        assert summ["blocks_in_use_max"] > 0


# Block-scarcity and cache-bound scenarios (the JAX package's
# tests/test_serving_paged.py cases): decoder kwargs, then rounds of
# (prompt, max_tokens) each served by a fresh engine over the same
# decoder, so cache state carries from one round to the next.
SCENARIOS = {
    "oversized_prompt_sheds_at_submit": (
        dict(paged=True, max_slots=2, max_seq=48, block_size=4,
             n_blocks=3),
        [[(list(range(1, 14)), 2)]],
    ),
    "decode_growth_exhaustion_truncates": (
        dict(paged=True, max_slots=1, max_seq=48, block_size=4,
             n_blocks=3, prefix_cache=False),
        [[(list(range(1, 8)), 100)]],
    ),
    "adoption_cow_exhaustion_sheds_prefill": (
        dict(paged=True, max_slots=1, max_seq=16, block_size=4,
             n_blocks=3, prefill_chunk=8),
        [[(list(range(1, 9)), 2)], [(list(range(1, 9)), 2)]],
    ),
    "eviction_frees_cache_blocks": (
        dict(paged=True, max_slots=2, max_seq=16, block_size=4,
             prefill_chunk=8, n_blocks=4),
        [[(list(range(1, 8)), 2)], [(list(range(9, 18)), 2)]],
    ),
    "paged_max_seq_uses_every_row": (
        dict(paged=True, max_slots=2, max_seq=8, block_size=4,
             prefill_chunk=4),
        [[([1, 2, 3], 100)]],
    ),
    "v1_max_seq_uses_every_row": (
        dict(max_slots=2, max_seq=8),
        [[([1, 2, 3], 100), ([4, 5], 100)]],
    ),
}


def outcomes(engine_cls, dec, rounds):
    out = []
    for reqs in rounds:
        eng = engine_cls(dec)
        futs = [eng.submit(p, max_tokens=n, seed=0) for p, n in reqs]
        eng.run_until_idle()
        for f in futs:
            r = f.result(timeout=0)
            out.append((r.status, r.finish_reason, list(r.tokens)))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scarcity_and_bounds_match_jax(models, name):
    jm, tm = models
    kw, rounds = SCENARIOS[name]
    want = outcomes(JaxEngine, jm.make_decoder(**kw), rounds)
    got = outcomes(Engine, tm.make_decoder(**kw), rounds)
    assert got == want
    reasons = {reason for _, reason, _ in got}
    if "exhaustion" in name or "oversized" in name:
        assert "no_blocks" in reasons
    if "max_seq" in name:
        assert reasons == {"max_seq"}


def test_expired_queued_request_sheds_deadline(models):
    _, tm = models
    eng = Engine(tm.make_decoder(max_slots=1, max_seq=48))
    first = eng.submit([1, 2, 3], max_tokens=3)
    late = eng.submit([4, 5, 6], max_tokens=3, deadline_s=0.0)
    eng.run_until_idle()
    assert first.result(timeout=0).status == "ok"
    r = late.result(timeout=0)
    assert (r.status, r.finish_reason) == ("shed", "deadline")


def test_jax_checkpoint_serves_in_the_port(models, tmp_path):
    jm, _ = models
    jm.save(str(tmp_path))
    want, _ = run_all(JaxEngine, jm.make_decoder(**V1_KW), REQUESTS[:3])
    dec = decoder_from_checkpoint(SMALL, str(tmp_path), device="cpu",
                                  **V1_KW)
    assert run_all(Engine, dec, REQUESTS[:3])[0] == want
    pdec = decoder_from_checkpoint(SMALL, str(tmp_path), device="cpu",
                                   paged=True, **PAGED_KW)
    assert pdec.paged
    assert run_all(Engine, pdec, REQUESTS[:3])[0] == want


def test_corrupt_checkpoint_is_refused(models, tmp_path):
    jm, _ = models
    jm.save(str(tmp_path))
    (sidecar,) = tmp_path.glob("ckpt_*.json")
    meta = json.loads(sidecar.read_text())
    key = "params:['layers'][0]['wq']"
    meta["_digests"][key] = (meta["_digests"][key] + 1) & 0xFFFFFFFF
    sidecar.write_text(json.dumps(meta))
    with pytest.raises(FileNotFoundError, match="no loadable"):
        decoder_from_checkpoint(SMALL, str(tmp_path), device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_batched_equals_single(models, paged):
    """Each token's Gumbel draw is seeded by (request seed, position),
    so a sampled request gives the same ids in a full batch as alone."""
    _, tm = models
    dec = tm.make_decoder(paged=paged, **(PAGED_KW if paged else V1_KW))
    reqs = REQUESTS[:5]
    eng = Engine(dec, prefix_caching=False)
    futs = [eng.submit(p, max_tokens=n, seed=10 + i, temperature=0.8)
            for i, (p, n) in enumerate(reqs)]
    eng.run_until_idle()
    batched = [f.result(timeout=0).tokens for f in futs]
    for i, (p, n) in enumerate(reqs):
        eng = Engine(dec, prefix_caching=False)
        f = eng.submit(p, max_tokens=n, seed=10 + i, temperature=0.8)
        eng.run_until_idle()
        assert f.result(timeout=0).tokens == batched[i]
    greedy, _ = run_all(Engine, dec, reqs)
    assert batched != greedy


def test_admission_control_sheds(models):
    _, tm = models
    dec = tm.make_decoder(**V1_KW)
    eng = Engine(dec, queue_cap=1)
    too_long = eng.submit(list(range(1, 60)), max_tokens=3)
    assert too_long.result(timeout=0).finish_reason == "prompt_too_long"
    first = eng.submit([1, 2, 3], max_tokens=3)
    full = eng.submit([1, 2, 3], max_tokens=3)
    assert full.result(timeout=0).finish_reason == "queue_full"
    eng.run_until_idle()
    assert first.result(timeout=0).status == "ok"
    assert eng.recorder.summary()["n_shed"] == 2


def test_background_loop_drains(models):
    _, tm = models
    eng = Engine(tm.make_decoder(**V1_KW))
    eng.start()
    try:
        futs = [eng.submit(p, max_tokens=n) for p, n in REQUESTS[:3]]
        results = [f.result(timeout=60) for f in futs]
    finally:
        eng.stop()
    assert all(r.status == "ok" for r in results)
    late = eng.submit([1, 2], max_tokens=2)
    # after stop() a submission resolves at once instead of hanging
    assert late.result(timeout=0).finish_reason == "shutdown"


@pytest.mark.parametrize("feature", ["speculate_k", "tracer", "tokenizer"])
def test_engine_features_serve_the_jax_ids(models, feature):
    """Speculation, span tracing and the tokenizer front door each serve
    the JAX engine's greedy ids over the paged decoder."""
    jm, tm = models
    kw = {"speculate_k": dict(speculate_k=4),
          "tracer": dict(tracer=Tracer(process="engine")),
          "tokenizer": dict(tokenizer=ByteTokenizer(offset=0))}[feature]
    want, _ = run_all(JaxEngine, jm.make_decoder(paged=True, **PAGED_KW),
                      REQUESTS)
    got, eng = run_all(lambda d: Engine(d, **kw),
                       tm.make_decoder(paged=True, **PAGED_KW), REQUESTS)
    assert got == want
    if feature == "speculate_k":
        assert eng.recorder.summary()["drafted_tokens"] > 0
    if feature == "tracer":
        assert len({s["trace_id"] for s in eng.tracer.spans()}) == len(
            REQUESTS)
    if feature == "tokenizer":
        text = bytes(REQUESTS[0][0]).decode("ascii")
        assert eng.decode_text(REQUESTS[0][0]) == text
        f = eng.submit_text(text, max_tokens=REQUESTS[0][1])
        eng.run_until_idle()
        eng.stop()
        assert f.result(timeout=0).tokens == want[0]


def test_handoff_requests_serve_the_jax_ids(models):
    """prefill_only on one decoder, the handoff decoded on another: the
    JAX engine's ids."""
    jm, tm = models
    want, _ = run_all(JaxEngine, jm.make_decoder(paged=True, **PAGED_KW),
                      REQUESTS)
    pre = Engine(tm.make_decoder(paged=True, **PAGED_KW))
    futs = [pre.submit(p, max_tokens=n, prefill_only=True)
            for p, n in REQUESTS]
    pre.run_until_idle()
    handoffs = [f.result(timeout=0).handoff for f in futs]
    got, _ = run_all(Engine, tm.make_decoder(paged=True, **PAGED_KW),
                     [(p, n) for p, n in REQUESTS], handoffs=handoffs)
    assert got == want


def test_paging_stats_shape(models):
    _, tm = models
    _, eng = run_all(Engine, tm.make_decoder(paged=True, **PAGED_KW),
                     REQUESTS[:2])
    stats = eng.paging_stats()
    assert set(stats) == {"allocator", "prefix_cache"}
    assert stats["allocator"]["n_blocks"] == 48
    assert run_all(Engine, tm.make_decoder(**V1_KW),
                   REQUESTS[:1])[1].paging_stats() is None
    assert np.isfinite(eng.recorder.summary()["tokens_per_sec"])
