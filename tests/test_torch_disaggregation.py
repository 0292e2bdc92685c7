"""Disaggregated prefill/decode in the port against the JAX package: a
handoff record (``serving/kv_transfer.py``) round-trips bitwise through
``export_blocks``/``import_blocks``, carries the JAX record's fields
and values, and crosses between the packages both ways (fp32, the same
weights through ``params_from_jax``): a prompt prefilled on one decoder
and decoded on another gives the ids of serving it whole, in either
package.  bf16 records carry the bits as ``uint16`` and round-trip
exactly.  Also the engine's edges (``prefill_only`` frees everything,
the first decode block is reserved, ``max_tokens = 1`` ships nothing,
an incompatible record sheds ``"handoff_failed"``) and the restart
hook and done-callbacks."""

import time

import numpy as np
import pytest

from theanompi_tpu.serving import Engine as JaxEngine
from theanompi_tpu.serving import Request as JaxRequest
from theanompi_tpu.serving import kv_transfer as jax_kv
from theanompi_tpu_torch.models import Llama
from theanompi_tpu_torch.serving import Engine, Request, kv_transfer

from test_torch_decoder import SMALL, jax_model, port_model

pytestmark = pytest.mark.serving

# two blocks' worth at block_size 8: a multi-block table with a partial
# tail block
PROMPTS = [[1 + i, 5, 9, 3 + i, 17, 2, 4, 8, 6, 11 + i] for i in range(4)]
DEC_KW = dict(max_slots=2, max_seq=48, block_size=8, prefill_chunk=8)
# the JAX and port pools from one init agree within this (fp32, other
# summation orders); the ids are compared exactly
KV_ATOL = 1e-5


@pytest.fixture(scope="module")
def models(devices8):
    jm = jax_model(devices8)
    return jm, port_model(jm)


def paged(model, **over):
    return model.make_decoder(paged=True, **dict(DEC_KW, **over))


def run(engine, requests):
    futs = [engine.submit(r) for r in requests]
    engine.run_until_idle()
    return [f.result(timeout=0) for f in futs]


def unified(engine_cls, req_cls, dec, max_tokens=6):
    rs = run(engine_cls(dec), [req_cls(prompt=list(p), max_tokens=max_tokens)
                               for p in PROMPTS])
    assert all(r.status == "ok" for r in rs)
    return [r.tokens for r in rs]


def prefill_on(engine_cls, req_cls, dec, max_tokens=6):
    rs = run(engine_cls(dec), [req_cls(prompt=list(p), max_tokens=max_tokens,
                                       prefill_only=True) for p in PROMPTS])
    assert all(r.finish_reason == "prefilled" for r in rs)
    return rs


def decode_on(engine_cls, req_cls, dec, prefilled, max_tokens=6):
    rs = run(engine_cls(dec), [
        req_cls(prompt=list(p), max_tokens=max_tokens, handoff=r.handoff)
        for p, r in zip(PROMPTS, prefilled)])
    assert all(r.status == "ok" for r in rs)
    # the first token is the prefiller's, the rest the decoder's
    assert [r.tokens[0] for r in rs] == [r.tokens[0] for r in prefilled]
    return [r.tokens for r in rs]


def test_round_trip_bitwise_and_jax_fields(models):
    jm, tm = models
    h = prefill_on(Engine, Request, paged(tm))[0].handoff
    jh = prefill_on(JaxEngine, JaxRequest, paged(jm))[0].handoff
    assert kv_transfer.HANDOFF_FIELDS == jax_kv.HANDOFF_FIELDS
    assert kv_transfer.HANDOFF_VERSION == jax_kv.HANDOFF_VERSION
    assert set(h) == set(jh)
    for key in kv_transfer.HANDOFF_FIELDS:
        if key != "layers":
            assert h[key] == jh[key], key
    assert h["dtype"] == "float32" and h["n_blocks"] == 2
    assert len(h["layers"]) == SMALL["n_layers"]
    for lkv, jlkv in zip(h["layers"], jh["layers"]):
        for kv in ("k", "v"):
            assert lkv[kv].dtype == np.float32
            assert lkv[kv].shape == (2, 2, 8, 8)
            np.testing.assert_allclose(lkv[kv], np.asarray(jlkv[kv]),
                                       atol=KV_ATOL, rtol=0)
    assert kv_transfer.handoff_bytes(h) == jax_kv.handoff_bytes(jh) \
        == 2 * 2 * (2 * 2 * 8 * 8 * 4)
    dst = paged(tm)
    assert kv_transfer.compatible(dst, h) == (True, "")
    dst.manager.assign(0, [], h["n_blocks"])
    kv_transfer.inject_handoff(dst, dst.manager, 0, h)
    back = dst.export_blocks(dst.manager.slot_blocks(0, 2))
    for a, b in zip(h["layers"], back):
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["v"], b["v"])


def test_compatible_refusals(models):
    _, tm = models
    dec8, dec16 = paged(tm), paged(tm, block_size=16)
    h = {"version": kv_transfer.HANDOFF_VERSION, "n_prompt": 10,
         "first_token": 3, "block_size": 8, "n_blocks": 2, "n_layers": 2,
         "n_kv_heads": 2, "head_dim": 8, "dtype": "float32", "layers": []}
    assert kv_transfer.compatible(dec8, h) == (True, "")
    for dec, bad, word in (
            (dec16, h, "block_size"),
            (tm.make_decoder(max_slots=2, max_seq=48), h, "paged"),
            (dec8, dict(h, version=99), "version"),
            (dec8, {k: v for k, v in h.items() if k != "first_token"},
             "missing"),
            (dec8, dict(h, n_blocks=99), "blocks"),
            (dec8, dict(h, dtype="bfloat16"), "dtype"),
            (dec8, dict(h, n_kv_heads=4), "n_kv_heads")):
        ok, why = kv_transfer.compatible(dec, bad)
        assert not ok and word in why, (word, why)
    # the engine sheds an incompatible record for a full re-prefill
    h16 = prefill_on(Engine, Request, dec16)[0].handoff
    r = run(Engine(paged(tm)), [Request(prompt=list(PROMPTS[0]),
                                        max_tokens=4, handoff=h16)])[0]
    assert (r.status, r.finish_reason) == ("shed", "handoff_failed")


def test_prefill_only_skips_decode(models):
    _, tm = models
    eng = Engine(paged(tm), prefix_caching=False)
    r = run(eng, [Request(prompt=list(PROMPTS[1]), max_tokens=6,
                          prefill_only=True)])[0]
    assert (r.status, r.finish_reason) == ("ok", "prefilled")
    assert len(r.tokens) == 1 and r.ttft_s is not None
    assert r.handoff["first_token"] == r.tokens[0]
    assert eng.active_slots() == 0
    assert eng.paging_stats()["allocator"]["blocks_in_use"] == 0


def test_handoff_reserves_first_decode_block(models):
    """A prompt ending on a block boundary ships blocks_for(plen)
    blocks; admission reserves blocks_for(plen + 1), as a local prefill
    does, so the first decode write never finds a dry pool."""
    _, tm = models
    prompt = list(range(1, 17))           # 16 = 2 full blocks
    src = Engine(paged(tm), prefix_caching=False)
    h = run(src, [Request(prompt=prompt, max_tokens=4,
                          prefill_only=True)])[0].handoff
    assert h["n_blocks"] == 2
    dst = Engine(paged(tm), prefix_caching=False)
    fut = dst.submit(Request(prompt=prompt, max_tokens=4, handoff=h))
    dst._admit(time.monotonic())
    slot = next(i for i, s in enumerate(dst._slots) if s is not None)
    assert dst._mgr.n_owned[slot] == 3
    dst.run_until_idle()
    assert len(fut.result(timeout=0).tokens) == 4


def test_max_tokens_one_ships_no_handoff(models):
    _, tm = models
    r = run(Engine(paged(tm)), [Request(prompt=list(PROMPTS[1]),
                                        max_tokens=1, prefill_only=True)])[0]
    assert r.finish_reason == "max_tokens" and r.handoff is None


def test_prefill_a_decode_b_equals_unified_and_jax(models):
    jm, tm = models
    want = unified(JaxEngine, JaxRequest, paged(jm))
    assert unified(Engine, Request, paged(tm)) == want
    pre = prefill_on(Engine, Request, paged(tm))
    assert decode_on(Engine, Request, paged(tm), pre) == want
    # the v1 engine ignores both fields and serves the whole prompt
    v1 = tm.make_decoder(max_slots=2, max_seq=48)
    rs = run(Engine(v1), [Request(prompt=list(p), max_tokens=6,
                                  prefill_only=True) for p in PROMPTS])
    assert [r.tokens for r in rs] == want
    assert all(r.handoff is None for r in rs)


def test_records_cross_between_packages(models):
    """A JAX fp32 record decoded by the port, and a port record decoded
    by the JAX decoder, both give the JAX unified ids."""
    jm, tm = models
    want = unified(JaxEngine, JaxRequest, paged(jm))
    jpre = prefill_on(JaxEngine, JaxRequest, paged(jm))
    assert decode_on(Engine, Request, paged(tm), jpre) == want
    pre = prefill_on(Engine, Request, paged(tm))
    assert decode_on(JaxEngine, JaxRequest, paged(jm), pre) == want


def test_bf16_records_carry_bits(models):
    _, tm = models
    cfg = dict(SMALL, compute_dtype="bfloat16")
    m = Llama(cfg, device="cpu", params=tm.params)
    want = unified(Engine, Request, paged(m))
    pre = prefill_on(Engine, Request, paged(m))
    h = pre[0].handoff
    assert h["dtype"] == "bfloat16"
    lkv = h["layers"][0]
    assert lkv["k"].dtype == np.uint16 and lkv["k"].shape == (2, 2, 8, 8)
    assert kv_transfer.handoff_bytes(h) == 2 * 2 * (2 * 2 * 8 * 8 * 2)
    assert decode_on(Engine, Request, paged(m), pre) == want
    dst = paged(m)
    dst.manager.assign(0, [], 2)
    kv_transfer.inject_handoff(dst, dst.manager, 0, h)
    back = dst.export_blocks(dst.manager.slot_blocks(0, 2))
    for a, b in zip(h["layers"], back):
        np.testing.assert_array_equal(a["k"], b["k"])
        np.testing.assert_array_equal(a["v"], b["v"])
    with pytest.raises(TypeError, match="bfloat16"):
        dst.import_blocks([{k: a.astype(np.float32) for k, a in l.items()}
                           for l in h["layers"]], [1, 2])


def test_abandon_all_and_done_callbacks(models):
    _, tm = models
    eng = Engine(paged(tm))
    seen = []
    futs = [eng.submit(list(p), max_tokens=8) for p in PROMPTS]
    futs[0].add_done_callback(seen.append)
    eng.step()              # two slots mid-prefill, two queued
    assert eng.active_slots() == 2 and eng.queue_depth() == 2
    assert eng.paging_stats()["allocator"]["blocks_in_use"] == 4
    assert eng.abandon_all() == 4
    rs = [f.result(timeout=0) for f in futs]
    assert {(r.status, r.finish_reason) for r in rs} == {("shed", "restart")}
    assert seen == [rs[0]]
    assert eng.active_slots() == 0 and eng.queue_depth() == 0
    assert eng.paging_stats()["allocator"]["blocks_in_use"] == 0
    late = []
    futs[1].add_done_callback(late.append)     # already resolved: at once
    assert late == [rs[1]]
    futs[1]._set(rs[0])                        # the first resolution wins
    assert futs[1].result(timeout=0) is rs[1]
    # the engine serves on after the restart
    assert unified(Engine, Request, eng.decoder)[0]
