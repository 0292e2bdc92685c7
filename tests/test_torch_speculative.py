"""Speculative decoding in the port against the JAX package: the copied
``NGramDrafter`` drafts what the JAX one drafts; ``PagedLlamaDecoder
.verify`` (on the CPU: the gather path, the plain version of kernel K4)
gives the JAX ``verify``'s token matrix and block pools from the same
state (fp32 within 1e-6 absolute plus 1e-6 relative: the two
frameworks sum in other orders, a few ulp at |x| ~ 1); and
``Engine(speculate_k=4)`` gives the ids of one-token decode (greedy
and sampled) and of the JAX speculative engine, with the JAX run's
accept rate and tokens per step, through the window's edge cases (EOS
and ``max_tokens`` inside a window, ``max_seq`` inside a window, block
scarcity, a drafter that is always wrong).  Also the refusal of
speculation over the v1 decoder, and windows wider than 16 query rows
(K4's row group) built on a card."""

import numpy as np
import pytest
import torch

from theanompi_tpu.serving import Engine as JaxEngine
from theanompi_tpu.serving import NGramDrafter as JaxNGramDrafter
from theanompi_tpu_torch.serving import Engine, NGramDrafter

from test_torch_decoder import PAGED_KW, SMALL, V1_KW, jax_model, port_model

pytestmark = pytest.mark.serving

# repetitive continuations: the regime self-drafting feeds on
PROMPTS = [
    [5, 9, 5, 9, 5, 9, 5],
    [3, 3, 3, 3, 3],
    [1, 2, 3, 1, 2, 3],
    [7, 11, 7, 11, 7, 2],
    [4, 8, 15, 4, 8, 15],
    [2, 2, 9, 2, 2, 9],
]
POOL_TOL = 1e-6


@pytest.fixture(scope="module")
def models(devices8):
    jm = jax_model(devices8)
    return jm, port_model(jm)


def paged(model, **over):
    return model.make_decoder(paged=True, **dict(PAGED_KW, **over))


def serve(engine_cls, dec, prompts, *, max_tokens=12, temps=None,
          eos_id=None, **ekw):
    eng = engine_cls(dec, prefix_caching=False, eos_id=eos_id, **ekw)
    futs = [eng.submit(p, max_tokens=max_tokens, seed=i,
                       temperature=temps[i] if temps else 0.0)
            for i, p in enumerate(prompts)]
    eng.run_until_idle()
    rs = [f.result(timeout=0) for f in futs]
    assert all(r.status == "ok" for r in rs)
    return [r.tokens for r in rs], [r.finish_reason for r in rs], eng


def test_ngram_drafts_equal_jax():
    rng = np.random.default_rng(0)
    cases = 0
    for max_n, min_n, max_scan in ((3, 1, 512), (4, 2, 16), (1, 1, 8)):
        ours = NGramDrafter(max_n, min_n, max_scan)
        theirs = JaxNGramDrafter(max_n, min_n, max_scan)
        for _ in range(60):
            hist = rng.integers(0, 5, size=int(rng.integers(0, 40))).tolist()
            k = int(rng.integers(0, 6))
            assert ours.draft(hist, k) == theirs.draft(hist, k)
            cases += bool(ours.draft(hist, k))
    assert cases > 50       # most seeded histories do draft
    with pytest.raises(ValueError):
        NGramDrafter(max_n=1, min_n=2)


def verify_after_prefill(dec, jax_side: bool):
    """Prefill PROMPTS[:3] into slots 0-2, then one verify step with a
    4-token window (one slot drafting 2 tokens, one slot inactive)."""
    mgr = dec.manager
    s, k = dec.max_slots, 4
    seeds = (np.zeros((s, 2), np.uint32) if jax_side
             else np.zeros((s,), np.int64))
    tokens = np.zeros((s, k), np.int32)
    lengths = np.zeros((s,), np.int32)
    n_valid = np.zeros((s,), np.int32)
    for slot, p in enumerate(PROMPTS[:3]):
        mgr.assign(slot, [], mgr.blocks_for(len(p) + k))
        tok = dec.prefill(mgr.tables[slot], p, 0, len(p), seeds[slot], 0.0)
        tokens[slot] = [int(tok), p[-3], p[-2], p[-1]]
        lengths[slot] = len(p)
        n_valid[slot] = 4
    n_valid[1] = 3          # the last column writes to the trash block
    out = dec.verify(tokens, lengths, seeds, np.zeros((s,), np.float32),
                     mgr.tables, n_valid)
    return np.asarray(out), lengths + n_valid


def test_verify_matches_jax(models):
    jm, tm = models
    jdec, tdec = paged(jm), paged(tm)
    want, lengths = verify_after_prefill(jdec, True)
    got, _ = verify_after_prefill(tdec, False)
    assert got.shape == (4, 4)
    assert np.array_equal(got[:3], want[:3])
    assert np.array_equal(jdec.manager.tables, tdec.manager.tables)
    bs = PAGED_KW["block_size"]
    for jp, tp_ in zip(jdec.pools, tdec.pools):
        for kv in ("k", "v"):
            jarr, tarr = np.asarray(jp[kv]), tp_[kv].numpy()
            for slot, n in enumerate(lengths[:3]):
                t = np.arange(n)
                table = tdec.manager.tables[slot]
                np.testing.assert_allclose(
                    tarr[table[t // bs], :, t % bs],
                    jarr[table[t // bs], :, t % bs], atol=POOL_TOL,
                    rtol=POOL_TOL)


def test_verify_rows_equal_sequential_decode(models):
    """Row j of a verify window is what decode computes at position
    lengths + j with the drafts committed: feed verify the greedy
    stream itself and every row must reproduce it."""
    _, tm = models
    ref, _, _ = serve(Engine, paged(tm), PROMPTS[:1], max_tokens=6)
    dec = paged(tm)
    mgr = dec.manager
    p = PROMPTS[0]
    mgr.assign(0, [], mgr.blocks_for(len(p) + 5))
    first = int(dec.prefill(mgr.tables[0], p, 0, len(p), 0, 0.0))
    assert first == ref[0][0]
    s = dec.max_slots
    tokens = np.zeros((s, 5), np.int64)
    tokens[0] = ref[0][:5]
    n_valid = np.array([5] + [0] * (s - 1))
    out = dec.verify(tokens, np.array([len(p)] + [0] * (s - 1)),
                     np.zeros(s, np.int64), np.zeros(s, np.float32),
                     mgr.tables, n_valid)
    assert out[0].tolist() == ref[0][1:6]


def test_greedy_equals_plain_and_jax(models):
    jm, tm = models
    ref, ref_fr, _ = serve(Engine, paged(tm), PROMPTS[:4])
    got, got_fr, eng = serve(Engine, paged(tm), PROMPTS[:4], speculate_k=4)
    jgot, jfr, jeng = serve(JaxEngine, paged(jm), PROMPTS[:4],
                            speculate_k=4)
    assert got == ref and got_fr == ref_fr
    assert got == jgot and got_fr == jfr
    s, js = eng.recorder.summary(), jeng.recorder.summary()
    assert s["accept_rate"] > 0 and s["tokens_per_step"] > 1.0
    for key in ("accept_rate", "tokens_per_step", "drafted_tokens",
                "accepted_tokens"):
        assert s[key] == js[key], key


def test_temperature_equals_plain(models):
    """Sampling folds each row's seed with its own position, so
    accept-by-equality holds at every temperature."""
    _, tm = models
    temps = [0.0, 0.9, 0.7, 1.3]
    ref, _, _ = serve(Engine, paged(tm), PROMPTS[:4], temps=temps)
    got, _, eng = serve(Engine, paged(tm), PROMPTS[:4], temps=temps,
                        speculate_k=4)
    assert got == ref
    assert eng.recorder.summary()["drafted_tokens"] > 0


def test_batched_equals_alone(models):
    """6 requests through 4 slots (evictions and refills mid-run) equal
    each request served alone and the plain stream."""
    _, tm = models
    dec = paged(tm)
    plain, _, _ = serve(Engine, dec, PROMPTS)
    alone = [serve(Engine, dec, [p], speculate_k=4)[0][0] for p in PROMPTS]
    batched, _, _ = serve(Engine, dec, PROMPTS, speculate_k=4)
    assert alone == plain and batched == plain


def test_eos_mid_window_exact_count(models):
    _, tm = models
    dec = paged(tm)
    base, _, _ = serve(Engine, dec, PROMPTS[:1])
    eos = base[0][len(base[0]) // 2]
    ref, ref_fr, _ = serve(Engine, dec, PROMPTS[:1], eos_id=eos)
    got, got_fr, _ = serve(Engine, dec, PROMPTS[:1], eos_id=eos,
                           speculate_k=4)
    assert got == ref and got_fr == ref_fr == ["eos"]
    assert got[0][-1] == eos and eos not in got[0][:-1]


@pytest.mark.parametrize("max_tokens", [2, 3, 5, 7])
def test_max_tokens_mid_window_no_overshoot(models, max_tokens):
    _, tm = models
    dec = paged(tm)
    ref, ref_fr, _ = serve(Engine, dec, PROMPTS[:2], max_tokens=max_tokens)
    got, got_fr, _ = serve(Engine, dec, PROMPTS[:2], max_tokens=max_tokens,
                           speculate_k=4)
    assert got == ref and got_fr == ref_fr
    assert all(len(t) == max_tokens for t in got)


def test_max_seq_inside_window(models):
    _, tm = models
    dec = paged(tm, max_seq=16)
    prompt = PROMPTS[0]                 # 7 tokens: 9 rows left
    ref, ref_fr, _ = serve(Engine, dec, [prompt], max_tokens=50)
    got, got_fr, _ = serve(Engine, dec, [prompt], max_tokens=50,
                           speculate_k=4)
    assert got == ref and got_fr == ref_fr == ["max_seq"]
    assert len(got[0]) == dec.max_seq - len(prompt) + 1


def test_block_scarcity_degrades_window(models):
    """A pool sized so one-token decode just fits: the speculative run
    shrinks its windows instead of finishing ``no_blocks``."""
    _, tm = models
    ref, ref_fr, _ = serve(Engine, paged(tm, max_slots=2, n_blocks=8),
                           PROMPTS[:2], max_tokens=8)
    got, got_fr, _ = serve(Engine, paged(tm, max_slots=2, n_blocks=8),
                           PROMPTS[:2], max_tokens=8, speculate_k=4)
    assert got == ref and got_fr == ref_fr


class WrongDrafter:
    """Proposes the true continuation shifted by one in the vocab:
    every draft is rejected."""

    def __init__(self, truth, prompts, vocab):
        self.truth = {tuple(p): t for p, t in zip(prompts, truth)}
        self.vocab = vocab

    def draft(self, history, k):
        for p, t in self.truth.items():
            if tuple(history[:len(p)]) == p:
                done = len(history) - len(p)
                return [(x + 1) % self.vocab for x in t[done:done + k]]
        return [0] * k


def test_wrong_drafter_degrades_to_one_token_a_step(models):
    _, tm = models
    dec = paged(tm)
    ref, ref_fr, _ = serve(Engine, dec, PROMPTS[:3])
    got, got_fr, eng = serve(
        Engine, dec, PROMPTS[:3], speculate_k=4,
        drafter=WrongDrafter(ref, PROMPTS[:3], SMALL["vocab"]))
    assert got == ref and got_fr == ref_fr
    s = eng.recorder.summary()
    assert s["accept_rate"] == 0.0 and s["tokens_per_step"] == 1.0
    assert s["drafted_tokens"] > 0


def test_v1_refuses_and_k1_is_off(models):
    _, tm = models
    with pytest.raises(NotImplementedError, match="paged"):
        Engine(tm.make_decoder(**V1_KW), speculate_k=4)
    dec = paged(tm)
    ref, _, _ = serve(Engine, dec, PROMPTS[:2])
    got, _, eng = serve(Engine, dec, PROMPTS[:2], speculate_k=1)
    assert got == ref and eng.drafter is None
    assert eng.recorder.summary()["accept_rate"] is None


def test_window_beyond_kernel_rows_refused_on_the_card(models):
    """K4 cuts a (slot, kv head)'s query rows into groups of 16, so no
    window is refused on a card any more: an engine over a decoder that
    claims a card builds at 16 rows and past them (speculate_k 9 at rep
    2: 18 rows), and serves the one-token ids on the CPU at that k.
    (The decoder is built on the CPU and only claims a card: the engine
    reads ``decoder.device``.)"""
    _, tm = models
    dec = paged(tm)
    assert dec._rep == 2
    ref, _, _ = serve(Engine, dec, PROMPTS[:2])
    got, _, _ = serve(Engine, dec, PROMPTS[:2], speculate_k=9)
    assert got == ref
    dec.device = torch.device("cuda", 0)
    for k in (8, 9, 32):
        assert Engine(dec, speculate_k=k).speculate_k == k
