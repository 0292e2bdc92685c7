"""Decoder parity: the port's ``LlamaDecoder`` and ``PagedLlamaDecoder``
(on the CPU: the plain versions of kernels K1 and K4) against the JAX
package's, with the same weights (carried across by
``params_from_jax``) and the same prompts.  Prefill plus 16 greedy
decode steps must give equal ids, and the KV cache / block pools must
agree within fp32 atol 1e-5 on the rows the requests own (trash-block
and padding rows hold garbage by design and are not compared).

The helpers below drive each decoder's host API directly (v1: a slot
per prompt; paged: blocks assigned through the decoder's own block
manager, prompts prefilled chunk by chunk)."""

import numpy as np
import pytest

import jax
import torch

from theanompi_tpu.models.llama import Llama as JaxLlama
from theanompi_tpu.parallel import make_mesh
from theanompi_tpu_torch.models import Llama, params_from_jax
from theanompi_tpu_torch.serving import Engine

pytestmark = pytest.mark.serving

SMALL = dict(
    dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
    vocab=64, seq_len=64, batch_size=4, lr=1e-2,
    n_train=64, n_val=32, compute_dtype="float32", remat=False,
)
PROMPTS = [
    [1, 5, 9, 3, 17],
    [2, 9, 4, 7, 5, 11, 3, 8, 6, 1, 13, 22, 40, 7, 30, 2, 19],
    [33, 2, 61, 18, 9, 27, 44, 3, 12],
]
N_STEPS = 16
ATOL = 1e-5
V1_KW = dict(max_slots=4, max_seq=48)
PAGED_KW = dict(max_slots=4, max_seq=48, block_size=4, prefill_chunk=8)


def jax_model(devices):
    m = JaxLlama(dict(SMALL))
    m.build_model(n_replicas=1)
    m.compile_iter_fns(mesh=make_mesh(data=1, model=1, devices=devices[:1]))
    return m


def port_model(jm) -> Llama:
    params = params_from_jax(jax.device_get(jm.params), SMALL, "cpu")
    return Llama(SMALL, device="cpu", params=params)


@pytest.fixture(scope="module")
def models(devices8):
    jm = jax_model(devices8)
    return jm, port_model(jm)


class Keys:
    """Per-package sampling-key plumbing (unused by greedy decoding,
    but part of each host API): JAX takes uint32 key pairs, the port
    integer seeds."""

    def __init__(self, jax_side: bool, s: int):
        self.jax_side = jax_side
        self.batch = (np.zeros((s, 2), np.uint32) if jax_side
                      else np.zeros((s,), np.int64))

    def one(self):
        return np.zeros((2,), np.uint32) if self.jax_side else 0


def greedy_v1(dec, jax_side: bool):
    s = dec.max_slots
    keys = Keys(jax_side, s)
    tokens = np.zeros((s,), np.int32)
    lengths = np.zeros((s,), np.int32)
    temps = np.zeros((s,), np.float32)
    n = len(PROMPTS)
    for slot, p in enumerate(PROMPTS):
        tokens[slot] = dec.prefill(slot, p, keys.one(), 0.0)
        lengths[slot] = len(p)
    out = [tokens[:n].tolist()]
    for _ in range(N_STEPS):
        nxt = np.asarray(dec.decode(tokens, lengths, keys.batch, temps))
        lengths[:n] += 1
        tokens[:n] = nxt[:n]
        out.append(tokens[:n].tolist())
    return np.array(out).T, lengths[:n].copy()


def greedy_paged(dec, jax_side: bool):
    s = dec.max_slots
    keys = Keys(jax_side, s)
    mgr = dec.manager
    bs = dec.block_size
    tokens = np.zeros((s,), np.int32)
    lengths = np.zeros((s,), np.int32)
    temps = np.zeros((s,), np.float32)
    active = np.zeros((s,), bool)
    n = len(PROMPTS)
    for slot, p in enumerate(PROMPTS):
        mgr.assign(slot, [], mgr.blocks_for(len(p) + 1))
        pos, tok = 0, None
        while pos < len(p):
            c = min(dec.prefill_chunk, len(p) - pos)
            tok = dec.prefill(mgr.tables[slot], p[pos:pos + c], pos, c,
                              keys.one(), 0.0)
            pos += c
        tokens[slot] = int(tok)
        lengths[slot] = len(p)
        active[slot] = True
    out = [tokens[:n].tolist()]
    for _ in range(N_STEPS):
        for slot in range(n):
            mgr.grow(slot, int(lengths[slot]) // bs)
        nxt = np.asarray(dec.decode(tokens, lengths, keys.batch, temps,
                                    mgr.tables, active))
        lengths[:n] += 1
        tokens[:n] = nxt[:n]
        out.append(tokens[:n].tolist())
    return np.array(out).T, lengths[:n].copy()


def owned_rows(pool, table, length, bs):
    """[length, Hkv, hd] rows of one slot's positions [0, length)."""
    t = np.arange(length)
    return pool[table[t // bs], :, t % bs]


def test_v1_prefill_and_decode_match_jax(models):
    jm, tm = models
    jdec, tdec = jm.make_decoder(**V1_KW), tm.make_decoder(**V1_KW)
    want, lengths = greedy_v1(jdec, True)
    got, _ = greedy_v1(tdec, False)
    assert got.shape == (len(PROMPTS), N_STEPS + 1)
    assert np.array_equal(got, want)
    for jc, tc in zip(jdec.cache, tdec.cache):
        for kv in ("k", "v"):
            jarr = np.asarray(jc[kv])
            for slot, n in enumerate(lengths):
                np.testing.assert_allclose(
                    tc[kv][slot, :, :n].numpy(), jarr[slot, :, :n],
                    atol=ATOL, rtol=0,
                )


def test_paged_prefill_and_decode_match_jax(models):
    jm, tm = models
    jdec = jm.make_decoder(paged=True, **PAGED_KW)
    tdec = tm.make_decoder(paged=True, **PAGED_KW)
    want, lengths = greedy_paged(jdec, True)
    got, _ = greedy_paged(tdec, False)
    assert np.array_equal(got, want)
    # both managers allocate deterministically: identical tables
    assert np.array_equal(jdec.manager.tables, tdec.manager.tables)
    bs = PAGED_KW["block_size"]
    for jp, tp_ in zip(jdec.pools, tdec.pools):
        for kv in ("k", "v"):
            jarr, tarr = np.asarray(jp[kv]), tp_[kv].numpy()
            for slot, n in enumerate(lengths):
                table = tdec.manager.tables[slot]
                np.testing.assert_allclose(
                    owned_rows(tarr, table, n, bs),
                    owned_rows(jarr, table, n, bs), atol=ATOL, rtol=0,
                )


def test_v1_and_paged_agree_in_the_port(models):
    _, tm = models
    v1, _ = greedy_v1(tm.make_decoder(**V1_KW), False)
    paged, _ = greedy_paged(tm.make_decoder(paged=True, **PAGED_KW), False)
    assert np.array_equal(v1, paged)


def serve(dec, prompt, **ekw):
    eng = Engine(dec, **ekw)
    f = eng.submit(prompt, max_tokens=6, seed=3)
    eng.run_until_idle()
    r = f.result(timeout=0)
    assert r.status == "ok"
    return r.tokens, eng


def test_chunked_prefix_hit_equals_cold(models):
    """A prompt whose blocks are adopted from the radix cache (only the
    divergent tail prefills, chunked) gives the cold prefill's ids,
    with the hit counted and copy-on-write fired on the first write
    into the adopted partial block."""
    _, tm = models
    dec = tm.make_decoder(paged=True, **PAGED_KW)
    prompt = [2, 9, 4, 7, 5, 11, 3, 8, 6, 1, 13, 22]   # 3 blocks at bs=4
    cold, _ = serve(dec, prompt, prefix_caching=False)
    assert serve(dec, prompt)[0] == cold          # populates the cache
    cow_before = dec.manager.allocator.n_cow
    hit, eng = serve(dec, prompt)
    assert hit == cold
    summ = eng.recorder.summary()
    assert summ["prefix_hit_tokens"] == len(prompt) - 1
    assert dec.manager.allocator.n_cow > cow_before
    # a longer prompt sharing the prefix: partial adoption + chunks
    longer = prompt + [17, 3, 9, 41, 5, 6, 12, 8, 1]
    cold_long, _ = serve(dec, longer, prefix_caching=False)
    hit_long, eng = serve(dec, longer)
    assert hit_long == cold_long
    assert eng.recorder.summary()["prefix_hit_tokens"] >= 8


def test_copy_block_copies_every_layer(models):
    _, tm = models
    dec = tm.make_decoder(paged=True, **PAGED_KW)
    for pool in dec.pools:
        pool["k"][3].normal_()
        pool["v"][3].normal_()
    dec.copy_block(3, 5)
    for pool in dec.pools:
        assert torch.equal(pool["k"][5], pool["k"][3])
        assert torch.equal(pool["v"][5], pool["v"][3])


def test_bucket_and_chunk_refusals(models):
    _, tm = models
    v1 = tm.make_decoder(**V1_KW)
    assert v1.prefill_buckets == (16, 32, 47)
    assert v1.bucket_for(17) == 32
    with pytest.raises(ValueError, match="servable range"):
        v1.bucket_for(48)
    paged = tm.make_decoder(paged=True, **PAGED_KW)
    assert paged.bucket_for(30) == 8
    with pytest.raises(ValueError, match="paged decode needs"):
        paged.decode([0] * 4, [0] * 4, [0] * 4, [0.0] * 4)
