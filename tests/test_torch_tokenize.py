"""The tokenizer front door in the port: the copied ``ByteTokenizer``
encodes and decodes as the JAX one does, the copied
``TokenizeService`` batches concurrent callers into sweeps and records
them, and ``Engine.submit_text`` gives the ids of ``submit(encode)``."""

import threading

import pytest

from theanompi_tpu.serving import ByteTokenizer as JaxByteTokenizer
from theanompi_tpu_torch.models import Llama
from theanompi_tpu_torch.serving import ByteTokenizer, Engine, TokenizeService

from test_torch_decoder import SMALL

pytestmark = pytest.mark.serving

TEXTS = ["", "hello", "héllo wörld ✓", "tabs\tand\nnewlines", "🙂" * 3,
         "".join(chr(c) for c in range(32, 127))]


@pytest.mark.parametrize("offset", [0, 3, 7])
def test_byte_tokenizer_equals_jax(offset):
    ours, theirs = ByteTokenizer(offset), JaxByteTokenizer(offset)
    assert ours.vocab_size == theirs.vocab_size == 256 + offset
    for t in TEXTS:
        ids = ours.encode(t)
        assert ids == theirs.encode(t)
        assert ours.decode(ids) == theirs.decode(ids) == t
    junk = [0, 1, 2, offset + 0xC3, 300, offset + 65]
    assert ours.decode(junk) == theirs.decode(junk)
    assert ours.encode_batch(TEXTS) == theirs.encode_batch(TEXTS)
    assert ours.decode_batch([[offset + 65]] * 2) == ["A", "A"]
    with pytest.raises(ValueError):
        ByteTokenizer(-1)


def test_service_batches_concurrent_callers():
    svc = TokenizeService(ByteTokenizer(), max_batch=4)
    out = [None] * 16
    go = threading.Barrier(16)

    def call(i):
        go.wait()
        out[i] = svc.tokenize(f"request {i}")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    tok = ByteTokenizer()
    assert out == [tok.encode(f"request {i}") for i in range(16)]
    assert svc.detokenize(out[3]) == "request 3"
    st = svc.stats()
    assert st["items"] == 17 and st["sweeps"] <= 17
    svc.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        svc.tokenize("late")


def test_submit_text_equals_submit_encode():
    model = Llama(dict(SMALL, vocab=259), device="cpu")
    tok = ByteTokenizer()
    texts = ["the cat", "sat on the mat", "ok"]
    eng = Engine(model.make_decoder(paged=True, max_slots=2, max_seq=48,
                                    block_size=4, prefill_chunk=8),
                 tokenizer=tok)
    try:
        by_text = [eng.submit_text(t, max_tokens=5, seed=i)
                   for i, t in enumerate(texts)]
        by_ids = [eng.submit(tok.encode(t), max_tokens=5, seed=i)
                  for i, t in enumerate(texts)]
        eng.run_until_idle()
        a = [f.result(timeout=0).tokens for f in by_text]
        b = [f.result(timeout=0).tokens for f in by_ids]
        assert a == b and all(len(t) == 5 for t in a)
        assert eng.decode_text(tok.encode("round trip")) == "round trip"
        summ = eng.recorder.summary()
        assert summ["tokenize_items"] == 4
    finally:
        eng.stop()
    with pytest.raises(RuntimeError, match="tokenizer"):
        Engine(eng.decoder).submit_text("no service")
