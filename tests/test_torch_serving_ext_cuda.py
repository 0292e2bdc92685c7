"""The rest of one-engine serving on the card: ``PagedLlamaDecoder
.verify`` on the card against the CPU (a small fp32 model, one set of
weights: equal token matrices, pools within 1e-4 — fp32 sums in another
order), kernel K4 launched by every verify layer at the 16-row shape on
the tensor-core route and never the gather path, and a bf16 KV handoff
round trip (``uint16`` bits) between two decoders on the card.  Marked
``cuda``; each test skips where no CUDA device is present.  Run on the
card with ``python -m pytest --noconftest
tests/test_torch_serving_ext_cuda.py``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SMALL = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256,
             vocab=256, seq_len=128, compute_dtype="float32", seed=3)
KW = dict(max_slots=4, max_seq=96, block_size=16, prefill_chunk=64)
PROMPTS = [[5, 9, 5, 9, 5, 9, 5, 9, 5], list(range(1, 40)),
           [7, 7, 7, 7, 7, 7], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def models(dev, **over):
    from theanompi_tpu_torch.models import Llama

    cfg = dict(SMALL, **over)
    gpu = Llama(cfg, device=dev)
    params = {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v]
                  if k == "layers" else v.cpu())
              for k, v in gpu.params.items()}
    return gpu, Llama(cfg, device="cpu", params=params)


def verify_window(dec):
    """Prefill every prompt into its own slot, then one 4-token verify
    window a slot, then free the slots: (the [S, 4] token matrix, the
    lengths written, the tables they were written through)."""
    mgr = dec.manager
    s = dec.max_slots
    tokens = np.zeros((s, 4), np.int64)
    lengths = np.zeros((s,), np.int64)
    for slot, p in enumerate(PROMPTS):
        mgr.assign(slot, [], mgr.blocks_for(len(p) + 4))
        tok = dec.prefill(mgr.tables[slot], p, 0, len(p), slot, 0.0)
        tokens[slot] = [int(tok)] + p[-3:]
        lengths[slot] = len(p)
    out = dec.verify(tokens, lengths, np.arange(s), np.zeros(s, np.float32),
                     mgr.tables, np.full((s,), 4))
    tables = mgr.tables.copy()
    for slot in range(len(PROMPTS)):
        mgr.free_slot(slot)
    return out, lengths + 4, tables


def test_verify_on_the_card_matches_the_cpu(dev):
    gpu, cpu = models(dev)
    dg, dc = gpu.make_decoder(paged=True, **KW), cpu.make_decoder(
        paged=True, **KW)
    got, lengths, tables = verify_window(dg)
    want, _, _ = verify_window(dc)
    assert np.array_equal(got, want)
    bs = KW["block_size"]
    for pg, pc in zip(dg.pools, dc.pools):
        for kv in ("k", "v"):
            for slot, n in enumerate(lengths):
                t = np.arange(n)
                table = tables[slot]
                np.testing.assert_allclose(
                    pg[kv].cpu().numpy()[table[t // bs], :, t % bs],
                    pc[kv].numpy()[table[t // bs], :, t % bs],
                    atol=1e-4, rtol=1e-4)


def test_verify_launches_k4_at_16_rows_on_the_tensor_cores(dev,
                                                            monkeypatch):
    from theanompi_tpu_torch.serving import Engine
    from theanompi_tpu_torch.serving import paged_attention as pa

    gpu, _ = models(dev, compute_dtype="bfloat16", dim=512, n_heads=8,
                    n_kv_heads=2)                   # hd 64, rep 4
    dec = gpu.make_decoder(paged=True, **KW)

    def gather_path(*a, **k):
        raise AssertionError("verify on the card took the gather path")

    monkeypatch.setattr(pa, "paged_attend_reference", gather_path)
    fn = pa.paged_attend_cuda
    fn.launches, fn.tc_launches, fn.launches_by_rows = 0, 0, {}
    out, _, _ = verify_window(dec)
    assert out.shape == (4, 4) and ((0 <= out) & (out < 256)).all()
    assert (fn.launches, fn.tc_launches) == (2, 2)
    assert fn.launches_by_rows == {16: 2}
    # an engine at speculate_k = 4 serves through the same shape
    eng = Engine(dec, speculate_k=4, prefix_caching=False)
    futs = [eng.submit(p, max_tokens=12) for p in PROMPTS]
    eng.run_until_idle()
    assert all(f.result(timeout=0).status == "ok" for f in futs)
    assert set(fn.launches_by_rows) == {16}
    # past one row group: speculate_k = 5 is 20 rows, two groups
    fn.launches_by_rows = {}
    eng = Engine(dec, speculate_k=5, prefix_caching=False)
    futs = [eng.submit(p, max_tokens=12) for p in PROMPTS]
    eng.run_until_idle()
    assert all(f.result(timeout=0).status == "ok" for f in futs)
    assert set(fn.launches_by_rows) == {20}


def test_bf16_handoff_round_trip_on_the_card(dev):
    from theanompi_tpu_torch.serving import Engine, Request, kv_transfer

    gpu, _ = models(dev, compute_dtype="bfloat16")
    a, b = (gpu.make_decoder(paged=True, **KW) for _ in range(2))

    def run(dec, reqs):
        eng = Engine(dec, prefix_caching=False)
        futs = [eng.submit(r) for r in reqs]
        eng.run_until_idle()
        return [f.result(timeout=0) for f in futs]

    want = [r.tokens for r in run(b, [Request(prompt=p, max_tokens=8)
                                      for p in PROMPTS])]
    pre = run(a, [Request(prompt=p, max_tokens=8, prefill_only=True)
                  for p in PROMPTS])
    h = pre[1].handoff
    assert h["dtype"] == "bfloat16" and h["layers"][0]["k"].dtype == np.uint16
    assert kv_transfer.handoff_bytes(h) == (2 * SMALL["n_layers"]
                                            * h["n_blocks"] * 2 * 16 * 32 * 2)
    got = run(b, [Request(prompt=p, max_tokens=8, handoff=r.handoff)
                  for p, r in zip(PROMPTS, pre)])
    assert [r.tokens for r in got] == want
    b.manager.assign(0, [], h["n_blocks"])
    kv_transfer.inject_handoff(b, b.manager, 0, h)
    back = b.export_blocks(b.manager.slot_blocks(0, h["n_blocks"]))
    for x, y in zip(h["layers"], back):
        np.testing.assert_array_equal(x["k"], y["k"])
        np.testing.assert_array_equal(x["v"], y["v"])
