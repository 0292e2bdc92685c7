"""The port's hot-path sanitizer (``theanompi_tpu_torch/analysis/
hotpath.py``): TM104, torch's host syncs in a hot function.  The JAX
package's ``tests/test_tmcheck_hotpath.py`` fixtures in torch idiom
(``.item()``/``.tolist()``/``.cpu()`` and ``int()``/``float()``/
``np.asarray`` of a tensor inside a loop, ``synchronize`` anywhere),
each beside its clean twin: the per-chunk fence in chunked prefill,
the verify window, the tracer's span bodies, the loader's producer —
and the K-step training chunk, whose loop must stay fence-free.
Its fixtures of TM105 and TM106 (traced JAX bodies) have no torch
counterpart.
"""

import textwrap

from theanompi_tpu_torch.analysis import core, hotpath


def run(src: str) -> list:
    sf = core.SourceFile(textwrap.dedent(src), "fixture.py")
    return core.collect([sf], rule_fns=(hotpath.check_file,))


def rules_of(findings) -> list:
    return [f.rule for f in findings]


class TestHostFences:
    def test_per_chunk_int_fence_flagged(self):
        # chunked prefill reading each chunk's token back to the host
        # inside the chunk loop
        out = run("""
            import torch

            class Dec:
                def prefill(self, ids):
                    pos = 0
                    tok = None
                    while pos < len(ids):
                        out = torch.argmax(self._forward(ids[pos:pos + 8]))
                        tok = int(out)
                        pos += 8
                    return tok
        """)
        assert rules_of(out) == ["TM104"]
        assert "per-iteration int()" in out[0].message

    def test_one_fence_after_loop_clean(self):
        # the discipline: launches stay asynchronous, ONE sync at the
        # end (the prefill's TTFT fence)
        out = run("""
            import torch

            class Dec:
                def prefill(self, ids):
                    pos = 0
                    out = None
                    while pos < len(ids):
                        out = torch.argmax(self._forward(ids[pos:pos + 8]))
                        pos += 8
                    return int(out)
        """)
        assert out == []

    def test_untainted_int_in_loop_clean(self):
        # host bookkeeping ints are not fences
        out = run("""
            class Eng:
                def step(self, slots):
                    n = 0
                    for s in slots:
                        n += int(s.budget)
                    return n
        """)
        assert out == []

    def test_item_tolist_cpu_in_loop_flagged(self):
        out = run("""
            import torch

            class Dec:
                def decode(self, xs):
                    out = []
                    for x in xs:
                        y = torch.exp(x)
                        out.append(y.item())
                        out.append(y.tolist())
                        out.append(y.cpu())
                    return out
        """)
        assert rules_of(out) == ["TM104"] * 3
        assert ".item()" in out[0].message

    def test_one_readback_after_loop_clean(self):
        out = run("""
            import torch

            class Dec:
                def decode(self, xs):
                    ys = [torch.exp(x) for x in xs]
                    return torch.stack(ys).tolist()
        """)
        assert out == []

    def test_readback_in_comprehension_flagged(self):
        # a comprehension is a loop: one wait a element
        out = run("""
            import torch

            class Dec:
                def decode(self, xs):
                    return [torch.exp(x).item() for x in xs]
        """)
        assert rules_of(out) == ["TM104"]

    def test_iterable_of_for_is_evaluated_once_clean(self):
        out = run("""
            import torch

            class Dec:
                def decode(self, logits):
                    out = []
                    for tok in torch.argmax(logits, -1).tolist():
                        out.append(tok)
                    return out
        """)
        assert out == []

    def test_synchronize_flagged_anywhere(self):
        out = run("""
            import torch

            class Dec:
                def decode(self, x):
                    y = torch.exp(x)
                    torch.cuda.synchronize()
                    self._done.synchronize()
                    return y
        """)
        assert rules_of(out) == ["TM104", "TM104"]
        assert "synchronize" in out[0].message

    def test_np_asarray_of_tensor_in_loop_flagged(self):
        out = run("""
            import numpy as np
            import torch

            class Dec:
                def decode_step(self, chunks):
                    outs = []
                    for c in chunks:
                        y = torch.softmax(c, -1)
                        outs.append(np.asarray(y))
                    return outs
        """)
        assert rules_of(out) == ["TM104"]

    def test_bool_of_tensor_in_loop_flagged(self):
        out = run("""
            import torch

            class Dec:
                def decode_step(self, chunks):
                    for c in chunks:
                        if bool(torch.isnan(c).any()):
                            return False
                    return True
        """)
        assert rules_of(out) == ["TM104"]

    def test_non_hot_function_exempt(self):
        out = run("""
            import torch

            class Dec:
                def gather(self, chunks):
                    outs = []
                    for c in chunks:
                        outs.append(int(torch.argmax(c)))
                    return outs
        """)
        assert out == []

    def test_hot_marker_opts_in(self):
        out = run("""
            import torch

            class Dec:
                def gather(self, chunks):  # tmcheck: hot
                    outs = []
                    for c in chunks:
                        outs.append(int(torch.argmax(c)))
                    return outs
        """)
        assert rules_of(out) == ["TM104"]

    def test_test_functions_exempt(self):
        out = run("""
            import torch

            def test_decode_roundtrip(dec, chunks):
                for c in chunks:
                    assert int(torch.argmax(c)) >= 0
                    assert c.item() is not None
        """)
        assert out == []


class TestTrainChunk:
    """``train_chunk`` is seeded hot: its K steps run with no host fence
    among them, the K (loss, err) pairs read once, after the loop."""

    def test_item_in_chunk_loop_flagged(self):
        out = run("""
            import torch

            class Model:
                def train_chunk(self, count, k, recorder):
                    for _ in range(k):
                        stats = self._train_step(*self._cached_batch())
                        recorder.train_error(count, stats[0].item(), 0.0)
        """)
        assert rules_of(out) == ["TM104"]
        assert "train_chunk (hot path)" in out[0].message

    def test_stacked_metrics_after_loop_clean(self):
        # the shipped shape: the pairs stay on the device, meaned and
        # recorded once a chunk
        out = run("""
            import torch

            class Model:
                def train_chunk(self, count, k, recorder):
                    rows = []
                    for _ in range(k):
                        rows.append(self._train_step(*self._cached_batch()))
                    stats = self._rank_mean(torch.stack(rows))
                    recorder.train_error(count, stats[:, 0], stats[:, 1])
        """)
        assert out == []

    def test_per_step_float_of_loss_flagged(self):
        out = run("""
            import torch

            class Model:
                def train_chunk(self, count, k, recorder):
                    total = 0.0
                    for _ in range(k):
                        loss = torch.stack(self._train_step())[0]
                        total += float(loss)
                    return total
        """)
        assert rules_of(out) == ["TM104"]


class TestSuppressionTracking:
    def test_suppressed_fence_and_stale_marker(self):
        out = run("""
            import torch

            class Dec:
                def prefill(self, ids):
                    toks = []
                    for c in ids:
                        y = torch.argmax(c)
                        toks.append(int(y))  # tmcheck: disable=TM104
                    n = len(toks)  # tmcheck: disable=TM104
                    return toks
        """)
        # the loop fence is suppressed; the second marker sits on a
        # clean line and is itself flagged as stale
        assert rules_of(out) == ["TM201"]
        assert "matches no finding" in out[0].message

    def test_jax_only_rules_are_unknown(self):
        # TM105/TM106 (traced JAX bodies) are not rules of the port
        out = run("""
            def helper():
                return 1  # tmcheck: disable=TM105
        """)
        assert rules_of(out) == ["TM201"]
        assert "unknown rule id" in out[0].message


class TestSpeculativeVerifyFences:
    """The speculative hot path (seeds "verify"/"draft"): a per-draft
    token readback inside the verify loop serializes the window the
    one verify call exists to batch."""

    def test_per_draft_token_int_fence_flagged(self):
        out = run("""
            import torch

            class Eng:
                def _spec_verify(self, drafts):
                    toks = []
                    for d in drafts:
                        out = torch.argmax(self._verify_logits(d), -1)
                        toks.append(int(out))
                    return toks
        """)
        assert rules_of(out) == ["TM104"]
        assert "per-iteration int()" in out[0].message

    def test_one_verify_call_per_window_clean(self):
        out = run("""
            import torch

            class Eng:
                def _spec_verify(self, drafts):
                    out = torch.argmax(self._verify_logits(drafts), -1)
                    return out.tolist()
        """)
        assert out == []

    def test_drafter_is_hot_but_host_pure_clean(self):
        out = run("""
            class Drafter:
                def draft(self, history, k):
                    out = []
                    for n in range(3, 0, -1):
                        if history[-n:] == history[:n]:
                            out = history[n:n + k]
                            break
                    return out
        """)
        assert out == []


class TestTracerSpans:
    """``span``/``start_span``/``end_span``/``record_span`` are seeded:
    a device value read back into a span attribute inside a hot loop is
    the per-iteration round trip TM104 exists for."""

    def test_fence_inside_span_attr_in_hot_loop_flagged(self):
        out = run("""
            import torch

            class Eng:
                def _spec_decode_once(self):
                    for slot in range(8):
                        out = torch.argmax(self.logits[slot])
                        with self.tracer.span(
                            self.ctx, "spec_window", tokens=int(out)
                        ):
                            self.commit(slot)
        """)
        assert "TM104" in rules_of(out)
        assert any("int()" in f.message for f in out)

    def test_host_stamp_only_span_clean(self):
        out = run("""
            class Eng:
                def _spec_decode_once(self):
                    for slot in range(8):
                        with self.tracer.span(
                            self.ctx, "spec_window",
                            tokens=self._step_tokens,
                        ):
                            self.commit(slot)
        """)
        assert out == []

    def test_span_body_is_hot(self):
        out = run("""
            class Tracer:
                def span(self, ctx, name, values):
                    t0 = self.clock()
                    snapshot = [v.item() for v in values]
                    return (t0, snapshot)
        """)
        assert rules_of(out) == ["TM104"]
        assert ".item()" in out[0].message


class TestLoaderProducerFences:
    """The streaming loader's producer loop (seeds "next"/"_produce"):
    a per-batch readback inside it re-serializes what the producer
    thread overlaps."""

    def test_per_batch_float_fence_in_producer_flagged(self):
        out = run("""
            import torch

            class Loader:
                def _produce(self):
                    while True:
                        staged = torch.as_tensor(self._fetch(self._next))
                        self._checksum += float(staged[0])
                        self._ring.append(staged)
        """)
        assert rules_of(out) == ["TM104"]
        assert "per-iteration float()" in out[0].message

    def test_stage_without_value_read_clean(self):
        out = run("""
            import torch

            class Loader:
                def _produce(self):
                    while True:
                        staged = torch.as_tensor(self._fetch(self._next))
                        self._ring.append(staged)
        """)
        assert out == []

    def test_consumer_that_synchronizes_flagged(self):
        out = run("""
            class Loader:
                def next(self, i):
                    staged = self._stage(self._fetch(i))
                    staged.event.synchronize()
                    return staged
        """)
        assert rules_of(out) == ["TM104"]
