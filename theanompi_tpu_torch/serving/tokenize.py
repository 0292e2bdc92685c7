"""Batched tokenize/detokenize — the serving side of the data plane
(a copy of ``theanompi_tpu/serving/tokenize.py``, stdlib only).

The training loops stage batches through a producer thread so the
device never waits on the host (``data/pipeline.py``); the serving
front door has the same disease one layer up: every ``Engine.submit``
caller that starts from *text* pays a tokenizer call inline on the
submit path, per request, on whatever thread submitted.  Under
concurrent load that is pure serialized host work in front of the
queue — the engine's continuous batching starts only after each
request has been encoded one at a time.

:class:`TokenizeService` moves that work behind a thread + queue with
the same shape as the loader's producer: callers hand a string (or
token ids to detokenize) to the service and get a future; a single
daemon worker drains whatever has accumulated — up to ``max_batch``
items per sweep — encodes the sweep as one batch, and resolves the
futures.  Batching is *natural*: while the worker is busy with one
sweep, new requests pile up and form the next one, so a lone caller
pays no artificial linger (``max_wait_s`` adds one only if asked).

Lock discipline (TM103): futures are resolved and the tokenizer runs
strictly OUTSIDE the condition lock — the lock covers only queue
push/pop, exactly like the engine's submit queue.

Telemetry rides :class:`~theanompi_tpu_torch.utils.recorder.ServingRecorder`
(``record_tokenize``): sweeps, items, tokens, and queue-wait seconds,
so ``summary()``/``metrics_txt`` expose the amortization factor
(items per sweep) next to TTFT — if tokenize wait ever shows up in
the tail, the knob to turn is visible in the same place.

:class:`ByteTokenizer` is the dependency-free codec the tests and
benches use: UTF-8 bytes shifted past the special ids, so any text
round-trips through a 256-entry vocab without an external model file.
"""

from __future__ import annotations

import threading
from collections import deque

__all__ = ["ByteTokenizer", "TokenizeFuture", "TokenizeService"]


class ByteTokenizer:
    """UTF-8 byte-level codec: token id = byte value + ``offset``.

    The offset reserves the low ids for specials (pad/bos/eos) so the
    encoding composes with the synthetic LLaMA vocab; ids below the
    offset decode to nothing (they are control tokens, not text).
    """

    def __init__(self, offset: int = 3):
        self.offset = int(offset)
        if self.offset < 0:
            raise ValueError(f"offset must be >= 0, got {self.offset}")

    @property
    def vocab_size(self) -> int:
        return 256 + self.offset

    def encode(self, text: str) -> list:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        off = self.offset
        bs = bytes(
            i - off for i in ids if off <= int(i) < 256 + off
        )
        return bs.decode("utf-8", errors="replace")

    # batch entry points — what the service's worker calls once per
    # sweep.  For the byte codec these are trivial loops; a real
    # tokenizer amortizes setup/FFI cost here, which is the point of
    # sweeping N requests through one call.
    def encode_batch(self, texts) -> list:
        return [self.encode(t) for t in texts]

    def decode_batch(self, ids_list) -> list:
        return [self.decode(ids) for ids in ids_list]


class TokenizeFuture:
    """Resolution handle for one service item — a minimal future
    (Event + value), resolved by the worker thread OUTSIDE the
    service lock (TM103: no ``._set`` under a lock, no inline
    done-callbacks from a lock holder — this class has none)."""

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._err: BaseException | None = None

    def _resolve(self, value) -> None:
        self._value = value
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._err = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout_s: float | None = None):
        if not self._ev.wait(timeout_s):
            raise TimeoutError("tokenize result not ready")
        if self._err is not None:
            raise self._err
        return self._value


class TokenizeService:
    """Thread + queue batching front-end over a tokenizer.

    ``encode_async``/``decode_async`` enqueue and return a
    :class:`TokenizeFuture`; the blocking wrappers ``tokenize``/
    ``detokenize`` are the submit-path entry (``Engine.submit_text``).
    (Deliberately NOT named ``encode``/``decode``: tmcheck's TM102
    receiver resolution is name-based, and a blocking method named
    like ``str.encode`` would make every ``text.encode()`` call site
    in the tree look like it could reach this wait.)
    One daemon worker sweeps the queue: pop up to ``max_batch`` items
    under the lock, run the tokenizer and resolve futures with the
    lock RELEASED.  ``stop()`` drains what was queued before the stop
    and fails anything submitted after it.
    """

    def __init__(self, tokenizer, *, max_batch: int = 64,
                 max_wait_s: float = 0.0, recorder=None):
        self.tokenizer = tokenizer
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}"
            )
        self.max_wait_s = float(max_wait_s)
        self.recorder = recorder
        self._cv = threading.Condition()
        # (kind, payload, enqueue_stamp, future) triples; queue and
        # flags mutate only under _cv (worker + any submitting thread)
        self._q: deque = deque()
        self._stop = False
        self._thread: threading.Thread | None = None
        # exact lifetime counters (worker-thread-owned, folded into
        # the recorder per sweep; read via stats() for tests)
        self.sweeps = 0
        self.items = 0
        self.tokens = 0

    # -- submission (any thread) ------------------------------------------

    def _submit(self, kind: str, payload) -> TokenizeFuture:
        import time

        fut = TokenizeFuture()
        with self._cv:
            if self._stop:
                stopped = True
            else:
                stopped = False
                self._q.append((kind, payload, time.monotonic(), fut))
                self._ensure_thread()
                self._cv.notify()
        if stopped:
            fut._fail(RuntimeError("tokenize service stopped"))
        return fut

    def encode_async(self, text: str) -> TokenizeFuture:
        return self._submit("encode", text)

    def decode_async(self, ids) -> TokenizeFuture:
        return self._submit("decode", list(ids))

    def tokenize(self, text: str, timeout_s: float | None = 30.0):
        return self.encode_async(text).result(timeout_s)

    def detokenize(self, ids, timeout_s: float | None = 30.0) -> str:
        return self.decode_async(ids).result(timeout_s)

    # -- worker -----------------------------------------------------------

    def _ensure_thread(self) -> None:
        # caller holds _cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="tm-tokenize", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        import time

        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(0.1)
                if self._stop and not self._q:
                    return
                if (self.max_wait_s > 0.0
                        and len(self._q) < self.max_batch
                        and not self._stop):
                    # optional linger: trade a bounded wait for a
                    # fuller sweep (off by default — natural batching
                    # from worker busy time needs no added latency)
                    self._cv.wait(self.max_wait_s)
                batch = []
                while self._q and len(batch) < self.max_batch:
                    batch.append(self._q.popleft())
            self._sweep(batch, time.monotonic())

    def _sweep(self, batch: list, now: float) -> None:
        """Run one popped sweep and resolve its futures — no lock
        held: the tokenizer call and ``_resolve`` both happen on this
        thread with the queue free to accumulate the next sweep."""
        enc = [(p, f) for k, p, _, f in batch if k == "encode"]
        dec = [(p, f) for k, p, _, f in batch if k == "decode"]
        wait_s = sum(now - t for _, _, t, _ in batch)
        n_tok = 0
        try:
            if enc:
                outs = self.tokenizer.encode_batch([p for p, _ in enc])
                for (_, fut), ids in zip(enc, outs):
                    n_tok += len(ids)
                    fut._resolve(ids)
            if dec:
                outs = self.tokenizer.decode_batch([p for p, _ in dec])
                for (p, fut), text in zip(dec, outs):
                    n_tok += len(p)
                    fut._resolve(text)
        except Exception as e:  # codec bug: fail the sweep, not the thread
            for _, _, _, fut in batch:
                if not fut.done():
                    fut._fail(e)
        self.sweeps += 1
        self.items += len(batch)
        self.tokens += n_tok
        if self.recorder is not None:
            self.recorder.record_tokenize(
                n_items=len(batch), n_tokens=n_tok, wait_s=wait_s
            )

    def stats(self) -> dict:
        return {
            "sweeps": self.sweeps,
            "items": self.items,
            "tokens": self.tokens,
            "items_per_sweep": (
                self.items / self.sweeps if self.sweeps else None
            ),
        }

    def stop(self) -> None:
        """Drain everything queued before the stop, then park the
        worker; post-stop submissions fail fast (their futures
        resolve with an error — never a hang)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
