"""Engine layer: slot-based continuous batching over a ``LlamaDecoder``
(Orca-style iteration-level scheduling).

Port of ``theanompi_tpu/serving/engine.py``.  The decode batch is
``max_slots`` wide and never restarts: every engine iteration (1) sheds
queued requests whose deadline passed, (2) refills free slots from the
queue — a prefill per admitted request — and (3) runs ONE decode step
for all active slots, evicting slots that hit EOS or ``max_tokens``.

Admission control makes overload a result, never a hang: a full queue
sheds at ``submit`` (``"queue_full"``), an expired queued request sheds
on the next iteration (``"deadline"``).  Every future resolves.

Over a ``PagedLlamaDecoder`` the same loop drives the paged cache:
admission adopts radix-prefix-cached blocks and allocates the rest
(waiting, or shedding ``"no_blocks"`` when nothing in flight can free
any); long prompts prefill in chunks, at most
``prefill_chunks_per_step`` per iteration, with the decode step for
in-flight slots running between chunks; every write position passes
the copy-on-write gate and tables grow as decode crosses block
boundaries.

``submit()`` is thread-safe; the loop runs inline (``run_until_idle``)
or on a background thread (``start``/``stop``).  Telemetry flows
through ``utils.recorder.ServingRecorder``.

Not ported yet (ROADMAP.md): speculative decoding (``speculate_k >=
2``), span tracing, the tokenizer front door and disaggregated KV
handoffs — asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from theanompi_tpu_torch.serving.blocks import OutOfBlocks
from theanompi_tpu_torch.serving.decoder import LlamaDecoder
from theanompi_tpu_torch.utils.recorder import ServingRecorder


@dataclass
class Request:
    """One generation request (all fields host-side).  ``seed`` seeds
    the request's sampling noise (used at temperature > 0)."""

    prompt: list
    max_tokens: int = 16
    temperature: float = 0.0         # <= 0: greedy
    deadline_s: float | None = None  # queue-wait budget from submit
    seed: int = 0
    prefill_only: bool = False       # disaggregation: not ported yet
    handoff: dict | None = None      # disaggregation: not ported yet


@dataclass
class Result:
    """Terminal state of a request.  ``status``: ``"ok"`` or
    ``"shed"``.  ``finish_reason``: ``"eos"``, ``"max_tokens"``,
    ``"max_seq"`` or ``"no_blocks"`` (tokens so far returned) when
    served; ``"queue_full"``, ``"deadline"``, ``"prompt_too_long"``,
    ``"shutdown"`` or ``"no_blocks"`` when shed."""

    status: str
    finish_reason: str
    tokens: list = field(default_factory=list)
    ttft_s: float | None = None   # submit -> first token
    tpot_s: float | None = None   # mean inter-token time after first
    queued_s: float | None = None
    e2e_s: float | None = None


class ServingFuture:
    """Minimal thread-safe future for one request's ``Result``."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Result | None = None

    def _set(self, result: Result) -> None:
        # exactly once, by whichever path owns the entry (submit-time
        # shed, the engine loop, or stop()'s drain after the join)
        self._result = result
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Result:
        if not self._event.wait(timeout):
            raise TimeoutError("serving result not ready")
        return self._result


class _Entry:
    __slots__ = ("request", "future", "submit_t", "deadline_s")

    def __init__(self, request: Request, default_deadline_s: float):
        self.request = request
        self.future = ServingFuture()
        self.submit_t = time.monotonic()
        self.deadline_s = (
            request.deadline_s if request.deadline_s is not None
            else default_deadline_s
        )


class _SlotState:
    __slots__ = ("entry", "generated", "first_tok_t", "last_tok_t",
                 "prompt_len", "state", "pf_pos", "n_prefix_hit")

    def __init__(self, entry: _Entry, prompt_len: int,
                 first_tok: int | None = None, *, state: str = "decode",
                 pf_pos: int = 0, n_prefix_hit: int = 0):
        now = time.monotonic()
        self.entry = entry
        self.generated = [] if first_tok is None else [first_tok]
        self.first_tok_t = now if first_tok is not None else None
        self.last_tok_t = now
        self.prompt_len = prompt_len
        # paged lifecycle: "prefill" (chunks still running; pf_pos =
        # next prompt position) -> "decode"; v1 slots are born "decode"
        self.state = state
        self.pf_pos = pf_pos
        self.n_prefix_hit = n_prefix_hit


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to theanompi_tpu_torch yet (ROADMAP.md "
        f"A11, serving)"
    )


class Engine:
    """Thread-safe continuous-batching front-end over a decoder."""

    def __init__(
        self,
        decoder: LlamaDecoder,
        *,
        queue_cap: int = 64,
        default_deadline_s: float = 60.0,
        eos_id: int | None = None,
        recorder: ServingRecorder | None = None,
        chunked_prefill: bool | None = None,
        prefill_chunks_per_step: int = 1,
        prefix_caching: bool = True,
        speculate_k: int = 0,
        tracer=None,
        tokenizer=None,
    ):
        if int(speculate_k) >= 2:
            raise _unported("speculative decoding (speculate_k >= 2)")
        if tracer is not None:
            raise _unported("span tracing (tracer=)")
        if tokenizer is not None:
            raise _unported("the tokenizer front door (tokenizer=)")
        self.decoder = decoder
        self.queue_cap = int(queue_cap)
        self.default_deadline_s = float(default_deadline_s)
        self.eos_id = eos_id
        s = decoder.max_slots
        self.recorder = recorder or ServingRecorder(max_slots=s)

        self._paged = bool(getattr(decoder, "paged", False))
        self.chunked_prefill = (
            bool(chunked_prefill) if chunked_prefill is not None
            else self._paged
        )
        self.prefill_chunks_per_step = int(prefill_chunks_per_step)
        if self.prefill_chunks_per_step < 1:
            raise ValueError(
                "prefill_chunks_per_step must be >= 1, got "
                f"{self.prefill_chunks_per_step}: a prefilling slot "
                "that advances zero chunks per step never finishes"
            )
        self._mgr = decoder.manager if self._paged else None
        self._prefix = (
            decoder.prefix_cache if self._paged and prefix_caching else None
        )
        # eviction sees the decoder's cache even when this engine does
        # no matching: blocks another engine retained are reclaimable
        self._evictable = decoder.prefix_cache if self._paged else None

        self._lock = threading.Lock()
        self._queue: deque[_Entry] = deque()  # guarded-by: _lock
        self._slots: list[_SlotState | None] = [None] * s
        # device-call mirrors (owned by the engine loop thread)
        self._tokens = np.zeros((s,), np.int64)
        self._lengths = np.zeros((s,), np.int64)
        self._seeds = np.zeros((s,), np.int64)
        self._temps = np.zeros((s,), np.float32)
        self._active = np.zeros((s,), bool)   # paged: decoding slots
        self._step_slots = 0

        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- submission (any thread) ------------------------------------------

    def submit(self, prompt, **kw) -> ServingFuture:
        """Queue one request; returns its future.  A full queue, a prompt
        the decoder cannot hold, or a stopping engine resolves the future
        immediately with a shed result."""
        if isinstance(prompt, Request):
            if kw:
                raise TypeError(
                    f"submit(Request, ...) does not accept keyword "
                    f"overrides {sorted(kw)} — set them on the Request"
                )
            req = prompt
        else:
            req = Request(prompt=list(prompt), **kw)
        if req.prefill_only or req.handoff is not None:
            raise _unported("disaggregated prefill/decode (KV handoffs)")
        entry = _Entry(req, self.default_deadline_s)
        try:
            self.decoder.bucket_for(len(req.prompt))
        except ValueError:
            return self._shed_at_submit(entry, "prompt_too_long")
        if self._paged and (
            self._mgr.blocks_for(len(req.prompt) + 1)
            > self._mgr.allocator.n_blocks
        ):
            return self._shed_at_submit(entry, "no_blocks")
        with self._lock:
            # the shutdown check shares the enqueue's lock hold, so an
            # entry appended with _stop unset is seen by the final drain
            reason = (
                "shutdown" if self._stop.is_set()
                else "queue_full"
                if len(self._queue) >= self.queue_cap else None
            )
            if reason is None:
                self._queue.append(entry)
        if reason is not None:
            return self._shed_at_submit(entry, reason)
        return entry.future

    def _shed_at_submit(self, entry: _Entry, reason: str):
        entry.future._set(Result(
            status="shed", finish_reason=reason, queued_s=0.0,
        ))
        self.recorder.record_request(
            status="shed", finish_reason=reason,
            n_prompt=len(entry.request.prompt), n_generated=0,
        )
        return entry.future

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- engine loop (one owner thread) -----------------------------------

    def _shed(self, entry: _Entry, reason: str, now: float) -> None:
        entry.future._set(Result(
            status="shed", finish_reason=reason,
            queued_s=now - entry.submit_t,
        ))
        self.recorder.record_request(
            status="shed", finish_reason=reason,
            n_prompt=len(entry.request.prompt), n_generated=0,
            queued_s=now - entry.submit_t,
        )

    def _sweep_deadlines(self, now: float) -> None:
        with self._lock:
            keep: deque[_Entry] = deque()
            expired = []
            for entry in self._queue:
                if now - entry.submit_t > entry.deadline_s:
                    expired.append(entry)
                else:
                    keep.append(entry)
            self._queue = keep
        for entry in expired:
            self._shed(entry, "deadline", now)

    def _finish(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        # reset the mirrors: a stale temperature > 0 would force the
        # sampling path on later all-greedy batches
        self._temps[slot] = 0.0
        self._tokens[slot] = 0
        self._lengths[slot] = 0
        self._active[slot] = False
        if self._paged:
            self._mgr.free_slot(slot)
        n = len(st.generated)
        tpot = (
            (st.last_tok_t - st.first_tok_t) / (n - 1) if n > 1 else None
        )
        e2e = st.last_tok_t - st.entry.submit_t
        ttft = st.first_tok_t - st.entry.submit_t
        st.entry.future._set(Result(
            status="ok", finish_reason=reason, tokens=list(st.generated),
            ttft_s=ttft, tpot_s=tpot, e2e_s=e2e,
        ))
        self.recorder.record_request(
            status="ok", finish_reason=reason,
            n_prompt=st.prompt_len, n_generated=n,
            ttft_s=ttft, tpot_s=tpot, e2e_s=e2e,
            n_prefix_hit=st.n_prefix_hit,
        )

    # -- paged-cache admission / prefill ---------------------------------

    def _try_blocks(self, n_needed: int) -> bool:
        """Free-list headroom for ``n_needed`` fresh blocks, evicting LRU
        prefix-cache leaves when short (host-side only)."""
        alloc = self._mgr.allocator
        if alloc.blocks_free >= n_needed:
            return True
        if self._evictable is not None:
            self._evictable.evict(n_needed - alloc.blocks_free)
        return alloc.blocks_free >= n_needed

    def _admit_paged(self, now: float) -> None:
        for slot in range(self.decoder.max_slots):
            if self._slots[slot] is not None:
                continue
            with self._lock:
                entry = self._queue.popleft() if self._queue else None
            if entry is None:
                return
            req = entry.request
            plen = len(req.prompt)
            # adopt the longest cached prefix (capped so at least one
            # prompt token prefills: its logits seed the first token)
            matched, adopted = (
                self._prefix.match(req.prompt, plen - 1)
                if self._prefix is not None else (0, [])
            )
            n_total = self._mgr.blocks_for(plen + 1)
            if not self._try_blocks(n_total - len(adopted)):
                self._mgr.release_adopted(adopted)
                if self._prefix is not None:
                    self._prefix.unrecord_match(matched)
                if not any(s is not None for s in self._slots):
                    # nothing in flight will ever free a block
                    self._shed(entry, "no_blocks", now)
                    continue
                with self._lock:
                    self._queue.appendleft(entry)   # keep FIFO order
                return
            self._mgr.assign(slot, adopted, n_total)
            self._slots[slot] = _SlotState(
                entry, plen, state="prefill", pf_pos=matched,
                n_prefix_hit=matched,
            )
            self._seeds[slot] = req.seed
            if not self.chunked_prefill:
                self._advance_prefill_slot(slot, limit=None)

    def _cow_gate(self, slot: int, bidx: int) -> None:
        """``ensure_writable`` with eviction headroom: a copy-on-write
        needs a fresh block beyond the admission reservation.  Raises
        ``OutOfBlocks`` when the pool is truly dry."""
        bid = int(self._mgr.tables[slot, bidx])
        if self._mgr.allocator.refcount(bid) > 1:
            self._try_blocks(1)
        self._mgr.ensure_writable(slot, bidx, self.decoder.copy_block)

    def _abort_prefill(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        self._mgr.free_slot(slot)
        self._shed(st.entry, reason, time.monotonic())

    def _advance_prefill_slot(self, slot: int, limit: int | None) -> int:
        """Run up to ``limit`` prefill chunks (None = to completion) for
        one mid-prefill slot, passing every write block through the
        copy-on-write gate first.  Returns the chunks run."""
        st = self._slots[slot]
        req = st.entry.request
        dec = self.decoder
        bs = dec.block_size
        done = 0
        tok = None
        while st.pf_pos < st.prompt_len and (limit is None or done < limit):
            c = min(dec.prefill_chunk, st.prompt_len - st.pf_pos)
            try:
                for bidx in range(
                    st.pf_pos // bs, (st.pf_pos + c - 1) // bs + 1
                ):
                    self._cow_gate(slot, bidx)
            except OutOfBlocks:
                self._abort_prefill(slot, "no_blocks")
                return done
            tok = dec.prefill(
                self._mgr.tables[slot],
                req.prompt[st.pf_pos: st.pf_pos + c],
                st.pf_pos, c, int(self._seeds[slot]), req.temperature,
            )
            st.pf_pos += c
            done += 1
        if st.pf_pos >= st.prompt_len:
            self._finish_prefill(slot, tok)
        return done

    def _finish_prefill(self, slot: int, first) -> None:
        """Final chunk done: record the first token (reading it is the
        device fence), publish the prompt's blocks to the radix cache,
        arm the decode mirrors."""
        st = self._slots[slot]
        req = st.entry.request
        first = int(first)
        now = time.monotonic()
        st.state = "decode"
        st.generated = [first]
        st.first_tok_t = now
        st.last_tok_t = now
        if self._prefix is not None:
            self._prefix.insert(
                req.prompt,
                self._mgr.slot_blocks(
                    slot, self._mgr.blocks_for(st.prompt_len)
                ),
            )
        self._tokens[slot] = first
        self._lengths[slot] = st.prompt_len
        self._temps[slot] = req.temperature
        self._active[slot] = True
        if self.eos_id is not None and first == self.eos_id:
            self._finish(slot, "eos")
        elif req.max_tokens <= 1:
            self._finish(slot, "max_tokens")

    def _prepare_decode_writes(self) -> None:
        """Before each paged decode step: grow every decoding slot's
        table across block boundaries and pass its write block through
        the copy-on-write gate.  A pool dry even after eviction ends
        that request with ``no_blocks`` (its tokens are delivered)."""
        bs = self.decoder.block_size
        for slot, st in enumerate(self._slots):
            if st is None or st.state != "decode":
                continue
            bidx = int(self._lengths[slot]) // bs
            try:
                need = bidx + 1 - self._mgr.n_owned[slot]
                if need > 0:
                    self._try_blocks(need)
                self._mgr.grow(slot, bidx)
                self._cow_gate(slot, bidx)
            except OutOfBlocks:
                self._finish(slot, "no_blocks")

    def _admit(self, now: float) -> None:
        """Fill free slots from the queue head — a prefill each, so the
        admitted request rides the very next decode step."""
        if self._paged:
            return self._admit_paged(now)
        for slot in range(self.decoder.max_slots):
            if self._slots[slot] is not None:
                continue
            with self._lock:
                entry = self._queue.popleft() if self._queue else None
            if entry is None:
                return
            req = entry.request
            first = self.decoder.prefill(
                slot, req.prompt, req.seed, req.temperature
            )
            self._slots[slot] = _SlotState(entry, len(req.prompt), first)
            self._tokens[slot] = first
            self._lengths[slot] = len(req.prompt)
            self._seeds[slot] = req.seed
            self._temps[slot] = req.temperature
            if self.eos_id is not None and first == self.eos_id:
                self._finish(slot, "eos")
            elif req.max_tokens <= 1:
                self._finish(slot, "max_tokens")

    def _decoding_slots(self) -> int:
        return sum(
            st is not None and st.state == "decode" for st in self._slots
        )

    def _decode_once(self) -> int:
        self._step_slots = 0
        if self._paged:
            self._prepare_decode_writes()
            if not self._decoding_slots():
                return 0
            nxt = self.decoder.decode(
                self._tokens, self._lengths, self._seeds, self._temps,
                self._mgr.tables, self._active,
            )
        else:
            nxt = self.decoder.decode(
                self._tokens, self._lengths, self._seeds, self._temps
            )
        now = time.monotonic()
        emitted = 0
        for slot, st in enumerate(self._slots):
            if st is None or st.state != "decode":
                continue
            self._lengths[slot] += 1  # last token now lives in cache
            tok = int(nxt[slot])
            self._tokens[slot] = tok
            st.generated.append(tok)
            st.last_tok_t = now
            emitted += 1
            self._step_slots += 1
            req = st.entry.request
            if self.eos_id is not None and tok == self.eos_id:
                self._finish(slot, "eos")
            elif len(st.generated) >= req.max_tokens:
                self._finish(slot, "max_tokens")
            elif self._lengths[slot] >= self.decoder.max_seq:
                # the next write position is out of cache bounds
                self._finish(slot, "max_seq")
        return emitted

    def step(self) -> bool:
        """One engine iteration (shed → admit → [prefill chunks] →
        decode).  Returns whether any work remains in flight.  Under
        chunked prefill at most ``prefill_chunks_per_step`` chunks run
        per iteration in total, in slot order."""
        now = time.monotonic()
        self._sweep_deadlines(now)
        self._admit(now)
        if self._paged and self.chunked_prefill:
            budget = self.prefill_chunks_per_step
            for slot, st in enumerate(self._slots):
                if budget <= 0:
                    break
                if st is not None and st.state == "prefill":
                    budget -= self._advance_prefill_slot(slot, limit=budget)
        if not any(s is not None for s in self._slots):
            return False
        if self._paged and not self._decoding_slots():
            alloc = self._mgr.allocator
            self.recorder.record_block_gauges(
                blocks_in_use=alloc.blocks_in_use,
                blocks_free=alloc.blocks_free,
            )
            return True
        t0 = time.monotonic()
        emitted = self._decode_once()
        gauges = {}
        if self._paged:
            alloc = self._mgr.allocator
            gauges = dict(blocks_in_use=alloc.blocks_in_use,
                          blocks_free=alloc.blocks_free)
        self.recorder.record_step(
            active_slots=self._step_slots,
            queue_depth=self.queue_depth(),
            dt_s=time.monotonic() - t0,
            tokens=emitted,
            **gauges,
        )
        return True

    def n_prefilling(self) -> int:
        """Slots still mid-prefill."""
        return sum(
            1 for s in self._slots if s is not None and s.state == "prefill"
        )

    def paging_stats(self) -> dict | None:
        """Allocator + prefix-cache counters (None over a v1 decoder)."""
        if not self._paged:
            return None
        out = {"allocator": self._mgr.allocator.stats()}
        if self._prefix is not None:
            out["prefix_cache"] = self._prefix.stats()
        return out

    def run_until_idle(self) -> None:
        """Drive the loop inline until nothing is queued or in flight."""
        while True:
            if not self.step() and self.queue_depth() == 0:
                return

    def start(self) -> None:
        """Background-thread mode for open-loop traffic."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                if not self.step() and self.queue_depth() == 0:
                    time.sleep(1e-3)
            self.run_until_idle()   # drain what came before stop()

        self._thread = threading.Thread(
            target=_loop, name="tm-serving-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the background loop, draining work submitted before the
        stop (later submissions shed with ``"shutdown"``)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        now = time.monotonic()
        with self._lock:
            residual = list(self._queue)
            self._queue.clear()
        for entry in residual:
            self._shed(entry, "shutdown", now)
