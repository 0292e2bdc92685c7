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

Also over a ``PagedLlamaDecoder``:

- speculative decoding (``speculate_k >= 2``): a drafter proposes up to
  k - 1 tokens a slot, one ``verify`` step scores the window, and the
  engine commits the longest drafted prefix the model reproduced plus
  the model's own next token — the same ids as one-token decode;
- disaggregated prefill/decode: a ``prefill_only`` request finishes
  ``"prefilled"`` with a KV handoff record (``serving/kv_transfer.py``),
  and a request carrying a ``handoff`` skips prefill and joins the
  decode batch with the imported blocks.  A v1 engine ignores both
  fields and serves the full prompt.

``tracer=``/``trace_sample=`` record host-stamped spans per sampled
request (queue wait, prefill and its chunks, decode, speculative
windows, copy-on-write, growth, eviction) through ``obs/tracer.py``;
each ``Result`` carries its request's spans.  ``tokenizer=`` wires the
batched tokenize service (``serving/tokenize.py``) behind
``submit_text``/``decode_text``.

``submit()`` is thread-safe; the loop runs inline (``run_until_idle``)
or on a background thread (``start``/``stop``).  Telemetry flows
through ``utils.recorder.ServingRecorder``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from theanompi_tpu_torch.obs.tracer import Tracer, child_context, force_sample
from theanompi_tpu_torch.serving import kv_transfer
from theanompi_tpu_torch.serving.blocks import OutOfBlocks
from theanompi_tpu_torch.serving.decoder import LlamaDecoder
from theanompi_tpu_torch.serving.speculation import NGramDrafter
from theanompi_tpu_torch.serving.tokenize import TokenizeService
from theanompi_tpu_torch.utils.recorder import ServingRecorder


@dataclass
class Request:
    """One generation request (all fields host-side).  ``seed`` seeds
    the request's sampling noise (used at temperature > 0).

    ``prefill_only``/``handoff`` are the disaggregation fields: a
    prefill-only request runs its prompt to the end of prefill and
    resolves ``"prefilled"`` with the KV handoff record instead of
    decoding; a request with a handoff record skips prefill — its
    blocks are imported and it joins the decode batch.  ``trace`` is a
    span context (``obs/tracer.py``) from whoever dispatched the
    request; None lets the engine root its own trace."""

    prompt: list
    max_tokens: int = 16
    temperature: float = 0.0         # <= 0: greedy
    deadline_s: float | None = None  # queue-wait budget from submit
    seed: int = 0
    prefill_only: bool = False
    handoff: dict | None = None
    trace: dict | None = None


@dataclass
class Result:
    """Terminal state of a request.  ``status``: ``"ok"`` or
    ``"shed"``.  ``finish_reason``: ``"eos"``, ``"max_tokens"``,
    ``"max_seq"``, ``"no_blocks"`` (tokens so far returned) or
    ``"prefilled"`` (``handoff`` holds the record) when served;
    ``"queue_full"``, ``"deadline"``, ``"prompt_too_long"``,
    ``"shutdown"``, ``"no_blocks"`` or ``"handoff_failed"`` when shed.
    ``spans``: the request's flight record when it was traced."""

    status: str
    finish_reason: str
    tokens: list = field(default_factory=list)
    ttft_s: float | None = None   # submit -> first token
    tpot_s: float | None = None   # mean inter-token time after first
    queued_s: float | None = None
    e2e_s: float | None = None
    handoff: dict | None = None
    spans: list = field(default_factory=list)


class ServingFuture:
    """Minimal thread-safe future for one request's ``Result``."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Result | None = None
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    def _set(self, result: Result) -> None:
        with self._cb_lock:
            if self._event.is_set():
                return      # the first resolution wins
            self._result = result
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(result)

    def add_done_callback(self, fn) -> None:
        """Run ``fn(result)`` when the future resolves, at once if it
        already has.  Callbacks run on the resolving thread (the engine
        loop), so keep them cheap."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self._result)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Result:
        if not self._event.wait(timeout):
            raise TimeoutError("serving result not ready")
        return self._result


class _Entry:
    __slots__ = ("request", "future", "submit_t", "deadline_s", "ctx",
                 "root", "qspan")

    def __init__(self, request: Request, default_deadline_s: float):
        self.request = request
        self.future = ServingFuture()
        self.submit_t = time.monotonic()
        self.deadline_s = (
            request.deadline_s if request.deadline_s is not None
            else default_deadline_s
        )
        # tracing state (set by Engine._trace_submit): the span
        # context, the engine-rooted root span (None when the
        # dispatcher owns the root) and the open queue-wait span
        self.ctx: dict | None = None
        self.root: dict | None = None
        self.qspan: dict | None = None


class _SlotState:
    __slots__ = ("entry", "generated", "first_tok_t", "last_tok_t",
                 "prompt_len", "state", "pf_pos", "n_prefix_hit",
                 "pf_span", "dec_span")

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
        # open span handles (tracing): the prefill and decode legs
        self.pf_span: dict | None = None
        self.dec_span: dict | None = None


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
        drafter=None,
        tracer: Tracer | None = None,
        trace_sample: int = 0,
        tokenizer=None,
    ):
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

        # speculative decoding: k tokens a verify step (1 committed +
        # up to k - 1 drafted), accepted by equality; 0 and 1 are off
        self.speculate_k = int(speculate_k)
        if self.speculate_k >= 2:
            if not self._paged:
                raise NotImplementedError(
                    "speculative decoding serves through the paged "
                    "decoder only — the verify window's over-provisioned "
                    "KV writes need the trash-block discipline "
                    "(PagedLlamaDecoder); rebuild with paged=True"
                )
        self.drafter = (
            (drafter if drafter is not None else NGramDrafter())
            if self.speculate_k >= 2 else None
        )
        self._draft = np.zeros((s, max(1, self.speculate_k)), np.int64)
        self._n_valid = np.zeros((s,), np.int64)
        self._step_drafted = 0
        self._step_accepted = 0
        self._step_slots = 0

        self._lock = threading.Lock()
        self._queue: deque[_Entry] = deque()  # guarded-by: _lock
        self._slots: list[_SlotState | None] = [None] * s
        # device-call mirrors (owned by the engine loop thread)
        self._tokens = np.zeros((s,), np.int64)
        self._lengths = np.zeros((s,), np.int64)
        self._seeds = np.zeros((s,), np.int64)
        self._temps = np.zeros((s,), np.float32)
        self._active = np.zeros((s,), bool)   # paged: decoding slots

        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

        # span tracing: host stamps only, None (off) by default; a
        # request's spans ride its Result
        if tracer is None and int(trace_sample) > 0:
            tracer = Tracer(process="engine", sample=int(trace_sample))
        self._tracer = tracer
        # the batched tokenize front door (None: submit_text raises)
        self._tok_service = (
            TokenizeService(tokenizer, recorder=self.recorder)
            if tokenizer is not None else None
        )

    @property
    def tracer(self) -> Tracer | None:
        return self._tracer

    # -- tracing hooks (host stamps only, no device reads) -----------------

    def _trace_submit(self, entry: _Entry) -> None:
        tr = self._tracer
        if tr is None:
            return
        req = entry.request
        if req.trace is not None:
            # the dispatcher owns the root: parent under its span
            ctx = req.trace
        elif req.handoff is not None and isinstance(
                req.handoff.get("trace"), dict):
            # a handoff record carries the prefill side's context, so
            # the decode leg joins the same tree
            ctx = dict(req.handoff["trace"])
        else:
            ctx = tr.new_context()
            entry.root = tr.start_span(
                ctx, "request", n_prompt=len(req.prompt)
            )
        entry.ctx = ctx
        entry.qspan = tr.start_span(
            ctx, "engine_queue", parent_id=self._parent_of(entry),
            n_prompt=len(req.prompt),
        )

    def _parent_of(self, entry: _Entry) -> int | None:
        if entry.root is not None:
            return entry.root["span_id"]
        return entry.ctx.get("parent_id") if entry.ctx else None

    def _slot_ctx(self, slot: int) -> dict | None:
        st = self._slots[slot]
        return st.entry.ctx if st is not None else None

    def _slot_parent(self, slot: int) -> int | None:
        """The slot's innermost open span id — what the block
        machinery's spans (CoW, grow, evict) parent under, so every
        span stays on one connected tree."""
        st = self._slots[slot]
        if st is None:
            return None
        h = st.pf_span if st.state == "prefill" else st.dec_span
        if h is not None:
            return h["span_id"]
        return self._parent_of(st.entry)

    def _trace_shed(self, entry: _Entry, reason: str) -> list:
        """Close a shed request's open spans, force-sampled (a shed is
        the tail a 1/N rate must not lose), and return its flight
        record."""
        tr = self._tracer
        if tr is None or entry.ctx is None:
            return []
        force_sample(entry.ctx)
        tr.end_span(entry.qspan, reason=reason)
        entry.qspan = None
        if entry.root is not None:
            tr.end_span(entry.root, status="shed", finish_reason=reason)
            entry.root = None
        return tr.spans(entry.ctx["trace_id"])

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
        entry = _Entry(req, self.default_deadline_s)
        self._trace_submit(entry)
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
            spans=self._trace_shed(entry, reason),
        ))
        self.recorder.record_request(
            status="shed", finish_reason=reason,
            n_prompt=len(entry.request.prompt), n_generated=0,
        )
        return entry.future

    def submit_text(self, text: str, **kw) -> ServingFuture:
        """Submit a request from text: encode it through the batched
        tokenize service (concurrent submitters share one codec sweep),
        then queue it as ``submit`` does.  Needs ``Engine(tokenizer=)``."""
        if self._tok_service is None:
            raise RuntimeError(
                "submit_text requires Engine(tokenizer=...): no "
                "tokenize service is wired on this engine"
            )
        return self.submit(self._tok_service.tokenize(text), **kw)

    def decode_text(self, ids) -> str:
        """Detokenize generated ids through the same service."""
        if self._tok_service is None:
            raise RuntimeError(
                "decode_text requires Engine(tokenizer=...): no "
                "tokenize service is wired on this engine"
            )
        return self._tok_service.detokenize(ids)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    # -- engine loop (one owner thread) -----------------------------------

    def _shed(self, entry: _Entry, reason: str, now: float) -> None:
        entry.future._set(Result(
            status="shed", finish_reason=reason,
            queued_s=now - entry.submit_t,
            spans=self._trace_shed(entry, reason),
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

    def _clear_slot(self, slot: int) -> None:
        """Empty ``slot`` and release its blocks.  Resetting the mirrors
        matters: a stale temperature > 0 would force the sampling path
        on later all-greedy batches."""
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._tokens[slot] = 0
        self._lengths[slot] = 0
        self._active[slot] = False
        if self._paged:
            self._mgr.free_slot(slot)

    def _finish(self, slot: int, reason: str,
                handoff: dict | None = None) -> None:
        st = self._slots[slot]
        self._clear_slot(slot)
        n = len(st.generated)
        tpot = (
            (st.last_tok_t - st.first_tok_t) / (n - 1) if n > 1 else None
        )
        e2e = st.last_tok_t - st.entry.submit_t
        ttft = st.first_tok_t - st.entry.submit_t
        spans: list = []
        tr = self._tracer
        ent = st.entry
        if tr is not None and ent.ctx is not None:
            tr.end_span(st.dec_span, tokens=n, finish_reason=reason)
            st.dec_span = None
            if ent.root is not None:
                tr.end_span(ent.root, status="ok", finish_reason=reason)
                ent.root = None
            # the flight record: every span this engine kept for the
            # trace rides the result to whoever dispatched it
            spans = tr.spans(ent.ctx["trace_id"])
        ent.future._set(Result(
            status="ok", finish_reason=reason, tokens=list(st.generated),
            ttft_s=ttft, tpot_s=tpot, e2e_s=e2e, handoff=handoff,
            spans=spans,
        ))
        self.recorder.record_request(
            status="ok", finish_reason=reason,
            n_prompt=st.prompt_len, n_generated=n,
            ttft_s=ttft, tpot_s=tpot, e2e_s=e2e,
            n_prefix_hit=st.n_prefix_hit,
        )

    # -- paged-cache admission / prefill ---------------------------------

    def _try_blocks(self, n_needed: int, ctx: dict | None = None,
                    parent_id: int | None = None) -> bool:
        """Free-list headroom for ``n_needed`` fresh blocks, evicting LRU
        prefix-cache leaves when short (host-side only).
        ``ctx``/``parent_id`` attribute the eviction span to the request
        that forced it."""
        alloc = self._mgr.allocator
        if alloc.blocks_free >= n_needed:
            return True
        if self._evictable is not None:
            short = n_needed - alloc.blocks_free
            if self._tracer is not None and ctx is not None:
                with self._tracer.span(ctx, "cache_evict",
                                       parent_id=parent_id,
                                       n_requested=short):
                    self._evictable.evict(short)
            else:
                self._evictable.evict(short)
        return alloc.blocks_free >= n_needed

    def _admit_handoff(self, slot: int, entry: _Entry, now: float) -> bool:
        """Admit a request whose prompt was prefilled elsewhere: reserve
        a fresh table, import the record's blocks, and seed the slot in
        the decode state with the prefiller's first token.  Returns
        False when the pool is dry and something in flight may free
        blocks (the entry went back to the queue head: stop admitting).
        An incompatible record sheds ``"handoff_failed"``, so the
        dispatcher can requeue the full prompt."""
        req = entry.request
        h = req.handoff
        ok, why = kv_transfer.compatible(self.decoder, h)
        if ok and h["n_prompt"] != len(req.prompt):
            ok, why = False, (
                f"handoff n_prompt {h['n_prompt']} != prompt length "
                f"{len(req.prompt)}"
            )
        if not ok:
            print(f"serving: refusing handoff: {why}", flush=True)
            self._shed(entry, "handoff_failed", now)
            return True
        n_blk = h["n_blocks"]
        plen = len(req.prompt)
        # reserve what normal admission reserves: blocks_for(plen + 1)
        # covers the first decode write when the prompt ends on a block
        # boundary (the payload's blocks alone would let the first
        # grow() hit a dry pool and cut an "ok" result to one token)
        n_total = max(n_blk, self._mgr.blocks_for(plen + 1))
        if not self._try_blocks(n_total, entry.ctx, self._parent_of(entry)):
            if not any(s is not None for s in self._slots):
                # nothing in flight will ever free a block
                self._shed(entry, "handoff_failed", now)
                return True
            with self._lock:
                self._queue.appendleft(entry)   # keep FIFO order
            return False
        tr = self._tracer
        if tr is not None:
            tr.end_span(entry.qspan)
            entry.qspan = None
        t0 = tr.clock() if tr is not None else 0.0
        self._mgr.assign(slot, [], n_total)
        kv_transfer.inject_handoff(self.decoder, self._mgr, slot, h)
        first = int(h["first_token"])
        self._slots[slot] = _SlotState(entry, plen, first)
        if tr is not None and entry.ctx is not None:
            tr.record_span(
                entry.ctx, "handoff_import", t0, tr.clock(),
                parent_id=self._parent_of(entry), n_blocks=n_blk,
            )
            self._slots[slot].dec_span = tr.start_span(
                entry.ctx, "decode", parent_id=self._parent_of(entry),
            )
        self._tokens[slot] = first
        self._lengths[slot] = plen
        self._seeds[slot] = req.seed
        self._temps[slot] = req.temperature
        self._active[slot] = True
        if self.eos_id is not None and first == self.eos_id:
            self._finish(slot, "eos")
        elif req.max_tokens <= 1:
            self._finish(slot, "max_tokens")
        return True

    def _admit_paged(self, now: float) -> None:
        for slot in range(self.decoder.max_slots):
            if self._slots[slot] is not None:
                continue
            with self._lock:
                entry = self._queue.popleft() if self._queue else None
            if entry is None:
                return
            if entry.request.handoff is not None:
                if not self._admit_handoff(slot, entry, now):
                    return
                continue
            req = entry.request
            plen = len(req.prompt)
            # adopt the longest cached prefix (capped so at least one
            # prompt token prefills: its logits seed the first token)
            matched, adopted = (
                self._prefix.match(req.prompt, plen - 1)
                if self._prefix is not None else (0, [])
            )
            n_total = self._mgr.blocks_for(plen + 1)
            if not self._try_blocks(n_total - len(adopted), entry.ctx,
                                    self._parent_of(entry)):
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
            if self._tracer is not None:
                self._tracer.end_span(entry.qspan)
                entry.qspan = None
                self._slots[slot].pf_span = self._tracer.start_span(
                    entry.ctx, "prefill", parent_id=self._parent_of(entry),
                    n_prompt=plen, matched=matched,
                )
            self._seeds[slot] = req.seed
            if not self.chunked_prefill:
                self._advance_prefill_slot(slot, limit=None)

    def _cow_gate(self, slot: int, bidx: int) -> None:
        """``ensure_writable`` with eviction headroom: a copy-on-write
        needs a fresh block beyond the admission reservation.  Raises
        ``OutOfBlocks`` when the pool is truly dry."""
        bid = int(self._mgr.tables[slot, bidx])
        shared = self._mgr.allocator.refcount(bid) > 1
        ctx = self._slot_ctx(slot)
        parent = self._slot_parent(slot)
        if shared:
            self._try_blocks(1, ctx, parent)
        if shared and self._tracer is not None and ctx is not None:
            # only the copy gets a span: the unshared path is a no-op
            with self._tracer.span(ctx, "kv_cow", parent_id=parent,
                                   block=bid):
                self._mgr.ensure_writable(slot, bidx, self.decoder.copy_block)
        else:
            self._mgr.ensure_writable(slot, bidx, self.decoder.copy_block)

    def _abort_prefill(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        self._mgr.free_slot(slot)
        if self._tracer is not None:
            self._tracer.end_span(st.pf_span, force=True, reason=reason)
            st.pf_span = None
        self._shed(st.entry, reason, time.monotonic())

    def _advance_prefill_slot(self, slot: int, limit: int | None) -> int:
        """Run up to ``limit`` prefill chunks (None = to completion) for
        one mid-prefill slot, passing every write block through the
        copy-on-write gate first.  Returns the chunks run."""
        st = self._slots[slot]
        req = st.entry.request
        dec = self.decoder
        bs = dec.block_size
        tr = self._tracer
        ctx = st.entry.ctx
        done = 0
        tok = None
        while st.pf_pos < st.prompt_len and (limit is None or done < limit):
            c = min(dec.prefill_chunk, st.prompt_len - st.pf_pos)
            t0c = tr.clock() if tr is not None else 0.0
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
            if tr is not None and ctx is not None:
                # dispatch stamps only: a non-final chunk's token stays
                # an unread device tensor, so the span measures the
                # dispatch; the prefill span's end is the fence
                tr.record_span(
                    ctx, "prefill_chunk", t0c, tr.clock(),
                    parent_id=(st.pf_span["span_id"]
                               if st.pf_span else None),
                    pos=st.pf_pos, n_tokens=c,
                )
            st.pf_pos += c
            done += 1
        if st.pf_pos >= st.prompt_len:
            self._finish_prefill(slot, tok)
        return done

    def _finish_prefill(self, slot: int, first) -> None:
        """Final chunk done: record the first token (reading it is the
        device fence), publish the prompt's blocks to the radix cache,
        arm the decode mirrors; a ``prefill_only`` request finishes
        ``"prefilled"`` with its handoff record."""
        st = self._slots[slot]
        req = st.entry.request
        first = int(first)
        now = time.monotonic()
        st.state = "decode"
        st.generated = [first]
        st.first_tok_t = now
        st.last_tok_t = now
        if self._tracer is not None:
            # ends at the fence: admission to the first real token
            self._tracer.end_span(st.pf_span, n_prompt=st.prompt_len)
            st.pf_span = None
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
        elif req.prefill_only:
            # export the prompt's blocks and the first token; the radix
            # insert above already warmed this decoder's cache
            ctx = st.entry.ctx
            parent = self._parent_of(st.entry) if ctx is not None else None
            h = kv_transfer.build_handoff(
                self.decoder, self._mgr, slot, st.prompt_len, first,
                # re-parented under this request's root so a receiver's
                # decode-leg spans hang off the prefill tree
                trace=(child_context(ctx, parent) if parent is not None
                       else dict(ctx) if ctx is not None else None),
            )
            self._finish(slot, "prefilled", handoff=h)
        elif self._tracer is not None and st.entry.ctx is not None:
            st.dec_span = self._tracer.start_span(
                st.entry.ctx, "decode", parent_id=self._parent_of(st.entry),
            )

    def _prepare_decode_writes(self) -> None:
        """Before each paged decode step: grow every decoding slot's
        table across block boundaries and pass its write block through
        the copy-on-write gate.  A pool dry even after eviction ends
        that request with ``no_blocks`` (its tokens are delivered)."""
        bs = self.decoder.block_size
        tr = self._tracer
        for slot, st in enumerate(self._slots):
            if st is None or st.state != "decode":
                continue
            bidx = int(self._lengths[slot]) // bs
            try:
                need = bidx + 1 - self._mgr.n_owned[slot]
                if need > 0:
                    ctx = st.entry.ctx
                    parent = st.dec_span["span_id"] if st.dec_span else None
                    self._try_blocks(need, ctx, parent)
                    if tr is not None and ctx is not None:
                        tr.record_span(ctx, "kv_grow", tr.clock(),
                                       tr.clock(), parent_id=parent,
                                       n_blocks=need)
                self._mgr.grow(slot, bidx)
                self._cow_gate(slot, bidx)
            except OutOfBlocks:
                self._finish(slot, "no_blocks")

    def _draft_history(self, st: _SlotState, req: Request) -> list:
        """The drafter's view of the slot's tokens, bounded to the
        drafter's own scan window when it declares one (rebuilding the
        whole prompt + generated list every step would put an
        O(prompt_len) host copy on the decode cadence)."""
        scan = getattr(self.drafter, "max_scan", None)
        if scan is None:
            return list(req.prompt) + st.generated
        if len(st.generated) >= scan:
            return st.generated[-scan:]
        head = scan - len(st.generated)
        return list(req.prompt[-head:]) + st.generated

    def _prepare_spec_decode_writes(self) -> None:
        """The speculative sibling of ``_prepare_decode_writes``: draft
        up to ``speculate_k - 1`` tokens per decoding slot (the window
        clamped to ``max_seq`` and to the request's remaining tokens,
        floor one), then grow the table and pass every block the window
        touches through the copy-on-write gate.  Block scarcity shrinks
        the window to one token (plain decode's reservation) before it
        becomes a ``no_blocks`` finish, so speculation never cuts a
        request that plain decode would have served."""
        dec = self.decoder
        bs = dec.block_size
        self._n_valid[:] = 0
        for slot, st in enumerate(self._slots):
            if st is None or st.state != "decode":
                continue
            pos = int(self._lengths[slot])
            req = st.entry.request
            want = min(self.speculate_k, dec.max_seq - pos,
                       req.max_tokens - len(st.generated))
            draft: list = []
            if want > 1:
                draft = list(self.drafter.draft(
                    self._draft_history(st, req), want - 1
                ))[: want - 1]
            n = 1 + len(draft)
            while True:
                try:
                    last_bidx = (pos + n - 1) // bs
                    need = last_bidx + 1 - self._mgr.n_owned[slot]
                    if need > 0:
                        self._try_blocks(
                            need, st.entry.ctx,
                            st.dec_span["span_id"] if st.dec_span else None,
                        )
                    self._mgr.grow(slot, last_bidx)
                    for bidx in range(pos // bs, last_bidx + 1):
                        self._cow_gate(slot, bidx)
                    break
                except OutOfBlocks:
                    if n > 1:
                        n, draft = 1, []    # degrade to one token
                        continue
                    self._finish(slot, "no_blocks")
                    n = 0
                    break
            if n:
                self._n_valid[slot] = n
                self._draft[slot, 0] = self._tokens[slot]
                self._draft[slot, 1:n] = draft
                self._draft[slot, n:] = 0

    def _emit(self, slot: int, st: _SlotState, tok: int, now: float) -> bool:
        """Commit one generated token to ``slot`` and apply the eviction
        rules (EOS, ``max_tokens``, ``max_seq``).  Returns whether the
        slot finished."""
        self._lengths[slot] += 1    # the consumed token now lives in cache
        self._tokens[slot] = tok
        st.generated.append(tok)
        st.last_tok_t = now
        req = st.entry.request
        if self.eos_id is not None and tok == self.eos_id:
            self._finish(slot, "eos")
        elif len(st.generated) >= req.max_tokens:
            self._finish(slot, "max_tokens")
        elif self._lengths[slot] >= self.decoder.max_seq:
            # the next write position is out of cache bounds
            self._finish(slot, "max_seq")
        else:
            return False
        return True

    def _spec_decode_once(self) -> int:
        """One verify step and the host-side accept: commit the longest
        drafted prefix the model reproduced plus the model's own next
        token.  Emission replays the eviction rules token by token, so
        an EOS mid-window stops there with no overshoot."""
        self._prepare_spec_decode_writes()
        if not self._decoding_slots():
            return 0
        tr = self._tracer
        t_v0 = tr.clock() if tr is not None else 0.0
        out = self.decoder.verify(
            self._draft, self._lengths, self._seeds, self._temps,
            self._mgr.tables, self._n_valid,
        )
        now = time.monotonic()
        emitted = 0
        for slot, st in enumerate(self._slots):
            if st is None or st.state != "decode":
                continue
            kv = int(self._n_valid[slot])
            if kv < 1:
                continue
            self._step_slots += 1
            row = out[slot]
            a = 0       # drafts the model itself emitted
            while a < kv - 1 and row[a] == self._draft[slot, a + 1]:
                a += 1
            self._step_drafted += kv - 1
            if tr is not None and st.entry.ctx is not None:
                # recorded before the emit loop, so a mid-window finish
                # still carries this window in its flight record
                tr.record_span(
                    st.entry.ctx, "spec_window", t_v0, tr.clock(),
                    parent_id=(st.dec_span["span_id"]
                               if st.dec_span else None),
                    drafted=kv - 1, accepted=a,
                )
            n_emit = 0
            for i in range(a + 1):
                emitted += 1
                n_emit += 1
                if self._emit(slot, st, int(row[i]), now):
                    break
            self._step_accepted += max(0, n_emit - 1)
        return emitted

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
            tr = self._tracer
            if tr is not None:
                tr.end_span(entry.qspan)
                entry.qspan = None
            t0 = tr.clock() if tr is not None else 0.0
            first = self.decoder.prefill(
                slot, req.prompt, req.seed, req.temperature
            )
            self._slots[slot] = _SlotState(entry, len(req.prompt), first)
            if tr is not None and entry.ctx is not None:
                # the v1 prefill is fenced (it returns a host int), so
                # this span is the prefill leg's wall time
                tr.record_span(
                    entry.ctx, "prefill", t0, tr.clock(),
                    parent_id=self._parent_of(entry),
                    n_prompt=len(req.prompt),
                )
                self._slots[slot].dec_span = tr.start_span(
                    entry.ctx, "decode", parent_id=self._parent_of(entry),
                )
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
        self._step_drafted = self._step_accepted = 0
        self._step_slots = 0
        if self.speculate_k >= 2:
            return self._spec_decode_once()
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
            emitted += 1
            self._step_slots += 1
            self._emit(slot, st, int(nxt[slot]), now)
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
        if self.speculate_k >= 2:
            gauges.update(drafted=self._step_drafted,
                          accepted=self._step_accepted)
        self.recorder.record_step(
            # the batch that decoded: under speculation a slot can emit
            # several tokens, so slots and tokens part
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

    def abandon_all(self, reason: str = "restart") -> int:
        """Resolve every queued and in-flight request as shed and free
        their slots and blocks — the restart hook: a loop that died
        mid-flight leaves futures and blocks that must not dangle.  Call
        only with the engine loop stopped; returns how many requests
        were abandoned."""
        now = time.monotonic()
        with self._lock:
            residual = list(self._queue)
            self._queue.clear()
        for entry in residual:
            self._shed(entry, reason, now)
        n = len(residual)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            self._clear_slot(slot)
            if self._tracer is not None:
                self._tracer.end_span(st.pf_span, force=True, reason=reason)
                self._tracer.end_span(st.dec_span, force=True,
                                      reason=reason)
                st.pf_span = st.dec_span = None
            self._shed(st.entry, reason, now)
            n += 1
        return n

    def stop(self) -> None:
        """Stop the background loop, draining work submitted before the
        stop (later submissions shed with ``"shutdown"``), and the
        tokenize worker."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
            now = time.monotonic()
            with self._lock:
                residual = list(self._queue)
                self._queue.clear()
            for entry in residual:
                self._shed(entry, "shutdown", now)
        # the tokenize worker exists in inline mode too
        if self._tok_service is not None:
            self._tok_service.stop()
