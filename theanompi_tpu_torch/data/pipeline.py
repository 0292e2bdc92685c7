"""Streaming input pipeline: host work overlapped with the step.

Port of ``theanompi_tpu/data/pipeline.py``.  Two pieces:

- :class:`HostStager` — the ONE host→device path of the port: train,
  val and the streaming feed all stage through it.  A host ``(x, y,
  ...)`` global batch gives this rank's rows ``[r*B, (r+1)*B)``, which
  are copied into a ring of pinned host buffers and sent to the card
  with ``non_blocking`` copies on a dedicated copy stream, one event
  recorded after them.  :meth:`StagedBatch.wait` makes the consumer's
  stream wait on that event and ``record_stream``\\ s the tensors, so
  the caching allocator does not hand their blocks out while the
  consumer still reads them.  A pinned slot is refilled only after its
  previous copy has finished (its event), else a batch in flight would
  be overwritten.  The JAX stager's ``host_load`` HLO marker becomes a
  ``host_load`` profiler range (``obs.profiler.scope``: entered only
  while a profiler is active on the staging thread) around the
  staging.  On the CPU staging is ``torch.from_numpy`` of the same rows:
  no pinning, no stream.
- :class:`StreamingLoader` — a producer thread pulls ``fetch(i)`` and
  stages into a bounded ring of device batches, so batch k+1's fetch
  and copy ride under step k's compute.  The batch SEQUENCE is defined
  by the epoch permutation, not by the transport: the pipelined stream
  is bitwise the synchronous feed, and a starved consumer degrades to a
  synchronous fetch (counted in ``starved``) instead of deadlocking.
  The ``stall_loader`` fault drill (``utils/faults.py``) stalls the
  producer for ``TM_STALL_LOADER_N`` batches to drive that degrade
  path, as in the JAX producer.

Neither the producer nor ``next()`` reads a device value: the ring
bounds batches in flight by COUNT, and the step waits on the copy's
event on the device, not on a host fence.

:func:`engine_feed` is the asynchronous rules' feed: a
:class:`StreamingLoader` over ``data.train_batch`` and the replica
engine's ``put_batch``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from theanompi_tpu_torch.obs.profiler import scope

__all__ = [
    "HostStager", "StagedBatch", "StreamingLoader", "engine_feed",
    "resolve_loader_depth",
]


def resolve_loader_depth(cfg: dict) -> int:
    """The ``loader_pipeline`` config knob, validated: 0/None/False =
    synchronous feed (the default), True = 2, an int >= 2 = pipelined
    feed with that many ring slots (2 = classic double buffering).  The
    ONE resolver — the worker validates through it before the model
    build so a bad value fails in milliseconds, and models size the
    ring with the same rule."""
    raw = cfg.get("loader_pipeline", 0)
    if raw is None or raw is False:
        return 0
    if raw is True:
        return 2
    try:
        depth = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"loader_pipeline must be an int ring depth (0 = off, "
            f">= 2 = pipelined), got {raw!r}"
        ) from None
    if depth == 0:
        return 0
    if depth < 2:
        raise ValueError(
            f"loader_pipeline needs at least 2 ring slots to overlap "
            f"(double buffering); got {depth}"
        )
    return depth


def engine_feed(cfg: dict, data, engine, *, epoch_of=None, world=None):
    """The in-process async loops' feed (EASGD/GoSGD): a
    :class:`StreamingLoader` over ``(data.train_batch,
    engine.put_batch)`` whose staged batches go straight to
    ``ReplicaEngine.train_step_staged``.  None when the
    ``loader_pipeline`` knob is off (the synchronous default)."""
    depth = resolve_loader_depth(cfg)
    if not depth:
        return None
    journal_meta = None
    if epoch_of is not None:
        def journal_meta():
            m = {"epoch": int(epoch_of())}
            if world is not None:
                m["world"] = int(world)
            return m
    # a synthetic set builds its train arrays at the first read: build
    # them before the producer starts (see ClassifierModel._init_feed)
    perm = getattr(data, "epoch_permutation", None)
    if perm is not None:
        perm()
    return StreamingLoader(
        data.train_batch,
        engine.put_batch,
        n_batches=lambda: data.n_batch_train,
        depth=depth,
        global_batch=int(data.global_batch),
        sample_ids=getattr(data, "batch_indices", None),
        journal_meta=journal_meta,
        device=engine.device,
    )


class StagedBatch:
    """Device tensors of one staged batch and the event of their copy
    (None on the CPU)."""

    def __init__(self, tensors: tuple, event=None, device=None):
        self.tensors = tensors
        self.event = event
        self.device = device

    def wait(self) -> tuple:
        """The tensors, usable on the calling thread's current stream:
        that stream waits (on the device) for the copy, and each tensor
        is recorded as used by it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.tensors


class HostStager:
    """One copy of the host→device transfer discipline (module doc).

    ``device`` — where batches go; ``batch_size``/``rank`` — this
    rank's rows of each global batch; ``dtypes`` — optional per-array
    torch dtypes, cast host-side as the rows enter the pinned buffer
    (labels and token ids as int64); ``slots`` — pinned buffers per
    array (the ring; at least 2)."""

    def __init__(self, device, batch_size: int, rank: int = 0, *,
                 dtypes=None, slots: int = 2):
        self.device = torch.device(device)
        self.batch_size = int(batch_size)
        self.rank = int(rank)
        self.dtypes = dtypes
        self.slots = max(2, int(slots))
        self._lock = threading.Lock()
        self._next = 0
        self._bufs: list = [None] * self.slots
        self._events: list = [None] * self.slots
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _rows(self, batch) -> list:
        lo = self.rank * self.batch_size
        arrays = [np.asarray(a)[lo:lo + self.batch_size] for a in batch]
        dtypes = self.dtypes or (None,) * len(arrays)
        return list(zip(arrays, dtypes))

    def _slot_buffers(self, slot: int, rows) -> list:
        """The pinned buffers of ``slot`` for these rows, allocated at
        the first batch (and again when shapes or dtypes change)."""
        want = [(a.shape, dt or torch.from_numpy(np.empty(0, a.dtype)).dtype)
                for a, dt in rows]
        bufs = self._bufs[slot]
        if bufs is None or [(tuple(b.shape), b.dtype) for b in bufs] != want:
            bufs = [torch.empty(shape, dtype=dt, pin_memory=True)
                    for shape, dt in want]
            if not all(b.is_pinned() for b in bufs):
                raise RuntimeError("HostStager: host memory was not pinned")
            self._bufs[slot] = bufs
        return bufs

    def stage(self, batch) -> StagedBatch:
        """This rank's rows of a host ``(x, y, ...)`` global batch, on
        the device.  On the card the call returns while the copy is in
        flight; :meth:`StagedBatch.wait` orders the consumer after it."""
        rows = self._rows(batch)
        if self._stream is None:
            out = []
            for a, dt in rows:
                t = torch.from_numpy(np.ascontiguousarray(a))
                out.append(t if dt is None else t.to(dt))
            return StagedBatch(tuple(out))
        with self._lock, torch.cuda.device(self.device), \
                scope("host_load"):
            slot = self._next
            self._next = (slot + 1) % self.slots
            if self._events[slot] is not None:
                # the slot's previous copy still reads its buffers
                self._events[slot].synchronize()
            bufs = self._slot_buffers(slot, rows)
            for buf, (a, _) in zip(bufs, rows):
                np.copyto(buf.numpy(), a, casting="same_kind")
            with torch.cuda.stream(self._stream):
                out = tuple(b.to(self.device, non_blocking=True)
                            for b in bufs)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._events[slot] = event
        return StagedBatch(out, event, self.device)


class StreamingLoader:
    """Producer-thread pipeline over any ``fetch(i)`` batch source
    (module doc).

    ``fetch(i)`` — host batch for in-epoch index ``i`` (the model-data
    contract's ``train_batch``); a pure indexed read, since the
    starvation fallback may call it from the consumer thread while a
    late producer still holds a reference.  ``stage(batch)`` — host
    batch → device batch (a :class:`HostStager`'s ``stage``).
    ``n_batches`` — int or callable giving the epoch length; the
    producer never reads past it, so a permutation installed by
    ``shuffle(epoch)`` before the epoch's first ``next(0)`` is the one
    it fetches from.  ``device`` — the card the producer thread makes
    current (the current device is per thread).

    Restarts and jumps need no bookkeeping by the caller: ``next(i)``
    for an out-of-sequence ``i`` resyncs the producer (generation bump;
    queued stale batches drop), which is how epoch boundaries, resumes
    and post-starvation realignment all work.
    """

    def __init__(self, fetch, stage, *, n_batches, depth=2,
                 timeout_s=2.0, global_batch=None, sample_ids=None,
                 journal_meta=None, device=None):
        if depth < 2:
            raise ValueError(f"ring depth must be >= 2, got {depth}")
        self._fetch = fetch
        self._stage = stage
        self._n_batches = (
            n_batches if callable(n_batches) else (lambda: n_batches)
        )
        self.depth = int(depth)
        self.timeout_s = float(timeout_s)
        self.global_batch = (
            int(global_batch) if global_batch is not None else None
        )
        self._sample_ids = sample_ids
        self._journal_meta = journal_meta
        self._journal_path = os.environ.get("TM_LOADER_JOURNAL")
        self._device = None if device is None else torch.device(device)

        self._cv = threading.Condition()
        # guarded-by: _cv
        self._ring: deque = deque()
        self._gen = 0
        self._next_prod = 0
        self._next_cons: int | None = None
        self._stop = False
        # telemetry (written under _cv, read-only from summaries)
        self.starved = 0       # consumer timeouts -> synchronous fetch
        self.staged = 0        # batches delivered from the ring
        self._thread: threading.Thread | None = None

    # -- producer ---------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._produce, name="tm-loader", daemon=True
            )
            self._thread.start()

    def _produce(self) -> None:
        from theanompi_tpu_torch.utils import faults

        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                while not self._stop and (
                    len(self._ring) >= self.depth
                    or self._next_prod >= self._n_batches()
                ):
                    self._cv.wait(0.25)
                if self._stop:
                    return
                gen, i = self._gen, self._next_prod
            if faults.consume_loader_stall():
                # the stall drill: the producer stops staging for this
                # iteration — sleep past the consumer's timeout so the
                # degrade path (synchronous fetch + starved counter)
                # takes over instead of a deadlock
                time.sleep(self.timeout_s)
                continue
            staged = self._stage(self._fetch(i))
            with self._cv:
                if gen == self._gen and i == self._next_prod:
                    self._ring.append((gen, i, staged))
                    self._next_prod = i + 1
                # else: resynced mid-stage (epoch restart / starvation
                # realignment) — the batch is stale and drops; the
                # permutation, not the transport, defines order
                self._cv.notify_all()

    # -- consumer (the worker loops' drop-in) -----------------------------

    def _resync(self, i: int) -> None:
        """Point the producer at ``i`` (caller holds ``_cv``)."""
        self._gen += 1
        self._ring.clear()
        self._next_prod = i
        self._cv.notify_all()

    def next(self, i: int):
        """Device batch for in-epoch index ``i`` — the drop-in for the
        inline fetch + stage.  Sequential calls ride the ring; a timeout
        degrades to a synchronous fetch (recorded in ``starved``),
        never a deadlock."""
        self._ensure_thread()
        fallback = False
        with self._cv:
            if self._next_cons != i:
                self._resync(i)
            deadline = time.monotonic() + self.timeout_s
            staged = None
            while staged is None:
                while self._ring and (
                    self._ring[0][0] != self._gen
                    or self._ring[0][1] < i
                ):
                    self._ring.popleft()   # stale generation / index
                if self._ring and self._ring[0][1] == i:
                    staged = self._ring.popleft()[2]
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    fallback = True
                    break
                self._cv.wait(remaining)
            if fallback:
                self.starved += 1
                # realign the producer PAST i: we fetch i ourselves,
                # and its late-staged copy must drop
                self._resync(i + 1)
            else:
                self.staged += 1
                self._cv.notify_all()
            self._next_cons = i + 1
        if fallback:
            staged = self._stage(self._fetch(i))
        self._journal(i)
        return staged

    # -- cursor / accounting ----------------------------------------------

    def cursor(self) -> dict:
        """The stream cursor stamped into checkpoints: the next in-epoch
        batch index and its SAMPLE offset (sample units survive a
        global-batch regrid), plus delivery counters.  The permutation
        is derived state — ``shuffle(epoch)`` reseeds it — so epoch +
        offset identify the position exactly."""
        with self._cv:
            nxt = self._next_cons or 0
            return {
                "next_iter": nxt,
                "next_sample": (
                    nxt * self.global_batch
                    if self.global_batch is not None else None
                ),
                "global_batch": self.global_batch,
                "staged": self.staged,
                "starved": self.starved,
            }

    def _journal(self, i: int) -> None:
        """Sample-id accounting (``TM_LOADER_JOURNAL`` env): one JSON
        line per delivered batch, flushed per line so an abrupt exit
        cannot lose delivered entries."""
        if not self._journal_path or self._sample_ids is None:
            return
        entry = {"iter": i}
        if self._journal_meta is not None:
            entry.update(self._journal_meta())
        ids = self._sample_ids(i)
        entry["ids"] = [int(s) for s in ids]
        with open(self._journal_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.timeout_s + 1.0)
            self._thread = None
