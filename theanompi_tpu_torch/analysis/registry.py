"""Seed configuration for the port's tmcheck rule families (the JAX
package's ``analysis/registry.py``, for torch).

The registry encodes what the serving/control-plane code already
practices, so the checkers enforce the existing discipline rather
than invent one:

- :data:`GUARDED_BY` — per-class lock attribute + the attributes that
  must only be touched with it held (rule TM101).  Seeded for the
  threaded control-plane classes, which the port copies from the JAX
  package; ``# guarded-by: _lock`` comments on ``self.attr = ...``
  lines in ``__init__`` extend it per file.  Attributes owned by a
  single thread by construction (the engine's slot mirrors, a
  replica's heartbeat dict) are deliberately NOT registered.
- :data:`HOT_EXACT` / :data:`HOT_SUBSTR` — function-name seeds for the
  hot-path sanitizer (TM104): the decode/prefill/step loops and the
  K-step training chunk, where the contract is at most one host sync
  a call, after the loop.  ``# tmcheck: hot`` on a def line opts any
  other function in; ``test_``-prefixed functions are exempt (tests
  fence deliberately to assert values).
- :data:`DENY_UNDER_LOCK` — the TM103 deny list.
- :data:`PROFILE_SCOPES` / :data:`PROFILE_SCOPE_PREFIXES` — the
  profiler's range labels and the legs they file under (rule TM107,
  consumed by ``obs/profiler.py``; the port's ranges are
  ``torch.profiler.record_function`` labels, opened through
  ``obs.profiler.scope``, where the JAX package has
  ``jax.named_scope`` labels).
- :data:`RECEIVER_HINTS` — receiver names for resolving call sites to
  classes in the lock-order graph (TM102).
"""

from __future__ import annotations

#: class name -> (lock attribute, attributes guarded by it).
GUARDED_BY: dict[str, tuple[str | None, frozenset]] = {
    # the fleet router: membership, pending table, dispatch queue and
    # cursor all mutate under the RLock from submit/watchdog/replica
    # callback threads
    "Router": ("_lock", frozenset({
        "_members", "_pending", "_queue", "_rr", "_ring", "_stopping",
    })),
    # the engine: the submit queue is the ONE cross-thread structure
    # (slots/mirrors are engine-loop-owned by construction)
    "Engine": ("_lock", frozenset({"_queue"})),
    # the TCP client: futures + command-reply slots are shared by the
    # submitting thread, the reader thread, and the pinger
    "TCPReplicaClient": ("_lock", frozenset({"_futures", "_replies"})),
    # single-owner loops: no lock-guarded state today; registered so
    # adding guarded state later starts from an explicit entry
    "InProcessReplica": (None, frozenset()),
    "Autoscaler": (None, frozenset()),
    "Supervisor": (None, frozenset()),
}

#: hot-path seeds: exact function names …  The tracer API
#: (obs/tracer.py span/start_span/end_span/record_span) is seeded
#: because spans are recorded inside the decode/prefill loops; the
#: streaming loader's consumer/producer pair (data/pipeline.py
#: ``next``/``_produce``) because the pipeline only overlaps if neither
#: side ever fences; ``train_chunk`` because its K steps run with no
#: host fence among them (one read of the K metrics, after the loop).
HOT_EXACT = frozenset({
    "step", "decode", "decode_step", "prefill", "verify", "draft",
    "span", "start_span", "end_span", "record_span",
    "next", "_produce", "train_chunk",
})
#: … and substrings (``_advance_prefill_slot``, ``_spec_decode_once``,
#: ``_verify_body`` and their future siblings)
HOT_SUBSTR = ("prefill", "decode", "verify", "draft")

#: TM103: operations that must not run while holding a lock.  Keys
#: are symbolic op ids (used in messages); values document the match.
DENY_UNDER_LOCK = {
    "future-resolve": "`._set(...)` resolves a future: its done-"
                      "callbacks run on THIS thread, under the lock",
    "done-callback": "`.add_done_callback(...)` fires inline when the "
                     "future already resolved",
    "unbounded-send": "`send_frame(...)`/`.sendall(...)` without "
                      "timeout_s: a peer that stops reading wedges "
                      "the lock holder forever",
    "blocking-wait": "blocking `.result()`/queue `.get()`/thread "
                     "`.join()` parks the lock holder",
    "sleep": "`time.sleep(...)` holds the lock across a stall",
    "trace-export": "`chrome_trace(...)`/`critical_path(...)`/"
                    "`collect_spans(...)` serializes/pulls a whole "
                    "span ring (possibly over the wire) while "
                    "holding a lock",
}

#: profiler-range registry (rule TM107; consumed by
#: ``obs/profiler.py``).  Exact ``torch.profiler.record_function``
#: label -> the StepProfile leg the work under it is attributed to.  A
#: label absent from BOTH tables is a range the profiler would
#: silently file under "compute".
PROFILE_SCOPES: dict[str, str] = {
    # compressed-exchange codec halves (parallel/exchange.py)
    "quantize_wire": "quantize",
    "dequantize_wire": "quantize",
    # optimizer update (models/base.py, scatter_update_gather's
    # per-bucket update)
    "opt_update": "optimizer",
    # serving decode attribution (serving/decoder.py)
    "serving_sample": "sample",
    "paged_attend": "attend",
    "kv_write": "kv_write",
    # host→device batch staging (data/pipeline.py HostStager): the
    # residual feed cost the streaming loader can't hide
    "host_load": "host_load",
}

#: label PREFIX -> leg family: labels carrying a per-instance index
#: (``exchange_b{i}`` — one leg per exchange bucket).  The profiler
#: keeps the full label as the leg name; a literal label (or an
#: f-string's literal head) starting with a prefix is registered.
PROFILE_SCOPE_PREFIXES: dict[str, str] = {
    "exchange_b": "exchange",
}

#: receiver-name hints -> class-name keywords, for resolving
#: `obj.method(...)` call sites to candidate classes in the
#: lock-order graph (TM102).  A hint that matches no analyzed class
#: falls back to "all classes defining the method".
RECEIVER_HINTS = {
    "engine": "engine",
    "replica": "replica",
    "router": "router",
    "client": "client",
    "fut": "future",
    "future": "future",
    "efut": "future",
    "recorder": "recorder",
    "decoder": "decoder",
    "dec": "decoder",
    "mgr": "manager",
    "manager": "manager",
    "allocator": "allocator",
    "cache": "cache",
    "supervisor": "supervisor",
    "autoscaler": "autoscaler",
}
