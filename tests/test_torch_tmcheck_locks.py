"""The port's tmcheck lock-rule families (``theanompi_tpu_torch/
analysis/locks.py``, a copy of the JAX package's): TM101 lock
discipline, TM102 ABBA/lock-order, TM103 held-lock side effects.  The
JAX package's fixtures (threads and locks, no framework in them) run
through the port's checker, the send fixture importing the port's
``send_frame``.  Every rule has a known-bad fixture (flagged) and a
known-good twin (clean), plus the two regressions the rules exist for:
the ``_mark_dead``-under-lock pattern (TM103, and its router↔client
ABBA shape as TM102) and the deliberate patterns the tree suppresses
with comments.
"""

import textwrap

from theanompi_tpu_torch.analysis import core, locks


def run(src: str) -> list:
    sf = core.SourceFile(textwrap.dedent(src), "fixture.py")
    return core.collect(
        [sf],
        rule_fns=(locks.check_file,),
        cross_fns=(locks.check_lock_order,),
    )


def rules_of(findings) -> list:
    return [f.rule for f in findings]


# -- TM101: guarded-attribute discipline ------------------------------------


class TestLockDiscipline:
    def test_registry_class_access_outside_lock_flagged(self):
        # Router is registry-seeded: _pending is guarded by _lock
        out = run("""
            import threading

            class Router:
                def __init__(self):
                    self._lock = threading.RLock()
                    self._pending = {}

                def peek(self):
                    return len(self._pending)
        """)
        assert rules_of(out) == ["TM101"]
        assert "_pending" in out[0].message

    def test_access_under_lock_clean(self):
        out = run("""
            import threading

            class Router:
                def __init__(self):
                    self._lock = threading.RLock()
                    self._pending = {}

                def peek(self):
                    with self._lock:
                        return len(self._pending)
        """)
        assert out == []

    def test_locked_suffix_and_holds_marker_exempt(self):
        out = run("""
            import threading

            class Router:
                def __init__(self):
                    self._lock = threading.RLock()
                    self._pending = {}

                def _sweep_locked(self):
                    self._pending.clear()

                def _peek(self):  # tmcheck: holds=_lock
                    return len(self._pending)
        """)
        assert out == []

    def test_guarded_by_comment_extends_registry(self):
        out = run("""
            import threading

            class JobPool:
                def __init__(self):
                    self._mu = threading.Lock()
                    self._jobs = []  # guarded-by: _mu

                def bad(self):
                    return self._jobs.pop()

                def good(self):
                    with self._mu:
                        return self._jobs.pop()
        """)
        assert rules_of(out) == ["TM101"]
        assert "bad" in out[0].message

    def test_closure_under_lock_runs_lock_free(self):
        # registering a callback under the lock is fine; the callback
        # BODY touching guarded state is the deferred-callback bug
        out = run("""
            import threading

            class Router:
                def __init__(self):
                    self._lock = threading.RLock()
                    self._pending = {}

                def kick(self):
                    with self._lock:
                        cb = lambda: self._pending.clear()
                    return cb
        """)
        assert rules_of(out) == ["TM101"]


# -- TM102: lock order / ABBA ------------------------------------------------


ABBA = """
    import threading

    class AlphaServer:
        def __init__(self, beta):
            self._lock = threading.Lock()
            self.beta = beta

        def poke(self):
            with self._lock:
                self.beta.prod()

        def ping(self):
            with self._lock:
                return 1

    class BetaServer:
        def __init__(self, alpha):
            self._lock = threading.Lock()
            self.alpha = alpha

        def prod(self):
            with self._lock:
                {body}
"""


class TestLockOrder:
    def test_abba_cycle_flagged(self):
        out = run(ABBA.format(body="self.alpha.ping()"))
        assert "TM102" in rules_of(out)
        assert "AlphaServer._lock" in out[0].message
        assert "BetaServer._lock" in out[0].message

    def test_one_direction_clean(self):
        out = run(ABBA.format(body="return 2"))
        assert out == []

    def test_router_client_shape_flagged(self):
        # the fleet ABBA: router holds its lock and probes client
        # load(); a client resolving futures under ITS lock calls the
        # router's completion path back
        out = run("""
            import threading

            class FleetRouter:
                def __init__(self, client):
                    self._lock = threading.Lock()
                    self.client = client

                def pick(self):
                    with self._lock:
                        return self.client.load()

                def on_result(self, res):
                    with self._lock:
                        return res

            class WireClient:
                def __init__(self, router):
                    self._lock = threading.Lock()
                    self.router = router

                def load(self):
                    with self._lock:
                        return 0

                def mark_dead(self):
                    with self._lock:
                        self.router.on_result(None)
        """)
        assert "TM102" in rules_of(out)

    def test_plain_lock_self_reentry_flagged_rlock_clean(self):
        src = """
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.{kind}()

                def outer(self):
                    with self._lock:
                        self.inner()

                def inner(self):
                    with self._lock:
                        return 1
        """
        assert "TM102" in rules_of(run(src.format(kind="Lock")))
        assert run(src.format(kind="RLock")) == []


# -- TM103: side effects under a held lock -----------------------------------


class TestHeldLockSideEffects:
    def test_mark_dead_under_lock_flagged(self):
        # the fleet regression, verbatim shape: resolving futures
        # while still inside the client lock
        out = run("""
            import threading

            class WireClient:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._futures = {}

                def _mark_dead(self):
                    with self._lock:
                        for fut in list(self._futures.values()):
                            fut._set(None)
        """)
        assert rules_of(out) == ["TM103"]
        assert "_set" in out[0].message

    def test_mark_dead_fixed_shape_clean(self):
        # the shipped shape: snapshot under the lock,
        # resolve after releasing it
        out = run("""
            import threading

            class WireClient:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._futures = {}

                def _mark_dead(self):
                    with self._lock:
                        futures = list(self._futures.values())
                        self._futures.clear()
                    for fut in futures:
                        fut._set(None)
        """)
        assert out == []

    def test_transitive_shed_under_lock_flagged(self):
        # the resolve hides one self-call deep: flagged at the call
        # site, pointing at the op inside the callee
        out = run("""
            import threading

            class MiniRouter:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._pending = {}

                def submit(self, entry):
                    with self._lock:
                        if len(self._pending) > 8:
                            return self._shed(entry)

                def _shed(self, entry):
                    entry.future._set(None)
                    return entry.future
        """)
        tm103 = [f for f in out if f.rule == "TM103"]
        assert len(tm103) == 1
        assert "_shed" in tm103[0].message

    def test_send_without_timeout_under_lock_flagged(self):
        out = run("""
            import threading
            from theanompi_tpu_torch.parallel.center_server import send_frame

            class Pusher:
                def __init__(self, sock):
                    self._send_lock = threading.Lock()
                    self.sock = sock

                def bad(self, frame):
                    with self._send_lock:
                        send_frame(self.sock, frame)

                def good(self, frame):
                    with self._send_lock:
                        send_frame(self.sock, frame, timeout_s=30.0)
        """)
        assert rules_of(out) == ["TM103"]
        assert "timeout_s" in out[0].message

    def test_sleep_and_thread_join_under_lock_flagged(self):
        out = run("""
            import threading
            import time

            class Loop:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._thread = threading.Thread(target=int)

                def nap(self):
                    with self._lock:
                        time.sleep(0.1)

                def reap(self):
                    with self._lock:
                        self._thread.join()
        """)
        assert rules_of(out) == ["TM103", "TM103"]

    def test_add_done_callback_under_lock_flagged(self):
        out = run("""
            import threading

            class MiniRouter:
                def __init__(self):
                    self._lock = threading.Lock()

                def dispatch(self, fut):
                    with self._lock:
                        fut.add_done_callback(print)
        """)
        assert rules_of(out) == ["TM103"]

    def test_suppression_silences_and_is_tracked(self):
        out = run("""
            import threading

            class MiniRouter:
                def __init__(self):
                    self._lock = threading.Lock()

                def dispatch(self, fut):
                    with self._lock:
                        fut.add_done_callback(print)  # tmcheck: disable=TM103
        """)
        assert out == []

    def test_suppressed_op_does_not_propagate(self):
        # a documented exception inside a helper is not a latent
        # hazard for its callers
        out = run("""
            import threading

            class MiniRouter:
                def __init__(self):
                    self._lock = threading.Lock()

                def submit(self, entry):
                    with self._lock:
                        self._shed(entry)

                def _shed(self, entry):
                    entry.future._set(None)  # tmcheck: disable=TM103
        """)
        assert out == []


# -- TM103: trace exports under a held lock --------------------------------


class TestTraceExportUnderLock:
    def test_chrome_trace_under_lock_flagged(self):
        out = run("""
            class Router:
                def dump(self):
                    with self._lock:
                        return chrome_trace(self._spans)
        """)
        assert "TM103" in rules_of(out)
        assert any("trace-export" in f.rule or "span ring" in f.message
                   for f in out)

    def test_collect_spans_method_under_lock_flagged(self):
        # the wire-pulling variant: replicas answer over TCP — doing
        # that while holding the router lock parks the fleet
        out = run("""
            class Router:
                def dump(self):
                    with self._lock:
                        return self.router.collect_spans()
        """)
        assert "TM103" in rules_of(out)

    def test_export_outside_lock_clean(self):
        # the real router's shape: snapshot membership under the
        # lock, pull and serialize outside it
        out = run("""
            class Router:
                def dump(self):
                    with self._lock:
                        members = list(self._members)
                    spans = self.router.collect_spans()
                    return chrome_trace(spans)
        """)
        assert [f for f in out if f.rule == "TM103"] == []
