"""The port's TM107, profiler-range registration
(``theanompi_tpu_torch/analysis/scopes.py``): the JAX package's
``tests/test_tmcheck_scopes.py`` fixtures with ``torch.profiler.
record_function`` and ``obs.profiler.scope`` in place of
``jax.named_scope``.

The failure mode under test: a range label absent from
``analysis/registry.PROFILE_SCOPES``/``PROFILE_SCOPE_PREFIXES`` looks
instrumented, but the step-phase profiler files its work under the
compute leg.  Fixtures: a positive and a clean twin per shape
(literal, f-string family, dynamic), suppression semantics, and the
registry↔profiler coupling.
"""

import textwrap

from theanompi_tpu_torch.analysis import core, scopes
from theanompi_tpu_torch.analysis.registry import (
    PROFILE_SCOPE_PREFIXES,
    PROFILE_SCOPES,
)


def run(src: str) -> list:
    sf = core.SourceFile(textwrap.dedent(src), "fixture.py")
    return core.collect([sf], rule_fns=(scopes.check_file,))


class TestTM107:
    def test_unregistered_literal_flagged(self):
        out = run("""
            import torch

            def step(x):
                with torch.profiler.record_function("my_new_phase"):
                    return x * 2
        """)
        assert [f.rule for f in out] == ["TM107"]
        assert "my_new_phase" in out[0].message
        assert "compute leg" in out[0].message

    def test_registered_literal_clean_twin(self):
        out = run("""
            import torch

            def step(x):
                with torch.profiler.record_function("opt_update"):
                    return x * 2
        """)
        assert out == []

    def test_scope_helper_checked_like_record_function(self):
        bad = run("""
            from theanompi_tpu_torch.obs.profiler import scope

            def step(x):
                with scope("rogue"):
                    return x
        """)
        assert [f.rule for f in bad] == ["TM107"]
        good = run("""
            from theanompi_tpu_torch.obs.profiler import scope

            def step(x):
                with scope("host_load"):
                    return x
        """)
        assert good == []

    def test_registered_prefix_literal_clean(self):
        out = run("""
            from torch.profiler import record_function

            def step(x):
                with record_function("exchange_b3"):
                    return x
        """)
        assert out == []

    def test_fstring_on_registered_prefix_clean(self):
        out = run("""
            from theanompi_tpu_torch.obs.profiler import scope

            def step(xs):
                for i, x in enumerate(xs):
                    with scope(f"exchange_b{i}"):
                        pass
        """)
        assert out == []

    def test_fstring_unregistered_head_flagged(self):
        out = run("""
            from theanompi_tpu_torch.obs.profiler import scope

            def step(xs):
                for i, x in enumerate(xs):
                    with scope(f"mystery_{i}"):
                        pass
        """)
        assert [f.rule for f in out] == ["TM107"]

    def test_fstring_short_head_flagged(self):
        """A literal head that is merely a prefix of a registered prefix
        (f"e{i}", f"exchange_{x}") must flag: the profiler matches the
        whole prefix and digits."""
        for head in ("e", "exchange_"):
            out = run(f"""
                from theanompi_tpu_torch.obs.profiler import scope

                def step(xs):
                    for i, x in enumerate(xs):
                        with scope(f"{head}{{i}}"):
                            pass
            """)
            assert [f.rule for f in out] == ["TM107"], head

    def test_dynamic_label_flagged(self):
        out = run("""
            import torch

            def step(x, label):
                with torch.profiler.record_function(label):
                    return x
        """)
        assert [f.rule for f in out] == ["TM107"]
        assert "not a (f-)string literal" in out[0].message

    def test_suppression_silences_and_tracks(self):
        out = run("""
            import torch

            def step(x):
                with torch.profiler.record_function("rogue"):  # tmcheck: disable=TM107
                    return x
        """)
        assert out == []
        stale = run("""
            import torch

            def step(x):
                with torch.profiler.record_function("opt_update"):  # tmcheck: disable=TM107
                    return x
        """)
        assert [f.rule for f in stale] == ["TM201"]

    def test_unrelated_calls_ignored(self):
        out = run("""
            def step(x):
                return span("anything") + named_scope_of("x")
        """)
        assert out == []

    def test_tests_are_not_exempt(self):
        """Unlike the hot-path seeds, a range opened inside a test_*
        function still needs registration: the same attribution path."""
        out = run("""
            import torch

            def test_something():
                with torch.profiler.record_function("fixture_only"):
                    pass
        """)
        assert [f.rule for f in out] == ["TM107"]


class TestRegistryProfilerCoupling:
    def test_every_registered_label_resolves(self):
        for label in PROFILE_SCOPES:
            assert scopes.label_registered(label)
        for prefix in PROFILE_SCOPE_PREFIXES:
            assert scopes.label_registered(prefix + "0")

    def test_profiler_files_registered_labels_under_their_legs(self):
        """The registry the rule enforces is the one the profiler
        reads: every exact label files under its registered leg, every
        prefix family under its own label."""
        from theanompi_tpu_torch.obs import profiler

        for label, leg in PROFILE_SCOPES.items():
            assert profiler._label_leg(label) == leg
        for prefix in PROFILE_SCOPE_PREFIXES:
            assert profiler._label_leg(prefix + "7") == prefix + "7"
        assert profiler._label_leg("not_registered") is None

    def test_rule_in_catalog(self):
        assert "TM107" in core.RULES
