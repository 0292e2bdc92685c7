"""The port's tmcheck core and CLI (``theanompi_tpu_torch/analysis/
{core,cli,refusals}.py``): suppression semantics and stale-suppression
tracking (TM201), the port tree clean (no unsuppressed finding over
``theanompi_tpu_torch/``), ``python -m theanompi_tpu_torch.analysis``
exit codes (1 on a ``.item()`` planted inside the real ``train_chunk``
loop), deterministic output, and the refusal matrix file
(``analysis/REFUSALS.md``) byte-identical to a fresh render of the
code.  The JAX package's ``tests/test_tmcheck_core.py`` and
``tests/test_refusals_doc.py``, for the port.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

from theanompi_tpu_torch.analysis import core, hotpath, locks, refusals
from theanompi_tpu_torch.analysis.cli import DEFAULT_TARGETS, run_suite

ROOT = Path(__file__).resolve().parent.parent


def run(src: str) -> list:
    sf = core.SourceFile(textwrap.dedent(src), "fixture.py")
    return core.collect(
        [sf],
        rule_fns=(locks.check_file, hotpath.check_file),
        cross_fns=(locks.check_lock_order,),
    )


class TestSuppressions:
    BAD = """
        import threading

        class MiniRouter:
            def __init__(self):
                self._lock = threading.Lock()

            def dispatch(self, fut):
                with self._lock:
                    fut.add_done_callback(print){suffix}
    """

    def test_finding_without_suppression(self):
        out = run(self.BAD.format(suffix=""))
        assert [f.rule for f in out] == ["TM103"]

    def test_suppression_silences(self):
        out = run(self.BAD.format(suffix="  # tmcheck: disable=TM103"))
        assert out == []

    def test_wrong_rule_suppression_does_not_silence(self):
        out = run(self.BAD.format(suffix="  # tmcheck: disable=TM104"))
        assert sorted(f.rule for f in out) == ["TM103", "TM201"]

    def test_stale_suppression_flagged(self):
        out = run("""
            def helper():
                return 1  # tmcheck: disable=TM103
        """)
        assert [f.rule for f in out] == ["TM201"]

    def test_unknown_rule_id_flagged(self):
        out = run("""
            def helper():
                return 1  # tmcheck: disable=TM999
        """)
        assert [f.rule for f in out] == ["TM201"]
        assert "unknown rule id" in out[0].message

    def test_docstring_mention_is_not_an_annotation(self):
        out = run('''
            def helper():
                """Write `# tmcheck: disable=TM103` on the line."""
                return 1
        ''')
        assert out == []

    def test_partial_run_exempts_cross_file_suppressions(self):
        src = textwrap.dedent("""
            def helper():
                return 1  # tmcheck: disable=TM102
        """)
        full = core.collect([core.SourceFile(src, "fixture.py")],
                            rule_fns=(locks.check_file,))
        assert [f.rule for f in full] == ["TM201"]
        part = core.collect([core.SourceFile(src, "fixture.py")],
                            rule_fns=(locks.check_file,), partial=True)
        assert part == []

    def test_multiple_rules_one_comment(self):
        out = run("""
            import threading
            import time

            class Loop:
                def __init__(self):
                    self._lock = threading.Lock()

                def nap(self):
                    with self._lock:
                        time.sleep(0.1)  # tmcheck: disable=TM103, TM104
        """)
        # TM103 matched; TM104 on the same line is stale
        assert [f.rule for f in out] == ["TM201"]


class TestTreeIsClean:
    def test_zero_unsuppressed_findings_over_the_port(self):
        """The port tree reports nothing: every finding is fixed or
        carries its suppression with a reason."""
        findings = run_suite(ROOT, DEFAULT_TARGETS)
        assert findings == [], "\n".join(str(f) for f in findings)

    def test_deterministic(self):
        a = run_suite(ROOT, ["theanompi_tpu_torch/serving"])
        b = run_suite(ROOT, ["theanompi_tpu_torch/serving"])
        assert a == b == []

    def test_suppressions_carry_a_reason(self):
        """Each suppression in the port sits beside a comment that says
        why: on its own line or the line above."""
        for sf in core.iter_source_files(ROOT, DEFAULT_TARGETS):
            for line in sf.suppressions:
                here = sf.comments[line].split("tmcheck:")[0].strip("# ")
                assert here or (line - 1) in sf.comments, \
                    f"{sf.rel}:{line}"


def cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "theanompi_tpu_torch.analysis", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ))


class TestCLI:
    def test_port_tree_exits_zero(self):
        r = cli()
        assert r.returncode == 0, r.stdout + r.stderr

    def test_item_planted_in_train_chunk_exits_one(self, tmp_path):
        """The real ``TMModel.train_chunk`` with a ``.item()`` planted
        inside its step loop: TM104 at that line, exit 1; the file as it
        is: exit 0."""
        src = (ROOT / "theanompi_tpu_torch/models/base.py").read_text()
        clean = tmp_path / "base_clean.py"
        clean.write_text(src)
        loop = ("            rows.append(self._train_step("
                "*self._cached_batch(count + j)))\n")
        assert src.count(loop) == 1
        planted = src.replace(
            loop, loop + "            rows[-1][0].item()\n")
        bad = tmp_path / "base_planted.py"
        bad.write_text(planted)
        assert cli(str(clean)).returncode == 0
        r = cli(str(bad))
        assert r.returncode == 1, r.stdout + r.stderr
        line = planted.splitlines().index(
            "            rows[-1][0].item()") + 1
        assert re.search(rf"base_planted\.py:{line}: TM104 train_chunk",
                         r.stdout), r.stdout
        assert "finding(s)" in r.stderr

    def test_missing_target_exits_two(self):
        r = cli("no/such/dir")
        assert r.returncode == 2
        assert "no such target" in r.stderr

    def test_list_rules(self):
        r = cli("--list-rules")
        assert r.returncode == 0
        for rule in core.RULES:
            assert rule in r.stdout
        assert "TM105" not in r.stdout and "TM106" not in r.stdout

    def test_changed_only_runs(self):
        r = cli("--changed-only")
        assert r.returncode in (0, 1), r.stdout + r.stderr


def entries():
    return refusals.collect(ROOT)


class TestRefusalMatrix:
    def test_known_refusals_present(self):
        msgs = [(e["module"], e["message"] or "") for e in entries()
                if e["message"] is not None]
        assert all(m.startswith("theanompi_tpu_torch/") for m, _ in msgs)
        assert any("base" in m and "zero1" in t for m, t in msgs)
        assert any("decoder" in m and "tensor parallelism" in t
                   for m, t in msgs)
        # the knobs this port now runs refuse nowhere
        assert not any("not ported yet" in t for _, t in msgs)

    def test_bare_raises_are_abstract_slots(self):
        wheres = {e["where"] for e in entries() if e["message"] is None}
        assert "TMModel.build_model" in wheres

    def test_sorted_and_stable(self):
        e1, e2 = entries(), entries()
        assert e1 == e2
        keys = [(e["module"], e["where"], e["message"] or "") for e in e1]
        assert keys == sorted(keys)

    def test_file_matches_code(self):
        doc = (ROOT / refusals.DOC_REL).read_text()
        assert doc == refusals.render(entries()), (
            f"{refusals.DOC_REL} is stale — regenerate with `python -m "
            f"theanompi_tpu_torch.analysis --write-refusals`")

    def test_counts_in_headers(self):
        doc = (ROOT / refusals.DOC_REL).read_text()
        n = sum(1 for e in entries() if e["message"] is not None)
        assert f"## Declared refusals ({n})" in doc
