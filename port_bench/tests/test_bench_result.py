"""The last line a run prints, and a run without a card."""

import json
import subprocess
import sys

from port_bench import run, spec
from port_bench.drivers import Outcome


def _cell(name):
    return spec.load_cell(name)


def test_result_keys_and_order():
    cell = _cell("train.mistral7b.s4096")
    out = Outcome(end_to_end={"train_tokens_per_s": 1.5, "setup_s": 2.0},
                  numbers={"loss_gap": 0.0, "grad_gap": 0.0,
                           "change_gap": 0.0},
                  attempted=3, memory_peak_bytes=7)
    line = run.result_line(cell, out, False, {"platform": "gpu",
                                              "kind": "x", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert line["metrics"]["setup_s"] == {"value": 2.0, "unit": "s"}
    assert line["device"]["memory_peak_bytes"] == 7
    assert line["correct"] is True
    assert list(line["checks"]) == list(cell.limits["numbers"])
    json.dumps(line, allow_nan=False)


def test_traced_line_has_breakdown_and_a_failed_check():
    cell = _cell("serve.mistral7b.chat")
    out = Outcome(records={"step_s": [0.5, 1.5]},
                  numbers={"served_gap": float("inf")}, busy_s=1.0,
                  window_s=2.0, breakdown={"device_ops": [],
                                           "idle_gaps": []})
    line = run.result_line(cell, out, True, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["metrics"] == {"serve.step_ms": {"value": 1000.0,
                                                 "unit": "ms"}}
    assert line["device"]["busy_s"] == 1.0
    assert line["correct"] is False
    assert line["checks"]["served_gap"]["value"] is None
    json.dumps(line, allow_nan=False)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "train.mistral7b.s4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        cwd=spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
