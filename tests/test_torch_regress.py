"""The port's ``obs/regress`` (a copy) against the JAX package's: the
cases of the JAX package's ``tests/test_bench_regress.py`` run through
both modules, on captures written to ``tmp_path`` (the repository's own
``BENCH_*.json`` files copied there, and synthetic ones in the
in-container format), give equal results."""

import json
import shutil
from pathlib import Path

import pytest

from theanompi_tpu.obs import regress as jax_rg
from theanompi_tpu_torch.obs import regress as port_rg

ROOT = Path(__file__).resolve().parent.parent


def row(value, unit="images/sec/chip", spread=None, error=None, **kw):
    r = {"value": value, "unit": unit, "vs_baseline": None,
         "spread": spread, "metric": "m", **kw}
    if error is not None:
        r["error"] = error
    return r


def write_capture(d: Path, name: str, rows: dict) -> None:
    (d / f"BENCH_{name}.json").write_text(json.dumps(
        {"n": int(name[1:]) if name[1:].isdigit() else None,
         "platform": "cpu-container", "rows": rows}))


def both(fn_name, *args, **kw):
    want = getattr(jax_rg, fn_name)(*args, **kw)
    got = getattr(port_rg, fn_name)(*args, **kw)
    assert got == want, fn_name
    return got


@pytest.fixture
def repo_copy(tmp_path):
    """The repository's captures, copied."""
    for f in ROOT.glob("BENCH_*.json"):
        shutil.copy(f, tmp_path / f.name)
    return tmp_path


def test_constants_equal():
    assert port_rg.BAND_FLOOR == jax_rg.BAND_FLOOR
    assert port_rg.LOWER_BETTER_UNITS == jax_rg.LOWER_BETTER_UNITS


def test_every_capture_loads_the_same(repo_copy):
    files = sorted(repo_copy.glob("BENCH_*.json"))
    assert files
    for f in files:
        both("load_capture", f)


def test_history_rows_and_verdict_over_the_trajectory(repo_copy):
    hist = both("load_history", repo_copy)
    both("align_rows", hist)
    both("judge_capture", hist)


@pytest.mark.parametrize("values,unit,cur,spread", [
    ([100.0, 101.0, 99.5, 100.5], "images/sec/chip", 80.0, 0.02),
    ([100.0, 101.0, 99.5], "images/sec/chip", 95.0, 0.02),
    ([100.0, 100.5], "images/sec/chip", 130.0, 0.02),
    ([100.0, 210.0], "images/sec/chip", 110.0, 0.02),
    ([100.0, 70.0, 95.0], "images/sec/chip", 72.0, None),
    ([100.0, 100.0], "images/sec/chip", 80.0, 0.25),
    ([10.0, 10.1], "ms/round", 13.0, 0.02),
    ([10.0, 10.1], "ms/round", 8.0, 0.02),
    ([100.0], "images/sec/chip", 100.0, None),
])
def test_synthetic_trajectories_written_to_disk(tmp_path, values, unit, cur,
                                                spread):
    """The JAX test's synthetic verdict cases as capture files: the
    history, then the current capture judged against it."""
    for i, v in enumerate(values):
        write_capture(tmp_path, f"r{i + 1:02d}",
                      {"row": row(v, unit=unit, spread=spread)})
    hist = both("load_history", tmp_path)
    write_capture(tmp_path, "r99", {"row": row(cur, unit=unit, spread=spread),
                                    "fresh": row(5.0)})
    cur_cap = both("load_capture", tmp_path / "BENCH_r99.json")
    both("judge_capture", hist, cur_cap)
    both("judge_capture", both("load_history", tmp_path))


def test_error_and_platform_cases(tmp_path):
    write_capture(tmp_path, "r01", {"row": row(100.0, spread=0.02)})
    write_capture(tmp_path, "r02", {"row": row(101.0, spread=0.02)})
    write_capture(tmp_path, "r03", {"row": row(None, error="infra")})
    write_capture(tmp_path, "r04", {"row": row(2900.0, unit="images/sec",
                                               platform="chip")})
    hist = both("load_history", tmp_path)
    for cur in ({"row": row(100.5, spread=0.02)},
                {"row": row(None, error="boom")},
                {"row": row(1650.0, unit="images/sec",
                            platform="cpu-container")}):
        both("judge_capture", hist, both("record_to_capture", {
            "metric": "m", "value": None, "secondary": cur}))
    both("judge", [("r01", row(100.0, spread=0.02)), ("r02", None),
                   ("r03", row(None, error="x")), ("r04", row(90.0))])


def test_judge_record_on_the_trajectory(repo_copy, tmp_path):
    rec = {"metric": "ResNet50 images/sec/chip (BSP)", "value": 2300.0,
           "unit": "images/sec/chip",
           "secondary": {"serving": {"value": 1900.0,
                                     "unit": "tokens/sec"}}}
    both("judge_record", rec, repo_copy)
    empty = tmp_path / "empty"
    empty.mkdir()
    both("judge_record", {"value": 1.0}, empty)
