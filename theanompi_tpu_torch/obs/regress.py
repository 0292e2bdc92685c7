"""Bench-trajectory loader and spread-aware regression verdicts (a
copy of ``theanompi_tpu/obs/regress.py``, which imports no JAX: the
judge the port's benchmark reads its trajectory with).

- :func:`load_capture` parses every capture format: the key/value
  baseline, the wrapper ``{"n", "cmd", "rc", "tail", "parsed"}`` whose
  ``parsed`` holds the full record, the truncated wrapper whose
  ``parsed`` is null (rows are salvaged from the tail text, the
  ``BENCH_HEADLINE`` last line preferred when present), and the
  in-container format ``{"n", "platform", "rows"}``.
- :func:`load_history` orders them (BASELINE, r01, r02, ...) and
  :func:`align_rows` joins per-row across captures.
- :func:`judge` applies spread-aware verdicts: a row is regressed only
  when its adverse move exceeds its own noise band, the largest of the
  two captures' recorded window spreads, the row's own trajectory
  variability (the largest accepted step-to-step excursion among prior
  captures) and an absolute floor (``BAND_FLOOR``) for cross-invocation
  drift the window spread cannot see.
- :func:`judge_record` is the compact verdict a bench record carries.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

#: relative floor of every noise band: window spreads are
#: same-invocation; cross-invocation drift is larger (±4% observed
#: between the JAX package's bench invocations), so the floor doubles it.
BAND_FLOOR = 0.08

#: units where a SMALLER value is the better one
LOWER_BETTER_UNITS = ("wait_frac", "ms/round", "ms", "seconds")

#: baseline-file key -> (row name, unit) for the key/value format
_BASELINE_ROWS = {
    "ResNet50_images_per_sec_per_chip": ("resnet50", "images/sec/chip"),
    "WResNet_images_per_sec_per_chip": ("wresnet", "images/sec/chip"),
    "Llama_tokens_per_sec_per_chip": ("llama", "tokens/sec/chip"),
    "AlexNet_images_per_sec_per_chip": ("alexnet", "images/sec/chip"),
    "Loader_images_per_sec": ("loader", "images/sec"),
}

#: headline-metric prefix -> row name (the top-level record is the
#: flagship; secondary rows already carry their bench names)
_HEADLINE_PREFIXES = (
    ("ResNet50", "resnet50"),
    ("WResNet", "wresnet"),
    ("Llama", "llama"),
    ("AlexNet", "alexnet"),
)


def _row_from_record(rec: dict) -> dict:
    """Normalize one bench record (a row dict with metric/value/...)
    to the fields the verdicts use; the full record rides along."""
    out = {
        "value": rec.get("value"),
        "unit": rec.get("unit"),
        "vs_baseline": rec.get("vs_baseline"),
        "spread": rec.get("spread"),
        "metric": rec.get("metric"),
    }
    if rec.get("error") is not None:
        out["error"] = str(rec["error"])
    return out


def _headline_row_name(metric: str | None) -> str:
    for prefix, name in _HEADLINE_PREFIXES:
        if metric and metric.startswith(prefix):
            return name
    return "headline"


def _add_row(rows: dict, name: str, rec: dict) -> None:
    """One record → one judged row, PLUS one ``"{name}.{sub}"`` row
    per entry in its ``subrows`` dict (the loader bench's sync/
    pipelined A/B arms): sub-arms get their own trajectory
    verdicts instead of hiding inside the parent record, and a
    subrow first appearing on a capture judges ``new`` (non-fatal),
    so growing an A/B never reds the gate retroactively."""
    rows[name] = _row_from_record(rec)
    for sub, srec in (rec.get("subrows") or {}).items():
        if isinstance(srec, dict):
            rows[f"{name}.{sub}"] = _row_from_record(srec)


def _rows_from_parsed(parsed: dict) -> dict:
    rows = {}
    if parsed.get("value") is not None or parsed.get("metric"):
        _add_row(rows, _headline_row_name(parsed.get("metric")),
                 parsed)
    for name, rec in (parsed.get("secondary") or {}).items():
        _add_row(rows, str(name), rec)
    return rows


_SALVAGE_ROW_RE = re.compile(r'"(\w+)":\s*\{"metric":')


def _balanced_object(text: str, start: int) -> str | None:
    """The JSON object starting at ``text[start] == '{'`` — balanced
    braces with string/escape awareness; None when truncated."""
    depth = 0
    in_str = False
    esc = False
    for i in range(start, len(text)):
        c = text[i]
        if esc:
            esc = False
        elif in_str:
            if c == "\\":
                esc = True
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return text[start:i + 1]
    return None


def _rows_from_tail(tail: str) -> dict:
    """Salvage rows from a truncated capture's tail text.

    Preference order: a ``BENCH_HEADLINE {...}`` line (bench.py's
    truncation-proof LAST line — value + vs_baseline per row survive
    any head cut), else every complete ``"<name>": {"metric": ...}``
    object still visible in the tail (the r05 case, which predates
    the headline line: its record line was cut at the head, so the
    flagship row is gone but the later rows parse whole)."""
    rows: dict = {}
    for line in tail.splitlines():
        if line.startswith("BENCH_HEADLINE "):
            try:
                compact = json.loads(line[len("BENCH_HEADLINE "):])
            except ValueError:
                continue
            rows.update(_rows_from_parsed(compact))
    if rows:
        return rows
    for m in _SALVAGE_ROW_RE.finditer(tail):
        obj = _balanced_object(tail, m.end() - len('{"metric":'))
        if obj is None:
            continue
        try:
            rows[m.group(1)] = _row_from_record(json.loads(obj))
        except ValueError:
            continue
    return rows


def load_capture(path: str | Path) -> dict | None:
    """One on-disk capture → ``{"name", "n", "rows", "format",
    "path"}`` (None when the file holds nothing row-shaped).  Never
    raises on a malformed file — a half-written capture must not
    break the gate run that would have caught the regression."""
    path = Path(path)
    m = re.match(r"BENCH_(r?\w+)\.json$", path.name)
    name = m.group(1) if m else path.stem
    try:
        d = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict):
        return None
    fmt, rows, n = None, {}, None
    if "rows" in d and isinstance(d["rows"], dict):
        fmt = "rows"
        n = d.get("n")
        for k, v in d["rows"].items():
            if isinstance(v, dict):
                _add_row(rows, str(k), v)
    elif "parsed" in d or "tail" in d:
        n = d.get("n")
        if isinstance(d.get("parsed"), dict):
            fmt = "wrapper"
            rows = _rows_from_parsed(d["parsed"])
        else:
            fmt = "tail-salvage"
            rows = _rows_from_tail(str(d.get("tail") or ""))
    elif any(k in d for k in _BASELINE_ROWS):
        fmt = "baseline-kv"
        for key, (row, unit) in _BASELINE_ROWS.items():
            if d.get(key) is not None:
                rows[row] = {"value": float(d[key]), "unit": unit,
                             "vs_baseline": 1.0, "spread": None,
                             "metric": key}
    if fmt is None:
        return None
    # stamp the capture's platform onto each row: the judge refuses
    # cross-platform value comparisons (a host-side throughput row
    # captured on the chip-attached machine vs the CPU container is
    # not a trajectory, it is two machines) — legacy formats carry
    # no platform and stay wildcard
    plat = d.get("platform")
    if plat is not None:
        for r in rows.values():
            r.setdefault("platform", plat)
    return {"name": name, "n": n, "rows": rows, "format": fmt,
            "path": str(path)}


def _capture_sort_key(cap: dict):
    m = re.match(r"r(\d+)$", cap["name"])
    if m:
        return (1, int(m.group(1)))
    return (0, 0)       # BASELINE (and anything unnumbered) first


def load_history(repo: str | Path, pattern: str = "BENCH_*.json"
                 ) -> list[dict]:
    """Every parseable capture under ``repo``, trajectory-ordered."""
    caps = []
    for p in sorted(Path(repo).glob(pattern)):
        cap = load_capture(p)
        if cap is not None:
            caps.append(cap)
    caps.sort(key=_capture_sort_key)
    return caps


def align_rows(history: list[dict]) -> dict:
    """``{row_name: [(capture_name, row_or_None), ...]}`` over the
    whole trajectory — the join the verdicts (and the human table)
    walk."""
    names: list[str] = []
    for cap in history:
        for k in cap["rows"]:
            if k not in names:
                names.append(k)
    return {
        k: [(cap["name"], cap["rows"].get(k)) for cap in history]
        for k in names
    }


def higher_is_better(row: dict | None) -> bool:
    unit = str((row or {}).get("unit") or "")
    return not any(unit.startswith(u) or unit == u
                   for u in LOWER_BETTER_UNITS)


def _comparable(cur: dict, prev: dict | None) -> bool:
    """Whether ``prev`` is a valid comparison point for ``cur``: a
    row that DECLARES a platform only judges against its own
    platform's trajectory; a platform-less row (legacy captures, the
    in-flight bench record) compares against anything — it cannot
    demand filtering it never stamped."""
    if prev is None:
        return False
    plat = cur.get("platform")
    return plat is None or prev.get("platform") == plat


def trajectory_band(series: list, upto: int,
                    higher_better: bool = True,
                    like: dict | None = None) -> float:
    """The row's own accepted step-to-step variability: the largest
    ADVERSE-direction excursion among CONSECUTIVE prior captures
    (indices < ``upto``) that both carry values.  Past adverse moves
    were accepted as the trajectory's noise, so the gate must
    tolerate at least that much — the CPU-container serving rows
    swing ~30% between identical runs.  Improvements are NOT noise:
    counting a deliberate 2x win into the band would leave the row
    permanently unguardable (a 50% collapse inside a |ratio-1| band
    of 1.0).  With ``like``, only captures comparable to that row's
    platform contribute (a cross-machine jump is not noise)."""
    vals = [
        row["value"] for _, row in series[:upto]
        if row is not None and row.get("value") is not None
        and row.get("error") is None
        and (like is None or _comparable(like, row))
    ]
    band = 0.0
    for a, b in zip(vals, vals[1:]):
        if a:
            adverse = (1.0 - b / a) if higher_better else (b / a - 1.0)
            band = max(band, adverse)
    return band


def judge(series: list, cur_idx: int | None = None) -> dict:
    """Verdict for the row at ``series[cur_idx]`` (default: last
    capture carrying the row) against the nearest PRIOR capture that
    also carries it.

    Returns ``{"verdict", "ratio", "band", "vs", "value", "prev"}``
    with verdict one of ``ok`` / ``improved`` / ``regressed`` /
    ``new`` (no prior capture has the row) / ``error`` (the current
    capture recorded an error for it) / ``absent`` (the current
    capture does not carry it).  A row that declares a ``platform``
    judges only against same-platform priors (cross-machine
    throughput is two series, not one trajectory) — a row with none
    carries over prior behavior and compares against anything."""
    if cur_idx is None:
        cur_idx = max(
            (i for i, (_, r) in enumerate(series) if r is not None),
            default=len(series) - 1,
        )
    cap_name, cur = series[cur_idx]
    if cur is None:
        return {"verdict": "absent", "vs": None, "capture": cap_name}
    if cur.get("error") is not None:
        return {"verdict": "error", "vs": None, "capture": cap_name,
                "error": cur["error"]}
    prev_idx = next(
        (i for i in range(cur_idx - 1, -1, -1)
         if series[i][1] is not None
         and series[i][1].get("value") is not None
         and series[i][1].get("error") is None
         and _comparable(cur, series[i][1])),
        None,
    )
    if prev_idx is None or cur.get("value") is None:
        return {"verdict": "new", "vs": None, "capture": cap_name,
                "value": cur.get("value")}
    prev_name, prev = series[prev_idx]
    ratio = (
        cur["value"] / prev["value"] if prev["value"] else None
    )
    hib = higher_is_better(cur)
    band = max(
        float(cur.get("spread") or 0.0),
        float(prev.get("spread") or 0.0),
        trajectory_band(series, prev_idx + 1, higher_better=hib,
                        like=cur),
        BAND_FLOOR,
    )
    out = {
        "capture": cap_name,
        "vs": prev_name,
        "value": cur["value"],
        "prev": prev["value"],
        "ratio": round(ratio, 4) if ratio is not None else None,
        "band": round(band, 4),
    }
    if ratio is None:
        out["verdict"] = "ok"
        return out
    adverse = (1.0 - ratio) if hib else (ratio - 1.0)
    if adverse > band:
        out["verdict"] = "regressed"
    elif -adverse > band:
        out["verdict"] = "improved"
    else:
        out["verdict"] = "ok"
    return out


def judge_capture(history: list[dict],
                  cur: dict | None = None) -> dict:
    """Verdicts for every row of the NEWEST capture (or ``cur``, an
    extra capture appended to the history — the in-flight bench
    record judging itself) — the ``--gate`` unit.  Rows older
    captures carried but the newest does not are reported ``absent``
    and never gate."""
    hist = list(history)
    if cur is not None:
        hist.append(cur)
    if not hist:
        return {"capture": None, "rows": {}, "regressed": [],
                "verdict": "ok"}
    aligned = align_rows(hist)
    idx = len(hist) - 1
    rows = {
        name: judge(series, idx)
        for name, series in aligned.items()
    }
    regressed = sorted(
        n for n, v in rows.items() if v["verdict"] == "regressed"
    )
    return {
        "capture": hist[-1]["name"],
        "rows": rows,
        "regressed": regressed,
        "verdict": "regressed" if regressed else "ok",
    }


def record_to_capture(rec: dict, name: str = "current") -> dict:
    """An in-flight bench record (bench.py's one JSON line: headline
    fields + ``secondary``) as a capture the judge accepts."""
    return {"name": name, "n": None, "format": "record",
            "rows": _rows_from_parsed(rec), "path": None}


def judge_record(rec: dict, repo: str | Path) -> dict:
    """The compact self-judgment the ``BENCH_HEADLINE`` line embeds:
    the current record's rows against the newest on-disk capture.
    Never raises — a broken history must not kill the bench."""
    try:
        history = load_history(repo)
        j = judge_capture(history, record_to_capture(rec))
        prevs = sorted({
            v["vs"] for v in j["rows"].values() if v.get("vs")
        })
        return {
            "verdict": j["verdict"],
            "vs": prevs[-1] if prevs else None,
            "regressed": j["regressed"],
        }
    except Exception as e:  # pragma: no cover - defensive
        return {"verdict": "unknown", "error": str(e)[:120]}
