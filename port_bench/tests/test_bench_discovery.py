"""A configuration, a traffic mix, a traffic generator, a limit and a
metric added as new files are found by their names, with no other file
edited."""

import json

from port_bench import spec


def test_new_files_are_found(tmp_path):
    bench_dir = tmp_path / "bench"
    for sub in ("configs", "traffic", "generators", "limits", "metrics"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "newmodel.json").write_text(
        json.dumps({"hidden_size": 8}))
    (bench_dir / "traffic" / "newmix.json").write_text(
        json.dumps({"driver": "serve", "generator": "bursts",
                    "clients": 3}))
    (bench_dir / "generators" / "bursts.py").write_text(
        "def make(traffic, vocab, seed):\n"
        "    return [(0.0, [seed % vocab], traffic['clients'])]\n")
    (bench_dir / "limits" / "serve.newmodel.newmix.json").write_text(
        json.dumps({"numbers": {"served_gap": {"limit": 0.5}}}))
    (bench_dir / "metrics" / "new.metric.py").write_text(
        "def read(rec):\n    return rec.get('x', 0) * 2\n")
    bench = {
        "configs": [{"name": "newmodel", "file": "bench/configs/newmodel.json"}],
        "workloads": [{"name": "serve.newmodel.newmix", "config": "newmodel",
                       "traffic": "newmix", "chips": 1}],
        "end_to_end": [
            {"name": "setup_s"},
            {"name": "other", "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "new.metric",
                       "workloads": ["serve.newmodel.newmix"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("serve.newmodel.newmix", root=tmp_path,
                          bench_dir=bench_dir)
    assert cell.config == {"hidden_size": 8}
    assert cell.traffic["clients"] == 3
    assert cell.limits["numbers"]["served_gap"]["limit"] == 0.5
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert spec.load_reader("new.metric", bench_dir)({"x": 4}) == 8
    make = spec.load_generator(cell.traffic["generator"], bench_dir)
    assert make(cell.traffic, 10, 23) == [(0.0, [3], 3)]


def test_every_cell_of_the_benchmark_loads():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["driver"] in ("train", "serve")
        assert callable(spec.load_generator(cell.traffic["generator"]))
        assert cell.limits["numbers"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(spec.load_reader(m["name"]))
