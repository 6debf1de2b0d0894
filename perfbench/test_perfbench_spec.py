"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, generator and metric readers load by name, a workload file
added elsewhere is found with no edit, and every name, unit and key
keeps to the benchmark's rules."""

import json
import re
import shutil

import pytest

from perfbench import harness, spec, tiny

BENCH = spec.load_json(spec.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    c = spec.cell(name)
    assert c.config["name"] == c.entry["config"]
    spec.load_module("data", c.config["data"]["generator"])
    traffic = spec.load_module("traffic", c.workload["generator"])
    assert callable(traffic.run) and callable(traffic.warmup)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.workload["check"]["limits"]) == {"dist_gap", "rank_gap"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.REPO / "perfbench" / "run.py").is_file()


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("perfbench/")
        cfg = spec.load_json(spec.REPO / c["file"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert spec.NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and key != "dim"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME.match(w["name"]) and w["name"] not in names
        assert spec.NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        names.add(w["name"])
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads", "layer", "moves"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    perf = (spec.REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert f"`{m['layer']}`" in perf
        moved = next(x for x in BENCH["end_to_end"]
                     if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_files_under_perfbench_are_named_from_name_characters():
    for p in (spec.REPO / "perfbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(spec.REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel


def test_added_workload_file_is_found_with_no_edit(tmp_path):
    """A new cell is a workload file and an entry: copy the benchmark,
    add an open-loop cell as data only, and run it at a tiny size."""
    base = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "deep1b.open_l10", "config": "deep1b-96d",
        "traffic": "open_l10", "chips": 1,
        "why": "single-query requests at l = 10, Poisson arrivals"})
    bench["end_to_end"][1].pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = {"name": "deep1b.open_l10", "config": "deep1b-96d",
          "traffic": "open_l10", "generator": "open_loop",
          "params": {"rate": 40.0, "l": 10}, "query_pool": 64,
          "check": {"sample": 8,
                    "limits": {"dist_gap": 1e-5, "rank_gap": 1e-5}},
          "why": "added as data only"}
    (base / "workloads" / "deep1b.open_l10.json").write_text(
        json.dumps(wl))
    c = tiny.cell("deep1b.open_l10", bench_path=tmp_path / "BENCHMARK.json",
                  base=base)
    c.config["service"] = dict(c.config["service"],
                               bucket_sizes=[1, 2, 4, 8])
    assert c.base == base and c.workload["generator"] == "open_loop"
    assert "latency_p95_ms" in {m["name"] for m in c.end_to_end}
    line = harness.run_cell(c, 2**34 + 5, 0.3, False, "cpu", 0.0)
    assert line["correct"] and line["attempted"] > 0
    assert line["metrics"]["latency_p95_ms"]["value"] > 0
