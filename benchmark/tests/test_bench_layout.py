"""The benchmark's files: discovery by name, and BENCHMARK.json within the
limits its readers hold it to."""

from __future__ import annotations

import importlib.util
import json
import re

import pytest

from benchmark.cell import HERE, ROOT, benchmark_json, load_cell
from benchmark.run import end_to_end_entries, per_layer_readers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_WORDS = ("ch", "hidden", "width", "_dim", "_rank")


@pytest.fixture(scope="module")
def bench():
    return benchmark_json()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_keys(bench, kind):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}[kind]
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    for e in bench[kind]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_configs_found_by_name(bench):
    for c in bench["configs"]:
        meta = json.loads((ROOT / c["file"]).read_text())
        assert meta["name"] == c["name"] and meta["source"] == c["source"]
        assert meta["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS), c["reduced"]
        assert set(c["reduced"]) <= set(meta["published"])
        assert meta["flops_per_step"]["with_r1"] > 0


def test_cells_found_by_name(bench):
    names = {c["name"] for c in bench["configs"]}
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cell = load_cell(w["name"])
        assert cell.ranks == w["chips"]
        assert cell.limits, f"{w['name']} has no limits file"
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        reported = {m["name"] for m in end_to_end_entries(w["name"], bench)}
        assert "setup_s" in reported and len(reported) >= 2
        assert per_layer_readers(w["name"], bench)


def test_every_reader_is_a_file_of_its_own(bench):
    for m in bench["per_layer"]:
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)


def test_layers_named_alike(bench):
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert all(len(prefixes) == 1 for prefixes in by_layer.values()), by_layer
