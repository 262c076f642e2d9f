"""Every file the harness finds by name is there, parses, and names what
exists; BENCHMARK.json keeps to its contract's shape."""

import json
import re

import pytest

from benchlib import layout

BENCH = layout.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_their_keys(kind, keys):
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse_and_agree(name):
    c = layout.cell(name)
    assert c.workload["driver"] in ("mcmc", "smc")
    assert (layout.ROOT / "drivers" / f"{c.workload['driver']}.py").exists()
    assert (layout.ROOT / "reference"
            / f"{c.config['reference']}.py").exists()
    assert c.config["reduced"] == []
    rates = [m["name"] for m in layout.metrics(name, "end_to_end")]
    assert c.workload["rate"] in rates and "setup_s" in rates
    assert layout.metrics(name, "per_layer")
    assert set(c.workload["checks"]) >= {"lp_rel_gap", "stuck"}


def test_config_files_are_named_by_their_entries():
    for e in BENCH["configs"]:
        cfg = layout.read_json(layout.CHECKOUT / e["file"])
        assert e["file"] == f"portbench/configs/{e['name']}.json"
        assert cfg["source"] == e["source"]
        assert cfg["reduced"] == e["reduced"]
        assert {"grid", "eikonal", "model", "data"} <= set(cfg)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_metric_files(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = layout.layer_metric(metric)
    assert reader.UNIT == entry["unit"] and callable(reader.read)
    assert set(entry["workloads"]) <= set(CELLS)
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[entry["moves"]]
    # Every cell the metric lists reports the metric it moves.
    assert set(entry["workloads"]) <= set(moves.get("workloads", CELLS))


def test_every_cell_file_is_a_cell():
    files = {p.stem for p in (layout.ROOT / "workloads").glob("*.json")}
    assert files == set(CELLS)
    configs = {p.stem for p in (layout.ROOT / "configs").glob("*.json")}
    assert configs == {c["name"] for c in BENCH["configs"]}


def test_benchmark_json_is_small():
    assert len(json.dumps(BENCH)) < 64 * 1024
