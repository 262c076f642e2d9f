"""Every file the harness finds by name is there, parses, and names what
exists; BENCHMARK.json keeps to its contract's shape."""

import json
import re

import pytest

from benchlib import layout

BENCH = layout.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# What ``benchlib/cell.py`` uses of a driver's ``Run``.
DRIVER_MEMBERS = ("chunk", "start_window", "release", "check", "as_control",
                  "shapes", "phases")


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


def _has_member(run, name):
    """A method of the class, or an attribute it declares (an annotation at
    class level names one that ``__init__`` sets)."""
    return hasattr(run, name) or name in getattr(run, "__annotations__", {})


def cell_faults(c, root=layout.ROOT, bench=BENCH):
    """What keeps the cell ``c`` (a ``layout.Cell``) from running, each as a
    line: its driver file, with a ``Run`` class that has every member
    ``benchlib/cell.py`` uses; its reference file; its cuts; its rate and
    set-up time among its end-to-end metrics, a per-layer metric, and the
    checks every driver makes."""
    faults = []
    driver = root / "drivers" / f"{c.workload['driver']}.py"
    if not driver.exists():
        faults.append(f"no driver file {driver}")
    else:
        run = getattr(layout.load_module(driver, re.sub(r"\W", "_",
                                                        str(driver))),
                      "Run", None)
        if run is None:
            faults.append(f"{driver.name} defines no Run")
        else:
            faults += [f"{driver.name}'s Run has no {m}" for m in DRIVER_MEMBERS
                       if not _has_member(run, m)]
    if not (root / "reference" / f"{c.config['reference']}.py").exists():
        faults.append(f"no reference {c.config['reference']}")
    faults += reduced_faults(c.config)
    rates = [m["name"] for m in layout.metrics(c.name, "end_to_end", bench)]
    if c.workload["rate"] not in rates or "setup_s" not in rates:
        faults.append(f"{c.name} reports {rates}")
    if not layout.metrics(c.name, "per_layer", bench):
        faults.append(f"{c.name} has no per-layer metric")
    if not set(c.workload["checks"]) >= {"lp_rel_gap", "stuck"}:
        faults.append(f"{c.name} checks {sorted(c.workload['checks'])}")
    return faults


def reduced_faults(config):
    """A configuration's cuts: ``reduced`` lists the keys cut (names, as
    BENCHMARK.json lists them), and ``published`` gives, for each and no
    other, a line of at most 200 characters that names the key and its
    published value."""
    reduced = config["reduced"]
    published = config.get("published", {})
    faults = [f"reduced key {k!r} is not a name" for k in reduced
              if not isinstance(k, str) or not NAME.match(k)]
    if set(published) != set(reduced):
        faults.append(f"published {sorted(published)} against reduced "
                      f"{sorted(reduced)}")
    for k, line in published.items():
        if not (isinstance(line, str) and 1 <= len(line) <= 200
                and "\n" not in line and k in line):
            faults.append(f"published[{k!r}] does not name the key and its "
                          "published value in a line")
    return faults


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse_and_agree(name):
    assert cell_faults(layout.cell(name)) == []


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


MADE_UP_DRIVER = """
class Run:
    phases: dict

    def __init__(self, cell, data, seed, device):
        self.phases = {}

    def chunk(self):
        return {"steps": 1}

    def start_window(self):
        pass

    def release(self):
        pass

    def check(self, ref):
        return {}

    def as_control(self, ref):
        pass

    def shapes(self):
        return {}
"""


def _made_up_cell(tmp_path, driver_source):
    """A cell on a third driver, ``joint``, whose configuration cuts a key:
    its files under ``tmp_path`` as the layout puts them, its entries
    beside the benchmark's own."""
    root = tmp_path / "portbench"
    for sub in ("drivers", "reference"):
        (root / sub).mkdir(parents=True)
    (root / "drivers" / "joint.py").write_text(driver_source)
    (root / "reference" / "joint_ref.py").write_text("")
    config = {"reference": "joint_ref", "reduced": ["max_tree_depth"],
              "published": {"max_tree_depth": "max_tree_depth 7 in the "
                            "source's configs/c5_pod_nuts.json, cut to 2"},
              "grid": {}, "eikonal": {}, "model": {}, "data": {}}
    workload = {"config": "made_up", "traffic": "nuts2", "driver": "joint",
                "rate": "chain_steps_per_s",
                "checks": {"lp_rel_gap": 1e-4, "stuck": 0.5}}
    entry = {"name": "made_up.nuts2", "config": "made_up", "traffic": "nuts2",
             "chips": 1, "why": "a made-up cell"}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(entry)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("chain_steps_per_s", "idle_share.mcmc"):
            m["workloads"].append(entry["name"])
    c = layout.Cell(entry["name"], entry, workload, config)
    return c, root, bench


def test_a_new_driver_and_a_cut_pass(tmp_path):
    c, root, bench = _made_up_cell(tmp_path, MADE_UP_DRIVER)
    assert cell_faults(c, root, bench) == []


@pytest.mark.parametrize("source,fault", [
    ("class Other:\n    pass\n", "defines no Run"),
    (MADE_UP_DRIVER.replace("def as_control", "def not_control"),
     "Run has no as_control"),
    (MADE_UP_DRIVER.replace("    phases: dict\n", ""), "Run has no phases"),
])
def test_a_driver_without_run_fails(tmp_path, source, fault):
    c, root, bench = _made_up_cell(tmp_path, source)
    assert any(fault in f for f in cell_faults(c, root, bench))


@pytest.mark.parametrize("change,fault", [
    (lambda cfg: cfg["reduced"].append("num chains"), "not a name"),
    (lambda cfg: cfg["published"].pop("max_tree_depth"), "published"),
    (lambda cfg: cfg["published"].update(max_tree_depth="7"), "name the key"),
    (lambda cfg: cfg["published"].update(
        max_tree_depth="max_tree_depth " + "x" * 200), "name the key"),
])
def test_a_cut_not_written_down_fails(tmp_path, change, fault):
    c, root, bench = _made_up_cell(tmp_path, MADE_UP_DRIVER)
    change(c.config)
    assert any(fault in f for f in cell_faults(c, root, bench))


def test_benchmark_json_is_small():
    assert len(json.dumps(BENCH)) < 64 * 1024
