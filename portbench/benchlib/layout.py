"""Where the benchmark's pieces live, found by the names in ``BENCHMARK.json``.

- ``BENCHMARK.json`` at the root of the checkout: the cells and metrics.
- ``portbench/configs/<config>.json``: one deployment (the port's ``grid``,
  ``eikonal``, ``model`` and ``data`` groups as run, its ``source``,
  ``assumed``, the name of its plain reference,
  ``portbench/reference/<reference>.py``, and its cuts: ``reduced`` lists
  the keys cut from the source, as the configuration's entry in
  ``BENCHMARK.json`` lists them, and ``published`` gives each of them a
  line that names the key and its published value).
- ``portbench/workloads/<cell>.json``: one traffic mix on that deployment:
  its ``config`` and ``traffic`` names, the ``driver``, the ``rate`` (the
  end-to-end metric it reports besides ``setup_s``), the ``sampler`` group
  as run, the driver's settings and the ``checks``' limits.
- ``portbench/drivers/<driver>.py``: the program's side of a cell, a class
  ``Run`` with what ``benchlib/cell.py`` uses of it: ``__init__(cell,
  data, seed, device)``, which sets up and warms up; the methods ``chunk``,
  ``start_window``, ``release``, ``check``, ``as_control`` and ``shapes``;
  and the attribute ``phases``, declared in the class.
- ``portbench/reference/<reference>.py``: a plain reference with
  ``make_data``, ``for_config`` and ``tf32``.
- ``portbench/layer_metrics/<metric>.py``: one per-layer metric's reader,
  with ``UNIT``, ``read(ctx)`` and, where it reads the program's counters,
  ``COUNTERS``.

Adding a cell takes new files and entries, and no file here changes:

1. the files it needs that are not there yet: a configuration, its
   workload file, a reference, a driver, and a reader for each new
   per-layer metric;
2. its entry in ``workloads``, and its configuration's in ``configs``
   where that is new;
3. an entry in ``per_layer`` for each new per-layer metric, listing the
   cell under ``workloads``;
4. the cell's name added to the ``workloads`` list of its rate in
   ``end_to_end`` (and of each existing per-layer metric it reports): the
   only change to an entry that is there, needed because :func:`metrics`
   gives a cell only the metrics that list it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return read_json(CHECKOUT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict        # the cell's entry in BENCHMARK.json
    workload: Dict     # portbench/workloads/<name>.json
    config: Dict       # portbench/configs/<config>.json


def cell(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` with its traffic and configuration files; raises
    ``KeyError`` for a name ``BENCHMARK.json`` does not list, ``ValueError``
    where the files disagree with it."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(entries)})")
    entry = entries[name]
    workload = read_json(ROOT / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = read_json(ROOT / "configs" / f"{entry['config']}.json")
    return Cell(name, entry, workload, config)


def metrics(cell_name: str, kind: str, bench: Dict = None) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell_name``
    reports: those whose ``workloads`` list it, and those without the
    key."""
    bench = benchmark() if bench is None else bench
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``name`` (metric files are named
    after metrics, whose names may hold dots)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return load_module(ROOT / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")


def layer_metric(name: str):
    return load_module(ROOT / "layer_metrics" / f"{name}.py",
                       f"portbench_metric_{name}")


def reference(name: str):
    return importlib.import_module(f"reference.{name}")
