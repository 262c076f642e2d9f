"""The harness end to end: it refuses without a card and without the
program, each cell runs through on the CPU at a small size, and the trace
reader's arithmetic."""

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchlib import cell, layout, trace

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def shrink(c):
    """A cell cut to a size the CPU runs in seconds."""
    c = copy.deepcopy(c)
    cfg, s = c.config, c.workload["sampler"]
    cfg["data"].update(n_src=2, n_rec=3)
    if len(cfg["grid"]["shape"]) == 3:
        cfg["grid"]["shape"] = [12, 12, 11]
        cfg["model"]["inv_shape"] = [3, 3, 3]
        s.update(n_chains=16, n_warmup=4)
        if "n_map_steps" in s:
            s["n_map_steps"] = 3
        # Enough steps a chunk that a sound chain moves in a half-second
        # window, which may hold one chunk.
        c.workload["chunk_steps"] = 8
    else:
        cfg["grid"]["shape"] = [16, 15]
        cfg["model"]["inv_shape"] = [4, 4]
        s.update(n_particles=64, n_mutation_steps=20)
        c.workload["check_particles"] = 16
    return c


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without one")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "c2.am16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


FAKE_CARD = """
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ["portbench/run.py", "--workload", "c2.am16", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
runpy.run_path("portbench/run.py", run_name="__main__")
"""


def test_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-c", FAKE_CARD],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "mceik_tpu_torch" in out.stderr


@pytest.mark.parametrize("name", ["c2.am16", "c2.mala16", "c4.smc10k"])
def test_cell_runs_on_the_cpu(name):
    out = cell.run_cell(name, 2 ** 31 + 5, 0.5, False, time.perf_counter(),
                        device="cpu", adjust=shrink)
    c = layout.cell(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", c.workload["rate"]}
    assert out["metrics"][c.workload["rate"]]["value"] > 0
    assert set(out["checks"]) == set(c.workload["checks"])
    assert out["window"]["seconds"] >= 0.5
    assert out["forbidden"] == [] or "jax" in sys.modules


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reader():
    events = [_x(trace.WINDOW, "user_annotation", 100.0, 1000.0),
              _x("aten::item", "cpu_op", 390.0, 30.0),
              _x(trace.CHUNK, "user_annotation", 100.0, 1000.0),
              _x("k", "kernel", 50.0, 100.0),        # clipped to 100-150
              _x("k", "kernel", 140.0, 160.0),       # overlaps: 100-300
              _x("m", "gpu_memcpy", 500.0, 100.0),   # 500-600
              _x("late", "kernel", 1200.0, 10.0)]    # outside the window
    r = trace.read(events)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(300e-6)
    # By name each kernel's own (clipped) time: overlaps count twice there.
    assert r["kernels"] == pytest.approx({"k": 210e-6, "m": 100e-6})
    assert r["device_ops"][0][0] == "k"
    gaps = dict(r["idle_gaps"])
    # 300-500 under aten::item (open at 400), 600-1100 under the chunk.
    assert gaps == pytest.approx({"aten::item": 200e-6,
                                  trace.CHUNK: 500e-6})


def test_judge_counts_failures_and_nan():
    nums = {"lp_rel_gap": (torch.tensor([1e-6, float("nan"), 1e-3]), "max"),
            "stuck": (torch.tensor([0.0, 1.0, 0.0]), "mean")}
    v = cell.judge(nums, {"lp_rel_gap": 1e-4, "stuck": 0.5})
    assert not v["correct"] and v["failed"] == 2 and v["attempted"] == 3
    assert v["checks"]["stuck"]["value"] == pytest.approx(1 / 3)
