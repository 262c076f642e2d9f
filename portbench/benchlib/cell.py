"""One run of one cell: set-up, the measured window, the trace, the checks.

A driver (``portbench/drivers/<driver>.py``) owns the program's side. Its
``Run(cell, data, seed, device)`` sets the program up on the benchmark's
inputs and warms up every shape of the window; ``chunk()`` makes one call
into the program and returns the work it completed
(``{"steps", "forward_fields", "transport_fields"}``: sampler steps times
chains or particles, and the eikonal and transport field solves that work
needed); ``start_window()`` keeps what the checks need from the window's
start; ``release()`` drops what they do not; ``check(reference)`` returns
the numbers compared, ``{name: (per-answer values, "max" or "mean")}``.

The window: ``chunk()`` until ``seconds`` have passed on the host's clock,
then a device sync; a rate is all its work over all its time. With
``trace`` the same window runs under the profiler, and the per-layer
metrics read its trace and the program's counters.

``setup_s`` is the process's start to the window, less the seconds the
plain reference spends making the inputs (the device's context is made
before them and counts); the device's peak memory is the program's, read
from after the inputs are made.
"""

from __future__ import annotations

import importlib
import math
import sys
import time
from typing import Callable, Dict, Optional

import torch

from benchlib import layout, port, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "mceik_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def counter(spec: str) -> Optional[float]:
    """A program counter named ``"module:attr.attr"`` (an attribute ending in
    ``()`` is called), or None where the program has none such."""
    mod, path = spec.split(":")
    try:
        obj = importlib.import_module(mod)
        for part in path.split("."):
            obj = getattr(obj, part[:-2])() if part.endswith("()") \
                else getattr(obj, part)
    except (ImportError, AttributeError):
        return None
    return float(obj)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _add(total: Dict, work: Dict):
    for k, v in work.items():
        total[k] = total.get(k, 0) + v


def window(run, seconds: float, device) -> Dict:
    """``chunk()`` until ``seconds`` have passed, each inside a
    :data:`trace.CHUNK` span, all inside :data:`trace.WINDOW`; returns the
    work and the seconds from the first sync to the last."""
    work: Dict[str, float] = {}
    with torch.profiler.record_function(trace.WINDOW):
        _sync(device)
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function(trace.CHUNK):
                _add(work, run.chunk())
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
    return {"work": work, "seconds": wall}


def judge(numbers: Dict, limits: Dict) -> Dict:
    """Each number reduced over the answers, beside its limit; ``failed`` is
    the answers beyond a ``max`` number's limit. A NaN is beyond any
    limit."""
    checks, bad = {}, None
    for name, (values, how) in numbers.items():
        values = values.detach().double().cpu()
        value = float(values.max() if how == "max" else values.mean())
        checks[name] = {"value": value, "limit": limits[name]}
        if how == "max":
            over = ~(values <= limits[name])
            bad = over if bad is None else bad | over
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"no number for the limits {missing}")
    n = len(next(iter(numbers.values()))[0])
    return {"checks": checks, "attempted": n,
            "failed": int(bad.sum()) if bad is not None else 0,
            "correct": all(c["value"] <= c["limit"] for c in checks.values())}


class Memo:
    """A reference with each method's results kept by their input, so that
    the fp32 reference is computed once for the program and its control."""

    def __init__(self, ref):
        self.ref, self.kept = ref, []

    def __getattr__(self, name):
        def call(u):
            for n, v, out in self.kept:
                if n == name and v.shape == u.shape and torch.equal(v, u):
                    return out
            out = getattr(self.ref, name)(u)
            self.kept.append((name, u, out))
            return out
        return call


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda",
             adjust: Optional[Callable[[layout.Cell], layout.Cell]] = None,
             control: bool = False) -> Dict:
    """One run of the cell ``name``; returns the result's fields (without
    ``device``'s name and count, which the caller adds). ``adjust`` edits
    the cell's files as loaded (the tests shrink a cell to run on the
    CPU). With ``control``, the checks are also made of the control (the
    plain reference with TF32 matrix products put in the program's place,
    at the program's last states), under ``"control"``."""
    bench = layout.benchmark()
    c = layout.cell(name, bench)
    if adjust is not None:
        c = adjust(c)
    ref_mod = layout.reference(c.config["reference"])
    run = layout.driver(c.workload["driver"]).Run
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.zeros((), device=device)
    clock = port.Clock(device)
    data = ref_mod.make_data(c.config, seed, device)
    clock.lap("data")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    run = run(c, data, seed, device)
    end_to_end = layout.metrics(name, "end_to_end", bench)
    per_layer = [m["name"] for m in layout.metrics(name, "per_layer", bench)]
    readers = {m: layout.layer_metric(m) for m in per_layer} if traced else {}
    specs = {k: v for r in readers.values()
             for k, v in getattr(r, "COUNTERS", {}).items()}
    before = {k: counter(v) for k, v in specs.items()}
    run.start_window()
    _sync(device)
    setup_s = time.perf_counter() - t_start - clock.laps["data"]

    measure = lambda: window(run, seconds, device)
    if traced:
        win, tr = trace.profiled(measure)
    else:
        win, tr = measure(), None
    after = {k: counter(v) for k, v in specs.items()}
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    found = forbidden_modules()

    metrics = {}
    if traced:
        ctx = {"window_s": tr["window_s"], "busy_s": tr["busy_s"],
               "kernels": tr["kernels"], "counters_before": before,
               "counters_after": after, "work": win["work"],
               "shapes": run.shapes()}
        for m, reader in readers.items():
            value = reader.read(ctx)
            if value is not None and math.isfinite(value):
                metrics[m] = {"value": value, "unit": reader.UNIT}
    else:
        rate = c.workload["rate"]
        for m in end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == rate:
                rate_value = win["work"]["steps"] / win["seconds"]
                metrics[rate] = {"value": rate_value, "unit": m["unit"]}
            else:
                raise ValueError(f"cell {name} has no reading for {m['name']}")

    run.release()
    if cuda:
        torch.cuda.empty_cache()
    ref = ref_mod.for_config(c.config, data, device)
    limits = c.workload["checks"]
    if control:
        ref = Memo(ref)
    verdict = judge(run.check(ref), limits)
    out = {"correct": verdict["correct"] and not found,
           "attempted": verdict["attempted"], "failed": verdict["failed"],
           "metrics": metrics, "memory_peak_bytes": peak,
           "forbidden": found, "checks": verdict["checks"],
           "setup_s": setup_s, "phases": {**clock.laps, **run.phases},
           "window": win}
    if traced:
        out["busy_s"], out["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    if control:
        with ref_mod.tf32(True):
            run.as_control(ref.ref)
        out["control"] = judge(run.check(ref), limits)["checks"]
    return out
