"""The traced window: ``torch.profiler`` around it, and what its Chrome trace
says about the device.

The window runs inside a ``record_function`` span (:data:`WINDOW`), each of
its calls into the program inside another (:data:`CHUNK`). From the trace:

- ``window_s``: the window span's length;
- ``busy_s``: the union of the device's intervals (kernels, copies, sets)
  inside it, so that overlapping work counts once;
- ``kernels``: device seconds by name inside it;
- ``idle_gaps``: each stretch inside the window with nothing on the device,
  put under the innermost host span that was open at its middle (an ATen
  op, a CUDA runtime call or a benchmark span).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
CHUNK = "portbench.chunk"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def profiled(fn: Callable[[], object]) -> Tuple[object, Dict]:
    """Run ``fn`` (which opens the :data:`WINDOW` span itself) under the
    profiler; returns its result and :func:`read` of the trace, written to a
    file of this run's own under ``TMPDIR`` and removed after."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return out, read(events)


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(events: List[Dict]) -> Dict:
    """``window_s``, ``busy_s``, ``kernels`` (device seconds by name) and the
    breakdown's ``device_ops`` and ``idle_gaps`` (the ten largest, seconds
    summed by name) of the :data:`WINDOW` span in a Chrome trace's events.
    Times in the trace are microseconds."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + (b - a) / 1e6
    busy = union(dev)
    busy_us = sum(b - a for a, b in busy)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": kernels,
            "device_ops": sorted(([n, s] for n, s in kernels.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": _label_gaps(gaps, spans, w0, w1)}


def _label_gaps(gaps, spans, w0, w1) -> List[List]:
    """Idle seconds summed under the innermost host span open at each gap's
    middle; the ten largest sums."""
    host = []
    for e in spans:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if (e.get("cat") in HOST_CATS and e.get("name") != WINDOW
                and a < w1 and b > w0):
            host.append((a, b, e["name"]))
    host.sort()
    totals: Dict[str, float] = {}
    open_spans: List[Tuple[float, float, str]] = []   # (length, end, name)
    k = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= mid:
            s, e, n = host[k]
            heapq.heappush(open_spans, (e - s, e, n))
            k += 1
        while open_spans and open_spans[0][1] < mid:
            heapq.heappop(open_spans)
        name = open_spans[0][2] if open_spans else WINDOW
        totals[name] = totals.get(name, 0.0) + (b - a) / 1e6
    return sorted(([n, s] for n, s in totals.items()),
                  key=lambda x: -x[1])[:TOP]
