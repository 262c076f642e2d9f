"""A kernel family's share of its roofline in the traced window.

The share is the least time the window's work could take on the card,
divided by the device time of the family's kernels in the window. The least
time is the larger of the work's operations over the fp32 peak and its
bytes over the memory bandwidth: NVIDIA's H100 SXM data sheet gives 67
TFLOP/s fp32 outside the tensor cores (an FMA counted as two operations, at
700 W) and 3.35 TB/s of HBM3. The kernels are built with ``--fmad=false``
and the operations counted are adds, multiplies, minima, maxima, compares,
selects and square roots, one each, so a share of 50% is about the most
that issuing one such operation per lane and cycle allows: the share reads
low, never high. The work (operations and bytes) is the algorithm's, from
the plain cycle in ``portbench/reference/eikonal.py``, whatever implements
it: each metric's file counts it.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def family_seconds(kernels: Dict[str, float],
                   patterns: Iterable[str]) -> float:
    """Device seconds of every kernel whose name matches one of
    ``patterns`` (regular expressions searched in the name)."""
    rx = [re.compile(p) for p in patterns]
    return sum(s for n, s in kernels.items() if any(r.search(n) for r in rx))


def share(ops: float, bytes_: float, device_s: float) -> Optional[float]:
    """Percent of the roofline, or None where the family did not run (or
    did no counted work) in the window."""
    if device_s <= 0.0 or (ops <= 0.0 and bytes_ <= 0.0):
        return None
    least = max(ops / PEAK_FLOPS, bytes_ / PEAK_BYTES)
    return 100.0 * least / device_s


def delta(ctx: Dict, counter: str) -> Optional[float]:
    """How far a counter moved over the traced window, or None where the
    program has no such counter."""
    a = ctx["counters_before"].get(counter)
    b = ctx["counters_after"].get(counter)
    if a is None or b is None:
        return None
    return float(b - a)


def idle_percent(ctx: Dict) -> Optional[float]:
    """Percent of the traced window with nothing on the device."""
    if ctx["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
