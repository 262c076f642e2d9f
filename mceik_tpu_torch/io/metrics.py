"""Structured metrics logging: per-segment JSONL records on stdout.
Counterpart of ``mceik_tpu/io/metrics.py``."""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    """Prints ``[mceik] {"t": seconds since creation, ...}`` lines."""

    def __init__(self, stream=None, prefix: str = "mceik"):
        self._stream = stream
        self._prefix = prefix
        self._t0 = time.perf_counter()

    def log(self, record: dict) -> None:
        rec = {"t": round(time.perf_counter() - self._t0, 3), **record}
        stream = self._stream if self._stream is not None else sys.stdout
        print(f"[{self._prefix}] {json.dumps(rec)}", file=stream, flush=True)
