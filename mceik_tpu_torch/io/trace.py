"""The program's tracing: ``io.profile_dir`` traces, the ``mceik.*`` spans
and the host-sync counter.

``io.profile_dir``: a ``torch.profiler`` trace of one segment of a run.
Counterpart of the reference's ``jax.profiler`` trace of the second segment
(``mceik_tpu/api.py``): ``api.run`` traces its second sampling segment and
``samplers.smc.run_smc`` its second stage, on rank 0, and write the trace
as Chrome trace JSON, ``<profile_dir>/trace.json``.

Spans. :func:`span` marks one call at a layer boundary (``mceik.mcmc.step``,
``mceik.eikonal.solve``, ...) as a ``record_function`` range, so that any
``torch.profiler`` trace of the program, ``io.profile_dir``'s included,
shows it on the host's timeline beside the device's kernels, and the idle
stretches between kernels fall under the span that was open. With no
profiler running a span is one shared no-op context: a ``with`` over a
``record_function`` costs ~10 us even then, over a span ~0.4 us (an H100
machine's host).

Host syncs. :data:`COUNTERS` ``.host_syncs`` counts the places where the
host waits for the device's stream: a device value read to the host
(:func:`host_bool`, :func:`host_float`), a host value copied to the device
from pageable memory (:func:`device_tensor`), and a library call that reads
the device by itself (``torch.nonzero``'s size, ``torch.linalg.cholesky``'s
check of its result: :func:`host_sync` beside it). On the card each is a sync
(``torch.cuda.set_sync_debug_mode("warn")`` flags each once); the count is
raised whatever the device, so that a CPU run counts what a card would
wait for. Read it before and after a stretch of a run, as the kernels'
``launches`` and ``field_cycles()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch


def profiler(device: torch.device):
    """A ``torch.profiler`` of the CPU and, on the card, CUDA activities."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def write_trace(prof, profile_dir: str, verbose: bool, what: str) -> str:
    """Write ``prof``'s trace to ``profile_dir/trace.json``; returns the
    path."""
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    if verbose:
        print(f"[mceik-tpu-torch] profile of {what} written to {path}")
    return path


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else one
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@dataclasses.dataclass
class Counters:
    """The program's host-side counters (plain integers, raised in place)."""

    host_syncs: int = 0


COUNTERS = Counters()


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)``, counted as one host sync."""
    COUNTERS.host_syncs += 1
    return bool(t)


def host_float(t: torch.Tensor) -> float:
    """``float(t)``, counted as one host sync."""
    COUNTERS.host_syncs += 1
    return float(t)


def host_sync() -> None:
    """Count one host sync that the library call beside it makes by
    itself."""
    COUNTERS.host_syncs += 1


def device_tensor(data, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(data, dtype=dtype, device=device)``: a host value
    copied to the device, counted as one host sync."""
    COUNTERS.host_syncs += 1
    return torch.tensor(data, dtype=dtype, device=device)
