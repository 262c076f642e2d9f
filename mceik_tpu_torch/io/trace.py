"""``io.profile_dir``: a ``torch.profiler`` trace of one segment of a run.

Counterpart of the reference's ``jax.profiler`` trace of the second segment
(``mceik_tpu/api.py``): ``api.run`` traces its second sampling segment and
``samplers.smc.run_smc`` its second stage, on rank 0, and write the trace
as Chrome trace JSON, ``<profile_dir>/trace.json``.
"""

from __future__ import annotations

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
