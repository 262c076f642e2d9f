"""Device profile of sampler steps on the card.

    python -m mceik_tpu_torch.diag.profile configs/c2_mala.json [overrides] [--warm N] [--steps N]

Builds the config's posterior and sampler as ``api.run`` does (the Laplace
setup included), runs ``--warm`` warmup steps, times ``--steps`` steps with
the host clock around a synchronised loop, then traces ``--steps`` more
with ``torch.profiler``. Prints one JSON line: chain-steps/s, the device's
busy and idle share of the traced window (kernel and copy intervals
merged), and device time by kernel name. Needs a CUDA device: a
measurement path does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from mceik_tpu_torch.io.config_io import apply_overrides, load_config


def _busy_ms(events) -> float:
    """Union of device intervals (kernels, copies, sets), in ms."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mceik_tpu_torch.diag.profile")
    p.add_argument("config")
    p.add_argument("overrides", nargs="*")
    p.add_argument("--warm", type=int, default=5)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="path of the Chrome trace (default: a temp file)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: torch sees no CUDA device")
    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    from mceik_tpu_torch.api import _dispatch_sampler, _check_supported
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.io.metrics import MetricsLogger
    from mceik_tpu_torch.model.posterior import build_posterior
    from mceik_tpu_torch.samplers.base import run_mcmc

    _check_supported(cfg)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    scfg = cfg.sampler
    grid = cfg.grid.build()
    data, _ = make_dataset(grid, cfg.data, cfg.model, device=dev)
    post = build_posterior(cfg.model, data, grid, cfg.eikonal,
                           differentiable=scfg.algorithm == "mala")
    gen = torch.Generator(device=dev).manual_seed(scfg.seed)
    kernel, adapter, hyper, finalize_fn, states = _dispatch_sampler(
        scfg, post, gen, MetricsLogger())
    r = run_mcmc(kernel, adapter, states, hyper, gen, n_warmup=args.warm,
                 n_steps=0, finalize_fn=finalize_fn)
    states, hyper = r.states, r.hyper

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_mcmc(kernel, None, states, hyper, gen, n_warmup=0,
                 n_steps=args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    states = r.states

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_mcmc(kernel, None, states, hyper, gen, n_warmup=0,
                 n_steps=args.steps)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
    path = args.trace or os.path.join(tempfile.gettempdir(),
                                      "mceik_profile_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    dev_events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _busy_ms(dev_events)
    by_name = {}
    for e in dev_events:
        rec = by_name.setdefault(e["name"], [0, 0.0])
        rec[0] += 1
        rec[1] += e["dur"] / 1e3
    total = sum(v[1] for v in by_name.values()) or float("nan")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "config": args.config, "overrides": args.overrides,
        "device": torch.cuda.get_device_name(0),
        "n_chains": scfg.n_chains, "steps": args.steps,
        "chain_steps_per_s": args.steps * scfg.n_chains / wall,
        "ms_per_step": wall * 1e3 / args.steps,
        "traced_window_ms": window_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / window_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "kernels": [{"name": n[:90], "calls": c, "ms": round(ms, 3),
                     "share": round(ms / total, 4)} for n, (c, ms) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
