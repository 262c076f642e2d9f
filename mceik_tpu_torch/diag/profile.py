"""Device profile of sampler steps on the card.

    python -m mceik_tpu_torch.diag.profile configs/c2_mala.json [overrides] [--warm N] [--steps N]

For an MCMC config (rwm, am, am_full, pcn, mala, hmc, nuts): builds the
config's posterior and sampler as ``api.run`` does (the Laplace setup
included), runs ``--warm`` warmup steps, times ``--steps`` steps with the
host clock around a synchronised loop (with the kernels' launches per step
and the mean of every per-chain info entry, e.g. NUTS's tree depth), then
traces ``--steps`` more with ``torch.profiler``. Config 3's NUTS:
``configs/c3_joint_events.json --warm 5 --steps 3``. Under spike-slab noise
(config 5) the warmup is the annealed one of ``api.run`` and every step
ends with the Gibbs scan over the station indicators.

``--grad-chains 8,16`` first times one batched ``value_and_grad`` at each
of those chain counts (chains started as the sampler starts them), with its
K1 and transport launches (cycles per forward and per transport solve) and
its peak device memory in GB (1e9 bytes), and from the last two counts the
largest chain count whose gradient leaves 10 GB of the card's memory free
(memory is affine in the chain count); ``--steps 0`` stops there. Config
5: ``configs/c5_pod_nuts.json --grad-chains 8,16 --steps 0``, then its
NUTS with ``sampler.n_chains=4 sampler.max_tree_depth=3 --warm 4 --steps 2``.
Config 1 under NUTS (2-D gradients through K3 and K6):
``configs/c1_crosswell.json sampler.algorithm=nuts sampler.thin=1 --warm 100
--steps 20``.

For an SMC config (``configs/c4_smc.json``) a step is one stage of the
ladder (``samplers.smc.stage``: the next beta, reweight and resample, the
mutation steps) over the whole population: ``--warm`` stages, then
``--steps`` stages timed, each preceded by a timed ``next_beta`` alone on
the same particles (its bisection syncs the device once per probe), then
``--steps`` stages traced.

Prints one JSON line: steps/s, the kernels' launches per step and, for the
2-D kernels, whose one launch runs every field's whole solve, the cycles
they counted per step (summed over fields: ``sweep2d_field_cycles``,
``transport2d_field_cycles``) and K3's launches of its block route
(``sweep2d_block_launches``), the device's busy and idle share of the
traced window (kernel and copy intervals merged), and device time by kernel
name. Needs a CUDA device: a measurement path does not fall back to the
CPU.
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


def _traced(fn, path):
    """Run ``fn`` under ``torch.profiler``; returns the window's wall ms,
    device busy ms and idle share, and device time by kernel name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
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
    return {
        "traced_window_ms": window_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / window_ms,
        "kernels": [{"name": n[:90], "calls": c, "ms": round(ms, 3),
                     "share": round(ms / total, 4)} for n, (c, ms) in top],
    }


def kernels():
    """Every kernel wrapper, by the name its counts go under."""
    from mceik_tpu_torch.eikonal import cuda_sweep, cuda_transport
    return {"sweep3d_cycle": cuda_sweep.SWEEP3D,
            "transport3d_cycle": cuda_transport.TRANSPORT3D,
            "transport3d_large_cycle": cuda_transport.TRANSPORT3D_LARGE,
            "sweep2d": cuda_sweep.SWEEP2D,
            "transport2d": cuda_transport.TRANSPORT2D}


def counts():
    """Every kernel's launches, and the 2-D kernels' cycles summed over
    fields as the kernels count them (one launch of K3 or K6 runs every
    field's whole solve; one launch of K1, K4 or K5 is one cycle)."""
    out = {}
    for name, k in kernels().items():
        out[name] = k.launches
        if hasattr(k, "field_cycles"):
            out[f"{name}_field_cycles"] = k.field_cycles()
        if hasattr(k, "block_launches"):
            out[f"{name}_block_launches"] = k.block_launches
    return out


def reset():
    """Every kernel's launch counts to 0 (the 2-D kernels' field cycles go
    on counting: read them as the difference of two :func:`counts`)."""
    for k in kernels().values():
        k.launches = 0
        if hasattr(k, "block_launches"):
            k.block_launches = 0


def _per(before, after, n):
    """The counts that moved between two ``counts()``, per step."""
    return {k: (after[k] - before[k]) / n for k in after
            if after[k] > before[k]}


def _profile_gradients(post, gen, chain_counts):
    """One ``value_and_grad`` per chain count (after one untimed call):
    ms, launches by kernel, peak memory; then the one-card chain count."""
    from mceik_tpu_torch.model.posterior import value_and_grad

    vag = value_and_grad(post.logpost)
    rows = []
    for n in chain_counts:
        params = post.init_params(gen, n)
        vag(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts0 = counts()
        t0 = time.perf_counter()
        lp, _ = vag(params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"n_chains": n, "ms_per_value_and_grad": ms,
                     "launches": _per(counts0, counts(), 1),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "logpost_finite": bool(torch.isfinite(lp).all())})
        del params, lp
        torch.cuda.empty_cache()
    out = {"gradients": rows}
    if len(rows) >= 2:
        a, b = rows[-2], rows[-1]
        per_chain = (b["peak_mem_gb"] - a["peak_mem_gb"]) / (
            b["n_chains"] - a["n_chains"])
        fixed = a["peak_mem_gb"] - per_chain * a["n_chains"]
        total = torch.cuda.get_device_properties(0).total_memory / 1e9
        out.update(gb_per_chain=per_chain, gb_fixed=fixed,
                   device_total_gb=total,
                   one_card_chains=int((total - 10.0 - fixed) // per_chain))
    return out


def _profile_mcmc(cfg, args, path):
    from mceik_tpu_torch.api import (_check_supported, _dispatch_sampler,
                                     _uses_gradients, prepare_device,
                                     with_noise_gibbs)
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.io.metrics import MetricsLogger
    from mceik_tpu_torch.model.posterior import build_posterior
    from mceik_tpu_torch.samplers.base import run_mcmc

    _check_supported(cfg)
    dev = prepare_device("cuda")
    scfg = cfg.sampler
    grid = cfg.grid.build()
    data, _ = make_dataset(grid, cfg.data, cfg.model, device=dev)
    post = build_posterior(cfg.model, data, grid, cfg.eikonal,
                           differentiable=_uses_gradients(scfg))
    gen = torch.Generator(device=dev).manual_seed(scfg.seed)
    grads = {}
    if args.grad_chains:
        grads = _profile_gradients(post, gen, args.grad_chains)
        if args.steps == 0:
            return grads
    kernel, adapter, hyper, finalize_fn, states, _ = _dispatch_sampler(
        scfg, post, gen, MetricsLogger())
    kernel, states, hyper, n_warm = with_noise_gibbs(
        post, kernel, adapter, states, hyper, finalize_fn, gen, args.warm)
    r = run_mcmc(kernel, adapter, states, hyper, gen, n_warmup=n_warm,
                 n_steps=0, finalize_fn=finalize_fn)
    states, hyper = r.states, r.hyper

    counts0 = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_mcmc(kernel, None, states, hyper, gen, n_warmup=0,
                 n_steps=args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = _per(counts0, counts(), args.steps)
    info = {k: float(v.mean()) for k, v in r.info_trace.items()}
    states = r.states
    summary = _traced(lambda: run_mcmc(kernel, None, states, hyper, gen,
                                       n_warmup=0, n_steps=args.steps), path)
    return {**grads, "algorithm": scfg.algorithm,
            "n_chains": scfg.n_chains, "steps": args.steps,
            "chain_steps_per_s": args.steps * scfg.n_chains / wall,
            "ms_per_step": wall * 1e3 / args.steps,
            "launches_per_step": per_step, "info_mean": info, **summary}


def _profile_smc(cfg, args, path):
    from mceik_tpu_torch.samplers import smc

    post, gen, _ = smc.setup(cfg, "cuda")
    scfg = cfg.sampler
    n, k = scfg.n_particles, scfg.n_mutation_steps
    target = scfg.ess_threshold * n
    state = smc.init_particles(post, gen, n, scfg.step_size)
    beta = 0.0

    def stages(count):
        nonlocal state, beta
        for _ in range(count):
            state, beta, *_ = smc.stage(post, state, beta, gen, k, target)

    stages(args.warm)
    counts0 = counts()
    beta_s, stage_s = [], []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smc.next_beta(state.log_lik, beta, target)
        beta_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        stages(1)
        stage_s.append(time.perf_counter() - t0)
    per_step = _per(counts0, counts(), args.steps)
    summary = _traced(lambda: stages(args.steps), path)
    per_stage = sum(stage_s) / len(stage_s)
    return {"n_particles": n, "n_mutation_steps": k, "stages": args.steps,
            "beta_after": beta, "s_per_stage": per_stage,
            "particle_mutation_steps_per_s": n * k / per_stage,
            "next_beta_ms": 1e3 * sum(beta_s) / len(beta_s),
            "next_beta_host_share": sum(beta_s) / sum(stage_s),
            "launches_per_stage": per_step, **summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mceik_tpu_torch.diag.profile")
    p.add_argument("config")
    p.add_argument("overrides", nargs="*")
    p.add_argument("--warm", type=int, default=5)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="path of the Chrome trace (default: a temp file)")
    p.add_argument("--grad-chains", default="",
                   type=lambda v: [int(x) for x in v.split(",") if x],
                   help="chain counts at which to time one value_and_grad "
                        "first, e.g. 8,16 (MCMC configs)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: torch sees no CUDA device")
    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    path = args.trace or os.path.join(tempfile.gettempdir(),
                                      "mceik_profile_trace.json")
    run = _profile_smc if cfg.sampler.algorithm == "smc" else _profile_mcmc
    out = run(cfg, args, path)
    print(json.dumps({
        "config": args.config, "overrides": args.overrides,
        "device": torch.cuda.get_device_name(0), **out,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
