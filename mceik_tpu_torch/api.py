"""Top-level API: ``run(config, device) -> RunSummary``.

Counterpart of ``mceik_tpu/api.py`` for the tomo posterior: config ->
grid -> synthetic data -> posterior -> sampler (am, am_full, or mala with
an optional Laplace preconditioner), sampled in segments of
``io.log_every`` steps with one JSONL metrics record per segment (plus one
for the Laplace setup and one for the initial states), then pooled moments
and diagnostics. Welford moments carry across segments, so segmentation
never changes the statistics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from mceik_tpu_torch.config import RunConfig
from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.diag.ess import ess, ess_per_param, split_rhat
from mceik_tpu_torch.diag.moments import welford_finalize, welford_merge_chains
from mceik_tpu_torch.io.metrics import MetricsLogger
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import am, am_full, mala
from mceik_tpu_torch.samplers.base import MCMCResult, init_chain_states, run_mcmc
from mceik_tpu_torch.utils import tree_map

SAMPLERS = ("am", "am_full", "mala")


@dataclasses.dataclass
class RunSummary:
    """Host-side results: pooled posterior moments + diagnostics."""

    config: RunConfig
    result: MCMCResult               # last segment (device tensors)
    samples: Any                     # concatenated thinned draws (numpy)
    post_mean: Dict[str, Any]        # pooled posterior means of tracked fields
    post_var: Dict[str, Any]
    accept_rate: float
    rhat_max: float
    ess_logpost: float
    wall_time_s: float
    samples_per_sec: float           # raw chain-steps/s (all chains)
    eff_samples_per_sec: float       # ESS(logpost)/s
    truth: Dict[str, Any]
    recovery_corr: Optional[float]
    ess_param_min: float = float("nan")
    ess_param_median: float = float("nan")


def _check_supported(config: RunConfig) -> None:
    """Refuse, naming the later slice, what this slice of the port does not
    run yet."""
    scfg, io, dist = config.sampler, config.io, config.dist
    if scfg.algorithm not in SAMPLERS:
        raise NotImplementedError(
            f"sampler {scfg.algorithm!r}: the port runs {', '.join(SAMPLERS)} "
            "(rwm and smc are slice 3, the 2-D slice; hmc, nuts and pcn "
            "slice 4)")
    if io.checkpoint_path or io.resume or io.checkpoint_every:
        raise NotImplementedError("checkpointing and resume are slice 5 of "
                                  "the port")
    if io.profile_dir:
        raise NotImplementedError("io.profile_dir: profiling is not ported")
    if dist.multihost or (dist.n_devices or 1) > 1:
        raise NotImplementedError("multi-device runs are slice 6 of the port")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _step_size_of(hyper) -> float:
    return float(torch.exp(hyper.log_step))


def _dispatch_sampler(scfg, posterior, gen: torch.Generator, logger):
    """Returns ``(kernel, adapter, hyper, finalize_fn, states)``, with the
    chains initialised. MALA carries cached gradients; with
    ``precondition="laplace"`` the MAP and Gauss-Newton covariance are
    computed once here and pinned, and the chains start at the MAP plus
    0.3x Laplace jitter."""
    scales = posterior.prior_scales
    lp = posterior.logpost
    if scfg.algorithm == "mala":
        target = max(scfg.target_accept, 0.574)
        hyper = mala.init_hyper(scales, scfg.step_size)
        init_fn = posterior.init_params
        adapt_cov = True
        if scfg.precondition == "laplace":
            from mceik_tpu_torch.model.laplace import laplace_preconditioner
            t0 = time.perf_counter()
            p_map, cov, trace = laplace_preconditioner(
                posterior, n_map_steps=scfg.n_map_steps)
            hyper = mala.prime_covariance(hyper, cov)
            adapt_cov = False
            x_map = mala._ravel(p_map, batch_dims=1)            # (1, d)
            active = (mala._ravel(scales) > 0).to(torch.float32)
            L_init = torch.linalg.cholesky(cov)
            unravel = mala._unravel_fn(p_map, batch_dims=1)

            def init_fn(gen, n):
                # MAP + 0.3x Laplace jitter: full draws from the Laplace
                # fit land far out in the soft, prior-dominated subspace
                # where the forward model is most nonlinear (reference
                # api.py); burn-in is discarded as usual.
                eps = active * torch.randn((n, x_map.shape[1]), generator=gen,
                                           dtype=torch.float32,
                                           device=x_map.device)
                return unravel(x_map + 0.3 * (eps @ L_init.T))

            if logger is not None:
                logger.log({"phase": "laplace",
                            "seconds": round(time.perf_counter() - t0, 3),
                            "n_trace": len(trace),
                            "logpost_first": round(trace[0], 3),
                            "logpost_last": round(trace[-1], 3)})
        states = mala.init_states(lp, init_fn, gen, scfg.n_chains)
        return (mala.make_kernel(lp), mala.make_adapter(target,
                                                        adapt_cov=adapt_cov),
                hyper, mala.finalize, states)
    states = init_chain_states(lp, posterior.init_params, gen, scfg.n_chains)
    if scfg.algorithm == "am_full":
        return (am_full.make_kernel(lp), am_full.make_adapter(scfg.target_accept),
                am_full.init_hyper(scales, scfg.step_size),
                am_full.finalize, states)
    example = tree_map(lambda x: x[0], states.params)
    return (am.make_kernel(lp), am.make_adapter(scfg.target_accept),
            am.init_hyper(scales, scfg.step_size, example), am.finalize, states)


def run(config: RunConfig, device="cuda", verbose: bool = True) -> RunSummary:
    """Sample the config's posterior on ``device`` ("cuda" or "cpu")."""
    _check_supported(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device (pass --device cpu to run on the CPU)")
    # fp32 end to end: no TF32 anywhere (bf16/TF32 are too coarse at
    # sigma ~ 0.01 s).
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    grid = config.grid.build()
    data, truth = make_dataset(grid, config.data, config.model, device=device)
    scfg = config.sampler
    # Of the samplers the port runs, only MALA takes gradients (hmc, nuts
    # and whitened pcn join it in slice 4).
    posterior = build_posterior(config.model, data, grid, config.eikonal,
                                differentiable=scfg.algorithm == "mala")

    logger = MetricsLogger() if verbose else None
    gen = torch.Generator(device=device).manual_seed(scfg.seed)
    kernel, adapter, hyper, finalize_fn, states = _dispatch_sampler(
        scfg, posterior, gen, logger)

    def track_fn(params):
        return {"params": params, "slowness": posterior.slowness_of(params)}

    collect_fn = lambda params: params

    seg = config.io.log_every if config.io.log_every > 0 else scfg.n_samples
    seg = max(1, min(seg, scfg.n_samples))
    n_seg = max(1, scfg.n_samples // seg)
    n_steps_actual = n_seg * seg
    n_warmup = scfg.n_warmup

    if logger is not None:
        lp0 = _to_numpy(states.logpost)
        logger.log({"phase": "init", "step": 0, "device": str(device),
                    "logpost_mean": round(float(lp0.mean()), 3),
                    "logpost_min": round(float(lp0.min()), 3),
                    "logpost_max": round(float(lp0.max()), 3)})
    t0 = time.perf_counter()
    seg_results = []
    welford = None
    step_done = 0
    for si in range(n_seg):
        r = run_mcmc(kernel, adapter if si == 0 else None, states, hyper, gen,
                     n_warmup=n_warmup if si == 0 else 0, n_steps=seg,
                     thin=scfg.thin, track_fn=track_fn, collect_fn=collect_fn,
                     finalize_fn=finalize_fn if si == 0 else None,
                     init_welford=welford)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        states, hyper, welford = r.states, r.hyper, r.welford
        step_done += seg
        seg_results.append(r)

        if logger is not None:
            lp = _to_numpy(r.logpost_trace)
            last = lp[-1] if len(lp) else _to_numpy(states.logpost)
            logger.log({
                "phase": "sample", "step": step_done,
                "accept": round(float(np.mean(_to_numpy(r.accept_trace))), 4),
                "logpost_mean": round(float(last.mean()), 3),
                "logpost_min": round(float(last.min()), 3),
                "logpost_max": round(float(last.max()), 3),
                "step_size": _step_size_of(hyper),
                "chain_steps_per_s": round(
                    step_done * scfg.n_chains / (time.perf_counter() - t0), 2),
            })
    wall = time.perf_counter() - t0

    # --- host-side summary ---------------------------------------------
    kept = [r for r in seg_results if r.samples is not None]
    samples = (tree_map(lambda *xs: np.concatenate([_to_numpy(x) for x in xs]),
                        *[r.samples for r in kept]) if kept else None)
    logpost_trace = np.concatenate(
        [_to_numpy(r.logpost_trace) for r in seg_results], axis=0)
    accept_trace = np.concatenate(
        [_to_numpy(r.accept_trace) for r in seg_results], axis=0)

    mean, var = welford_finalize(welford_merge_chains(welford))
    post_mean = tree_map(_to_numpy, mean)
    post_var = tree_map(_to_numpy, var)

    accept = float(np.mean(accept_trace)) if accept_trace.size else float("nan")
    ess_lp = ess(logpost_trace) if logpost_trace.size else float("nan")

    probe = None
    if samples is not None and samples.u is not None:
        probe = samples.u.reshape(logpost_trace.shape[0],
                                  logpost_trace.shape[1], -1)
    rhat_max = (float(np.nanmax(split_rhat(probe))) if probe is not None
                else float("nan"))
    ess_min = ess_med = float("nan")
    if probe is not None:
        pe = ess_per_param(probe)
        ess_min, ess_med = float(np.min(pe)), float(np.median(pe))

    recovery = None
    if "slowness" in truth:
        s_mean = post_mean["slowness"]
        s_true = _to_numpy(truth["slowness"])
        a = s_mean - s_mean.mean()
        b = s_true - s_true.mean()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        recovery = float((a * b).sum() / denom) if denom > 0 else 0.0

    n_total_steps = n_steps_actual * scfg.n_chains
    summary = RunSummary(
        config=config, result=seg_results[-1], samples=samples,
        post_mean=post_mean, post_var=post_var,
        accept_rate=accept, rhat_max=rhat_max, ess_logpost=ess_lp,
        wall_time_s=wall, samples_per_sec=n_total_steps / wall,
        eff_samples_per_sec=ess_lp / wall,
        truth={k: _to_numpy(v) for k, v in truth.items()},
        recovery_corr=recovery, ess_param_min=ess_min,
        ess_param_median=ess_med,
    )
    if verbose:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        print(f"[mceik-tpu-torch] {scfg.algorithm} chains={scfg.n_chains} "
              f"warmup={n_warmup} samples={n_steps_actual} device={name} "
              f"wall={wall:.2f}s accept={accept:.3f} rhat={rhat_max:.3f} "
              f"ess(logpost)={ess_lp:.1f} ess(param min/med)={ess_min:.1f}"
              f"/{ess_med:.1f} samples/s={summary.samples_per_sec:.1f} "
              + (f"recovery_corr={recovery:.3f}" if recovery is not None
                 else ""))
    return summary
