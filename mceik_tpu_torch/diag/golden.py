"""Golden-run statistical acceptance harness of the port.

Counterpart of ``mceik_tpu/diag/golden.py``. The system's correctness
criterion is posterior moments within Monte-Carlo error: long seeded runs
of four reduced problems produced committed golden moments with MC error
bars (``tests/golden/*.json``); a check run of the same problem with a
different seed and the golden's pinned proposal must give per cell

    z = (mean_test - mean_golden) / sqrt(se_test^2 + se_golden^2),

with max |z| < 3.5 and median |z| < 1.5, where each ``se`` is
``sqrt(var / max(ESS, 2))`` with the autocorrelation-corrected per-cell
ESS. Both runs are seeded, and a run's generator lives on the host
(``rng="host"``): every random number is drawn there and moved to the
run's device, so a check on the card draws the CPU check's numbers and,
its posterior being the CPU's (:func:`device_parity`), takes the CPU's
chain up to rounding. ``rng="device"`` draws on the run's device instead
(CUDA's generator on the card: another random stream, the same bars).

The problems' data are the reference's own draw (JAX's noise), committed as
``golden_data/<name>.pt`` (written by ``tools/torch_golden_data.py`` with
``io.loaders.save_dataset_pt``): the port's datasets draw their noise from
torch and so define other posteriors. Every golden spec pins
``"use_pallas": "off"``; the spec is compared with the artifact's as it
stands, and a run may take another route with ``use_pallas`` ("on": the
kernels), which changes no posterior.

Check on the card (all four problems through the kernels, at the
reference's check budgets and bars; exits non-zero if a bar fails)::

    python -m mceik_tpu_torch.diag.golden check [names...] [--device cuda|cpu] [--route on|off] [--rng host|device]

``--seeds 133,233`` runs each named problem at those seeds instead of its
budget's, to see the check's spread over random streams. The card's
posterior against the CPU's plain one, at the golden's points and draws
around them (exits non-zero above the bars)::

    python -m mceik_tpu_torch.diag.golden parity [names...] [--device cuda] [--route on|off]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.diag.ess import ess_per_param
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.loaders import load_dataset_pt
from mceik_tpu_torch.model.params import slowness_from_u
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import am_full, mala
from mceik_tpu_torch.samplers.am_full import _ravel, _unravel_fn
from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc

# The reference's problems, verbatim (mceik_tpu/diag/golden.py): a committed
# artifact's "spec" must equal its entry.
PROBLEMS = {
    "c1_small": {
        "grid": {"shape": [25, 25], "spacing": [1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-4, "max_iters": 50,
                    "use_pallas": "off"},
        "model": {"mode": "tomo", "inv_shape": [4, 4],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.05},
        "data": {"dataset": "crosswell2d", "n_src": 4, "n_rec": 5,
                 "noise": 0.05, "seed": 77, "checker_cells": [2, 2],
                 "checker_amplitude": 0.08},
    },
    "c2_small": {
        "grid": {"shape": [12, 12, 12], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30,
                    "use_pallas": "off"},
        "model": {"mode": "tomo", "inv_shape": [3, 3, 3],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.05},
        "data": {"dataset": "checkerboard3d_volume", "n_src": 5, "n_rec": 6,
                 "noise": 0.03, "seed": 78, "checker_cells": [2, 2, 2],
                 "checker_amplitude": 0.08},
    },
    "c3_joint_small": {
        "grid": {"shape": [12, 12, 10], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30,
                    "use_pallas": "off"},
        "model": {"mode": "joint", "inv_shape": [3, 3, 2],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.04, "marginalize_t0": True},
        "data": {"dataset": "events3d_volume", "n_events": 3,
                 "n_stations": 12, "noise": 0.04, "seed": 79,
                 "checker_cells": [2, 2, 2], "checker_amplitude": 0.08},
        "kernel": "mala",
        "golden_n_steps": 9000, "golden_thin": 3,
    },
    "c2_mid": {
        "grid": {"shape": [16, 16, 14], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30,
                    "use_pallas": "off"},
        "model": {"mode": "tomo", "inv_shape": [6, 6, 6],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.04},
        "data": {"dataset": "checkerboard3d_volume", "n_src": 6, "n_rec": 8,
                 "noise": 0.04, "seed": 80, "checker_cells": [3, 3, 3],
                 "checker_amplitude": 0.08},
        "kernel": "mala",
        "golden_n_steps": 9000, "golden_thin": 3,
    },
}

_REPO = Path(__file__).resolve().parents[2]
GOLDEN_DIR = os.path.join(_REPO, "tests", "golden")
DATA_DIR = Path(__file__).resolve().parent / "golden_data"
# make_golden's default output: never the committed tests/golden/.
OUT_DIR = os.path.join(_REPO, "build", "golden")
N_CHAINS = 8

# The reference's check runs (tests/test_golden.py): (seed, warmup, steps),
# thin 2.
CHECK_BUDGET = {
    "c1_small": (31, 300, 2500),
    "c2_small": (32, 300, 2500),
    "c3_joint_small": (33, 300, 2500),
    "c2_mid": (34, 300, 1200),
}
# The reference's bars.
MAX_Z = 3.5
MEDIAN_Z = 1.5
MIN_ACCEPT = 0.05
MIN_MEDIAN_ESS = 20.0
# Where the inversion basis can represent the checkerboard.
RECOVERY_MIN = {"c1_small": 0.5}
# device_parity's bars: the logpost's (tests/test_torch_golden.py's, the
# port against JAX) and the gradient's per-point relative L2 (the port's
# gradient against JAX's, tests/test_torch_adjoint.py).
PARITY_LOGPOST_RTOL = 2e-5
PARITY_GRAD_REL_L2 = 1e-4


def _tuples(d):
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}


def _is_mala(name: str) -> bool:
    return PROBLEMS[name].get("kernel") == "mala"


def problem_grid(name: str) -> Grid:
    g = PROBLEMS[name]["grid"]
    return Grid(shape=tuple(g["shape"]), spacing=tuple(g["spacing"]))


def load_data(name: str, device="cpu"):
    """``(data, truth)`` of the problem: the committed reference draw."""
    return load_dataset_pt(str(DATA_DIR / f"{name}.pt"), device=device)


def _generator(seed: int, dev: torch.device, rng: str) -> torch.Generator:
    """The run's generator: on the host (``"host"``) or on ``dev``
    (``"device"``). The samplers and the posterior draw on the generator's
    device and move the numbers to the run's."""
    if rng not in ("host", "device"):
        raise ValueError(f"rng must be 'host' or 'device', not {rng!r}")
    return torch.Generator(
        device="cpu" if rng == "host" else dev).manual_seed(seed)


def _build(name: str, device="cuda", use_pallas: Optional[str] = None,
           return_truth: bool = False):
    """The problem's posterior on ``device`` from the committed data;
    ``use_pallas`` None keeps the spec's route ("off"), "on" takes the
    kernels' routes. Differentiable where the problem's kernel is MALA."""
    spec = PROBLEMS[name]
    eik = dict(spec["eikonal"])
    if use_pallas is not None:
        eik["use_pallas"] = use_pallas
    data, truth = load_data(name, device)
    post = build_posterior(ModelCfg(**_tuples(spec["model"])), data,
                           problem_grid(name), EikonalCfg(**eik),
                           differentiable=_is_mala(name))
    if return_truth:
        return post, truth["slowness"]
    return post


def recovery_corr(name: str, mean_u_flat) -> float:
    """Correlation of the posterior-mean slowness field with the truth, from
    a run's mean over u (the checkerboard-recovery criterion)."""
    spec = PROBLEMS[name]["model"]
    _, truth = load_data(name)
    u = torch.as_tensor(np.asarray(mean_u_flat, np.float32)).reshape(
        tuple(spec["inv_shape"]))
    s_mean = slowness_from_u(u, problem_grid(name),
                             torch.tensor(spec["background_slowness"])).numpy()
    s_true = truth["slowness"].numpy()
    a = s_mean - s_mean.mean()
    b = s_true - s_true.mean()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def _stats(flat: np.ndarray, accept, final_proposal: dict) -> dict:
    """Per-cell moments of ``(n_collect, n_chains, d)`` draws."""
    mean = flat.mean(axis=(0, 1))
    var = flat.var(axis=(0, 1))
    ess = ess_per_param(flat)
    se = np.sqrt(var / np.maximum(ess, 2.0))
    X = flat.reshape(-1, flat.shape[-1]).astype(np.float64)
    post_cov = np.cov(X.T) + 1e-8 * np.eye(X.shape[1])
    return {"mean": mean, "var": var, "se": se, "ess": ess,
            "accept": float(accept.mean()), "proposal": final_proposal,
            "post_cov": post_cov}


def run_problem(name: str, seed: int, n_warmup: int, n_steps: int,
                thin: int = 2, proposal: dict = None, device="cuda",
                use_pallas: Optional[str] = None, rng: str = "host"):
    """Seeded run of a golden problem (8 chains); returns per-cell moment
    stats.

    Full-covariance AM, or for problems with ``"kernel": "mala"`` the
    Laplace-preconditioned MALA leg (:func:`_run_problem_mala`).
    ``proposal``: ``{"cov", "log_step"}`` from a golden run: that FIXED
    proposal (the covariance pinned at a count of 1e6, so warmup retunes
    only the step) makes the check mix from step one; without it the run
    adapts from scratch (golden generation). One generator seeded with
    ``seed`` (on the host, or with ``rng="device"`` on ``device``) draws
    the starts, then the steps.

    Returns ``mean``, ``var``, ``se``, ``ess`` (per cell of the tracked
    vector: u for tomo problems, the full flat params for joint ones),
    ``accept``, the final ``proposal`` and ``post_cov``, the draws' sample
    covariance.
    """
    if _is_mala(name):
        return _run_problem_mala(name, seed, n_warmup, n_steps, thin,
                                 proposal, device, use_pallas, rng)
    dev = torch.device(device)
    post = _build(name, dev, use_pallas)
    gen = _generator(seed, dev, rng)
    states = init_chain_states(post.logpost, post.init_params, gen, N_CHAINS)
    hyper = am_full.init_hyper(post.prior_scales, 0.3)
    if proposal is not None:
        n_prime = 1e6
        cov = torch.tensor(np.asarray(proposal["cov"], np.float32),
                           device=dev)
        hyper = dataclasses.replace(
            hyper,
            log_step=torch.tensor(np.float32(proposal["log_step"]),
                                  device=dev),
            count=torch.tensor(np.float32(n_prime), device=dev),
            m2=(n_prime - 1.0) * cov)
    # Tomo problems track u (the committed artifacts' layout); joint ones
    # the full flat params.
    collect = ((lambda p: p.u) if post.cfg.mode == "tomo"
               else (lambda p: _ravel(p, batch_dims=1)))
    r = run_mcmc(am_full.make_kernel(post.logpost), am_full.make_adapter(),
                 states, hyper, gen, n_warmup=n_warmup, n_steps=n_steps,
                 thin=thin, collect_fn=collect)
    u = r.samples.cpu().numpy()
    flat = u.reshape(u.shape[0], N_CHAINS, -1)
    h = r.hyper
    final = {"cov": (h.m2 / max(float(h.count) - 1.0, 1.0)).cpu().numpy(),
             "log_step": float(h.log_step)}
    return _stats(flat, r.accept_trace.cpu().numpy(), final)


def _run_problem_mala(name: str, seed: int, n_warmup: int, n_steps: int,
                      thin: int = 2, proposal: dict = None, device="cuda",
                      use_pallas: Optional[str] = None, rng: str = "host"):
    """MALA leg of :func:`run_problem`: the Laplace/Gauss-Newton covariance
    is the pinned preconditioner, chains start at the MAP plus 0.3x Laplace
    jitter, and only the step adapts. Golden generation (``proposal``
    None) computes the MAP and covariance (150 MAP steps, step 0.5); check
    runs reuse the artifact's ``cov``, ``log_step`` and ``x_map``."""
    dev = torch.device(device)
    post = _build(name, dev, use_pallas)
    if proposal is None:
        from mceik_tpu_torch.model.laplace import laplace_preconditioner
        p_map, cov, _ = laplace_preconditioner(post, n_map_steps=150)
        cov = cov.double().cpu().numpy()
        log_step = math.log(0.5)
        x_map = _ravel(p_map, batch_dims=1)[0].double().cpu().numpy()
    else:
        cov = np.asarray(proposal["cov"], np.float64)
        log_step = float(proposal["log_step"])
        x_map = np.asarray(proposal["x_map"], np.float64)

    cov = 0.5 * (cov + cov.T)
    cov += (1e-9 * np.trace(cov) / cov.shape[0]) * np.eye(cov.shape[0])
    L = torch.tensor(np.linalg.cholesky(cov), dtype=torch.float32, device=dev)
    x0 = torch.tensor(x_map, dtype=torch.float32, device=dev)
    gen = _generator(seed, dev, rng)
    unravel = _unravel_fn(post.init_params(gen, 1), batch_dims=1)

    def init(g, n):
        xi = torch.randn((n, x0.shape[0]), generator=g, device=g.device)
        return unravel(x0 + 0.3 * xi.to(dev) @ L.T)

    states = mala.init_states(post.logpost, init, gen, N_CHAINS)
    hyper = dataclasses.replace(
        mala.prime_covariance(mala.init_hyper(post.prior_scales, 1.0),
                              torch.tensor(cov, dtype=torch.float32)),
        log_step=torch.tensor(np.float32(log_step), device=dev))
    r = run_mcmc(mala.make_kernel(post.logpost),
                 mala.make_adapter(adapt_cov=False), states, hyper, gen,
                 n_warmup=n_warmup, n_steps=n_steps, thin=thin,
                 collect_fn=lambda p: _ravel(p, batch_dims=1))
    final = {"cov": cov, "log_step": float(r.hyper.log_step), "x_map": x_map}
    return _stats(r.samples.cpu().numpy(), r.accept_trace.cpu().numpy(),
                  final)


def make_golden(name: str, seed: int = 1000, n_warmup: int = 2000,
                n_steps: int = 24000, thin: int = 4, out_dir: str = None,
                device="cuda", use_pallas: Optional[str] = None,
                rng: str = "host"):
    """Generate a golden artifact of ``name`` in the committed schema and
    write it to ``out_dir`` (default ``build/golden/``, never
    ``tests/golden/``); returns ``(path, artifact)``.

    The reference's recipe: MALA problems take one long run from their
    Laplace fit; AM problems bootstrap the proposal (an adaptive round,
    then a round on its draws' covariance) before the long run, whose
    proposal is stored so that a check reuses exactly it."""
    n_steps = PROBLEMS[name].get("golden_n_steps", n_steps)
    thin = PROBLEMS[name].get("golden_thin", thin)
    run = dict(device=device, use_pallas=use_pallas, rng=rng)
    if _is_mala(name):
        stats = run_problem(name, seed + 500, 500, n_steps, thin, **run)
        prop_store = {
            "cov": np.asarray(stats["proposal"]["cov"]).tolist(),
            "log_step": float(stats["proposal"]["log_step"]),
            "x_map": np.asarray(stats["proposal"]["x_map"]).tolist(),
        }
    else:
        warm = run_problem(name, seed, n_warmup, max(n_steps // 8, 500),
                           thin=2, **run)
        prop = {"cov": warm["post_cov"], "log_step": 0.0}
        boot = run_problem(name, seed + 250, 400, max(n_steps // 4, 1000),
                           thin=2, proposal=prop, **run)
        prop = {"cov": boot["post_cov"], "log_step": 0.0}
        stats = run_problem(name, seed + 500, 500, n_steps, thin,
                            proposal=prop, **run)
        prop_store = {
            "cov": np.asarray(prop["cov"]).tolist(),
            "log_step": float(stats["proposal"]["log_step"]),
        }
    artifact = {
        "problem": name,
        "spec": PROBLEMS[name],
        "seed": seed, "n_warmup": n_warmup, "n_steps": n_steps,
        "thin": thin, "n_chains": N_CHAINS,
        "mean": stats["mean"].tolist(),
        "var": stats["var"].tolist(),
        "se": stats["se"].tolist(),
        "ess": [round(float(e), 1) for e in stats["ess"]],
        "accept": round(stats["accept"], 4),
        "proposal": prop_store,
    }
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f)
    os.replace(tmp, path)
    return path, artifact


def load_golden(name: str, golden_dir: str = None):
    with open(os.path.join(golden_dir or GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def z_scores(name: str, golden: dict, seed: int, n_warmup: int,
             n_steps: int, thin: int = 2, device="cuda",
             use_pallas: Optional[str] = None, rng: str = "host"):
    """A check run (another seed, the golden's fixed proposal) -> per-cell
    |z| and the run's stats. The artifact's spec must equal the problem's
    as it stands."""
    assert golden["spec"] == PROBLEMS[name], (
        "golden artifact spec drifted from PROBLEMS: regenerate the goldens "
        "if the problem definition changed on purpose")
    stats = run_problem(name, seed, n_warmup, n_steps, thin,
                        proposal=golden["proposal"], device=device,
                        use_pallas=use_pallas, rng=rng)
    mean_g = np.asarray(golden["mean"])
    se_g = np.asarray(golden["se"])
    z = (stats["mean"] - mean_g) / np.sqrt(stats["se"] ** 2 + se_g ** 2)
    return np.abs(z), stats


def bars(name: str, z: np.ndarray, stats: dict) -> dict:
    """The reference's bars of a check run: ``{bar: (value, passed)}``."""
    out = {
        "max_z": (float(z.max()), bool(z.max() < MAX_Z)),
        "median_z": (float(np.median(z)), bool(np.median(z) < MEDIAN_Z)),
        "accept": (stats["accept"], bool(stats["accept"] > MIN_ACCEPT)),
        "median_ess": (float(np.median(stats["ess"])),
                       bool(np.median(stats["ess"]) > MIN_MEDIAN_ESS)),
    }
    if name in RECOVERY_MIN:
        corr = recovery_corr(name, stats["mean"])
        out["recovery_corr"] = (corr, bool(corr > RECOVERY_MIN[name]))
    return out


def check(names: Sequence[str] = tuple(PROBLEMS), device="cuda",
          route: Optional[str] = "on", verbose: bool = True,
          seeds: Optional[Sequence[int]] = None, rng: str = "host"):
    """The check run of each problem at the reference's budget, with its
    bars, wall seconds and every kernel's launches in the run (counts
    reset before it). ``seeds``: run each problem at each of these seeds
    instead of its budget's (the spread of the check over random streams).
    Returns one dict per run."""
    from mceik_tpu_torch.diag import profile

    out = []
    for name, seed in [(n, s) for n in names
                       for s in (seeds or [CHECK_BUDGET[n][0]])]:
        _, n_warmup, n_steps = CHECK_BUDGET[name]
        profile.reset()
        c0 = profile.counts()     # the 2-D kernels' cycles keep counting
        t0 = time.perf_counter()
        z, stats = z_scores(name, load_golden(name), seed, n_warmup, n_steps,
                            device=device, use_pallas=route, rng=rng)
        wall = time.perf_counter() - t0
        res = {"problem": name, "seed": seed, "device": str(device),
               "route": route, "rng": rng,
               "bars": bars(name, z, stats), "seconds": wall,
               "launches": {k: v - c0[k] for k, v in profile.counts().items()}}
        res["ok"] = all(p for _, p in res["bars"].values())
        out.append(res)
        if verbose:
            b = res["bars"]
            launched = {k: v for k, v in res["launches"].items() if v}
            corr = (f", recovery corr {b['recovery_corr'][0]:.3f}"
                    if "recovery_corr" in b else "")
            print(f"golden {name} (seed {seed}): "
                  f"{'OK' if res['ok'] else 'FAIL'} max |z| "
                  f"{b['max_z'][0]:.3f}, median |z| {b['median_z'][0]:.3f}, "
                  f"acceptance {b['accept'][0]:.4f}, median ESS "
                  f"{b['median_ess'][0]:.1f}{corr}; {wall:.1f} s on "
                  f"{device} (route {route}, rng {rng}); launches "
                  f"{launched}",
                  flush=True)
    return out


def device_parity(name: str, device="cuda", use_pallas: Optional[str] = "on",
                  n_points: int = 32, seed: int = 0) -> dict:
    """The problem's posterior on ``device`` (route ``use_pallas``) against
    the CPU's plain one, at the golden's mean, its MAP where it has one, and
    ``n_points`` draws around the MAP (else the mean) from the golden
    proposal's covariance. Returns the largest logpost difference and, for
    MALA problems, the largest per-point L2 difference of the gradients,
    each relative to the CPU's root mean square over the points (a per-point
    ratio blows up where a logpost crosses zero or at the MAP, whose
    gradient is ~0), the largest absolute logpost difference, and whether
    the device's gradient repeats its bits on a second call; ``ok``
    against the ``PARITY_*`` bars."""
    from mceik_tpu_torch.model.posterior import value_and_grad

    art = load_golden(name)
    prop = art["proposal"]
    centre = np.asarray(prop.get("x_map", art["mean"]), np.float64)
    cov = np.asarray(prop["cov"], np.float64)
    cov = 0.5 * (cov + cov.T) + (1e-9 * np.trace(cov) / len(cov)) * np.eye(
        len(cov))
    xi = torch.randn((n_points, len(centre)), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(seed)).numpy()
    pts = [np.asarray(art["mean"])] + (
        [centre] if "x_map" in prop else []) + list(
            centre + xi @ np.linalg.cholesky(cov).T)
    x = torch.tensor(np.stack(pts), dtype=torch.float32)
    mala_problem = _is_mala(name)
    lps, grads, repeat = [], [], True
    for d, route in ((torch.device(device), use_pallas),
                     (torch.device("cpu"), "off")):
        post = _build(name, d, route)
        unravel = _unravel_fn(post.init_params(torch.Generator().manual_seed(
            0), 1), batch_dims=1)
        params = unravel(x.to(d))
        if mala_problem:
            vag = value_and_grad(post.logpost)
            lp, g = vag(params)
            g = _ravel(g, batch_dims=1)
            if d.type != "cpu":
                repeat = torch.equal(g, _ravel(vag(params)[1], batch_dims=1))
            grads.append(g.double().cpu())
        else:
            lp = post.logpost(params)
        lps.append(lp.detach().double().cpu())
    d_lp = (lps[0] - lps[1]).abs()
    out = {"problem": name, "points": len(pts),
           "logpost_rel": float(d_lp.max() / lps[1].square().mean().sqrt()),
           "logpost_abs": float(d_lp.max())}
    ok = out["logpost_rel"] <= PARITY_LOGPOST_RTOL
    if mala_problem:
        g_norm = grads[1].norm(dim=1)
        out["grad_rel_l2"] = float((grads[0] - grads[1]).norm(dim=1).max()
                                   / g_norm.square().mean().sqrt())
        out["grad_repeats"] = repeat
        ok = ok and out["grad_rel_l2"] <= PARITY_GRAD_REL_L2 and repeat
    out["ok"] = bool(ok)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mceik_tpu_torch.diag.golden")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="check runs against tests/golden/")
    c.add_argument("names", nargs="*", default=list(PROBLEMS))
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    c.add_argument("--route", default="on", choices=["on", "off"])
    c.add_argument("--seeds", default=None,
                   help="comma-separated seeds to run each problem at "
                        "instead of its check budget's")
    c.add_argument("--rng", default="host", choices=["host", "device"],
                   help="where the random numbers are drawn")
    q = sub.add_parser("parity", help="the device's posterior against the "
                                      "CPU's at the golden's points")
    q.add_argument("names", nargs="*", default=list(PROBLEMS))
    q.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    q.add_argument("--route", default="on", choices=["on", "off"])
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in PROBLEMS]
    if unknown:
        ap.error(f"unknown problems {unknown}; known: {list(PROBLEMS)}")
    from mceik_tpu_torch.api import prepare_device
    device = prepare_device(args.device)
    if args.cmd == "parity":
        rows = [device_parity(n, device, args.route) for n in args.names]
        for r in rows:
            print(json.dumps(r), flush=True)
        return 0 if all(r["ok"] for r in rows) else 1
    seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
             else None)
    results = check(args.names, device, args.route, seeds=seeds,
                    rng=args.rng)
    failed = [f"{r['problem']} (seed {r['seed']})" for r in results
              if not r["ok"]]
    print(f"golden check: {len(results) - len(failed)} of {len(results)} "
          f"within the bars" + (f"; FAILED {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
