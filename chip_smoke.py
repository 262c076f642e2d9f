#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mceik_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build of every kernel on the main paths from the sources in the
   checkout, one ``nvcc`` per source, all started together: K1, the 3-D
   sweep cycle (``csrc/sweep3d.cu``), K4, the adjoint transport cycle
   (``csrc/transport3d.cu``), and K3, the 2-D sweep cycle
   (``csrc/sweep2d.cu``);
3. K1 against its plain PyTorch version on the card, at the main path's
   shapes and on edge cases (bar: max abs traveltime difference <= 1e-4);
4. K4 against its plain version (bar: max abs difference <= 1e-5 of the
   plain version's max abs): the main-path batch (16 chains x 8 sources of
   64^3, cotangents of the config-2 log-likelihood), an odd anisotropic
   non-cube batch, and a mixed batch with a zero, contractive and divergent
   field (the divergent one must come back all NaN, the others untouched);
5. the logpost gradient of 16 chains at config-2 width through K1 + K4
   against the same gradient through the plain solves on the card (bar:
   1e-5 of its max abs), and against a central finite difference along one
   random direction of all chains' parameters (bar: relative error < 0.1);
6. the MALA path through the normal entry point,
   ``mceik_tpu_torch.cli.main(["run", "configs/c2_mala.json", ...])`` at the
   config's full width (16 chains, 64^3 grid, 12^3 basis, 8 sources, 12
   receivers) with only the depth cut, every kernel's launch count reset
   just before and read just after: both kernels launched, the Laplace MAP
   trace rising, every logpost finite, the acceptance in (0.05, 0.99);
7. the AM path of slice 1, ``configs/c2_checkerboard3d.json`` at 16
   chains, depth cut, counts reset and read the same way: K1 launched,
   logposts finite and rising;
8. K3 against its plain version on the card (bar: max abs traveltime
   difference <= 1e-4), one cycle and a full solve each, on (a) config 4's
   batch, 10,000 prior-drawn particles x 8 crosswell sources = 80,000
   fields of 48^2 at tol 1e-3, (b) config 1's batch, 4 chains x 8 sources =
   32 fields of 65^2 at tol 1e-4, and (c) an odd anisotropic non-square
   batch with done flags set, whose fields must come back untouched; then
   config 4's log-likelihood of the 10,000 particles through K3 and
   through the plain solve (bar: rtol 1e-6);
9. config 4's tempered SMC at full width (10,000 particles, 48^2 grid)
   through ``mceik_tpu_torch.samplers.smc.run_smc_config``, the function
   the CLI calls, with the ladder capped at 3 stages, counts reset and
   read: K3 launched, beta strictly rising, each stage's ESS at its target
   0.5 N (or beta = 1), log Z and acceptance finite;
10. config 1's RWM at full width (4 chains, 65^2 grid) through
   ``mceik_tpu_torch.cli.main(["run", "configs/c1_crosswell.json", ...])``
   with the depth cut, counts reset and read: K3 launched, logposts finite
   and rising, acceptance in (0.05, 0.99).

The line before the last is a JSON object listing the kernels with their
launch counts (K1 and K4 on the MALA path, K3 on the SMC path), errors and
times; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device and the repository
around this file; without either it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
AM_CONFIG = os.path.join(REPO, "configs", "c2_checkerboard3d.json")
MALA_CONFIG = os.path.join(REPO, "configs", "c2_mala.json")
C1_CONFIG = os.path.join(REPO, "configs", "c1_crosswell.json")
C4_CONFIG = os.path.join(REPO, "configs", "c4_smc.json")
K1_BAR = 1e-4       # K1 vs plain, max abs traveltime difference
K3_BAR = 1e-4       # K3 vs plain, max abs traveltime difference
LL_RTOL = 1e-6      # c4 log-likelihood through K3 vs through the plain solve
SMC_STAGES = 3      # c4 ladder cap (depth cut)
K4_REL_BAR = 1e-5   # K4 vs plain, max abs difference / max abs plain
GRAD_REL_BAR = 1e-5  # kernel vs plain gradient, max abs diff / max abs
FD_BAR = 0.1        # gradient vs central finite difference, relative
SOLVE_TOL = 1e-5    # solver tolerance of the K1 comparison solves
N_CHAINS = 16
AM_ARGS = ["sampler.n_chains=16", "sampler.n_warmup=40",
           "sampler.n_samples=80", "sampler.thin=4", "io.log_every=40"]
# c2_mala.json at full width; depth cut from 150 MAP steps, 60 warmup and
# 600 sampling steps.
MALA_ARGS = ["sampler.n_map_steps=40", "sampler.n_warmup=30",
             "sampler.n_samples=60", "io.log_every=30"]
# c1_crosswell.json at full width; depth cut from 2000 warmup and 6000
# sampling steps.
C1_ARGS = ["sampler.n_warmup=400", "sampler.n_samples=400", "io.log_every=200"]


class _Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def _timed(fn, reps=1):
    """(result, ms per call) with CUDA events around ``reps`` calls."""
    import torch

    out = fn()  # warm-up (and the result)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1) / reps


def _build_all(kernels):
    """Build every kernel at once (one nvcc each); raise the first error."""
    errors = []

    def build(k):
        try:
            k.build()
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a kernel build did not finish")
    print(f"build: {len(kernels)} kernels in {time.perf_counter() - t0:.2f} s")
    for k in kernels:
        print(f"build: {k.source.relative_to(REPO)} in {k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _run_cli(cli, argv):
    """``cli.main(argv)`` with stdout kept; returns (JSONL records, lines,
    wall seconds)."""
    tee = _Tee(sys.stdout)
    print(f"main path: mceik_tpu_torch.cli.main({argv})")
    t0 = time.perf_counter()
    sys.stdout = tee
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout = tee.out
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    lines = tee.buf.getvalue().splitlines()
    recs = [json.loads(line.split("] ", 1)[1]) for line in lines
            if line.startswith("[mceik] ")]
    return recs, lines, wall


def _check_run(recs, label, n_warm, n_chains=N_CHAINS):
    """Init and sample records present, logposts finite; returns
    (init, sample records, steps after init, chain-steps/s overall, in the
    last segment)."""
    init = [r for r in recs if r["phase"] == "init"]
    samp = [r for r in recs if r["phase"] == "sample"]
    if len(init) != 1 or not samp:
        raise RuntimeError(f"{label}: expected init + sample records, got "
                           f"{len(init)} + {len(samp)}")
    vals = [r[k] for r in init + samp
            for k in ("logpost_mean", "logpost_min", "logpost_max")]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"{label}: non-finite logpost")
    steps = n_warm + samp[-1]["step"]
    rate_all = steps * n_chains / (samp[-1]["t"] - init[0]["t"])
    rate_last = float("nan")
    if len(samp) >= 2:
        rate_last = ((samp[-1]["step"] - samp[-2]["step"]) * n_chains
                     / (samp[-1]["t"] - samp[-2]["t"]))
    return init[0], samp, steps, rate_all, rate_last


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from mceik_tpu_torch import cli
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.datasets.synthetic import (borehole_3d_geometry,
                                                    checkerboard_slowness)
    from mceik_tpu_torch.eikonal import cuda_sweep, cuda_sweep2d, cuda_transport
    from mceik_tpu_torch.eikonal.adjoint_sweep import (transport_cycle_plain,
                                                       transport_solve,
                                                       transport_weights)
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                               seed_source, sweep_cycle_plain,
                                               sweep_solve)
    from mceik_tpu_torch.forward.predict import interp_tables
    from mceik_tpu_torch.grid import Grid
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config
    from mceik_tpu_torch.model.params import Params, slowness_from_u
    from mceik_tpu_torch.model.posterior import (_gaussian_loglik,
                                                 build_posterior,
                                                 value_and_grad)
    from mceik_tpu_torch.samplers.smc import run_smc_config

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    t_start = time.perf_counter()

    # 1. The card: nvidia-smi's own line (name, power limit), then versions.
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device 0: {kind}")

    # 2. Build.
    k1, k4 = cuda_sweep.SWEEP3D, cuda_transport.TRANSPORT3D
    k3 = cuda_sweep2d.SWEEP2D
    _build_all([k1, k4, k3])

    # 3. K1 vs plain, on the card.
    cfg = load_config(AM_CONFIG)
    grid = cfg.grid.build()
    on = EikonalConfig(tol=SOLVE_TOL, max_iters=200, use_pallas="on")
    off = EikonalConfig(tol=SOLVE_TOL, max_iters=200, use_pallas="off")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {"sweep3d_cycle": [], "transport3d_cycle": [], "sweep2d_cycle": []}

    def compare(label, s, srcs, g):
        launches0 = k1.launches
        T_k, ms_k = _timed(lambda: solve_eikonal_batched(s, srcs, g, on), 3)
        launched = k1.launches - launches0
        T_p, ms_p = _timed(lambda: solve_eikonal_batched(s, srcs, g, off), 1)
        if not launched:
            raise RuntimeError(f"{label}: the kernel was not launched")
        err = float((T_k - T_p).abs().max())
        finite = bool(torch.isfinite(T_k).all())
        print(f"K1 compare {label}: B={s.shape[0]} grid={g.shape} "
              f"spacing={g.spacing}: max|kernel-plain| = {err:.3e}; "
              f"ms per batch solve: kernel {ms_k:.3f}, plain {ms_p:.3f}")
        if not finite or not err <= K1_BAR:
            raise RuntimeError(f"{label}: kernel disagrees with plain "
                               f"(max abs {err}, finite {finite})")
        errs["sweep3d_cycle"].append(err)
        return T_k

    # (a) the main path's batch: 16 chains x c2's 8 sources on its 64^3
    # checkerboard, each chain's slowness perturbed as an AM proposal is.
    s_true = checkerboard_slowness(grid, cfg.data.checker_cells,
                                   cfg.data.checker_amplitude,
                                   cfg.model.background_slowness, device=dev)
    src, rec = borehole_3d_geometry(grid, cfg.data.n_src, cfg.data.n_rec,
                                    device=dev)
    inv = tuple(cfg.model.inv_shape)
    u_a = 0.1 * cfg.model.prior_sigma_u * torch.randn(
        (N_CHAINS,) + inv, generator=gen, device=dev)
    s_a = (s_true * slowness_from_u(u_a, grid, torch.tensor(1.0, device=dev)))
    s_a = s_a.unsqueeze(1).expand((N_CHAINS, cfg.data.n_src) + grid.shape)
    s_a = s_a.reshape((-1,) + grid.shape).contiguous()
    srcs_a = src.repeat(N_CHAINS, 1)
    compare("a (main-path batch)", s_a, srcs_a, grid)

    # One cycle at the main path's shape: the unit a launch does.
    T0, frozen_a = seed_source(s_a, srcs_a, grid, cfg.eikonal.seed_radius)
    floor = seed_floor(T0, frozen_a)
    done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)
    launches0 = k1.launches
    T1_k, ms_k1 = _timed(
        lambda: cuda_sweep.sweep_cycle(T0, s_a, floor, grid.spacing,
                                       cfg.eikonal.n_inner, done), reps=10)
    if k1.launches == launches0:
        raise RuntimeError("K1 cycle: the kernel was not launched")
    T1_p, ms_k1_plain = _timed(
        lambda: sweep_cycle_plain(T0, s_a, floor, grid.spacing,
                                  cfg.eikonal.n_inner, done), reps=1)
    err_cycle = float((T1_k - T1_p).abs().max())
    print(f"K1 compare one cycle, B={T0.shape[0]} grid={grid.shape}: "
          f"max|kernel-plain| = {err_cycle:.3e}; ms per launch: kernel "
          f"{ms_k1:.3f}, plain {ms_k1_plain:.3f}")
    if not err_cycle <= K1_BAR:
        raise RuntimeError(f"K1 cycle: kernel disagrees with plain ({err_cycle})")
    errs["sweep3d_cycle"].append(err_cycle)

    # (b) odd batch, non-cube grid, unequal spacing (weighted local solve).
    g_b = Grid((48, 40, 32), (1.0, 1.2, 0.9))
    u_b = 0.3 * torch.randn((3, 6, 6, 6), generator=gen, device=dev)
    s_b = slowness_from_u(u_b, g_b, torch.tensor(1.0, device=dev))
    ext = torch.tensor(g_b.extent, device=dev)
    srcs_b = (0.1 + 0.8 * torch.rand((3, 3), generator=gen, device=dev)) * ext
    T_b = compare("b (odd anisotropic non-cube)", s_b, srcs_b, g_b)

    # (c) mixed convergence: homogeneous fields converge in a few cycles,
    # high-contrast ones take many more; per-field done flags must leave
    # the early ones alone.
    g_c = Grid((64, 64, 64), (1.0, 1.0, 1.0))
    n_easy = 4
    u_c = torch.cat([torch.zeros((n_easy, 4, 4, 4), device=dev),
                     0.8 * torch.randn((4, 4, 4, 4), generator=gen,
                                       device=dev)])
    s_c = slowness_from_u(u_c, g_c, torch.tensor(1.0, device=dev))
    srcs_c = torch.tensor([[10.0, 20.0, 30.0], [50.0, 12.0, 40.0],
                           [31.5, 31.5, 31.5], [5.0, 60.0, 7.0]] * 2,
                          device=dev)
    T_c = compare("c (mixed convergence)", s_c, srcs_c, g_c)
    T0c, frc = seed_source(s_c, srcs_c, g_c, 3.0)
    history = []

    def recording_cycle(T, s, fl, sp, n_inner, done):
        history.append(done.clone())
        return cuda_sweep.sweep_cycle(T, s, fl, sp, n_inner, done)

    sweep_solve(T0c, seed_floor(T0c, frc), s_c, g_c.spacing, SOLVE_TOL, 200,
                2, cycle=recording_cycle)
    cycles = (~torch.stack(history)).sum(0).tolist()
    print(f"K1 compare c: cycles per field {cycles}")
    if len(set(cycles)) < 2:
        raise RuntimeError("c: every field took the same number of cycles")
    xyz = torch.as_tensor(g_c.node_coords(), dtype=torch.float32, device=dev)
    r = torch.linalg.norm(xyz[None] - srcs_c[:n_easy, None, None, None], dim=-1)
    # First-order upwind overestimates point-source distances off the grid
    # axes: ~7.6% at most on these fields with the plain sweep (CPU).
    analytic = float(((T_c[:n_easy] - r).abs() / r.clamp(min=1.0)).max())
    print(f"K1 compare c: homogeneous fields vs analytic distance: max "
          f"relative error {analytic:.4f} (first-order upwind, bar 0.1)")
    if not analytic < 0.1:
        raise RuntimeError(f"c: homogeneous solve off the analytic ({analytic})")

    # 4. K4 vs plain, on the card.
    def k4_check(label, out_k, out_p, finite_fields=None):
        sel = slice(None) if finite_fields is None else finite_fields
        scale = float(out_p[sel].abs().max())
        err = float((out_k[sel] - out_p[sel]).abs().max())
        print(f"K4 compare {label}: max|kernel-plain| = {err:.3e} "
              f"(max|plain| {scale:.3e})")
        if not bool(torch.isfinite(out_k[sel]).all()) or \
                not err <= K4_REL_BAR * scale:
            raise RuntimeError(f"K4 {label}: kernel disagrees with plain "
                               f"({err} vs bar {K4_REL_BAR * scale})")
        errs["transport3d_cycle"].append(err)

    def k4_solve_pair(label, g, ws, tol, max_cycles):
        launches0 = k4.launches
        lam_k, ms_sk = _timed(lambda: transport_solve(
            g, ws, tol, max_cycles, 2, cycle=cuda_transport.transport_cycle))
        if k4.launches == launches0:
            raise RuntimeError(f"K4 {label}: the kernel was not launched")
        lam_p, ms_sp = _timed(lambda: transport_solve(g, ws, tol, max_cycles, 2))
        print(f"K4 solve {label}: B={g.shape[0]} grid={tuple(g.shape[1:])}: "
              f"ms per solve at tol {tol}: kernel {ms_sk:.3f}, plain {ms_sp:.3f}")
        return lam_k, lam_p

    # (a) the main-path batch: T from K1 at the config's tolerance, g the
    # cotangent of the config-2 log-likelihood at this AM-like state.
    data, _ = make_dataset(grid, cfg.data, cfg.model, device=dev)
    econf = EikonalConfig(tol=cfg.eikonal.tol, max_iters=cfg.eikonal.max_iters,
                          n_inner=cfg.eikonal.n_inner)
    T_a = solve_eikonal_batched(s_a, srcs_a, grid, econf).requires_grad_(True)
    resid = data.t_obs - interp_tables(
        T_a.reshape((N_CHAINS, cfg.data.n_src) + grid.shape), data.rec_xyz,
        grid)
    sigma = torch.full_like(resid, cfg.model.sigma)
    (g_a,) = torch.autograd.grad(_gaussian_loglik(resid, sigma, None).sum(), T_a)
    T_a = T_a.detach()
    ws_a = transport_weights(T_a, s_a, frozen_a, grid.spacing)
    launches0 = k4.launches
    lam1_k, ms_k4 = _timed(lambda: cuda_transport.transport_cycle(
        g_a, g_a, ws_a, cfg.eikonal.n_inner, done), reps=10)
    if k4.launches == launches0:
        raise RuntimeError("K4 cycle: the kernel was not launched")
    lam1_p, ms_k4_plain = _timed(lambda: transport_cycle_plain(
        g_a, g_a, ws_a, cfg.eikonal.n_inner, done), reps=1)
    print(f"K4 one cycle, B={g_a.shape[0]} grid={grid.shape}: ms per launch: "
          f"kernel {ms_k4:.3f}, plain {ms_k4_plain:.3f}")
    k4_check("a (main-path batch, one cycle)", lam1_k, lam1_p)
    k4_check("a (main-path batch, solve)",
             *k4_solve_pair("a", g_a, ws_a, cfg.eikonal.tol,
                            cfg.eikonal.max_iters))

    # (b) odd batch, non-cube grid, unequal spacing.
    _, frozen_b = seed_source(s_b, srcs_b, g_b, 3.0)
    ws_b = transport_weights(T_b, s_b, frozen_b, g_b.spacing)
    g_rand = 0.1 * torch.randn(T_b.shape, generator=gen, device=dev)
    k4_check("b (odd anisotropic non-cube, one cycle)",
             cuda_transport.transport_cycle(g_rand, g_rand, ws_b, 2),
             transport_cycle_plain(g_rand, g_rand, ws_b, 2))
    k4_check("b (odd anisotropic non-cube, solve)",
             *k4_solve_pair("b", g_rand, ws_b, 1e-6, 100))

    # (c) mixed: a zero-g field, two contractive fields, and a divergent one
    # (pairs of nodes feeding each other with weight 1.3 along every axis).
    div = []
    for d, n in enumerate(g_b.shape):
        idx = torch.arange(n, device=dev).reshape(
            [-1 if e == d else 1 for e in range(3)])
        div.append(torch.where(idx % 2 == 0, -1.3, 1.3).expand(g_b.shape))
    ws_c = tuple(torch.cat([w, dv[None]]).contiguous()
                 for w, dv in zip(ws_b, div))
    g_mix = torch.cat([torch.zeros_like(g_rand[:1]), g_rand[1:],
                       torch.ones_like(g_rand[:1])])
    active_k = []

    def recording_k4(lam, g, ws, n_inner, done):
        active_k.append((~done).clone())
        return cuda_transport.transport_cycle(lam, g, ws, n_inner, done)

    lam_ck = transport_solve(g_mix, ws_c, 1e-6, 30, 2, cycle=recording_k4)
    lam_cp = transport_solve(g_mix, ws_c, 1e-6, 30, 2)
    per_field = torch.stack(active_k).sum(0).tolist()
    print(f"K4 compare c: cycles per field {per_field} (zero, contractive, "
          f"contractive, divergent)")
    if not (bool(torch.isnan(lam_ck[3]).all())
            and bool(torch.isnan(lam_cp[3]).all())):
        raise RuntimeError("K4 c: the divergent field is not all NaN")
    if per_field[0] != 1 or not bool((lam_ck[0] == 0).all()):
        raise RuntimeError("K4 c: the zero field did not finish in one cycle")
    k4_check("c (mixed, the three finite fields)", lam_ck, lam_cp,
             finite_fields=slice(0, 3))

    # 5. The gradient on the card: K1 + K4 against the plain solves.
    post_k = build_posterior(cfg.model, data, grid, cfg.eikonal,
                             differentiable=True)
    ecfg_off = apply_overrides(cfg, ["eikonal.use_pallas=off"]).eikonal
    post_p = build_posterior(cfg.model, data, grid, ecfg_off,
                             differentiable=True)
    params = Params(u=u_a)
    l1, l4 = k1.launches, k4.launches
    (lp_k, g_k), ms_gk = _timed(lambda: value_and_grad(post_k.logpost)(params))
    if k1.launches == l1 or k4.launches == l4:
        raise RuntimeError("gradient: a kernel was not launched")
    (lp_p, g_p), ms_gp = _timed(lambda: value_and_grad(post_p.logpost)(params))
    gscale = float(g_p.u.abs().max())
    gerr = float((g_k.u - g_p.u).abs().max())
    lperr = float((lp_k - lp_p).abs().max())
    print(f"gradient, {N_CHAINS} chains at c2 width: max|kernel-plain| = {gerr:.3e} "
          f"(max|grad| {gscale:.3e}), logpost max|diff| {lperr:.3e}; ms per "
          f"value_and_grad: kernels {ms_gk:.3f}, plain {ms_gp:.3f}")
    if not bool(torch.isfinite(g_k.u).all()) or not gerr <= GRAD_REL_BAR * gscale:
        raise RuntimeError(f"gradient: kernels disagree with plain ({gerr})")
    post_fd = build_posterior(
        cfg.model, data, grid,
        apply_overrides(cfg, ["eikonal.tol=1e-6",
                              "eikonal.max_iters=300"]).eikonal,
        differentiable=True)
    v = torch.randn(u_a.shape, generator=gen, device=dev)
    v = v / v.flatten(1).norm(dim=1).reshape((-1,) + (1,) * len(inv))
    _, g_fd = value_and_grad(post_fd.logpost)(params)
    eps = 1e-3
    fd = (post_fd.logpost(Params(u=u_a + eps * v))
          - post_fd.logpost(Params(u=u_a - eps * v))) / (2 * eps)
    ad = (g_fd.u * v).flatten(1).sum(1)
    # One direction in the space of all chains' parameters (the sum over
    # chains); the worst single chain is printed beside it.
    rel = float((ad.sum() - fd.sum()).abs()
                / torch.maximum(ad.sum().abs(), fd.sum().abs()))
    worst = float(((ad - fd).abs() / torch.maximum(ad.abs(), fd.abs())).max())
    print(f"gradient vs central finite difference along one random direction "
          f"of all {N_CHAINS} chains' parameters at tol 1e-6: relative error "
          f"{rel:.3e} (bar {FD_BAR}); worst single chain {worst:.3e}")
    if not rel < FD_BAR:
        raise RuntimeError(f"gradient: finite difference disagrees ({rel})")

    # 6. The MALA path through the CLI, at full width.
    k1.launches = k4.launches = 0
    recs, lines, wall = _run_cli(cli, ["run", MALA_CONFIG, *MALA_ARGS])
    mala_launches = {"sweep3d_cycle": k1.launches,
                     "transport3d_cycle": k4.launches}
    if min(mala_launches.values()) <= 0:
        raise RuntimeError(f"MALA path: a kernel was never launched "
                           f"({mala_launches})")
    lap = [r for r in recs if r["phase"] == "laplace"]
    if len(lap) != 1 or not lap[0]["logpost_last"] > lap[0]["logpost_first"]:
        raise RuntimeError(f"MALA path: the Laplace MAP trace did not rise "
                           f"({lap})")
    mala_cfg = apply_overrides(load_config(MALA_CONFIG), MALA_ARGS)
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "MALA path", mala_cfg.sampler.n_warmup)
    accept = sum(r["accept"] for r in samp) / len(samp)
    if not 0.05 < accept < 0.99:
        raise RuntimeError(f"MALA path: acceptance {accept} outside "
                           "(0.05, 0.99)")
    print(f"MALA path: launches {mala_launches}; Laplace setup "
          f"{lap[0]['seconds']:.3f} s (MAP trace {lap[0]['logpost_first']} -> "
          f"{lap[0]['logpost_last']} over {lap[0]['n_trace']} evaluations); "
          f"logpost_mean {init['logpost_mean']} -> {samp[-1]['logpost_mean']}; "
          f"acceptance {accept:.4f}; {rate_all:.2f} chain-steps/s over "
          f"{steps} steps x {N_CHAINS} chains after init, {rate_last:.2f} in "
          f"the last segment (cli wall {wall:.1f} s including data and "
          f"set-up)")

    # 7. The AM path of slice 1 through the CLI.
    k1.launches = k4.launches = 0
    recs, _, wall = _run_cli(cli, ["run", AM_CONFIG, *AM_ARGS])
    am_launches = k1.launches
    if am_launches <= 0:
        raise RuntimeError("AM path: the sweep kernel was never launched")
    am_cfg = apply_overrides(load_config(AM_CONFIG), AM_ARGS)
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "AM path", am_cfg.sampler.n_warmup)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"AM path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    print(f"AM path: {am_launches} K1 launches, {k4.launches} K4; "
          f"logpost_mean {init['logpost_mean']} -> {samp[-1]['logpost_mean']}; "
          f"{rate_all:.2f} chain-steps/s over {steps} steps x {N_CHAINS} "
          f"chains after init, {rate_last:.2f} in the last segment (cli wall "
          f"{wall:.1f} s)")

    # 8. K3 vs plain, on the card.
    def k3_pair(label, s, srcs, g, ecfg, done=None):
        """One cycle and a full solve through K3 and the plain version;
        returns the K3 cycle's and the plain cycle's ms per launch."""
        T0, frozen = seed_source(s, srcs, g, ecfg.seed_radius)
        fl = seed_floor(T0, frozen)
        if done is None:
            done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)
        launches0 = k3.launches
        T1_k, ms_k = _timed(lambda: cuda_sweep.sweep_cycle(
            T0, s, fl, g.spacing, ecfg.n_inner, done), reps=10)
        if k3.launches == launches0:
            raise RuntimeError(f"K3 {label}: the kernel was not launched")
        T1_p, ms_p = _timed(lambda: sweep_cycle_plain(
            T0, s, fl, g.spacing, ecfg.n_inner, done), reps=1)
        err = float((T1_k - T1_p).abs().max())
        kept = bool(torch.equal(T1_k[done], T0[done]))
        on_ = dataclasses.replace(ecfg, use_pallas="on")
        off_ = dataclasses.replace(ecfg, use_pallas="off")
        T_k, ms_sk = _timed(lambda: solve_eikonal_batched(s, srcs, g, on_))
        T_p, ms_sp = _timed(lambda: solve_eikonal_batched(s, srcs, g, off_))
        err_s = float((T_k - T_p).abs().max())
        finite = bool(torch.isfinite(T_k).all())
        print(f"K3 compare {label}: B={T0.shape[0]} grid={g.shape} "
              f"spacing={g.spacing}: one cycle max|kernel-plain| = "
              f"{err:.3e}, ms per launch kernel {ms_k:.3f}, plain {ms_p:.3f}; "
              f"solve at tol {ecfg.tol} max|kernel-plain| = {err_s:.3e}, ms "
              f"per solve kernel {ms_sk:.3f}, plain {ms_sp:.3f}; done fields "
              f"{int(done.sum())} untouched {kept}")
        if not (finite and kept and err <= K3_BAR and err_s <= K3_BAR):
            raise RuntimeError(f"K3 {label}: kernel disagrees with plain "
                               f"(cycle {err}, solve {err_s}, finite "
                               f"{finite}, done fields kept {kept})")
        errs["sweep2d_cycle"].extend([err, err_s])
        return ms_k, ms_p

    # (a) config 4's batch: prior-drawn particles x its crosswell sources.
    c4 = load_config(C4_CONFIG)
    g4 = c4.grid.build()
    data4, _ = make_dataset(g4, c4.data, c4.model, device=dev)
    post4 = build_posterior(c4.model, data4, g4, c4.eikonal)
    n_part = c4.sampler.n_particles
    parts = post4.sample_prior(gen, n_part)
    ecfg4 = EikonalConfig(tol=c4.eikonal.tol, max_iters=c4.eikonal.max_iters,
                          n_inner=c4.eikonal.n_inner,
                          seed_radius=c4.eikonal.seed_radius)
    n_src4 = data4.src_xyz.shape[0]
    s4 = post4.slowness_of(parts).unsqueeze(1).expand(
        (n_part, n_src4) + g4.shape).reshape((-1,) + g4.shape).contiguous()
    ms_k3, ms_k3_plain = k3_pair("a (c4 batch)", s4,
                                 data4.src_xyz.repeat(n_part, 1), g4, ecfg4)
    del s4
    # (b) config 1's batch: 4 chains (an RWM start) x its sources.
    c1 = load_config(C1_CONFIG)
    g1 = c1.grid.build()
    data1, _ = make_dataset(g1, c1.data, c1.model, device=dev)
    post1 = build_posterior(c1.model, data1, g1, c1.eikonal)
    u1 = post1.init_params(gen, c1.sampler.n_chains).u
    n_src1 = data1.src_xyz.shape[0]
    s1 = post1.slowness_of(Params(u=u1)).unsqueeze(1).expand(
        (c1.sampler.n_chains, n_src1) + g1.shape).reshape((-1,) + g1.shape)
    ecfg1 = EikonalConfig(tol=c1.eikonal.tol, max_iters=c1.eikonal.max_iters,
                          n_inner=c1.eikonal.n_inner,
                          seed_radius=c1.eikonal.seed_radius)
    ms_k3_c1, ms_k3_c1_plain = k3_pair(
        "b (c1 batch)", s1.contiguous(),
        data1.src_xyz.repeat(c1.sampler.n_chains, 1), g1, ecfg1)
    # (c) odd, anisotropic, non-square, with done flags.
    g_o = Grid((37, 23), (1.0, 1.25))
    u_o = 0.5 * torch.randn((7, 6, 6), generator=gen, device=dev)
    s_o = slowness_from_u(u_o, g_o, torch.tensor(1.0, device=dev))
    srcs_o = (0.05 + 0.9 * torch.rand((7, 2), generator=gen, device=dev)) \
        * torch.tensor(g_o.extent, device=dev)
    done_o = torch.tensor([False, True, False, False, True, False, True],
                          device=dev)
    k3_pair("c (odd anisotropic non-square, done flags)", s_o, srcs_o, g_o,
            EikonalConfig(tol=1e-5, max_iters=100), done=done_o)

    # Config 4's log-likelihood of the 10,000 particles, K3 vs plain.
    post4_off = build_posterior(
        c4.model, data4, g4,
        apply_overrides(c4, ["eikonal.use_pallas=off"]).eikonal)
    l3 = k3.launches
    ll_k, ms_llk = _timed(lambda: post4.log_lik(parts))
    if k3.launches == l3:
        raise RuntimeError("c4 log-likelihood: K3 was not launched")
    ll_p, ms_llp = _timed(lambda: post4_off.log_lik(parts))
    ll_rel = float(((ll_k - ll_p).abs() / ll_p.abs()).max())
    print(f"c4 log-likelihood of {n_part} prior particles: max relative "
          f"|K3-plain| = {ll_rel:.3e} (bar {LL_RTOL}); ms per log_lik: K3 "
          f"{ms_llk:.3f}, plain {ms_llp:.3f}")
    if not bool(torch.isfinite(ll_k).all()) or not ll_rel <= LL_RTOL:
        raise RuntimeError(f"c4 log-likelihood: K3 disagrees ({ll_rel})")
    del parts, post4_off, ll_k, ll_p
    torch.cuda.empty_cache()

    # 9. Config 4's SMC at full width through the CLI's SMC entry point.
    k1.launches = k4.launches = k3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_smc_config(c4, device="cuda", verbose=True,
                         max_stages=SMC_STAGES)
    smc_wall = time.perf_counter() - t0
    smc_launches = k3.launches
    if smc_launches <= 0:
        raise RuntimeError("SMC path: K3 was never launched")
    betas = res.betas
    target = c4.sampler.ess_threshold * n_part
    if not all(b1 > b0 for b0, b1 in zip(betas, betas[1:])):
        raise RuntimeError(f"SMC path: beta not strictly rising ({betas})")
    for b0, b1, e in zip(betas, betas[1:], res.ess_history[1:]):
        floored = b1 - b0 <= 1.000001e-6
        if not (b1 == 1.0 or floored or abs(e - target) <= 0.01 * target):
            raise RuntimeError(f"SMC path: ESS {e} at beta {b1} is off its "
                               f"target {target}")
    if not (math.isfinite(res.log_evidence)
            and all(math.isfinite(a) for a in res.accept_history)
            and bool(torch.isfinite(res.state.log_lik).all())):
        raise RuntimeError("SMC path: non-finite log Z, acceptance or "
                           "log-likelihood")
    per_stage = sum(res.stage_seconds) / res.n_stages
    pms = (n_part * c4.sampler.n_mutation_steps * res.n_stages
           / sum(res.stage_seconds))
    print(f"SMC path: {smc_launches} K3 launches; {res.n_stages} stages, "
          f"betas {betas}, ESS {res.ess_history}, acceptance "
          f"{res.accept_history}, log Z {res.log_evidence:.3f}; "
          f"{per_stage:.3f} s per stage (stages {res.stage_seconds}), "
          f"{pms:.1f} particle-mutation-steps/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; run wall "
          f"{smc_wall:.1f} s including data and the initial particles")

    # 10. Config 1's RWM at full width through the CLI.
    k1.launches = k4.launches = k3.launches = 0
    recs, _, wall = _run_cli(cli, ["run", C1_CONFIG, *C1_ARGS])
    rwm_launches = k3.launches
    if rwm_launches <= 0:
        raise RuntimeError("RWM path: K3 was never launched")
    c1_run = apply_overrides(c1, C1_ARGS)
    n1 = c1_run.sampler.n_chains
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "RWM path", c1_run.sampler.n_warmup, n1)
    accept = sum(r["accept"] for r in samp) / len(samp)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"RWM path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    if not 0.05 < accept < 0.99:
        raise RuntimeError(f"RWM path: acceptance {accept} outside "
                           "(0.05, 0.99)")
    print(f"RWM path: {rwm_launches} K3 launches; logpost_mean "
          f"{init['logpost_mean']} -> {samp[-1]['logpost_mean']}; acceptance "
          f"{accept:.4f}; {rate_all:.2f} chain-steps/s over {steps} steps x "
          f"{n1} chains after init, {rate_last:.2f} in the last segment "
          f"(cli wall {wall:.1f} s); K3 ms per launch at c1's batch "
          f"{ms_k3_c1:.3f}, plain {ms_k3_c1_plain:.3f}")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "sweep3d_cycle",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:372",
        "launches": mala_launches["sweep3d_cycle"],
        "max_abs_err": max(errs["sweep3d_cycle"]),
        "ms": ms_k1,
        "plain_ms": ms_k1_plain,
    }, {
        "name": "transport3d_cycle",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/transport3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_transport.py:132",
        "launches": mala_launches["transport3d_cycle"],
        "max_abs_err": max(errs["transport3d_cycle"]),
        "ms": ms_k4,
        "plain_ms": ms_k4_plain,
    }, {
        "name": "sweep2d_cycle",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:890",
        "launches": smc_launches,
        "max_abs_err": max(errs["sweep2d_cycle"]),
        "ms": ms_k3,
        "plain_ms": ms_k3_plain,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
