#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mceik_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build of every kernel on the main path from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and on edge cases (bar: max abs diff <= 1e-4);
4. the main path through the normal entry point,
   ``mceik_tpu_torch.cli.main(["run", "configs/c2_checkerboard3d.json",
   ...])`` at 16 chains (64^3 grid, 8 sources, 12 receivers), with every
   kernel's launch count reset just before and read just after, and the
   run's logposts checked: all finite, mean at the end above the start.

The line before the last is a JSON object listing the kernels with their
launch counts, errors and times; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device and the repository
around this file; without either it fails before printing any result.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "c2_checkerboard3d.json")
BAR = 1e-4          # kernel vs plain, max abs traveltime difference
SOLVE_TOL = 1e-5    # solver tolerance of the comparison solves
MAIN_ARGS = ["sampler.n_chains=16", "sampler.n_warmup=100",
             "sampler.n_samples=200", "sampler.thin=4", "io.log_every=50"]


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


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from mceik_tpu_torch import cli
    from mceik_tpu_torch.datasets.synthetic import (borehole_3d_geometry,
                                                    checkerboard_slowness)
    from mceik_tpu_torch.eikonal import cuda_sweep
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                               seed_source, sweep_cycle_plain,
                                               sweep_solve)
    from mceik_tpu_torch.grid import Grid
    from mceik_tpu_torch.io.config_io import load_config
    from mceik_tpu_torch.model.params import slowness_from_u

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = _card_line()

    # 1. The card: nvidia-smi's own line (name, power limit), then versions.
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device 0: {kind}")

    # 2. Build.
    k1 = cuda_sweep.SWEEP3D
    k1.build()
    print(f"build: sweep3d ({cuda_sweep.SOURCE.relative_to(REPO)}) in "
          f"{k1.build_seconds:.2f} s")
    for line in k1.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. Kernel vs plain, on the card.
    cfg = load_config(CONFIG)
    grid = cfg.grid.build()
    n_chains = 16
    on = EikonalConfig(tol=SOLVE_TOL, max_iters=200, use_pallas="on")
    off = EikonalConfig(tol=SOLVE_TOL, max_iters=200, use_pallas="off")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = []

    def compare(label, s, srcs, g, reps=3):
        launches0 = k1.launches
        T_k, ms_k = _timed(lambda: solve_eikonal_batched(s, srcs, g, on), reps)
        launched = k1.launches - launches0
        T_p, ms_p = _timed(lambda: solve_eikonal_batched(s, srcs, g, off), 1)
        if not launched:
            raise RuntimeError(f"{label}: the kernel was not launched")
        err = float((T_k - T_p).abs().max())
        finite = bool(torch.isfinite(T_k).all())
        print(f"compare {label}: B={s.shape[0]} grid={g.shape} "
              f"spacing={g.spacing}: max|kernel-plain| = {err:.3e}; "
              f"ms per batch solve: kernel {ms_k:.3f}, plain {ms_p:.3f}")
        if not finite or not err <= BAR:
            raise RuntimeError(f"{label}: kernel disagrees with plain "
                               f"(max abs {err}, finite {finite})")
        errs.append(err)
        return T_k

    # (a) the main path's batch: 16 chains x c2's 8 sources on its 64^3
    # checkerboard, each chain's slowness perturbed as an AM proposal is.
    s_true = checkerboard_slowness(grid, cfg.data.checker_cells,
                                   cfg.data.checker_amplitude,
                                   cfg.model.background_slowness, device=dev)
    src, _ = borehole_3d_geometry(grid, cfg.data.n_src, cfg.data.n_rec,
                                  device=dev)
    u = 0.1 * cfg.model.prior_sigma_u * torch.randn(
        (n_chains,) + tuple(cfg.model.inv_shape), generator=gen, device=dev)
    s_a = (s_true * slowness_from_u(u, grid, torch.tensor(1.0, device=dev)))
    s_a = s_a.unsqueeze(1).expand((n_chains, cfg.data.n_src) + grid.shape)
    s_a = s_a.reshape((-1,) + grid.shape).contiguous()
    srcs_a = src.repeat(n_chains, 1)
    compare("a (main-path batch)", s_a, srcs_a, grid)

    # One cycle at the main path's shape: the unit a launch does.
    T0, frozen = seed_source(s_a, srcs_a, grid, cfg.eikonal.seed_radius)
    floor = seed_floor(T0, frozen)
    done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)
    launches0 = k1.launches
    T1_k, ms_cycle_k = _timed(
        lambda: cuda_sweep.sweep_cycle(T0, s_a, floor, grid.spacing,
                                       cfg.eikonal.n_inner, done), reps=10)
    if k1.launches == launches0:
        raise RuntimeError("cycle: the kernel was not launched")
    T1_p, ms_cycle_p = _timed(
        lambda: sweep_cycle_plain(T0, s_a, floor, grid.spacing,
                                  cfg.eikonal.n_inner, done), reps=1)
    err_cycle = float((T1_k - T1_p).abs().max())
    print(f"compare one cycle, B={T0.shape[0]} grid={grid.shape}: "
          f"max|kernel-plain| = {err_cycle:.3e}; ms per launch: kernel "
          f"{ms_cycle_k:.3f}, plain {ms_cycle_p:.3f}")
    if not err_cycle <= BAR:
        raise RuntimeError(f"cycle: kernel disagrees with plain ({err_cycle})")
    errs.append(err_cycle)

    # (b) odd batch, non-cube grid, unequal spacing (weighted local solve).
    g_b = Grid((48, 40, 32), (1.0, 1.2, 0.9))
    u_b = 0.3 * torch.randn((3, 6, 6, 6), generator=gen, device=dev)
    s_b = slowness_from_u(u_b, g_b, torch.tensor(1.0, device=dev))
    ext = torch.tensor(g_b.extent, device=dev)
    srcs_b = (0.1 + 0.8 * torch.rand((3, 3), generator=gen, device=dev)) * ext
    compare("b (odd anisotropic non-cube)", s_b, srcs_b, g_b)

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
    print(f"compare c: cycles per field {cycles}")
    if len(set(cycles)) < 2:
        raise RuntimeError("c: every field took the same number of cycles")
    xyz = torch.as_tensor(g_c.node_coords(), dtype=torch.float32, device=dev)
    r = torch.linalg.norm(xyz[None] - srcs_c[:n_easy, None, None, None], dim=-1)
    # First-order upwind overestimates point-source distances off the grid
    # axes: ~7.6% at most on these fields with the plain sweep (CPU).
    analytic = float(((T_c[:n_easy] - r).abs() / r.clamp(min=1.0)).max())
    print(f"compare c: homogeneous fields vs analytic distance: max relative "
          f"error {analytic:.4f} (first-order upwind, bar 0.1)")
    if not analytic < 0.1:
        raise RuntimeError(f"c: homogeneous solve off the analytic ({analytic})")

    # 4. The main path through the CLI.
    k1.launches = 0
    tee = _Tee(sys.stdout)
    argv = ["run", CONFIG, *MAIN_ARGS]
    print(f"main path: mceik_tpu_torch.cli.main({argv})")
    t0 = time.perf_counter()
    sys.stdout = tee
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout = tee.out
    wall = time.perf_counter() - t0
    main_launches = k1.launches
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    if main_launches <= 0:
        raise RuntimeError("main path: the sweep kernel was never launched")
    recs = [json.loads(line.split("] ", 1)[1])
            for line in tee.buf.getvalue().splitlines()
            if line.startswith("[mceik] ")]
    init = [r for r in recs if r["phase"] == "init"]
    samp = [r for r in recs if r["phase"] == "sample"]
    if len(init) != 1 or not samp:
        raise RuntimeError(f"main path: expected init + sample records, got "
                           f"{len(init)} + {len(samp)}")
    vals = [r[k] for r in init + samp
            for k in ("logpost_mean", "logpost_min", "logpost_max")]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError("main path: non-finite logpost")
    lp_start, lp_end = init[0]["logpost_mean"], samp[-1]["logpost_mean"]
    if not lp_end > lp_start:
        raise RuntimeError(f"main path: logpost did not rise "
                           f"({lp_start} -> {lp_end})")
    n_warm = load_config(CONFIG).sampler.n_warmup
    for a in MAIN_ARGS:
        if a.startswith("sampler.n_warmup="):
            n_warm = int(a.split("=", 1)[1])
    steps = n_warm + samp[-1]["step"]
    rate_all = steps * n_chains / (samp[-1]["t"] - init[0]["t"])
    steady = ""
    if len(samp) >= 2:
        rate = ((samp[-1]["step"] - samp[-2]["step"]) * n_chains
                / (samp[-1]["t"] - samp[-2]["t"]))
        steady = f", {rate:.2f} in the last sampling segment"
    print(f"main path: {main_launches} kernel launches; logpost_mean "
          f"{lp_start} -> {lp_end}; {rate_all:.2f} chain-steps/s over "
          f"{steps} steps x {n_chains} chains after init{steady} "
          f"(cli wall {wall:.1f} s including data and set-up)")

    print(json.dumps({"kernels": [{
        "name": "sweep3d_cycle",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:372",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": ms_cycle_k,
        "plain_ms": ms_cycle_p,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
