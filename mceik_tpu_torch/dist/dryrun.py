"""The sharded paths on a few ranks at tiny shapes, and the rank entry the
tests and ``chip_smoke.py`` launch.

Counterpart of ``__graft_entry__.py::dryrun_multichip``. One rank per
process, started by ``torchrun``:

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m mceik_tpu_torch.dist.dryrun [--device cpu]

runs legs A-E, each held against the unsharded run of the same seed:

  A. chains sharded: adaptive Metropolis with the pooled adaptation;
  B. the grid-sharded solve (``eikonal/dist_sweep.py``: halo planes);
  C. the reshard of grid-sharded tables to stations (``forward/reshard.py``)
     and the prediction against ``forward.predict.predict_events``;
  D. SMC with the particles sharded, through ``samplers.smc.run_smc``;
  E. one NUTS step with gradients over sharded chains.

The same entry runs one named task per launch and writes what each rank
computed, with its kernels' launch counts, to ``<out>/rank<r>.pt``:

    ... -m mceik_tpu_torch.dist.dryrun [--device cpu] task <name> <out> [<in.pt>]
    ... -m mceik_tpu_torch.dist.dryrun [--device cpu] cli <out> <cli args>

Tasks: ``rwm`` (8 chains on a correlated 2-D Gaussian, 100 + 200 steps),
``smc`` and ``smc_resume`` (a conjugate Gaussian toy), ``solve`` and
``reshard`` (inputs from ``<in.pt>``), ``smc_config`` (a config's SMC through
``run_smc_config``) and ``tables`` (a config's station tables through the
grid-sharded solve, the reshard and the prediction of its events); ``cli``
runs ``mceik_tpu_torch.cli.main`` on the rest of the line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from mceik_tpu_torch.config import DataCfg, DistCfg, EikonalCfg, ModelCfg
from mceik_tpu_torch.dist.mesh import (Mesh, all_gather0, init_distributed,
                                       shard_chains)
from mceik_tpu_torch.grid import Grid

COV_P = np.linalg.inv(np.array([[1.0, 0.3], [0.3, 2.0]]))


def launches() -> Dict[str, int]:
    """This process's kernel launch counts."""
    from mceik_tpu_torch.eikonal import (cuda_sweep, cuda_sweep2d,
                                         cuda_transport, cuda_transport2d)
    k3 = cuda_sweep2d.SWEEP2D
    return {"sweep3d": cuda_sweep.SWEEP3D.launches,
            "transport3d": cuda_transport.TRANSPORT3D.launches,
            "transport3d_large": cuda_transport.TRANSPORT3D_LARGE.launches,
            "sweep2d": k3.launches, "sweep2d_block": k3.block_launches,
            "transport2d": cuda_transport2d.TRANSPORT2D.launches}


# --- toys ------------------------------------------------------------------

class GaussToy:
    """A conjugate Gaussian SMC target: N(0, I) prior on 2 coordinates and
    a Gaussian likelihood of ``obs`` with noise ``sigma``."""

    def __init__(self, obs, sigma: float, device="cpu"):
        self.obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
        self.sigma = sigma
        self.prior_scales = torch.ones(2, device=device)

    def log_prior(self, x):
        return -0.5 * (x * x).sum(1)

    def log_lik(self, x):
        return -0.5 * ((self.obs - x) ** 2).sum(1) / self.sigma ** 2

    def sample_prior(self, gen, n):
        return torch.randn((n, 2), generator=gen, device=self.obs.device)


def rwm_gaussian(mesh: Mesh = Mesh(), device="cpu", n_chains: int = 8,
                 n_warmup: int = 100, n_steps: int = 200):
    """RWM on a correlated 2-D Gaussian (tests/test_dist.py's target),
    ``n_chains`` chains sharded over ``mesh``; returns the run's
    ``MCMCResult`` (traces of every chain)."""
    from mceik_tpu_torch.samplers import rwm
    from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc

    prec = torch.tensor(COV_P, dtype=torch.float32, device=device)

    def logpost(x):
        return -0.5 * ((x @ prec) * x).sum(1)

    gen = torch.Generator(device=device).manual_seed(0)
    states = init_chain_states(logpost, lambda g, n: torch.randn(
        (n, 2), generator=g, device=device), gen, n_chains)
    return run_mcmc(rwm.make_kernel(logpost), rwm.make_adapter(),
                    shard_chains(states, mesh),
                    rwm.init_hyper(torch.ones(2, device=device), 0.5), gen,
                    n_warmup=n_warmup, n_steps=n_steps, mesh=mesh)


def tiny_posterior(device, grid_shape=(8, 8, 8), inv_shape=(4, 4, 4),
                   n_src=4, n_rec=6, differentiable=False):
    """A checkerboard tomo posterior at tiny shapes (the reference's
    ``_tiny_posterior``)."""
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.model.posterior import build_posterior

    grid = Grid(shape=grid_shape, spacing=tuple(1.0 for _ in grid_shape))
    mcfg = ModelCfg(mode="tomo", inv_shape=inv_shape, prior_sigma_u=0.2,
                    sigma=0.01)
    dcfg = DataCfg(dataset="checkerboard3d", n_src=n_src, n_rec=n_rec,
                   noise=0.01, checker_cells=(2, 2, 2),
                   checker_amplitude=0.1)
    ecfg = EikonalCfg(method="sweep", tol=1e-3, max_iters=20)
    data, _ = make_dataset(grid, dcfg, mcfg, device=device)
    return build_posterior(mcfg, data, grid, ecfg,
                           differentiable=differentiable), grid


def gather_axis1(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's slab along axis 1 (the grid-sharded tables' axis 0)."""
    return all_gather0(x.movedim(1, 0).contiguous(), mesh).movedim(0, 1)


# --- legs A-E ----------------------------------------------------------------

def _close(label, got, want, rtol, atol):
    got, want = (torch.as_tensor(x).detach().cpu().double() for x in (got, want))
    gap = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol,
                                                     atol=atol):
        raise AssertionError(f"{label}: sharded and unsharded disagree (max "
                             f"abs gap {gap}, shapes {tuple(got.shape)} "
                             f"{tuple(want.shape)})")
    return gap


def dryrun(mesh: Mesh, device) -> Dict[str, float]:
    """Legs A-E on ``mesh``; returns each leg's max abs gap to the unsharded
    run. Raises on a disagreement."""
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.dist_sweep import solve_eikonal_sharded
    from mceik_tpu_torch.eikonal.solve import EikonalConfig
    from mceik_tpu_torch.forward.predict import predict_events
    from mceik_tpu_torch.forward.reshard import predict_events_resharded
    from mceik_tpu_torch.samplers import am, hmc, nuts
    from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc
    from mceik_tpu_torch.samplers.smc import run_smc
    from mceik_tpu_torch.utils import tree_map

    n = mesh.world
    gaps = {}

    # A. Chains sharded: AM with the pooled adaptation.
    post, _ = tiny_posterior(device)

    def leg_a(m):
        gen = torch.Generator(device=device).manual_seed(0)
        states = init_chain_states(post.logpost, post.init_params, gen, 2 * n)
        example = tree_map(lambda x: x[0], states.params)
        hyper = am.init_hyper(post.prior_scales, 0.1, example)
        return run_mcmc(am.make_kernel(post.logpost), am.make_adapter(),
                        shard_chains(states, m), hyper, gen, n_warmup=1,
                        n_steps=1, mesh=m)
    r_sh, r_un = leg_a(mesh), leg_a(Mesh(device=device))
    if not bool(torch.isfinite(r_sh.logpost_trace).all()):
        raise AssertionError(f"A: non-finite logpost {r_sh.logpost_trace}")
    gaps["A"] = _close("A", r_sh.logpost_trace, r_un.logpost_trace, 2e-4, 2e-4)

    # B. The grid-sharded solve against the unsharded one.
    ggrid = Grid(shape=(2 * n, 9, 7), spacing=(1.0, 1.0, 1.0))
    s = torch.ones(ggrid.shape, device=device)
    src = torch.tensor([1.0, 4.0, 3.0], device=device)
    ecfg = EikonalConfig(method="sweep", tol=1e-4, max_iters=60,
                         use_pallas="off")
    T_sh = gather_axis1(solve_eikonal_sharded(s, src, ggrid, mesh,
                                              ecfg)[None], mesh)[0]
    T_un = solve_eikonal_batched(s[None], src[None], ggrid, ecfg)[0]
    gaps["B"] = _close("B", T_sh, T_un, 1e-4, 1e-4)

    # C. The reshard: grid-sharded station tables -> station-sharded.
    ugrid = Grid(shape=(2 * n, 8, 6), spacing=(1.0, 1.0, 1.0))
    g = torch.Generator(device="cpu").manual_seed(5)
    hi = torch.tensor([d - 1.0 for d in ugrid.shape])
    sta = (torch.rand((n, 3), generator=g) * hi).to(device)
    ev = (torch.rand((3, 3), generator=g) * hi).to(device)
    t0 = torch.zeros(3, device=device)
    su = torch.ones((n,) + ugrid.shape, device=device)
    slab = solve_eikonal_sharded(su, sta, ugrid, mesh, ecfg)
    tables = gather_axis1(slab, mesh)
    gaps["C"] = _close("C", predict_events_resharded(slab, ev, t0, ugrid,
                                                     mesh),
                       predict_events(tables, ev, t0, ugrid), 0.0, 1e-5)

    # D. SMC with the particles sharded, through run_smc.
    toy = GaussToy([0.8, 0.8], 0.5, device)
    kw = dict(n_particles=64 * n, n_mutation_steps=2, step_size=0.5)
    r_sh = run_smc(toy, torch.Generator(device=device).manual_seed(7),
                   mesh=mesh, **kw)
    r_un = run_smc(toy, torch.Generator(device=device).manual_seed(7), **kw)
    if not (r_sh.betas[-1] == 1.0 and np.isfinite(r_sh.log_evidence)
            and all(0.0 < a <= 1.0 for a in r_sh.accept_history)):
        raise AssertionError(f"D: ladder {r_sh.betas}, log Z "
                             f"{r_sh.log_evidence}, accept "
                             f"{r_sh.accept_history}")
    gaps["D"] = _close("D", r_sh.state.params.mean(0),
                       r_un.state.params.mean(0), 0.0, 0.25)

    # E. One NUTS step with gradients over sharded chains.
    dpost, _ = tiny_posterior(device, inv_shape=(3, 3, 3), n_src=2, n_rec=3,
                              differentiable=True)

    def leg_e(m):
        gen = torch.Generator(device=device).manual_seed(11)
        states = init_chain_states(dpost.logpost, dpost.init_params, gen, n)
        example = tree_map(lambda x: x[0], states.params)
        hyper = hmc.init_hyper(dpost.prior_scales, 0.01, example)
        return run_mcmc(nuts.make_kernel(dpost.logpost, max_tree_depth=3,
                                         mesh=m),
                        hmc.make_adapter(0.8), shard_chains(states, m), hyper,
                        gen, n_warmup=1, n_steps=1, mesh=m)
    r_sh, r_un = leg_e(mesh), leg_e(Mesh(device=device))
    if not bool(torch.isfinite(r_sh.logpost_trace).all()):
        raise AssertionError(f"E: non-finite logpost {r_sh.logpost_trace}")
    gaps["E"] = _close("E", r_sh.logpost_trace, r_un.logpost_trace, 2e-4,
                       2e-4)
    return gaps


# --- tasks -------------------------------------------------------------------

def task_rwm(mesh, device, inputs):
    r = rwm_gaussian(mesh, device)
    return {"logpost_trace": r.logpost_trace.cpu(),
            "log_step": r.hyper.log_step.cpu()}


def _smc_out(r):
    """A ladder's record; ``params`` the population (``u`` of a model's
    ``Params``)."""
    params = r.state.params
    params = params if isinstance(params, torch.Tensor) else params.u
    return {"betas": r.betas, "log_evidence": r.log_evidence,
            "n_stages": r.n_stages, "ess_history": r.ess_history,
            "accept_history": r.accept_history,
            "stage_seconds": r.stage_seconds, "params": params.cpu()}


def task_smc(mesh, device, inputs):
    """tests/test_dist.py's sharded SMC: 2048 particles, 3 mutation steps."""
    from mceik_tpu_torch.samplers.smc import run_smc
    toy = GaussToy([1.0, -1.0], 0.5, device)
    return _smc_out(run_smc(toy, torch.Generator(device=device).manual_seed(0),
                            n_particles=2048, n_mutation_steps=3,
                            step_size=0.5, mesh=mesh))


def task_smc_resume(mesh, device, inputs):
    """tests/test_dist.py's SMC checkpoint and resume, sharded: the whole
    ladder, then 2 stages with a checkpoint, then the rest resumed."""
    from mceik_tpu_torch.samplers.smc import run_smc
    toy = GaussToy([1.0, -1.0], 0.5, device)
    kw = dict(n_particles=512, n_mutation_steps=3, step_size=0.5,
              ess_threshold=0.9, mesh=mesh)
    ck = os.path.join(inputs["out"], "smc_resume.pt")
    gen = lambda: torch.Generator(device=device).manual_seed(3)
    full = run_smc(toy, gen(), **kw)
    part = run_smc(toy, gen(), max_stages=2, checkpoint_path=ck, **kw)
    rest = run_smc(toy, gen(), resume=ck, **kw)
    return {"full": _smc_out(full), "part": _smc_out(part),
            "rest": _smc_out(rest)}


def task_solve(mesh, device, inputs):
    """``solve_eikonal_sharded`` on each case of ``inputs["cases"]``
    (slowness, source, spacing, tol, max_iters); every rank's slabs
    gathered."""
    from mceik_tpu_torch.eikonal.dist_sweep import solve_eikonal_sharded
    from mceik_tpu_torch.eikonal.solve import EikonalConfig
    out = []
    for case in inputs["cases"]:
        s = torch.as_tensor(case["slowness"], device=device)
        grid = Grid(shape=tuple(s.shape), spacing=tuple(case["spacing"]))
        cfg = EikonalConfig(tol=case["tol"], max_iters=case["max_iters"],
                            use_pallas="off")
        T = solve_eikonal_sharded(s, torch.as_tensor(case["src"]), grid,
                                  mesh, cfg)
        out.append(gather_axis1(T[None], mesh)[0].cpu())
    return {"T": out}


def task_reshard(mesh, device, inputs):
    """The reshard of ``inputs["tables"]`` (every station's whole table;
    each rank takes its grid slab) and the prediction at the events."""
    from mceik_tpu_torch.forward.reshard import (predict_events_resharded,
                                                 reshard_tables_to_stations)
    tables = torch.as_tensor(inputs["tables"], device=device)
    grid = Grid(shape=tuple(tables.shape[1:]),
                spacing=tuple(inputs["spacing"]))
    lo, hi = mesh.rows(grid.shape[0])
    slab = tables[:, lo:hi].contiguous()
    ev = torch.as_tensor(inputs["events"], device=device)
    t0 = torch.as_tensor(inputs["t0"], device=device)
    tabs_s = all_gather0(reshard_tables_to_stations(slab, mesh), mesh)
    return {"tables": tabs_s.cpu(),
            "t": predict_events_resharded(slab, ev, t0, grid, mesh).cpu()}


def task_smc_config(mesh, device, inputs):
    """A config's SMC through ``run_smc_config`` (the CLI's entry), the
    ladder capped at ``inputs["max_stages"]``."""
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config
    from mceik_tpu_torch.samplers.smc import run_smc_config
    cfg = apply_overrides(load_config(inputs["config"]),
                          inputs.get("overrides", []))
    return _smc_out(run_smc_config(cfg, device=device,
                                   max_stages=inputs["max_stages"]))


def task_tables(mesh, device, inputs):
    """A config's station tables (the truth slowness, every station)
    through ``solve_eikonal_sharded`` at ``inputs["tol"]`` and
    ``inputs["max_iters"]``, held on rank 0 against the unsharded solve
    (the kernels' route on the card); then the reshard and the predicted
    arrivals of its events against ``predict_events`` on the gathered
    tables. Returns the gaps and the seconds."""
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.dist_sweep import solve_eikonal_sharded
    from mceik_tpu_torch.eikonal.solve import EikonalConfig
    from mceik_tpu_torch.forward.predict import predict_events
    from mceik_tpu_torch.forward.reshard import predict_events_resharded
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config

    cfg = apply_overrides(load_config(inputs["config"]),
                          inputs.get("overrides", []))
    grid = cfg.grid.build()
    data, truth = make_dataset(grid, cfg.data, cfg.model, device=device)
    sta = data.sta_xyz
    ecfg = EikonalConfig(tol=inputs["tol"], max_iters=inputs["max_iters"],
                         n_inner=cfg.eikonal.n_inner,
                         seed_radius=cfg.eikonal.seed_radius)
    s = truth["slowness"].expand((sta.shape[0],) + grid.shape)

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()
    t0 = synced()
    slab, iters = solve_eikonal_sharded(s, sta, grid, mesh, ecfg,
                                        return_iters=True)
    sec_sharded = synced() - t0
    tables = gather_axis1(slab, mesh)
    out = {"sharded_s": sec_sharded, "sharded_cycles": iters}
    if mesh.root:
        t0 = synced()
        ref = solve_eikonal_batched(s.contiguous(), sta, grid, ecfg)
        out["unsharded_s"] = synced() - t0
        out["solve_gap"] = float((tables - ref).abs().max())
        out["max_T"] = float(ref.max())
    t0 = synced()
    pred = predict_events_resharded(slab, truth["hypo"], truth["t0"], grid,
                                    mesh)
    out["reshard_s"] = synced() - t0
    out["predict_gap"] = float((pred - predict_events(
        tables, truth["hypo"], truth["t0"], grid)).abs().max())
    out["shape"] = [int(sta.shape[0]), *grid.shape, int(pred.shape[0])]
    return out


TASKS = {"rwm": task_rwm, "smc": task_smc, "smc_resume": task_smc_resume,
         "solve": task_solve, "reshard": task_reshard,
         "smc_config": task_smc_config, "tables": task_tables}


def _save(out_dir: str, rank: int, result: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    result["launches"] = launches()
    path = os.path.join(out_dir, f"rank{rank}.pt")
    tmp = tempfile.NamedTemporaryFile(dir=out_dir, suffix=".tmp",
                                      delete=False).name
    torch.save(result, tmp)
    os.replace(tmp, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mceik_tpu_torch.dist.dryrun")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; this rank's card) or cpu")
    p.add_argument("what", nargs="?", default="legs",
                   choices=("legs", "task", "cli"))
    p.add_argument("rest", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mceik_tpu_torch.api import prepare_device

    rank = int(os.environ.get("RANK", "") or 0)
    if args.what == "cli":
        from mceik_tpu_torch import cli
        out_dir, cli_argv = args.rest[0], args.rest[1:]
        rc = cli.main(cli_argv)
        _save(out_dir, rank, {"rc": rc})
        return rc

    mesh = init_distributed(DistCfg(), prepare_device(args.device))
    try:
        if args.what == "legs":
            gaps = dryrun(mesh, mesh.device)
            if mesh.root:
                print(f"dryrun over {mesh.world} ranks ({mesh.backend}, "
                      f"{mesh.device}): ALL OK, max abs gaps to the "
                      f"unsharded runs {json.dumps(gaps)}", flush=True)
            print(f"dryrun rank {rank}: {json.dumps(launches())}",
                  flush=True)
            return 0
        name, out_dir = args.rest[0], args.rest[1]
        inputs = (torch.load(args.rest[2], weights_only=False)
                  if len(args.rest) > 2 else {})
        inputs["out"] = out_dir
        _save(out_dir, rank, TASKS[name](mesh, mesh.device, inputs))
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
