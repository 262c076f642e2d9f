"""The port's distribution on gloo CPU ranks, against its unsharded runs and
the JAX package: sharded runs take the unsharded runs' draws and match them
at the bars of tests/test_dist.py and tests/test_dist_sweep.py (the
measured gaps are printed), checkpoints written sharded resume unsharded,
the grid-sharded solve and the reshard match JAX's on the same number of
virtual CPU devices, the dryrun's legs pass, and what cannot shard is
refused. Each test launches its ranks once, with ``torchrun``, through the
port's rank entry ``mceik_tpu_torch.dist.dryrun`` (or its CLI); the ranks
import neither JAX nor this file."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

from mceik_tpu.dist.mesh import chain_mesh as j_chain_mesh
from mceik_tpu.eikonal.dist_sweep import solve_eikonal_sharded as j_sharded
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.eikonal.solve import solve_eikonal as j_solve
from mceik_tpu.forward.predict import predict_events as j_predict_events
from mceik_tpu.forward.predict import traveltime_tables as j_tables
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch import api, cli
from mceik_tpu_torch.dist.dryrun import GaussToy, rwm_gaussian
from mceik_tpu_torch.dist.mesh import Mesh, pick_backend
from mceik_tpu_torch.eikonal.dist_sweep import solve_eikonal_sharded
from mceik_tpu_torch.forward.reshard import reshard_tables_to_stations
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.config_io import apply_overrides, load_config
from mceik_tpu_torch.samplers.smc import run_smc


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C2 = os.path.join(REPO, "configs", "c2_checkerboard3d.json")
TINY16 = ["grid.shape=[16,16,16]", "model.inv_shape=[4,4,4]", "data.n_src=2",
          "data.n_rec=3", "sampler.n_chains=4", "sampler.n_warmup=4",
          "sampler.thin=2", "io.log_every=2"]


def _torchrun(n, *args, timeout=240):
    """``torchrun --standalone --nproc_per_node=n <args>`` from the
    repository root, one intra-op thread per rank; returns the ranks'
    stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    return out.stdout


def _task(n, name, out_dir, inputs=None):
    """One launch of the rank entry's task ``name``; rank 0's result."""
    args = ["-m", "mceik_tpu_torch.dist.dryrun", "--device", "cpu", "task",
            name, str(out_dir)]
    if inputs is not None:
        path = os.path.join(str(out_dir), "in.pt")
        torch.save(inputs, path)
        args.append(path)
    _torchrun(n, *args)
    return torch.load(os.path.join(str(out_dir), "rank0.pt"),
                      weights_only=False)


def _records(text):
    return [json.loads(x.split("] ", 1)[1]) for x in text.splitlines()
            if x.startswith("[mceik] ")]


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# --- chains ------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_rwm_equals_unsharded(n, tmp_path):
    """tests/test_dist.py's RWM case (8 chains, 100 + 200 steps) sharded
    over n ranks against the unsharded run of the same seed: the logpost
    trace at rtol and atol 2e-4, log_step at rtol 1e-4 (JAX's bars); every
    rank draws the whole batch, so the gap is expected at 0."""
    sh = _task(n, "rwm", tmp_path)
    un = rwm_gaussian()
    print(f"rwm over {n} ranks: max |dlogpost| "
          f"{_gap(sh['logpost_trace'], un.logpost_trace):.3e}, |dlog_step| "
          f"{_gap(sh['log_step'], un.hyper.log_step):.3e}")
    assert sh["logpost_trace"].shape == (200, 8)
    np.testing.assert_allclose(sh["logpost_trace"].numpy(),
                               un.logpost_trace.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(sh["log_step"]),
                               float(un.hyper.log_step), rtol=1e-4)


@pytest.mark.parametrize("n, cap", [(2, []), (4, ["dist.n_devices=2"])],
                         ids=["2-ranks", "4-ranks-capped-at-2"])
def test_cli_sharded_c2_am_records_equal_unsharded(n, cap, capsys):
    """A tiny config-2 AM run (16^3, 4 chains) through the CLI under
    torchrun on 2 ranks, and on 4 with ``dist.n_devices=2`` (2 ranks shard,
    the others run unsharded and stay silent): rank 0 reports the backend
    and device first, and its records equal the unsharded CLI run's (all
    but the clock)."""
    argv = ["run", C2, *TINY16, "sampler.n_samples=4", "--device", "cpu"]
    text = _torchrun(n, "-m", "mceik_tpu_torch", *argv[:-2], *cap,
                     *argv[-2:])
    first = [x for x in text.splitlines() if x.startswith("[mceik")][0]
    assert first == "[mceik-tpu-torch] dist: 2 ranks, backend gloo, rank 0 " \
                    "on cpu"
    assert cli.main(argv) == 0
    want = _records(capsys.readouterr().out)
    got = _records(text)
    clock = ("t", "chain_steps_per_s")
    strip = lambda recs: [{k: v for k, v in r.items() if k not in clock}
                          for r in recs]
    assert [r["phase"] for r in got] == ["init", "sample", "sample"]
    assert strip(got) == strip(want)
    assert sum(x.startswith("[mceik-tpu-torch] am chains=4") for x in
               text.splitlines()) == 1


def test_sharded_checkpoint_resumes_unsharded(tmp_path):
    """Config 2 at 16^3 with 4 chains: 4 samples on 2 ranks with a
    checkpoint, then resumed for 4 more as one process, equal the
    uninterrupted 8-sample run of one process (the thinned draws of ``u``
    after step 4 and the final logposts at rtol 1e-6)."""
    ck = str(tmp_path / "am.pt")
    _torchrun(2, "-m", "mceik_tpu_torch", "run", C2, *TINY16,
              "sampler.n_samples=4", f"io.checkpoint_path={ck}",
              "io.checkpoint_every=2", "--device", "cpu")
    cfg = apply_overrides(load_config(C2), TINY16)
    full = api.run(apply_overrides(cfg, ["sampler.n_samples=8"]), "cpu",
                   verbose=False)
    rest = api.run(apply_overrides(cfg, ["sampler.n_samples=4",
                                         f"io.resume={ck}"]), "cpu",
                   verbose=False)
    n = rest.samples.u.shape[0]
    print(f"sharded checkpoint resumed unsharded: max |du| "
          f"{_gap(rest.samples.u, full.samples.u[-n:]):.3e}, max |dlogpost| "
          f"{_gap(rest.result.states.logpost, full.result.states.logpost):.3e}")
    np.testing.assert_allclose(rest.samples.u, full.samples.u[-n:],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rest.result.states.logpost.numpy(),
                               full.result.states.logpost.numpy(), rtol=1e-6)


# --- particles ---------------------------------------------------------------

def test_sharded_smc_matches_unsharded(tmp_path):
    """tests/test_dist.py's sharded SMC (2048 particles, 3 mutation steps,
    the conjugate toy) over 4 ranks against the unsharded run: the same
    ladder (betas at atol 1e-4, the stage count), log Z within 0.05, the
    posterior mean within 0.08 of the closed form and of the unsharded
    mean, the variances within 30%."""
    sh = _task(4, "smc", tmp_path)
    un = run_smc(GaussToy([1.0, -1.0], 0.5), torch.Generator().manual_seed(0),
                 n_particles=2048, n_mutation_steps=3, step_size=0.5)
    print(f"smc over 4 ranks: max |dbeta| {_gap(sh['betas'], un.betas):.3e}, "
          f"|dlogZ| {abs(sh['log_evidence'] - un.log_evidence):.3e}, max "
          f"|dparticle| {_gap(sh['params'], un.state.params):.3e}")
    assert sh["betas"][-1] == 1.0 and sh["n_stages"] == un.n_stages
    np.testing.assert_allclose(sh["betas"], un.betas, atol=1e-4)
    assert abs(sh["log_evidence"] - un.log_evidence) < 0.05
    xs, xu = sh["params"].numpy(), un.state.params.numpy()
    prec = 1.0 + 1.0 / 0.5 ** 2
    np.testing.assert_allclose(xs.mean(0), (1.0 / 0.5 ** 2) / prec
                               * np.array([1.0, -1.0]), atol=0.08)
    np.testing.assert_allclose(xs.mean(0), xu.mean(0), atol=0.08)
    np.testing.assert_allclose(xs.var(0), xu.var(0), rtol=0.3)


def test_sharded_smc_checkpoint_resume(tmp_path):
    """tests/test_dist.py's SMC checkpoint case (512 particles, ESS
    threshold 0.9) on 2 ranks: stopped after 2 stages and resumed, sharded,
    it ends where the uninterrupted sharded run does (betas rtol 1e-6, log Z
    rtol and atol 1e-5, particles rtol and atol 1e-6); the checkpoint
    (the global population) resumes unsharded to the same result."""
    sh = _task(2, "smc_resume", tmp_path)
    full, part, rest = sh["full"], sh["part"], sh["rest"]
    assert full["n_stages"] >= 3 and part["betas"][-1] < 1.0
    un = run_smc(GaussToy([1.0, -1.0], 0.5), torch.Generator().manual_seed(3),
                 n_particles=512, n_mutation_steps=3, step_size=0.5,
                 ess_threshold=0.9,
                 resume=str(tmp_path / "smc_resume.pt"))
    print(f"smc resume on 2 ranks: max |dparticle| "
          f"{_gap(rest['params'], full['params']):.3e}, resumed unsharded "
          f"{_gap(un.state.params, full['params']):.3e}")
    for r in (rest, {"n_stages": un.n_stages, "betas": un.betas,
                     "log_evidence": un.log_evidence,
                     "params": un.state.params}):
        assert r["n_stages"] == full["n_stages"]
        np.testing.assert_allclose(r["betas"], full["betas"], rtol=1e-6)
        np.testing.assert_allclose(r["log_evidence"], full["log_evidence"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["params"].numpy(),
                                   full["params"].numpy(), rtol=1e-6,
                                   atol=1e-6)


# --- the grid-sharded solve and the reshard --------------------------------

def _smooth(rng, shape, amp=0.25, coarse=4):
    c = rng.standard_normal((coarse,) * len(shape))
    up = scipy.ndimage.zoom(c, [n / coarse for n in shape], order=1)
    return np.exp(amp * up).astype(np.float32)


CASES = [((24, 17), [4.0, 8.0]), ((16, 11, 9), [3.0, 5.0, 4.0])]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_solve_matches_jax(n, tmp_path):
    """tests/test_dist_sweep.py's cases (24x17 and 16x11x9, tol 1e-6,
    max_iters 200) over n ranks against JAX's solve_eikonal_sharded on n
    virtual CPU devices and JAX's unsharded solve (atol 2e-3)."""
    rng = np.random.default_rng(8)
    cases = [{"slowness": _smooth(rng, shape), "src": src,
              "spacing": [1.0] * len(shape), "tol": 1e-6, "max_iters": 200}
             for shape, src in CASES]
    got = _task(n, "solve", tmp_path, {"cases": cases})["T"]
    jcfg = JEikonalConfig(method="sweep", tol=1e-6, max_iters=200,
                          use_pallas="off")
    mesh = j_chain_mesh(n_devices=n, axis="grid")
    for case, T in zip(cases, got):
        shape = case["slowness"].shape
        jgrid = JGrid(shape=shape, spacing=tuple(case["spacing"]))
        s = jnp.asarray(case["slowness"])
        src = jnp.asarray(case["src"], jnp.float32)
        T_jsh = np.asarray(j_sharded(s, src, jgrid, mesh, "grid", jcfg))
        T_ref = np.asarray(j_solve(s, src, jgrid, jcfg))
        print(f"sharded solve {shape} over {n} ranks: max |port - JAX "
              f"sharded| {_gap(T, T_jsh):.3e}, |port - JAX unsharded| "
              f"{_gap(T, T_ref):.3e}")
        np.testing.assert_allclose(T.numpy(), T_jsh, atol=2e-3)
        np.testing.assert_allclose(T.numpy(), T_ref, atol=2e-3)


def test_reshard_matches_jax_predict_events(tmp_path):
    """tests/test_dist_sweep.py's reshard case (16x12x9, 8 stations, 5
    events) over 4 ranks: JAX's tables, grid-sharded, resharded to stations
    equal the tables (atol 1e-6) and the predicted arrivals equal JAX's
    predict_events (atol 1e-5)."""
    rng = np.random.default_rng(3)
    shape = (16, 12, 9)
    jgrid = JGrid(shape=shape, spacing=(1.0, 1.0, 1.0))
    hi = np.array([15.0, 11.0, 8.0], np.float32)
    sta = (rng.uniform(size=(8, 3)) * hi).astype(np.float32)
    ev = (rng.uniform(size=(5, 3)) * hi).astype(np.float32)
    t0 = (0.1 * rng.standard_normal(5)).astype(np.float32)
    cfg = JEikonalConfig(method="sweep", tol=1e-5, max_iters=100,
                         use_pallas="off")
    tables = np.asarray(j_tables(jnp.asarray(_smooth(rng, shape)),
                                 jnp.asarray(sta), jgrid, cfg))
    t_ref = np.asarray(j_predict_events(jnp.asarray(tables), jnp.asarray(ev),
                                        jnp.asarray(t0), jgrid))
    got = _task(4, "reshard", tmp_path,
                {"tables": tables, "spacing": [1.0, 1.0, 1.0], "events": ev,
                 "t0": t0})
    print(f"reshard over 4 ranks: max |dtables| "
          f"{_gap(got['tables'], tables):.3e}, max |dt| "
          f"{_gap(got['t'], t_ref):.3e}")
    np.testing.assert_allclose(got["tables"].numpy(), tables, atol=1e-6)
    np.testing.assert_allclose(got["t"].numpy(), t_ref, atol=1e-5)


def test_dryrun_on_two_ranks():
    """The port's dryrun (legs A-E) on 2 gloo CPU ranks passes."""
    text = _torchrun(2, "-m", "mceik_tpu_torch.dist.dryrun", "--device",
                     "cpu")
    line = [x for x in text.splitlines() if x.startswith("dryrun over")]
    print(line)
    assert line and "ALL OK" in line[0]


# --- refusals ----------------------------------------------------------------

def test_refusals():
    """Axis 0 or stations that do not divide over the ranks, particles that
    do not divide, and NCCL asked for with ranks sharing a card are
    refused (before any collective); the backend rule picks NCCL only
    when every rank has a card of its own."""
    mesh = Mesh(world=2, rank=0, backend="gloo")
    grid = Grid(shape=(5, 4), spacing=(1.0, 1.0))
    with pytest.raises(ValueError, match=r"axis 0 \(5\) must divide over 2"):
        solve_eikonal_sharded(torch.ones(grid.shape), torch.zeros(2), grid,
                              mesh)
    with pytest.raises(ValueError, match=r"n_stations \(3\) must divide"):
        reshard_tables_to_stations(torch.zeros((3, 4, 4)), mesh)
    with pytest.raises(ValueError, match="n_particles=63 not divisible"):
        run_smc(GaussToy([1.0, -1.0], 0.5), torch.Generator(), 63, mesh=mesh)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one"):
        pick_backend("cuda", 2, 1, "nccl")
    with pytest.raises(ValueError, match="needs CUDA"):
        pick_backend("cpu", 2, 0, "nccl")
    assert pick_backend("cuda", 2, 1) == "gloo"
    assert pick_backend("cuda", 4, 4) == "nccl"
    assert pick_backend("cpu", 4, 0) == "gloo"
    assert pick_backend("cuda", 2, 1, "gloo") == "gloo"
