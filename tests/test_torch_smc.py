"""Parity of the PyTorch port's 2-D slice with the JAX package on the CPU:
the crosswell data and the 2-D tomo posterior, exact prior draws, random-
walk Metropolis (steps with JAX's draws replayed and a Gaussian target),
systematic resampling and the tempering ladder, SMC mutation with JAX's
draws replayed (a conjugate toy and the 2-D tomo posterior), SMC's moments
and evidence on the conjugate toy, and configs 1 and 4 through the CLI.
State crosses over through ``mceik_tpu_torch.convert``; inputs are made
with numpy from a seed."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import synthetic as jsyn
from mceik_tpu.dist import resample as jres
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.forward.predict import predict_tomo as j_predict_tomo
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior
from mceik_tpu.samplers import rwm as jrwm
from mceik_tpu.samplers import smc as jsmc
from mceik_tpu.samplers.base import MHState as JMHState

from mceik_tpu_torch import cli
from mceik_tpu_torch.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import (params_from_jax, rwm_hyper_from_jax,
                                     smc_state_from_jax, tomo_data_from_jax)
from mceik_tpu_torch.datasets import synthetic as tsyn
from mceik_tpu_torch.diag.ess import split_rhat
from mceik_tpu_torch.diag.moments import welford_finalize, welford_merge_chains
from mceik_tpu_torch.dist import resample as tres
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward.predict import predict_tomo
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.config_io import apply_overrides, load_config
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import rwm, smc
from mceik_tpu_torch.samplers.base import MHState, init_chain_states, run_mcmc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (24, 24)
INV = (6, 6)
N_CHAINS = 4
DKW = dict(dataset="crosswell2d", n_src=8, n_rec=12, noise=0.01,
           checker_cells=(3, 3), checker_amplitude=0.1)
MKW = dict(mode="tomo", inv_shape=INV, prior_sigma_u=0.2, sigma=0.01)
EKW = dict(tol=1e-5, max_iters=60)


@pytest.fixture(scope="module")
def models():
    """A config-1-like crosswell problem cut to 24^2 with a 6^2 basis, in
    both packages, on JAX's data."""
    jgrid = JGrid(SHAPE, (1.0, 1.0))
    jdata, _ = jsyn.crosswell_dataset(jgrid, JDataCfg(**DKW), JModelCfg(**MKW))
    jpost = j_build_posterior(JModelCfg(**MKW), jdata, jgrid, JEikonalCfg(**EKW))
    tpost = build_posterior(ModelCfg(**MKW), tomo_data_from_jax(jdata),
                            Grid(SHAPE, (1.0, 1.0)), EikonalCfg(**EKW))
    return jpost, tpost, jax.jit(jax.vmap(jpost.logpost))


def _u(seed, n=N_CHAINS, scale=0.05):
    return np.random.default_rng(seed).normal(
        0, scale, (n,) + INV).astype(np.float32)


# --- data and posterior -------------------------------------------------

@pytest.mark.parametrize("shape,spacing", [((65, 65), (1.0, 1.0)),
                                           ((30, 20), (1.5, 0.75))])
def test_crosswell_geometry_matches_jax(shape, spacing):
    jsrc, jrec = jsyn.crosswell_geometry(JGrid(shape, spacing), 8, 12)
    src, rec = tsyn.crosswell_geometry(Grid(shape, spacing), 8, 12)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))


def test_crosswell_clean_arrivals_match_jax():
    """The 2-D checkerboard truth at rtol 1e-6 and the noise-free arrivals
    through it at atol 1e-4 (solver tol 1e-5), on config 1's 65^2 grid."""
    shape = (65, 65)
    jg, g = JGrid(shape, (1.0, 1.0)), Grid(shape, (1.0, 1.0))
    js = jsyn.checkerboard_slowness(jg, (3, 3), 0.1)
    s = tsyn.checkerboard_slowness(g, (3, 3), 0.1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    jsrc, jrec = jsyn.crosswell_geometry(jg, 8, 12)
    src, rec = tsyn.crosswell_geometry(g, 8, 12)
    ref = np.asarray(j_predict_tomo(js, jsrc, jrec, jg,
                                    JEikonalConfig(tol=1e-5, max_iters=100)))
    out = predict_tomo(s, src, rec, g, EikonalConfig(tol=1e-5, max_iters=100))
    assert out.shape == (8, 12)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_logpost_2d_matches_jax_per_chain(models):
    """One batched call over 4 chains against JAX's logpost per chain at
    rtol 2e-5 (the bar of the 3-D posterior test: XLA contracts FMAs in its
    sweep and torch does not), log prior at rtol 1e-6."""
    jpost, tpost, jlp = models
    u = _u(0)
    ref = np.asarray(jlp(JParams(u=jnp.asarray(u))))
    out = tpost.logpost(Params(u=torch.from_numpy(u)))
    assert out.shape == (N_CHAINS,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5)
    ref_prior = np.asarray(jax.vmap(jpost.log_prior)(JParams(u=jnp.asarray(u))))
    np.testing.assert_allclose(
        tpost.log_prior(Params(u=torch.from_numpy(u))).numpy(), ref_prior,
        rtol=1e-6)


def test_sample_prior_moments(models):
    """4,000 exact prior draws of the 6^2 basis: mean 0 within 5 standard
    errors, std prior_sigma_u within 5 standard errors (144,000 values)."""
    _, tpost, _ = models
    u = tpost.sample_prior(torch.Generator().manual_seed(3), 4000).u
    assert u.shape == (4000,) + INV
    n, sd = u.numel(), MKW["prior_sigma_u"]
    assert abs(float(u.mean())) < 5 * sd / np.sqrt(n)
    assert abs(float(u.std()) - sd) < 5 * sd / np.sqrt(2 * n)


# --- random-walk Metropolis ----------------------------------------------

def test_rwm_steps_replay_jax_draws(models):
    """Four RWM warmup steps (kernel + Robbins-Monro adapter) with JAX's
    draws replayed: k_prop, k_acc = split(key) per chain as rwm.py draws
    them. Accept decisions equal, params at atol 1e-6, logpost at rtol
    2e-5, log_step after each update at atol 1e-6."""
    jpost, tpost, jlp = models
    jhyper = jrwm.init_hyper(jpost.prior_scales, 0.02)
    thyper = rwm_hyper_from_jax(jhyper)
    u0 = _u(1, scale=0.02)
    jstate = JMHState(params=JParams(u=jnp.asarray(u0)),
                      logpost=jlp(JParams(u=jnp.asarray(u0))))
    tstate = MHState(params=params_from_jax(jstate.params),
                     logpost=torch.from_numpy(np.asarray(jstate.logpost)))
    jkernel = jax.jit(jax.vmap(jrwm.make_kernel(jpost.logpost),
                               in_axes=(0, 0, None)))
    jadapt, tadapt = jrwm.make_adapter(), rwm.make_adapter()
    tkernel = rwm.make_kernel(tpost.logpost)
    decisions = []
    for t in range(4):
        keys = jax.random.split(jax.random.PRNGKey(300 + t), N_CHAINS)
        eps, unif = [], []
        for k in keys:
            k_prop, k_acc = jax.random.split(k)
            eps.append(np.asarray(jax.random.normal(
                jax.random.split(k_prop, 1)[0], INV, jnp.float32)))
            unif.append(float(jax.random.uniform(k_acc)))
        jstate, jinfo = jkernel(keys, jstate, jhyper)
        tstate, tinfo = tkernel(tstate, thyper,
                                Params(u=torch.from_numpy(np.stack(eps))),
                                torch.tensor(unif, dtype=torch.float32))
        acc = np.asarray(jinfo["accepted"])
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), acc)
        np.testing.assert_allclose(tstate.params.u.numpy(),
                                   np.asarray(jstate.params.u), atol=1e-6)
        np.testing.assert_allclose(tstate.logpost.numpy(),
                                   np.asarray(jstate.logpost), rtol=2e-5)
        decisions.extend(acc.tolist())
        jhyper = jadapt(jhyper, jax.tree.map(lambda x: jnp.mean(x, 0), jinfo),
                        jstate, jnp.int32(t))
        thyper = tadapt(thyper, {k: v.mean(0) for k, v in tinfo.items()},
                        tstate, t)
        np.testing.assert_allclose(thyper.log_step.numpy(),
                                   np.asarray(jhyper.log_step), rtol=0,
                                   atol=1e-6)
    assert 0 < sum(decisions) < len(decisions), decisions


COV = np.array([[1.0, 0.6], [0.6, 4.0]])
MEAN = np.array([1.0, -2.0])


def test_rwm_gaussian():
    """The port of tests/test_samplers.py::test_rwm_gaussian at its bars:
    8 chains on a correlated 2-D Gaussian, 500 warmup and 4000 steps;
    pooled mean within 0.25, variances within 35%, acceptance in (0.1,
    0.5), split R-hat < 1.2."""
    prec = torch.tensor(np.linalg.inv(COV), dtype=torch.float32)
    mean = torch.tensor(MEAN, dtype=torch.float32)

    def logpost(x):
        d = x - mean
        return -0.5 * ((d @ prec) * d).sum(1)

    gen = torch.Generator().manual_seed(0)
    states = init_chain_states(
        logpost, lambda g, n: torch.randn((n, 2), generator=g), gen, 8)
    result = run_mcmc(rwm.make_kernel(logpost), rwm.make_adapter(), states,
                      rwm.init_hyper(torch.ones(2), 0.5), gen, n_warmup=500,
                      n_steps=4000)
    m, v = welford_finalize(welford_merge_chains(result.welford))
    np.testing.assert_allclose(m.numpy(), MEAN, atol=0.25)
    np.testing.assert_allclose(v.numpy(), np.diag(COV), rtol=0.35)
    acc = float(result.accept_trace.mean())
    assert 0.1 < acc < 0.5, acc
    assert split_rhat(result.samples.numpy()).max() < 1.2


# --- resampling and the ladder --------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 30.0, 1e3])
def test_systematic_indices_match_jax(scale):
    """Log-weights spread over ``scale`` nats (1e3: a few particles hold
    all the weight), one shared uniform: the indices are identical, and the
    Kish ESS agrees at rtol 1e-5."""
    rng = np.random.default_rng(int(scale))
    lw = (scale * rng.standard_normal(512)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jres.systematic_indices(key, jnp.asarray(lw)))
    u = torch.tensor(float(jax.random.uniform(key)), dtype=torch.float32)
    out = tres.systematic_indices(torch.from_numpy(lw), u)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_allclose(
        float(tres.ess_from_log_weights(torch.from_numpy(lw))),
        float(jres.ess_from_log_weights(jnp.asarray(lw))), rtol=1e-5)
    tree = {"a": torch.arange(512.0), "b": torch.ones(512, 3)}
    picked = tres.resample_tree(tree, out)
    np.testing.assert_array_equal(picked["a"].numpy(), ref.astype(np.float32))
    assert picked["b"].shape == (512, 3)


@pytest.mark.parametrize("beta_prev", [0.0, 0.3])
def test_next_beta_matches_jax(beta_prev):
    """One log-likelihood vector (N = 512, spread like a tomo population
    early in the ladder): the bisected beta agrees with JAX's to 1e-6
    (both take the increment in fp32 and bisect in double), and the ESS
    there to rtol 1e-5."""
    rng = np.random.default_rng(7)
    ll = (-2e4 + 3e3 * rng.standard_normal(512)).astype(np.float32)
    target = 0.5 * 512
    ref = jsmc.next_beta(jnp.asarray(ll), beta_prev, target)
    out = smc.next_beta(torch.from_numpy(ll), beta_prev, target)
    assert beta_prev < out < 1.0
    assert abs(out - ref) <= 1e-6, (out, ref)
    np.testing.assert_allclose(
        smc.ess_at(torch.from_numpy(ll), beta_prev, out),
        float(jsmc._ess_at(jnp.asarray(ll), beta_prev, ref)), rtol=1e-5)


# --- SMC --------------------------------------------------------------------

SIGMA = 0.5
OBS = np.array([1.0, -1.0])


class JToy:
    """tests/test_smc.py's conjugate Gaussian target, in JAX."""

    def log_prior(self, x):
        return -0.5 * jnp.sum(x * x)

    def log_lik(self, x):
        return -0.5 * jnp.sum((jnp.asarray(OBS, jnp.float32) - x) ** 2) / SIGMA ** 2

    def sample_prior(self, key):
        return jax.random.normal(key, (2,), jnp.float32)

    @property
    def prior_scales(self):
        return jnp.ones(2, jnp.float32)


class TToy:
    """The same target for the port: particle-batched functions."""

    prior_scales = torch.ones(2)

    def log_prior(self, x):
        return -0.5 * (x * x).sum(1)

    def log_lik(self, x):
        obs = torch.tensor(OBS, dtype=torch.float32)
        return -0.5 * ((obs - x) ** 2).sum(1) / SIGMA ** 2

    def sample_prior(self, gen, n):
        return torch.randn((n, 2), generator=gen)


def _jax_mutation_draws(key, n, n_steps, shape):
    """JAX's draws inside ``_mutate_impl``: one key per step; k1, k2 =
    split(key); per particle a normal from split(k1, n), through
    tree_random_normal's split of one leaf; n uniforms from k2."""
    normals, uniforms = [], []
    for k in jax.random.split(key, n_steps):
        k1, k2 = jax.random.split(k)
        eps = jax.vmap(lambda kk: jax.random.normal(
            jax.random.split(kk, 1)[0], shape, jnp.float32))(
                jax.random.split(k1, n))
        normals.append(np.asarray(eps))
        uniforms.append(np.asarray(jax.random.uniform(k2, (n,))))
    return normals, np.stack(uniforms)


def test_mutate_replays_jax_draws_on_conjugate_toy():
    """One mutation stage (5 tempered RWM steps over 256 particles at beta
    0.4) with JAX's draws replayed, from JAX's initial particles: the same
    particles move (equal decisions), params at atol 1e-6, log_step and the
    mean pooled acceptance at atol 1e-6."""
    jpost, tpost = JToy(), TToy()
    jstate = jsmc.init_particles(jpost, jax.random.PRNGKey(1), 256, 0.5)
    key = jax.random.PRNGKey(2)
    jnew, jacc = jsmc._mutate(jstate, 0.4, key, jpost.prior_scales,
                              log_prior_fn=jpost.log_prior,
                              log_lik_fn=jpost.log_lik, n_steps=5)
    normals, uniforms = _jax_mutation_draws(key, 256, 5, (2,))
    tstate = smc_state_from_jax(jstate)
    tnew, tacc = smc.mutate(tstate, 0.4, tpost.prior_scales, tpost.log_prior,
                            tpost.log_lik, [torch.from_numpy(e) for e in normals],
                            torch.from_numpy(uniforms))
    moved_j = np.any(np.asarray(jnew.params) != np.asarray(jstate.params), 1)
    moved_t = (tnew.params != tstate.params).any(1).numpy()
    np.testing.assert_array_equal(moved_t, moved_j)
    assert 0 < moved_j.sum() < 256
    np.testing.assert_allclose(tnew.params.numpy(), np.asarray(jnew.params),
                               atol=1e-6)
    np.testing.assert_allclose(tnew.log_lik.numpy(), np.asarray(jnew.log_lik),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tnew.log_step), float(jnew.log_step),
                               atol=1e-6)
    np.testing.assert_allclose(float(tacc), float(jacc), atol=1e-6)


def test_mutate_replays_jax_draws_on_tomo_posterior(models):
    """One mutation stage (2 steps over 6 prior particles) on the 2-D tomo
    posterior at beta 1e-4 (an early rung of config 4's ladder), JAX's
    particles and draws replayed: equal decisions, params at atol 1e-6,
    log likelihoods at rtol 2e-5 (the logpost bar). The pooled acceptance
    and so log_step move by beta times the log-likelihood gap: within
    0.3 * 2 * 1e-4 * 2e-5 * max|log_lik| of JAX's."""
    jpost, tpost, _ = models
    jstate = jsmc.init_particles(jpost, jax.random.PRNGKey(4), 6, 0.1)
    key, beta = jax.random.PRNGKey(6), 1e-4
    jnew, jacc = jsmc._mutate(jstate, beta, key, jpost.prior_scales,
                              log_prior_fn=jpost.log_prior,
                              log_lik_fn=jpost.log_lik, n_steps=2)
    normals, uniforms = _jax_mutation_draws(key, 6, 2, INV)
    tstate = smc_state_from_jax(jstate)
    np.testing.assert_allclose(
        tpost.log_lik(tstate.params).numpy(), np.asarray(jstate.log_lik),
        rtol=2e-5)
    tnew, tacc = smc.mutate(tstate, beta, tpost.prior_scales, tpost.log_prior,
                            tpost.log_lik,
                            [Params(u=torch.from_numpy(e)) for e in normals],
                            torch.from_numpy(uniforms))
    moved_j = np.any(np.asarray(jnew.params.u != jstate.params.u)
                     .reshape(6, -1), 1)
    moved_t = (tnew.params.u != tstate.params.u).reshape(6, -1).any(1).numpy()
    np.testing.assert_array_equal(moved_t, moved_j)
    assert 0 < moved_j.sum() < 6
    np.testing.assert_allclose(tnew.params.u.numpy(),
                               np.asarray(jnew.params.u), atol=1e-6)
    np.testing.assert_allclose(tnew.log_lik.numpy(), np.asarray(jnew.log_lik),
                               rtol=2e-5)
    bar = 0.3 * 2 * beta * 2e-5 * float(np.abs(np.asarray(jnew.log_lik)).max())
    assert abs(float(tnew.log_step) - float(jnew.log_step)) <= bar + 1e-6
    assert abs(float(tacc) - float(jacc)) <= bar / 0.3 + 1e-6


def test_smc_gaussian_moments_and_evidence():
    """The port of tests/test_smc.py at its own bars: 2048 particles on the
    conjugate toy; posterior mean within 0.08, variance within 25%, log Z
    within 0.15 of the closed form, beta reaching 1 after at least two
    stages, every stage's acceptance above 0.1."""
    gen = torch.Generator().manual_seed(0)
    result = smc.run_smc(TToy(), gen, n_particles=2048, n_mutation_steps=5,
                         ess_threshold=0.5, step_size=0.5)
    x = result.state.params.numpy()
    prec = 1.0 + 1.0 / SIGMA ** 2
    np.testing.assert_allclose(x.mean(0), (1.0 / SIGMA ** 2) / prec * OBS,
                               atol=0.08)
    np.testing.assert_allclose(x.var(0), 1.0 / prec, rtol=0.25)
    var_ev = 1.0 + SIGMA ** 2
    log_z_true = float(np.sum(-0.5 * np.log(2 * np.pi * var_ev)
                              - 0.5 * OBS ** 2 / var_ev))
    log_norm = float(2 * (-0.5 * np.log(2 * np.pi * SIGMA ** 2)))
    assert abs(result.log_evidence - (log_z_true - log_norm)) < 0.15
    assert result.betas[-1] == 1.0
    assert result.n_stages >= 2
    assert min(result.accept_history) > 0.1
    assert len(result.stage_seconds) == result.n_stages
    with pytest.raises(NotImplementedError, match="mesh is not ported yet"):
        smc.run_smc(TToy(), gen, 64, mesh=object())
    with pytest.raises(NotImplementedError, match="profil.*not ported"):
        smc.run_smc_config(apply_overrides(load_config(os.path.join(
            REPO, "configs", "c4_smc.json")), ["io.profile_dir=prof"]),
            device="cpu")


# --- configs 1 and 4 through the CLI ---------------------------------------

SMALL = ["grid.shape=[16,16]", "model.inv_shape=[4,4]"]


def test_cli_runs_small_c1_rwm_on_cpu(capsys):
    """configs/c1_crosswell.json cut to 16^2 and a 4^2 basis (4 chains,
    8 sources, 12 receivers kept), short depth: init and sample records,
    finite and rising logposts, an rwm summary line."""
    argv = ["run", os.path.join(REPO, "configs", "c1_crosswell.json"), *SMALL,
            "sampler.n_warmup=20", "sampler.n_samples=40", "sampler.thin=2",
            "io.log_every=20", "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(x.split("] ", 1)[1]) for x in lines
            if x.startswith("[mceik] ")]
    assert [r["phase"] for r in recs] == ["init", "sample", "sample"]
    assert all(np.isfinite(r[k]) for r in recs
               for k in ("logpost_mean", "logpost_min", "logpost_max"))
    assert recs[-1]["logpost_mean"] > recs[0]["logpost_mean"]
    assert any(x.startswith("[mceik-tpu-torch] rwm chains=4") for x in lines)


def test_cli_runs_small_c4_smc_on_cpu(capsys):
    """configs/c4_smc.json cut to 16^2, a 4^2 basis, 64 particles and 2
    mutation steps, with sigma 0.2 so the ladder is short: the reference's
    [smc] stage lines, beta rising to 1, finite log Z. api.run refuses smc
    (its entry point is run_smc_config)."""
    c4 = os.path.join(REPO, "configs", "c4_smc.json")
    argv = ["run", c4, *SMALL, "sampler.n_particles=64",
            "sampler.n_mutation_steps=2", "model.sigma=0.2", "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    stages = [dict(kv.split("=") for kv in x.split()[1:])
              for x in lines if x.startswith("[smc] stage=")]
    betas = [float(st["beta"]) for st in stages]
    assert len(stages) >= 2 and betas[-1] == 1.0
    assert all(b1 > b0 for b0, b1 in zip(betas, betas[1:]))
    assert all(np.isfinite(float(st["logZ"])) and 0 <= float(st["accept"]) <= 1
               for st in stages)
    done = [x for x in lines if x.startswith("[smc] done:")]
    assert len(done) == 1 and f"stages={len(stages)}" in done[0]
    from mceik_tpu_torch.api import run
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config
    with pytest.raises(ValueError, match="run_smc_config"):
        run(apply_overrides(load_config(c4), SMALL), device="cpu")
