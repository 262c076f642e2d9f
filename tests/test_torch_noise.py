"""Parity of the PyTorch port's noise models with the JAX package on the
CPU (config 5's spike-slab noise, and the hierarchical model): the log
prior, log likelihood and logpost per chain under each model, the
heteroscedastic t0 marginalization, the Gibbs scan over the station
indicators replayed with JAX's own draws, the joint spike-slab gradient
against ``jax.grad``, the reference's refusals, the noisy-station recovery
of tests/test_spike_slab.py on the port, and config 5 through the port's
CLI at a reduced scale with ``dist.multihost`` left on. Inputs are made
with numpy from seeds; data and params cross over with ``convert``."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import \
    _marginalized_t0_loglik as j_marginalized_t0_loglik
from mceik_tpu.model.posterior import build_posterior as j_build_posterior
from mceik_tpu.samplers import smc as jsmc

from mceik_tpu_torch import api, cli
from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import (event_data_from_jax, params_from_jax,
                                     smc_state_from_jax, tomo_data_from_jax)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.config_io import apply_overrides, load_config
from mceik_tpu_torch.model.posterior import (_marginalized_t0_loglik,
                                             build_posterior, value_and_grad)
from mceik_tpu_torch.samplers import hmc, nuts, smc
from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc
from mceik_tpu_torch.utils import tree_leaves


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
C5 = os.path.join(REPO, "configs", "c5_pod_nuts.json")

# tests/test_spike_slab.py's problem: a 17^2 crosswell, 24 sources, 10
# receivers, homogeneous truth, three stations' noise inflated 12x.
SHAPE2 = (17, 17)
NOISY = (2, 5, 7)
SIGMA = 0.005
INFLATE = 12.0
EKW2 = dict(method="sweep", tol=1e-4, max_iters=50, use_pallas="off")
# A tiny joint problem: 8x8x6 grid, 2x2x2 basis, 2 events, 3 stations.
SHAPE3 = (8, 8, 6)
EKW3 = dict(method="sweep", tol=1e-5, max_iters=60, use_pallas="off")
C = 3


def _mkw2(noise_model, **kw):
    return dict(mode="tomo", inv_shape=(4, 4), prior_sigma_u=0.15,
                sigma=SIGMA, noise_model=noise_model, noise_p0=0.15,
                sigma_hyper=1.5, **kw)


@functools.lru_cache(maxsize=None)
def _corrupted_tomo():
    """JAX's noiseless crosswell arrivals, each station's noise column
    scaled to an exact RMS (12x on the noisy stations), as the reference
    test makes them; returned as numpy."""
    grid = JGrid(SHAPE2, (1.0, 1.0))
    dcfg = JDataCfg(dataset="crosswell2d", n_src=24, n_rec=10, noise=0.0,
                    seed=21, checker_cells=(2, 2), checker_amplitude=0.0)
    data, _ = j_make_dataset(grid, dcfg, JModelCfg(**_mkw2("spike_slab")),
                             JEikonalConfig(**EKW2))
    rng = np.random.default_rng(99)
    t_obs = np.asarray(data.t_obs).copy()
    for j in range(t_obs.shape[1]):
        eps = rng.standard_normal(t_obs.shape[0])
        eps *= 1.0 / np.sqrt((eps ** 2).mean())
        t_obs[:, j] += (INFLATE if j in NOISY else 1.0) * SIGMA * eps
    return data.replace(t_obs=jnp.asarray(t_obs))


def _tomo_posteriors(noise_model, differentiable=False, **kw):
    jdata = _corrupted_tomo()
    jpost = j_build_posterior(JModelCfg(**_mkw2(noise_model, **kw)), jdata,
                              JGrid(SHAPE2, (1.0, 1.0)),
                              JEikonalCfg(**EKW2), differentiable=differentiable)
    tpost = build_posterior(ModelCfg(**_mkw2(noise_model, **kw)),
                            tomo_data_from_jax(jdata), Grid(SHAPE2, (1.0, 1.0)),
                            EikonalCfg(**EKW2), differentiable=differentiable)
    return jpost, tpost


def _mkw3(noise_model, marginalize):
    return dict(mode="joint", inv_shape=(2, 2, 2), prior_sigma_u=0.1,
                sigma=0.02, noise_model=noise_model, noise_p0=0.2,
                noise_slab_mu=1.0, sigma_hyper=0.8,
                marginalize_t0=marginalize)


def _joint_posteriors(noise_model, marginalize, differentiable=False):
    grid = JGrid(SHAPE3, (1.0,) * 3)
    dcfg = JDataCfg(dataset="events3d", n_events=2, n_stations=3, noise=0.02,
                    seed=5, checker_cells=(2, 2, 2), checker_amplitude=0.05)
    jdata = j_make_dataset(grid, dcfg, JModelCfg())[0]
    mk = _mkw3(noise_model, marginalize)
    jpost = j_build_posterior(JModelCfg(**mk), jdata, grid,
                              JEikonalCfg(**EKW3), differentiable=differentiable)
    tpost = build_posterior(ModelCfg(**mk), event_data_from_jax(jdata),
                            Grid(SHAPE3, (1.0,) * 3), EikonalCfg(**EKW3),
                            differentiable=differentiable)
    return jpost, tpost


def _random_params(post, seed, n=C):
    """Chain-batched JAX params shaped like the model's, with u near the
    prior's scale, hypocentres inside the box, log_sigma around its prior
    and indicators half on, half off."""
    rng = np.random.default_rng(seed)
    ex = post.init_params(jax.random.PRNGKey(0))

    def draw(field, fn):
        x = getattr(ex, field)
        return None if x is None else jnp.asarray(
            fn((n,) + x.shape).astype(np.float32))

    mu = post.cfg.noise_slab_mu if post.cfg.noise_model == "spike_slab" else 0.0
    return JParams(
        u=draw("u", lambda s: 0.5 * post.cfg.prior_sigma_u
               * rng.standard_normal(s)),
        hypo_raw=draw("hypo_raw", lambda s: 0.8 * rng.standard_normal(s)),
        t0=draw("t0", lambda s: 0.1 * rng.standard_normal(s)),
        log_sigma=draw("log_sigma", lambda s: mu + 0.7 * rng.standard_normal(s)),
        noise_z=draw("noise_z", lambda s: (rng.random(s) < 0.5) * 1.0))


def _densities_match(jpost, tpost, jp):
    tp = params_from_jax(jp)
    for name in ("log_prior", "log_lik", "logpost"):
        want = np.asarray(jax.jit(jax.vmap(getattr(jpost, name)))(jp))
        got = getattr(tpost, name)(tp).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("noise_model,kw", [
    ("hierarchical", {}),                           # one log_sigma per chain
    ("hierarchical", {"per_station_noise": True}),  # one per station
    ("spike_slab", {}),
])
def test_tomo_noise_densities_match_jax(noise_model, kw):
    """log_prior, log_lik and logpost of three chains under each noise
    model, against JAX at rtol 2e-5; and the noise leaves' shapes, init
    (spike-slab chains start all-active) and prior scales (the indicators'
    0 freezes them)."""
    jpost, tpost = _tomo_posteriors(noise_model, **kw)
    _densities_match(jpost, tpost, _random_params(jpost, 3))
    p = tpost.init_params(torch.Generator().manual_seed(0), 2)
    jex = jpost.init_params(jax.random.PRNGKey(0))
    assert p.log_sigma.shape == (2,) + jex.log_sigma.shape
    assert tpost.n_dim == jpost.n_dim
    np.testing.assert_array_equal(tpost.prior_scales.log_sigma.numpy(),
                                  np.asarray(jpost.prior_scales.log_sigma))
    if noise_model == "spike_slab":
        assert torch.equal(p.noise_z, torch.ones((2, 10)))
        assert float(tpost.prior_scales.noise_z.abs().max()) == 0.0
        draws = tpost.sample_prior(torch.Generator().manual_seed(1), 4000)
        assert abs(float(draws.noise_z.mean()) - 0.15) < 0.01
        assert abs(float(draws.log_sigma.mean()) - 2.0) < 0.02
    else:
        assert p.noise_z is None and tpost.noise_gibbs is None


def test_joint_spike_slab_marginalized_densities_match_jax():
    """Config 5's model (joint, spike-slab) with t0 marginalized, so the
    per-station sigma enters the precision-weighted demeaning: log_prior,
    log_lik and logpost of three chains against JAX at rtol 2e-5."""
    jpost, tpost = _joint_posteriors("spike_slab", True)
    _densities_match(jpost, tpost, _random_params(jpost, 4))


def test_heteroscedastic_t0_marginalization_matches_jax():
    """``_marginalized_t0_loglik`` per chain with per-chain, per-station
    sigma and a mask, against JAX's at rtol 1e-6."""
    rng = np.random.default_rng(0)
    r = rng.standard_normal((C, 4, 6)).astype(np.float32)
    sigma = np.exp(0.5 * rng.standard_normal((C, 1, 6))).astype(np.float32)
    mask = (rng.random((4, 6)) > 0.2).astype(np.float32)
    got = _marginalized_t0_loglik(
        torch.from_numpy(r), torch.from_numpy(np.broadcast_to(sigma, r.shape).copy()),
        torch.from_numpy(np.broadcast_to(mask, r.shape).copy())).numpy()
    want = [float(j_marginalized_t0_loglik(jnp.asarray(r[c]),
                                           jnp.asarray(sigma[c, 0]),
                                           jnp.asarray(mask)))
            for c in range(C)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _jax_gibbs_draws(keys, n_sta):
    """The uniforms and normals JAX's noise_gibbs draws from each chain's
    key: ``split(key)`` into the scan key and the refresh key; per station
    ``k, kj = split(k)`` and ``bernoulli(kj, p)`` is ``uniform(kj) < p``;
    the refresh is ``normal(k_fresh, (n_sta,))``."""
    U, F = [], []
    for key in keys:
        k, k_fresh = jax.random.split(key)
        row = []
        for _ in range(n_sta):
            k, kj = jax.random.split(k)
            row.append(float(jax.random.uniform(kj, (), jnp.float32)))
        U.append(row)
        F.append(np.asarray(jax.random.normal(k_fresh, (n_sta,))))
    return (torch.tensor(U, dtype=torch.float32),
            torch.from_numpy(np.stack(F).astype(np.float32)))


@pytest.mark.parametrize("beta", [1.0, 0.3])
def test_noise_gibbs_replays_jax(beta):
    """The Gibbs scan of 6 chains with JAX's draws re-derived from its key
    tree: equal indicators and refreshed slab values; the returned
    (log_prior, log_lik) equal the posterior's own functions at the result
    (the reference test's bars, rtol 1e-6 and 1e-5) and JAX's (rtol 2e-5).
    Chains start at the truth with random indicators and small slab values
    (inflations e^-0.9 .. e^0.9), where the likelihood ratios are close
    and the prior odds decide many draws."""
    jpost, tpost = _tomo_posteriors("spike_slab")
    n = 6
    jp = _random_params(jpost, 5, n=n)
    ls = 0.3 * np.random.default_rng(7).standard_normal((n, 10))
    jp = jp.replace(u=jnp.zeros_like(jp.u),
                    log_sigma=jnp.asarray(ls.astype(np.float32)))
    keys = jax.random.split(jax.random.PRNGKey(11), n)
    jnew, jlp, jll = jax.jit(jax.vmap(
        lambda k, p: jpost.noise_gibbs(k, p, beta)))(keys, jp)
    U, F = _jax_gibbs_draws(keys, 10)
    new, lp, ll = tpost.noise_gibbs(params_from_jax(jp), U, F, beta)
    np.testing.assert_array_equal(new.noise_z.numpy(), np.asarray(jnew.noise_z))
    # The refresh mu + sigma_hyper * fresh: XLA contracts it into one FMA.
    np.testing.assert_allclose(new.log_sigma.numpy(),
                               np.asarray(jnew.log_sigma), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), tpost.log_prior(new).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(ll.numpy(), tpost.log_lik(new).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=2e-5)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=2e-5)
    z = new.noise_z.numpy()
    assert set(np.unique(z)).issubset({0.0, 1.0})
    # Both values occur, and some indicators changed: the replay exercises
    # decisions, not a foregone conclusion.
    assert 0.0 < z.mean() < 1.0
    assert (z != np.asarray(jp.noise_z)).any()


def test_smc_mutation_with_gibbs_replays_jax():
    """One SMC mutation stage with the tempered Gibbs scan after each RWM
    step (2 steps over 6 prior particles of the spike-slab tomo posterior
    at beta 0.05), JAX's particles and draws replayed (the RWM normals and
    uniforms, and per particle the scan's key from ``fold_in(k2, 1)``):
    equal RWM decisions and indicators, u at atol 1e-6, log likelihoods at
    rtol 2e-5 (the logpost bar)."""
    jpost, tpost = _tomo_posteriors("spike_slab")
    n, n_steps, beta = 6, 2, 0.05
    jstate = jsmc.init_particles(jpost, jax.random.PRNGKey(4), n, 0.1)
    key = jax.random.PRNGKey(6)
    jnew, _ = jsmc._mutate(jstate, beta, key, jpost.prior_scales,
                           log_prior_fn=jpost.log_prior,
                           log_lik_fn=jpost.log_lik, n_steps=n_steps,
                           gibbs_fn=jpost.noise_gibbs)
    ex = jstate.params
    normals, uniforms, gibbs = [], [], []
    for k in jax.random.split(key, n_steps):
        k1, k2 = jax.random.split(k)
        leaves = jax.vmap(lambda kk: [
            jax.random.normal(kl, x.shape[1:], jnp.float32)
            for kl, x in zip(jax.random.split(kk, 3),
                             (ex.u, ex.log_sigma, ex.noise_z))])(
            jax.random.split(k1, n))
        normals.append(params_from_jax(JParams(
            u=leaves[0], log_sigma=leaves[1], noise_z=leaves[2])))
        uniforms.append(np.asarray(jax.random.uniform(k2, (n,))))
        gibbs.append(_jax_gibbs_draws(
            jax.random.split(jax.random.fold_in(k2, 1), n), 10))
    tstate = smc_state_from_jax(jstate)
    tnew, _ = smc.mutate(tstate, beta, tpost.prior_scales, tpost.log_prior,
                         tpost.log_lik, normals,
                         torch.from_numpy(np.stack(uniforms)),
                         gibbs_fn=tpost.noise_gibbs, gibbs_draws=gibbs)
    np.testing.assert_array_equal(tnew.params.noise_z.numpy(),
                                  np.asarray(jnew.params.noise_z))
    assert (np.asarray(jnew.params.noise_z)
            != np.asarray(jstate.params.noise_z)).any()
    np.testing.assert_allclose(tnew.params.u.numpy(),
                               np.asarray(jnew.params.u), atol=1e-6)
    np.testing.assert_allclose(tnew.params.log_sigma.numpy(),
                               np.asarray(jnew.params.log_sigma), atol=1e-5)
    np.testing.assert_allclose(tnew.log_lik.numpy(), np.asarray(jnew.log_lik),
                               rtol=2e-5)


def test_joint_spike_slab_gradient_matches_jax():
    """Config 5's model (joint, spike-slab, t0 sampled) on a tiny grid:
    the gradient of three chains, every leaf (u, hypo_raw, t0, log_sigma,
    noise_z), against ``jax.grad`` through the reference's implicit adjoint
    at 1e-4 relative L2 per leaf, and the logposts at rtol 2e-5."""
    jpost, tpost = _joint_posteriors("spike_slab", False, differentiable=True)
    jp = _random_params(jpost, 6)
    jlp, jg = jax.jit(jax.vmap(jax.value_and_grad(jpost.logpost)))(jp)
    lp, g = value_and_grad(tpost.logpost)(params_from_jax(jp))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=2e-5)
    for f in ("u", "hypo_raw", "t0", "log_sigma", "noise_z"):
        a, b = getattr(g, f).numpy(), np.asarray(getattr(jg, f))
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 1e-4, (f, rel)


def test_continuous_kernels_freeze_indicators():
    """The indicators' prior scale 0 gives them inverse mass 0: one HMC
    step and one NUTS step over the spike-slab posterior move u and
    log_sigma but leave every noise_z as it was, and their logposts are
    the posterior's at the new states."""
    _, post = _tomo_posteriors("spike_slab", differentiable=True)
    gen = torch.Generator().manual_seed(3)
    states = init_chain_states(post.logpost, post.init_params, gen, 3)
    hyper = hmc.init_hyper(post.prior_scales, 0.002, post.prior_scales)
    assert float(hyper.inv_mass.noise_z.abs().max()) == 0.0
    for kernel in (hmc.make_kernel(post.logpost, n_leapfrog=2),
                   nuts.make_kernel(post.logpost, max_tree_depth=2)):
        new, info = kernel(states, hyper, *kernel.draw(gen, states))
        assert torch.equal(new.params.noise_z, states.params.noise_z)
        moved = (new.params.u != states.params.u).flatten(1).any(1)
        assert bool(moved.any())
        assert bool(((new.params.log_sigma != states.params.log_sigma)
                     .any(1) == moved).all())
        np.testing.assert_allclose(new.logpost.numpy(),
                                   post.logpost(new.params).numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("over, match", [
    (["sampler.precondition=whitened"], "whitened"),
    (["sampler.algorithm=hmc", "sampler.precondition=whitened"], "whitened"),
    (["sampler.algorithm=pcn", "sampler.precondition=whitened"], "whitened"),
    (["sampler.algorithm=pcn"], "pcn sampler"),
    (["sampler.algorithm=mala"], "mala sampler"),
], ids=["nuts-whitened", "hmc-whitened", "pcn-whitened", "pcn", "mala"])
def test_spike_slab_refusals_match_reference(over, match, monkeypatch):
    """Config 5 through the CLI with whitened NUTS/HMC/pCN, with pCN and
    with MALA raises the reference's error before any setup: no device,
    no dataset."""
    def no_setup(*args, **kwargs):
        raise AssertionError("setup ran before the refusal")

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(api, "prepare_device", no_setup)
    monkeypatch.setattr(api, "make_dataset", no_setup)
    with pytest.warns(UserWarning, match="one process"), \
            pytest.raises(ValueError, match=match):
        cli.main(["run", C5, *over, "--device", "cpu"])


@pytest.mark.parametrize("algo", ["hmc", "nuts", "rwm", "am", "am_full"])
def test_spike_slab_samplers_pass_the_check(algo):
    """The samplers the reference runs under spike-slab noise pass."""
    api.check_noise_options(apply_overrides(load_config(C5),
                                            [f"sampler.algorithm={algo}"]))


def test_multihost_runs_as_one_process(monkeypatch):
    """``dist.multihost`` (or ``dist.n_devices`` > 1) without a launcher
    warns and runs on one process; under a multi-process launcher the ranks
    shard (``dist.mesh.init_distributed``), with no warning."""
    import warnings

    cfg = load_config(C5)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.warns(UserWarning, match="one process"):
        api.check_run_options(cfg)
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.warns(UserWarning, match="one process"):
        api.check_run_options(cfg)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        api.check_run_options(cfg)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.warns(UserWarning, match="one process"):
        api.check_run_options(apply_overrides(
            cfg, ["dist.n_devices=2", "dist.multihost=false"]))


def test_spike_slab_recovers_noisy_stations():
    """tests/test_spike_slab.py's recovery on the port: HMC over the
    continuous leaves plus the exact Gibbs scan over the indicators, after
    the annealed warmup, flags the three stations with 12x noise
    (posterior inclusion > 0.7) and no clean one (< 0.3), and the active
    slab values estimate the inflation within 60%. The port's chains are
    shorter than the reference's (4 chains, 5 leapfrog steps, 40 warmup and
    60 sampling steps against 10, 300 and 300): its bars hold there."""
    _, post = _tomo_posteriors("spike_slab", differentiable=True)
    gen = torch.Generator().manual_seed(1)
    base = hmc.make_kernel(post.logpost, n_leapfrog=5)
    states = init_chain_states(post.logpost, post.init_params, gen, 4)
    hyper = hmc.init_hyper(post.prior_scales, 0.02, post.prior_scales)
    kernel, states, hyper, n_warm = api.with_noise_gibbs(
        post, base, hmc.make_adapter(), states, hyper, hmc.finalize, gen, 40)
    assert n_warm == 0
    result = run_mcmc(kernel, None, states, hyper, gen, n_warmup=0,
                      n_steps=60)
    z = result.samples.noise_z.numpy()                      # (T, C, S)
    incl = z.mean(axis=(0, 1))
    for j in range(10):
        assert (incl[j] > 0.7) if j in NOISY else (incl[j] < 0.3), (j, incl)
    ls = result.samples.log_sigma.numpy()[:, :, list(NOISY)]
    active = z[:, :, list(NOISY)] > 0
    assert abs(np.exp(ls[active].mean()) - INFLATE) / INFLATE < 0.6
    assert all(torch.isfinite(x).all() for x in tree_leaves(result.states.params))


def test_c5_runs_through_cli_at_reduced_scale(capsys):
    """Config 5 through the port's CLI on the CPU at the reference test's
    reduced scale (12^3 grid, 4^3 basis, 2 events, 4 stations; fewer chains
    and steps), ``dist.multihost: true`` left on: it warns and runs joint
    NUTS with the annealed Gibbs warmup. The records are finite and log the
    pooled inclusion rate of indicators that stay in {0, 1}."""
    import json

    over = ["grid.shape=[12,12,12]", "model.inv_shape=[4,4,4]",
            "sampler.n_chains=4", "sampler.n_warmup=4", "sampler.n_samples=4",
            "sampler.thin=2", "sampler.max_tree_depth=3", "data.n_events=2",
            "data.n_stations=4", "io.log_every=2"]
    cfg = apply_overrides(load_config(C5), over)
    assert cfg.dist.multihost and cfg.model.resolved_noise_model() == "spike_slab"
    with pytest.warns(UserWarning, match="multihost"):
        assert cli.main(["run", C5, *over, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(x.split("] ", 1)[1]) for x in lines
            if x.startswith("[mceik] ")]
    assert [r["phase"] for r in recs] == ["init", "warmup", "sample", "sample"]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("logpost_mean", "logpost_min",
                                               "logpost_max"))
    assert all(0.0 <= r["noise_inclusion"] <= 1.0 for r in recs[1:])
    # The inclusion rate is a mean of indicators in {0, 1} over 4 chains x
    # 4 stations.
    assert all(float(r["noise_inclusion"] * 16).is_integer() for r in recs[1:])
    assert any(x.startswith("[mceik-tpu-torch] nuts chains=4") for x in lines)
