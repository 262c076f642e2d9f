"""Parity of the PyTorch port's HMC, NUTS and pCN with the JAX package on the
CPU, with JAX's draws replayed: each test re-derives the random numbers
JAX's kernels draw from their keys (``split``, ``fold_in(key_d, depth)``,
``fold_in(., i)``) and hands them to the port's kernels as tensors. On a
Gaussian target the decisions (tree depth, divergence, acceptance) are
equal and the states agree at 1e-5; on a small joint posterior the
decisions are equal and the states agree within the logpost-sensitivity
bound of test_torch_samplers.py. Also the HMC warmup adapter (dual
averaging + pooled-Welford diagonal mass, zero-scale rule), finalize, and
pCN / generalized pCN steps with their adapter."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.params import box_logjac as j_box_logjac
from mceik_tpu.model.posterior import build_posterior as j_build_posterior
from mceik_tpu.samplers import hmc as jhmc
from mceik_tpu.samplers import nuts as jnuts
from mceik_tpu.samplers import pcn as jpcn
from mceik_tpu.samplers.base import MHState as JMHState

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import (event_data_from_jax, hmc_hyper_from_jax,
                                     params_from_jax, pcn_hyper_from_jax)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import Params, box_logjac
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import hmc, nuts, pcn
from mceik_tpu_torch.samplers.base import MHState


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = 4
D_GAUSS = 5
PREC = np.diag(np.linspace(1.0, 30.0, D_GAUSS)).astype(np.float32)


def _jlp(x):
    return -0.5 * x @ (jnp.asarray(PREC) @ x)


def _tlp(x):
    return -0.5 * ((x @ torch.from_numpy(PREC)) * x).sum(1)


def _leaf_normals(k_mom, example):
    """jax tree_random_normal: one key per leaf from ``split(k_mom, n)``."""
    leaves, treedef = jax.tree.flatten(example)
    keys = jax.random.split(k_mom, len(leaves))
    return [np.asarray(jax.random.normal(k, l.shape, l.dtype))
            for k, l in zip(keys, leaves)]


def _stack_normals(per_chain, example_t):
    """Per-chain lists of leaf normals -> the port's tree with a chain axis."""
    leaves = [torch.from_numpy(np.stack(x)) for x in zip(*per_chain)]
    if isinstance(example_t, torch.Tensor):
        return leaves[0]
    it = iter(leaves)
    return Params(**{f: (None if getattr(example_t, f) is None else next(it))
                     for f in ("u", "hypo_raw", "t0", "log_sigma", "noise_z")})


def hmc_draws(keys, jparams1, tparams):
    """HMC: ``k_mom, k_acc, k_jit = split(key, 3)`` per chain."""
    nor, acc, jit = [], [], []
    for key in keys:
        k_mom, k_acc, k_jit = jax.random.split(key, 3)
        nor.append(_leaf_normals(k_mom, jparams1))
        acc.append(float(jax.random.uniform(k_acc)))
        jit.append(float(jax.random.uniform(k_jit)))
    return (_stack_normals(nor, tparams), torch.tensor(acc),
            torch.tensor(jit))


def nuts_draws(keys, jparams1, tparams, depth_max):
    """NUTS: ``k_mom, k_loop = split(key)``; per depth ``key_d, key_dir,
    key_acc = split(key, 3)``, a direction bit, an acceptance uniform, and
    per leaf ``uniform(fold_in(fold_in(key_d, depth), i))``."""
    nor, right, acc, leaf = [], [], [], []
    for key in keys:
        k_mom, k = jax.random.split(key)
        nor.append(_leaf_normals(k_mom, jparams1))
        r_, a_, l_ = [], [], []
        for depth in range(depth_max):
            key_d, key_dir, key_acc = jax.random.split(k, 3)
            k = key_d
            r_.append(bool(jax.random.bernoulli(key_dir)))
            a_.append(float(jax.random.uniform(key_acc)))
            sub = jax.random.fold_in(key_d, depth)
            l_.extend(float(jax.random.uniform(jax.random.fold_in(sub, i)))
                      for i in range(2 ** depth))
        right.append(r_), acc.append(a_), leaf.append(l_)
    return (_stack_normals(nor, tparams), torch.tensor(right),
            torch.tensor(acc), torch.tensor(leaf))


def _gauss_start(seed=0):
    x0 = np.random.default_rng(seed).normal(0, 1, (C, D_GAUSS)).astype(np.float32)
    jstate = JMHState(params=jnp.asarray(x0),
                      logpost=jax.vmap(_jlp)(jnp.asarray(x0)))
    tstate = MHState(params=torch.from_numpy(x0),
                     logpost=_tlp(torch.from_numpy(x0)))
    return jstate, tstate


def _check_info(tinfo, jinfo, keys=("accepted", "divergent")):
    for k in keys:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]))


@pytest.mark.parametrize("step", [0.15, 0.45])
def test_hmc_steps_replay_jax_draws_gaussian(step):
    """Four HMC steps of 5 leapfrogs on an anisotropic Gaussian, each chain
    with its own jittered step: accept and divergence flags equal, states
    at 1e-5, accept probabilities at 1e-5. The larger step rejects some
    proposals."""
    jh = jhmc.init_hyper(jnp.ones(D_GAUSS), step, jnp.zeros(D_GAUSS))
    th = hmc_hyper_from_jax(jh)
    jk = jax.jit(jax.vmap(jhmc.make_kernel(_jlp, 5), in_axes=(0, 0, None)))
    tk = hmc.make_kernel(_tlp, 5)
    jstate, tstate = _gauss_start()
    decisions = []
    for t in range(4):
        keys = jax.random.split(jax.random.PRNGKey(10 + t), C)
        jstate, jinfo = jk(keys, jstate, jh)
        tstate, tinfo = tk(tstate, th, *hmc_draws(
            keys, jnp.zeros(D_GAUSS), tstate.params))
        _check_info(tinfo, jinfo)
        np.testing.assert_allclose(tstate.params.numpy(),
                                   np.asarray(jstate.params), atol=1e-5)
        np.testing.assert_allclose(tinfo["accept_prob"].numpy(),
                                   np.asarray(jinfo["accept_prob"]), atol=1e-5)
        decisions.extend(np.asarray(jinfo["accepted"]).tolist())
    if step > 0.3:
        assert 0 < sum(decisions) < len(decisions), decisions


@pytest.mark.parametrize("step", [0.25, 0.6])
def test_nuts_steps_replay_jax_draws_gaussian(step):
    """Six NUTS steps at max tree depth 5 on an anisotropic Gaussian:
    tree depths, divergence and accept flags equal, states at 1e-5, the
    acceptance statistic at 1e-5. At step 0.25 the trees reach several
    depths; at 0.6 some chains diverge and others do not, so the early
    ends of the leaf and depth loops are exercised against the
    reference's full budget."""
    depth = 5
    jh = jhmc.init_hyper(jnp.ones(D_GAUSS), step, jnp.zeros(D_GAUSS))
    th = hmc_hyper_from_jax(jh)
    jk = jax.jit(jax.vmap(jnuts.make_kernel(_jlp, depth), in_axes=(0, 0, None)))
    tk = nuts.make_kernel(_tlp, depth)
    jstate, tstate = _gauss_start(1)
    depths, divs = set(), []
    for t in range(6):
        keys = jax.random.split(jax.random.PRNGKey(20 + t), C)
        jstate, jinfo = jk(keys, jstate, jh)
        tstate, tinfo = tk(tstate, th, *nuts_draws(
            keys, jnp.zeros(D_GAUSS), tstate.params, depth))
        _check_info(tinfo, jinfo, ("accepted", "divergent", "tree_depth"))
        np.testing.assert_allclose(tstate.params.numpy(),
                                   np.asarray(jstate.params), atol=1e-5)
        np.testing.assert_allclose(tstate.logpost.numpy(),
                                   np.asarray(jstate.logpost), rtol=1e-5)
        np.testing.assert_allclose(tinfo["accept_prob"].numpy(),
                                   np.asarray(jinfo["accept_prob"]), atol=1e-5)
        depths.update(np.asarray(jinfo["tree_depth"]).tolist())
        divs.extend(np.asarray(jinfo["divergent"]).tolist())
    if step < 0.5:
        assert len(depths) >= 2, depths
    else:
        assert 0 < sum(divs) < len(divs), divs


def test_hmc_adapter_and_finalize_match_jax():
    """Seven adapter updates (dual averaging at target 0.8, gamma 0.05,
    t0 10, and every chain's position merged into the pooled Welford) with
    the mass engaging once the count passes ``mass_start``; a zero prior
    scale keeps its inverse mass at 0 however its position moves. Tuner
    and inverse mass at rtol 1e-5; finalize switches to the averaged
    step."""
    scales = np.array([1.0, 0.5, 0.0, 2.0, 0.3], np.float32)
    jh = jhmc.init_hyper(jnp.asarray(scales), 0.1, jnp.zeros(D_GAUSS))
    th = hmc_hyper_from_jax(jh)
    jadapt = jhmc.make_adapter(0.8, mass_start=10.0)
    tadapt = hmc.make_adapter(0.8, mass_start=10.0)
    rng = np.random.default_rng(3)
    for t in range(7):
        x = rng.normal(0, 1, (C, D_GAUSS)).astype(np.float32)
        acc = np.float32(rng.uniform())
        jh = jadapt(jh, {"accept_prob": jnp.asarray(acc)},
                    JMHState(params=jnp.asarray(x), logpost=jnp.zeros(C)),
                    jnp.int32(t))
        th = tadapt(th, {"accept_prob": torch.tensor(acc)},
                    MHState(params=torch.from_numpy(x), logpost=torch.zeros(C)),
                    t)
        for a, b in [(th.da.log_eps, jh.da.log_eps),
                     (th.da.log_eps_bar, jh.da.log_eps_bar),
                     (th.da.h_bar, jh.da.h_bar),
                     (th.inv_mass, jh.inv_mass),
                     (th.welford.m2, jh.welford.m2)]:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
        ready = float(th.welford.count) > 10.0
        assert float(th.inv_mass[2]) == 0.0
        assert ready == (float(th.inv_mass[0]) != 1.0)
    assert ready
    np.testing.assert_array_equal(hmc.finalize(th).da.log_eps.numpy(),
                                  th.da.log_eps_bar.numpy())
    np.testing.assert_allclose(hmc.finalize(th).da.log_eps.numpy(),
                               np.asarray(jhmc.finalize(jh).da.log_eps),
                               rtol=1e-6)


def _analytic_lik(mod):
    """A cheap stand-in likelihood of (u, hypo_raw, t0), the same function
    in both packages (the pCN kernel's mechanics are under test here)."""
    def lik(p):
        if mod is jnp:
            return (-0.5 * jnp.sum((p.u - 0.1) ** 2) / 0.04
                    - jnp.sum((p.hypo_raw - 0.3) ** 2) - jnp.sum(p.t0 ** 2))
        return (-0.5 * ((p.u - 0.1) ** 2).flatten(1).sum(1) / 0.04
                - ((p.hypo_raw - 0.3) ** 2).flatten(1).sum(1)
                - (p.t0 ** 2).flatten(1).sum(1))
    return lik


def _pcn_draws(keys, jparams1, tparams):
    """pCN: ``k_prop, k_acc = split(key)``."""
    nor, acc = [], []
    for key in keys:
        k_prop, k_acc = jax.random.split(key)
        nor.append(_leaf_normals(k_prop, jparams1))
        acc.append(float(jax.random.uniform(k_acc)))
    return _stack_normals(nor, tparams), torch.tensor(acc)


@pytest.mark.parametrize("whitened", [False, True])
def test_pcn_steps_and_adapter_replay_jax(whitened):
    """Five pCN warmup steps (kernel + dual averaging on logit rho) with
    JAX's draws. Plain: pCN on the Gaussian leaves (u, t0) against their
    prior scales and a random walk on hypo_raw whose logistic prior enters
    the acceptance. Whitened (generalized pCN): a flat state with unit
    reference scales. Accept flags equal, states at 1e-5, log rho at
    1e-5."""
    rng = np.random.default_rng(4)
    if whitened:
        d = 7
        jlik = lambda x: -0.5 * jnp.sum((x - 0.5) ** 2 * jnp.arange(1.0, d + 1))
        tlik = lambda x: -0.5 * ((x - 0.5) ** 2 * torch.arange(1.0, d + 1)).sum(1)
        jnong = tnong = None
        jgs, jrs = jnp.ones(d), None
        x0 = rng.normal(0, 0.5, (C, d)).astype(np.float32)
        jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
        jex = jnp.zeros(d)
    else:
        jlik, tlik = _analytic_lik(jnp), _analytic_lik(torch)
        jnong = lambda p: j_box_logjac(p.hypo_raw)
        tnong = lambda p: box_logjac(p.hypo_raw)
        jgs = JParams(u=jnp.full((2, 2), 0.2), t0=jnp.full((2,), 1.0))
        jrs = JParams(hypo_raw=jnp.ones((2, 3)))
        shapes = {"u": (2, 2), "hypo_raw": (2, 3), "t0": (2,)}
        vals = {k: rng.normal(0, 0.5, (C,) + s).astype(np.float32)
                for k, s in shapes.items()}
        jx = JParams(**{k: jnp.asarray(v) for k, v in vals.items()})
        tx = Params(**{k: torch.from_numpy(v) for k, v in vals.items()})
        jex = JParams(**{k: jnp.zeros(s) for k, s in shapes.items()})
    jh = jpcn.init_hyper(jgs, jrs, 0.3)
    th = pcn_hyper_from_jax(jh)
    jk = jax.jit(jax.vmap(jpcn.make_kernel(jlik, jnong), in_axes=(0, 0, None)))
    tk = pcn.make_kernel(tlik, tnong)
    jlp0 = jax.vmap(lambda p: jlik(p) + (jnong(p) if jnong else 0.0))(jx)
    jstate = JMHState(params=jx, logpost=jlp0)
    tlp0 = tlik(tx) + (tnong(tx) if tnong else 0.0)
    tstate = MHState(params=tx, logpost=tlp0)
    np.testing.assert_allclose(tlp0.numpy(), np.asarray(jlp0), rtol=1e-5)
    jadapt, tadapt = jpcn.make_adapter(0.234), pcn.make_adapter(0.234)
    decisions = []
    for t in range(5):
        keys = jax.random.split(jax.random.PRNGKey(40 + t), C)
        jstate, jinfo = jk(keys, jstate, jh)
        tstate, tinfo = tk(tstate, th, *_pcn_draws(keys, jex, tstate.params))
        _check_info(tinfo, jinfo, ("accepted",))
        pairs = ([(tstate.params, jstate.params)] if whitened else
                 [(getattr(tstate.params, f), getattr(jstate.params, f))
                  for f in ("u", "hypo_raw", "t0")])
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        decisions.extend(np.asarray(jinfo["accepted"]).tolist())
        jh = jadapt(jh, jax.tree.map(lambda x: jnp.mean(x, 0), jinfo), jstate,
                    jnp.int32(t))
        th = tadapt(th, {k: v.mean(0) for k, v in tinfo.items()}, tstate, t)
        np.testing.assert_allclose(th.log_rho.numpy(), np.asarray(jh.log_rho),
                                   atol=1e-5)
    assert 0 < sum(decisions) < len(decisions), decisions
    np.testing.assert_allclose(pcn.finalize(th).log_rho.numpy(),
                               np.asarray(jpcn.finalize(jh).log_rho), atol=1e-5)


# --- the small joint posterior ----------------------------------------------

JSHAPE = (8, 8, 6)
JINV = (2, 2, 2)
JC = 2
T_GAP = 1e-5       # traveltime gap between the packages (test_torch_samplers.py)
JSIGMA = 0.05


@pytest.fixture(scope="module")
def joint_models():
    """A joint problem small enough for replayed gradient samplers: 8x8x6
    grid, 2^3 basis, 2 events, 3 stations, t0 sampled; JAX's data."""
    mkw = dict(mode="joint", inv_shape=JINV, prior_sigma_u=0.1,
               sigma=JSIGMA)
    ekw = dict(tol=1e-5, max_iters=40, use_pallas="off")
    jgrid = JGrid(JSHAPE, (1.0,) * 3)
    jdata, _ = j_make_dataset(jgrid, JDataCfg(
        dataset="events3d_volume", n_events=2, n_stations=3, noise=0.05,
        seed=5, checker_cells=(1, 1, 1), checker_amplitude=0.05),
        JModelCfg(**mkw))
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**ekw), differentiable=True)
    tpost = build_posterior(ModelCfg(**mkw), event_data_from_jax(jdata),
                            Grid(JSHAPE, (1.0,) * 3), EikonalCfg(**ekw),
                            differentiable=True)
    rng = np.random.default_rng(6)
    jparams = JParams(
        u=jnp.asarray(rng.normal(0, 0.03, (JC,) + JINV).astype(np.float32)),
        hypo_raw=jnp.asarray(rng.normal(0, 0.3, (JC, 2, 3)).astype(np.float32)),
        t0=jnp.asarray(rng.normal(0, 0.05, (JC, 2)).astype(np.float32)))
    return jpost, tpost, jdata, jparams


def _lp_bar(jpost, jdata, jparams):
    """Per-chain logpost bar: T_GAP * sum |r| / sigma^2 at JAX's state."""
    r = np.asarray(jdata.t_obs)[None] - np.asarray(jax.vmap(jpost.predict)(jparams))
    return T_GAP * np.abs(r).reshape(r.shape[0], -1).sum(1) / JSIGMA ** 2


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_gradient_sampler_replays_jax_on_joint_posterior(joint_models, sampler):
    """Two steps of HMC (3 leapfrogs) or NUTS (max depth 2) on the joint
    posterior from one state, JAX's draws replayed: decisions equal
    (accepted, divergent, tree depth), params at atol 1e-4 (fp32 leapfrogs
    through two solvers whose fixed points differ at the ulp level), and
    logposts within T_GAP * sum|r| / sigma^2."""
    jpost, tpost, jdata, jparams = joint_models
    jh = jhmc.init_hyper(jpost.prior_scales, 0.05,
                         jpost.init_params(jax.random.PRNGKey(0)))
    th = hmc_hyper_from_jax(jh)
    if sampler == "hmc":
        jk = jax.jit(jax.vmap(jhmc.make_kernel(jpost.logpost, 3),
                              in_axes=(0, 0, None)))
        tk = hmc.make_kernel(tpost.logpost, 3)
        draws = lambda keys, tp: hmc_draws(keys, jax.tree.map(
            lambda x: x[0], jparams), tp)
        flags = ("accepted", "divergent")
    else:
        jk = jax.jit(jax.vmap(jnuts.make_kernel(jpost.logpost, 2),
                              in_axes=(0, 0, None)))
        tk = nuts.make_kernel(tpost.logpost, 2)
        draws = lambda keys, tp: nuts_draws(keys, jax.tree.map(
            lambda x: x[0], jparams), tp, 2)
        flags = ("accepted", "divergent", "tree_depth")
    jstate = JMHState(params=jparams,
                      logpost=jax.jit(jax.vmap(jpost.logpost))(jparams))
    tstate = MHState(params=params_from_jax(jparams),
                     logpost=torch.from_numpy(np.asarray(jstate.logpost)))
    for t in range(2):
        keys = jax.random.split(jax.random.PRNGKey(60 + t), JC)
        jstate, jinfo = jk(keys, jstate, jh)
        tstate, tinfo = tk(tstate, th, *draws(keys, tstate.params))
        _check_info(tinfo, jinfo, flags)
        for f in ("u", "hypo_raw", "t0"):
            np.testing.assert_allclose(getattr(tstate.params, f).numpy(),
                                       np.asarray(getattr(jstate.params, f)),
                                       atol=1e-4)
        bar = _lp_bar(jpost, jdata, jstate.params)
        assert np.all(np.abs(tstate.logpost.numpy()
                             - np.asarray(jstate.logpost)) <= bar)
