"""The port against the committed goldens c1_small and c3_joint_small
(tests/golden/): the z-test of tests/test_golden.py, run by the port on the
CPU.

The golden problems' data are JAX's (its noise draw), carried across with
``convert``; the port's own datasets draw their noise from torch and so
define different posteriors. The check runs are the reference's
(mceik_tpu/diag/golden.py ``z_scores``): for c1_small 8 chains of
full-covariance AM with the golden's pinned proposal, seed 31, 300 warmup
and 2500 steps, thin 2, about 7 minutes on the CPU; for c3_joint_small the
Laplace-preconditioned MALA leg, below. Same bars as the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.diag.golden import load_golden
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import event_data_from_jax, tomo_data_from_jax
from mceik_tpu_torch.diag.ess import ess_per_param
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import slowness_from_u
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import am_full, mala
from mceik_tpu_torch.samplers.am_full import _ravel, _unravel_fn
from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.slow


def _tuples(d):
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}


def test_port_c1_small_golden_moments():
    golden = load_golden("c1_small")
    spec = golden["spec"]
    shape, spacing = tuple(spec["grid"]["shape"]), tuple(spec["grid"]["spacing"])
    jdata, jtruth = j_make_dataset(JGrid(shape, spacing),
                                   JDataCfg(**_tuples(spec["data"])),
                                   JModelCfg(**_tuples(spec["model"])))
    grid = Grid(shape, spacing)
    mcfg = ModelCfg(**_tuples(spec["model"]))
    post = build_posterior(mcfg, tomo_data_from_jax(jdata), grid,
                           EikonalCfg(**spec["eikonal"]))
    n_chains, n_prime = 8, 1e6
    gen = torch.Generator().manual_seed(31)
    states = init_chain_states(post.logpost, post.init_params, gen, n_chains)
    cov = torch.tensor(np.asarray(golden["proposal"]["cov"], np.float32))
    hyper = dataclasses.replace(
        am_full.init_hyper(post.prior_scales, 0.3),
        log_step=torch.tensor(np.float32(golden["proposal"]["log_step"])),
        count=torch.tensor(np.float32(n_prime)), m2=(n_prime - 1.0) * cov)
    r = run_mcmc(am_full.make_kernel(post.logpost), am_full.make_adapter(),
                 states, hyper, gen, n_warmup=300, n_steps=2500, thin=2,
                 collect_fn=lambda p: p.u)
    flat = r.samples.numpy().reshape(r.samples.shape[0], n_chains, -1)
    mean, var = flat.mean((0, 1)), flat.var((0, 1))
    ess = ess_per_param(flat)
    se = np.sqrt(var / np.maximum(ess, 2.0))
    z = np.abs((mean - np.asarray(golden["mean"]))
               / np.sqrt(se ** 2 + np.asarray(golden["se"]) ** 2))
    assert z.max() < 3.5, np.round(z, 2).tolist()
    assert np.median(z) < 1.5, np.round(z, 2).tolist()
    assert float(r.accept_trace.mean()) > 0.05
    assert float(np.median(ess)) > 20.0, ess
    s_mean = slowness_from_u(
        torch.tensor(mean, dtype=torch.float32).reshape(mcfg.inv_shape), grid,
        torch.tensor(mcfg.background_slowness)).numpy()
    s_true = np.asarray(jtruth["slowness"])
    a, b = s_mean - s_mean.mean(), s_true - s_true.mean()
    assert float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.5


def test_port_c3_joint_small_golden_moments():
    """The joint golden (slowness + hypocentres, t0 marginalized, volume
    acquisition) by the port's Laplace-preconditioned MALA: the reference's
    check run (mceik_tpu/diag/golden.py ``_run_problem_mala``) with the
    golden's pinned ``proposal.cov``, ``log_step`` and ``x_map``, chains
    started at the MAP plus 0.3x Laplace jitter, seed 33, 300 warmup and
    2500 steps, thin 2. The tracked vector is the full flat params (u cells,
    then hypo_raw). Same bars as the reference's z-test. About 46 minutes
    on 8 CPU threads (96 plain solves and transports per step)."""
    golden = load_golden("c3_joint_small")
    spec = golden["spec"]
    shape, spacing = tuple(spec["grid"]["shape"]), tuple(spec["grid"]["spacing"])
    jdata, _ = j_make_dataset(JGrid(shape, spacing),
                              JDataCfg(**_tuples(spec["data"])),
                              JModelCfg(**_tuples(spec["model"])))
    post = build_posterior(ModelCfg(**_tuples(spec["model"])),
                           event_data_from_jax(jdata), Grid(shape, spacing),
                           EikonalCfg(**spec["eikonal"]), differentiable=True)
    n_chains = 8
    prop = golden["proposal"]
    cov = np.asarray(prop["cov"], np.float64)
    cov = 0.5 * (cov + cov.T)
    cov += (1e-9 * np.trace(cov) / cov.shape[0]) * np.eye(cov.shape[0])
    L = torch.tensor(np.linalg.cholesky(cov), dtype=torch.float32)
    x_map = torch.tensor(prop["x_map"], dtype=torch.float32)
    gen = torch.Generator().manual_seed(33)
    unravel = _unravel_fn(post.init_params(gen, 1), batch_dims=1)

    def init(g, n):
        xi = torch.randn((n, x_map.shape[0]), generator=g)
        return unravel(x_map + 0.3 * xi @ L.T)

    states = mala.init_states(post.logpost, init, gen, n_chains)
    hyper = dataclasses.replace(
        mala.prime_covariance(mala.init_hyper(post.prior_scales, 1.0),
                              torch.tensor(cov, dtype=torch.float32)),
        log_step=torch.tensor(np.float32(prop["log_step"])))
    r = run_mcmc(mala.make_kernel(post.logpost),
                 mala.make_adapter(adapt_cov=False), states, hyper, gen,
                 n_warmup=300, n_steps=2500, thin=2,
                 collect_fn=lambda p: _ravel(p, batch_dims=1))
    flat = r.samples.numpy()
    mean, var = flat.mean((0, 1)), flat.var((0, 1))
    ess = ess_per_param(flat)
    se = np.sqrt(var / np.maximum(ess, 2.0))
    z = np.abs((mean - np.asarray(golden["mean"]))
               / np.sqrt(se ** 2 + np.asarray(golden["se"]) ** 2))
    print(f"c3_joint_small: max |z| {z.max():.3f}, median {np.median(z):.3f}, "
          f"acceptance {float(r.accept_trace.mean()):.4f}, median ESS "
          f"{float(np.median(ess)):.1f}")
    assert z.max() < 3.5, np.round(z, 2).tolist()
    assert np.median(z) < 1.5, np.round(z, 2).tolist()
    assert float(r.accept_trace.mean()) > 0.05
    assert float(np.median(ess)) > 20.0, ess
