"""The port against the committed c1_small golden (tests/golden/c1_small.json):
the z-test of tests/test_golden.py, run by the port on the CPU.

The golden problem's data are JAX's (its noise draw), carried across with
``convert.tomo_data_from_jax``; the port's own crosswell data draw their
noise from torch and so define a different posterior. The check run is the
reference's (mceik_tpu/diag/golden.py ``z_scores``): 8 chains of
full-covariance AM with the golden's pinned proposal, seed 31, 300 warmup
and 2500 steps, thin 2, at the same bars. About 7 minutes on the CPU.
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
from mceik_tpu_torch.convert import tomo_data_from_jax
from mceik_tpu_torch.diag.ess import ess_per_param
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import slowness_from_u
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import am_full
from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc

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
