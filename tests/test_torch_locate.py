"""Parity of the PyTorch port's locate mode with the JAX package on the CPU:
the hypocentre grid search (``forward/locate.py``) against JAX's on JAX's
tables, chunked against unchunked; the locate-mode logpost per chain and
its hypocentre gradient against JAX's, under fixed, hierarchical
(per-station, t0 marginalized) and spike-slab noise with a partial mask,
the fixed slowness given as an array, as an ``.h5`` written by JAX's
``save_slowness_hdf5`` and as the background; the Gauss-Newton Jacobian of
locate mode against autograd; every sampler the reference runs in locate
mode through ``api.run`` (no slowness tracked); and the CLI over a ``.pt``
fixed model with the table cache. Inputs are made with numpy from seeds;
JAX's data cross over with ``convert``."""

import functools
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
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.forward.locate import locate_grid_search as j_locate
from mceik_tpu.forward.predict import traveltime_tables as j_tables
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.io.loaders import save_slowness_hdf5 as j_save_slowness_hdf5
from mceik_tpu.model.data import EventData as JEventData
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior

from mceik_tpu_torch import api, cli
from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import event_data_from_jax, params_from_jax
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward import predict
from mceik_tpu_torch.forward.locate import locate_grid_search
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.config_io import config_from_dict
from mceik_tpu_torch.io.loaders import save_slowness
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.model.posterior import build_posterior, value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C3 = os.path.join(REPO, "configs", "c3_joint_events.json")
SHAPE = (13, 11, 9)
N_EV, N_STA, N_CHAINS = 3, 5, 4
EKW = dict(tol=1e-5, max_iters=60, use_pallas="off")
DKW = dict(dataset="events3d", n_events=N_EV, n_stations=N_STA, noise=0.02,
           seed=7, checker_cells=(2, 2, 2), checker_amplitude=0.08)


@functools.lru_cache(maxsize=None)
def _jax_problem():
    """JAX's events dataset over a checkerboard truth, a partial mask (two
    picks dropped), and its truth slowness."""
    jgrid = JGrid(SHAPE, (1.0,) * 3)
    jdata, truth = j_make_dataset(jgrid, JDataCfg(**DKW), JModelCfg())
    mask = np.ones((N_EV, N_STA), np.float32)
    mask[0, 1] = mask[2, 4] = 0.0
    jdata = JEventData(sta_xyz=jdata.sta_xyz, t_obs=jdata.t_obs,
                       mask=jnp.asarray(mask))
    return jgrid, jdata, np.asarray(truth["slowness"])


@functools.lru_cache(maxsize=None)
def _jax_tables():
    jgrid, jdata, s = _jax_problem()
    return np.asarray(j_tables(jnp.asarray(s), jdata.sta_xyz, jgrid,
                               JEikonalConfig(**EKW)))


def _catalogue(n_ev=40, seed=0):
    """Synthetic picks from JAX's tables: each event at a random node with a
    random origin time and noise, and a mask keeping at least two picks."""
    T = _jax_tables().reshape(N_STA, -1)
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, T.shape[1], n_ev)
    t_obs = (T[:, nodes].T + 0.3 * rng.standard_normal((n_ev, 1))
             + 0.01 * rng.standard_normal((n_ev, N_STA))).astype(np.float32)
    mask = (rng.random((n_ev, N_STA)) > 0.25).astype(np.float32)
    mask[:, :2] = 1.0
    return t_obs, mask


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask"])
def test_grid_search_matches_jax(masked):
    """On JAX's tables (so only the reduction differs): the same nodes and
    hypocentres, t0 and loglik at rtol 1e-6."""
    jgrid, _, _ = _jax_problem()
    tables = _jax_tables()
    t_obs, mask = _catalogue()
    jm = jnp.asarray(mask) if masked else None
    want = j_locate(jnp.asarray(tables), jnp.asarray(t_obs), jgrid,
                    sigma=0.02, mask=jm)
    got = locate_grid_search(torch.from_numpy(tables),
                             torch.from_numpy(t_obs), Grid(SHAPE, (1.0,) * 3),
                             sigma=0.02,
                             mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_array_equal(got["hypo"].numpy(),
                                  np.asarray(want["hypo"]))
    np.testing.assert_allclose(got["t0"].numpy(), np.asarray(want["t0"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-6)


def test_grid_search_chunked_equals_unchunked():
    """Chunks of 1 and of 7 events against one chunk of all: the same
    nodes, t0 and loglik at rtol 1e-6; the truth nodes are found where the
    noise leaves them best."""
    tables = torch.from_numpy(_jax_tables())
    t_obs, mask = (torch.from_numpy(a) for a in _catalogue(n_ev=30, seed=1))
    grid = Grid(SHAPE, (1.0,) * 3)
    whole = locate_grid_search(tables, t_obs, grid, 0.02, mask, chunk=30)
    for chunk in (1, 7, None):
        part = locate_grid_search(tables, t_obs, grid, 0.02, mask,
                                  chunk=chunk)
        assert torch.equal(part["node"], whole["node"])
        torch.testing.assert_close(part["t0"], whole["t0"], rtol=1e-6,
                                   atol=0.0)
        torch.testing.assert_close(part["loglik"], whole["loglik"],
                                   rtol=1e-6, atol=0.0)
    assert torch.all(whole["loglik"] <= 0)


NOISE_CASES = {
    # noise model and its ModelCfg keys, where the fixed slowness comes from
    "fixed_array": (dict(noise_model="fixed"), "array"),
    "hier_marg_h5": (dict(noise_model="hierarchical", per_station_noise=True,
                          marginalize_t0=True), "h5"),
    "slab_background": (dict(noise_model="spike_slab"), "background"),
}


def _chain_params(mkw, seed=3):
    """JAX Params for N_CHAINS chains, drawn with numpy: hypocentres spread
    over the box, and the leaves the noise model samples."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    t0 = (None if mkw.get("marginalize_t0")
          else f32(0.2 * rng.standard_normal((N_CHAINS, N_EV))))
    ls = z = None
    if mkw["noise_model"] == "hierarchical":
        ls = f32(0.3 * rng.standard_normal((N_CHAINS, N_STA)))
    elif mkw["noise_model"] == "spike_slab":
        ls = f32(2.0 + 0.3 * rng.standard_normal((N_CHAINS, N_STA)))
        z = f32(rng.random((N_CHAINS, N_STA)) < 0.4)
    return JParams(hypo_raw=f32(0.8 * rng.standard_normal((N_CHAINS, N_EV, 3))),
                   t0=t0, log_sigma=ls, noise_z=z)


@pytest.mark.parametrize("case", list(NOISE_CASES))
def test_locate_logpost_and_gradient_match_jax(case, tmp_path):
    """Locate-mode logpost per chain at rtol 2e-5 and its hypocentre
    gradient at rtol 1e-4 (of the gradient's largest entry, where an entry
    is near zero), both packages solving their own tables over the same
    fixed model; the model has no u and no slowness."""
    noise, source = NOISE_CASES[case]
    jgrid, jdata, s_true = _jax_problem()
    mkw = dict(mode="locate", sigma=0.02, prior_sigma_t0=0.5, **noise)
    fixed = None
    if source == "array":
        fixed = s_true
    elif source == "h5":
        path = str(tmp_path / "model.h5")
        j_save_slowness_hdf5(path, s_true, jgrid)
        mkw["fixed_slowness_path"] = path
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**EKW), differentiable=True,
                              fixed_slowness=fixed)
    tpost = build_posterior(ModelCfg(**mkw), event_data_from_jax(jdata),
                            Grid(SHAPE, (1.0,) * 3), EikonalCfg(**EKW),
                            differentiable=True, fixed_slowness=fixed)
    jp = _chain_params(mkw)
    tp = params_from_jax(jp)
    want = np.asarray(jax.vmap(jpost.logpost)(jp))
    lp, g = value_and_grad(tpost.logpost)(tp)
    np.testing.assert_allclose(lp.numpy(), want, rtol=2e-5)
    gw = np.asarray(jax.vmap(jax.grad(jpost.logpost))(jp).hypo_raw)
    np.testing.assert_allclose(g.hypo_raw.numpy(), gw, rtol=1e-4,
                               atol=1e-4 * np.abs(gw).max())
    assert tpost.prior_scales.u is None
    assert tpost.slowness_of(tp) is None
    gen = torch.Generator().manual_seed(0)
    assert tpost.init_params(gen, 2).u is None
    assert tpost.sample_prior(gen, 2).u is None
    assert tpost.n_dim == jpost.n_dim


def test_locate_jacobian_matches_autograd():
    """The Gauss-Newton Jacobian of locate mode (rows (event, station);
    hypocentre and t0 columns, then zero noise columns) equals autograd's
    full Jacobian of ``predict`` for one chain."""
    jgrid, jdata, s_true = _jax_problem()
    mkw = dict(mode="locate", sigma=0.02, noise_model="hierarchical",
               per_station_noise=True)
    post = build_posterior(ModelCfg(**mkw), event_data_from_jax(jdata),
                           Grid(SHAPE, (1.0,) * 3), EikonalCfg(**EKW),
                           differentiable=True, fixed_slowness=s_true)
    p = params_from_jax(_chain_params(dict(mkw, noise_model="hierarchical")))
    p1 = Params(hypo_raw=p.hypo_raw[:1], t0=p.t0[:1],
                log_sigma=p.log_sigma[:1])
    t_rows, J = post.jacobian(p1)
    torch.testing.assert_close(t_rows, post.predict(p1)[0].reshape(-1),
                               rtol=0.0, atol=0.0)
    jh, jt = torch.autograd.functional.jacobian(
        lambda h, t: post.predict(Params(hypo_raw=h, t0=t))[0].reshape(-1),
        (p1.hypo_raw, p1.t0))
    want = torch.cat([jh.reshape(N_EV * N_STA, -1),
                      jt.reshape(N_EV * N_STA, -1),
                      torch.zeros(N_EV * N_STA, N_STA)], dim=1)
    assert J.shape == (N_EV * N_STA, post.n_dim)
    torch.testing.assert_close(J, want, rtol=1e-6, atol=1e-6)


def _locate_config(algo, tmp_path):
    return config_from_dict({
        "grid": {"shape": list(SHAPE), "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"tol": 1e-4, "max_iters": 50},
        "model": {"mode": "locate", "sigma": 0.02, "prior_sigma_t0": 0.5,
                  "table_cache_dir": str(tmp_path / "tables")},
        "sampler": {"algorithm": algo, "n_chains": 2, "n_warmup": 6,
                    "n_samples": 6, "thin": 1, "step_size": 0.05,
                    "n_leapfrog": 4, "max_tree_depth": 3, "n_map_steps": 3,
                    "seed": 1},
        "data": {"dataset": "events3d", "n_events": 2, "n_stations": 4,
                 "noise": 0.02, "seed": 5, "checker_cells": [2, 2, 2],
                 "checker_amplitude": 0.0},
        "io": {"log_every": 3},
    })


@pytest.mark.parametrize("algo", ["rwm", "am", "am_full", "mala", "hmc",
                                  "nuts", "pcn"])
def test_locate_runs_every_sampler(algo, tmp_path):
    """Each sampler the reference runs in locate mode, through api.run: no
    u, no slowness tracked, no recovery correlation, finite logposts and
    hypocentre moments."""
    s = api.run(_locate_config(algo, tmp_path), device="cpu", verbose=False)
    assert np.isfinite(s.result.logpost_trace.numpy()).all()
    assert "slowness" not in s.post_mean
    assert s.recovery_corr is None
    assert s.post_mean["params"].u is None
    assert np.isfinite(s.post_mean["params"].hypo_raw).all()
    assert len(os.listdir(tmp_path / "tables")) == 1


def test_cli_locate_over_pt_model_hits_the_cache(tmp_path, capsys,
                                                 monkeypatch):
    """config 3 cut to a tiny grid under model.mode=locate, the fixed model
    a .pt written by save_slowness: the first run solves the tables once and
    writes one file, the second solves nothing; logposts finite, no
    recovery_corr in the summary line."""
    grid = Grid(SHAPE, (1.0,) * 3)
    s = torch.from_numpy(_jax_problem()[2])
    model = str(tmp_path / "model.pt")
    save_slowness(model, s, grid)
    solves = []
    real = predict.traveltime_tables
    monkeypatch.setattr(predict, "traveltime_tables",
                        lambda *a, **k: solves.append(1) or real(*a, **k))
    argv = ["run", C3, f"grid.shape={list(SHAPE)}", "grid.spacing=[1,1,1]",
            "model.mode=locate", f"model.fixed_slowness_path={model}",
            f"model.table_cache_dir={tmp_path / 'tc'}", "data.n_events=2",
            "data.n_stations=4", "sampler.n_chains=2", "sampler.n_warmup=3",
            "sampler.n_samples=4", "sampler.thin=1", "sampler.max_tree_depth=2",
            "io.log_every=3", "--device", "cpu"]
    for n_solves in (1, 1):
        assert cli.main(argv) == 0
        assert len(solves) == n_solves
        assert len(os.listdir(tmp_path / "tc")) == 1
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(x.split("] ", 1)[1]) for x in lines
            if x.startswith("[mceik] ")]
    assert all(np.isfinite(r["logpost_mean"]) for r in recs)
    summary = [x for x in lines if x.startswith("[mceik-tpu-torch] nuts")]
    assert len(summary) == 2 and "recovery_corr" not in summary[0]


def test_locate_end_to_end_matches_jax():
    """Each package solves its own tables of the truth model and searches
    them with its own grid search, on JAX's masked events: the same
    hypocentres, t0 at atol 1e-4 and loglik at rtol 1e-3 (the tables
    differ at the ulp level, as XLA contracts FMAs)."""
    jgrid, jdata, s_true = _jax_problem()
    want = j_locate(jnp.asarray(_jax_tables()), jdata.t_obs, jgrid, 0.02,
                    jdata.mask)
    grid = Grid(SHAPE, (1.0,) * 3)
    data = event_data_from_jax(jdata)
    tables = predict.traveltime_tables(torch.from_numpy(s_true),
                                       data.sta_xyz, grid,
                                       EikonalConfig(**EKW))
    got = locate_grid_search(tables, data.t_obs, grid, 0.02, data.mask)
    np.testing.assert_array_equal(got["hypo"].numpy(), np.asarray(want["hypo"]))
    np.testing.assert_allclose(got["t0"].numpy(), np.asarray(want["t0"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["loglik"].numpy(),
                               np.asarray(want["loglik"]), rtol=1e-3)
