"""Config 5's shape through the port's production entry point
(tests/test_c5_shape.py's reduced config): joint NUTS with spike-slab noise,
``dist.multihost`` as the config writes it (no launcher: it warns and runs
as one process), and the eikonal solve by the Jacobi method, through
``api.run(device="cpu")``. Tier 1 runs 16 chains; the reference's 1024
chains are the slow version."""

import os

import numpy as np
import pytest
import torch

from mceik_tpu_torch.api import run
from mceik_tpu_torch.io.config_io import apply_overrides, load_config

C5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "configs", "c5_pod_nuts.json")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny grids: one intra-op thread runs them as fast, and keeps them
    from contending with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_c5(n_chains, monkeypatch):
    cfg = load_config(C5)
    assert cfg.dist.multihost         # the config requests multi-host
    cfg = apply_overrides(cfg, [
        "grid.shape=[10,9,8]", "model.inv_shape=[3,3,3]",
        "eikonal.method=jacobi", "eikonal.max_iters=60", "eikonal.tol=1e-3",
        "data.n_events=3", "data.n_stations=4",
        f"sampler.n_chains={n_chains}", "sampler.n_warmup=0",
        "sampler.n_samples=2", "sampler.thin=1",
        "sampler.max_tree_depth=2", "io.log_every=2",
    ])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.warns(UserWarning, match="one process"):
        return run(cfg, device="cpu", verbose=False)


def _check(summary, n_chains):
    lp = summary.result.states.logpost.numpy()
    assert lp.shape == (n_chains,)
    assert np.all(np.isfinite(lp))
    assert 0.0 < summary.accept_rate <= 1.0
    # The spike-slab indicators exist and stayed binary through NUTS + Gibbs.
    z = summary.result.states.params.noise_z.numpy()
    assert z.shape == (n_chains, 4)
    assert np.all((z == 0.0) | (z == 1.0))


def test_c5_reduced_jacobi_nuts(monkeypatch):
    _check(_run_c5(16, monkeypatch), 16)


@pytest.mark.slow
def test_c5_reduced_1024_chain_jacobi_nuts(monkeypatch):
    _check(_run_c5(1024, monkeypatch), 1024)
