"""The frozen reference against the program's plain solve (CPU tensors take
the program's plain route) and against the exact traveltime of a
homogeneous medium, at small sizes. The test imports the program; the
reference never does."""

import math

import pytest
import torch

from reference import eikonal, tomo

CFG3 = {"grid": {"shape": [14, 13, 12], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 20},
        "model": {"mode": "tomo", "inv_shape": [4, 3, 3],
                  "background_slowness": 1.0, "prior_sigma_u": 0.2,
                  "sigma": 0.01},
        "data": {"dataset": "checkerboard3d", "n_src": 3, "n_rec": 4,
                 "noise": 0.01, "checker_cells": [3, 3, 3],
                 "checker_amplitude": 0.1}}
CFG2 = {"grid": {"shape": [24, 21], "spacing": [1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30},
        "model": {"mode": "tomo", "inv_shape": [5, 4],
                  "background_slowness": 1.0, "prior_sigma_u": 0.2,
                  "sigma": 0.01},
        "data": {"dataset": "crosswell2d", "n_src": 4, "n_rec": 6,
                 "noise": 0.01, "checker_cells": [3, 3],
                 "checker_amplitude": 0.1}}


def _program(cfg, data):
    from mceik_tpu_torch.io.config_io import config_from_dict
    from mceik_tpu_torch.model.data import TomoData
    from mceik_tpu_torch.model.posterior import build_posterior

    rc = config_from_dict({k: cfg[k] for k in ("grid", "eikonal", "model")})
    td = TomoData(src_xyz=data["src"], rec_xyz=data["rec"],
                  t_obs=data["t_obs"])
    return build_posterior(rc.model, td, rc.grid.build(), rc.eikonal,
                           differentiable=True)


@pytest.mark.parametrize("cfg", [CFG3, CFG2], ids=["3d", "2d"])
def test_solve_matches_the_programs_plain_solve(cfg):
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.solve import EikonalConfig
    from mceik_tpu_torch.grid import Grid

    g = torch.Generator().manual_seed(3)
    shape = tuple(cfg["grid"]["shape"])
    s = 1.0 + 0.2 * torch.rand((3,) + shape, generator=g)
    src = torch.rand((3, len(shape)), generator=g) * (
        torch.tensor(shape, dtype=torch.float32) - 1)
    T, cycles = eikonal.solve(s, src, cfg["grid"]["spacing"], 1e-3, 20, 2,
                              3.0)
    grid = Grid(shape=shape, spacing=tuple(cfg["grid"]["spacing"]))
    T_p = solve_eikonal_batched(s, src, grid, EikonalConfig(
        tol=1e-3, max_iters=20, n_inner=2, use_pallas="off"))
    assert torch.allclose(T, T_p, rtol=0, atol=1e-5)
    assert bool((cycles > 1).all())


@pytest.fixture
def two_cycle_threshold(monkeypatch):
    """The reference's whole-field limit lowered under a 10 x 9 x 8 field,
    so that such a field takes the two-cycle count of fields above 2 MiB."""
    monkeypatch.setattr(eikonal, "WHOLE_FIELD_BYTES", 4 * 10 * 9 * 8 - 4)


def _batch(shape, n, seed):
    g = torch.Generator().manual_seed(seed)
    s = 1.0 + 0.2 * torch.rand((n,) + shape, generator=g)
    src = torch.rand((n, len(shape)), generator=g) * (
        torch.tensor(shape, dtype=torch.float32) - 1)
    return s, src


def test_two_cycle_count_matches_the_programs_blocked_count(
        two_cycle_threshold):
    """Above the limit a counted iteration is two cycles: the fields and each
    field's cycle count are those of the program's plain solve on the
    blocked route's count (``sweep_solve`` with ``cycles_per_iter=2``)."""
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.solve import (CYCLES_PER_ITER, EikonalConfig,
                                               seed_floor, seed_source,
                                               sweep_solve)
    from mceik_tpu_torch.grid import Grid

    shape, spacing = (10, 9, 8), (1.0, 1.0, 1.0)
    s, src = _batch(shape, 4, 7)
    assert eikonal.cycles_per_iter(shape) == CYCLES_PER_ITER["blocked"] == 2
    T, cycles = eikonal.solve(s, src, spacing, 1e-3, 20, 2, 3.0)
    grid = Grid(shape=shape, spacing=spacing)
    T0, frozen = seed_source(s, src, grid, 3.0)
    T_p, cycles_p = sweep_solve(T0, seed_floor(T0, frozen), s, spacing, 1e-3,
                                20, 2, cycles_per_iter=2, return_cycles=True)
    assert torch.allclose(T, T_p, rtol=0, atol=1e-5)
    assert torch.equal(cycles, cycles_p.long())
    assert bool((cycles % 2 == 0).all()) and bool((cycles >= 4).all())
    # The blocked route's solve of the program (its plain version on the
    # CPU) gives the same fields.
    T_b = solve_eikonal_batched(s, src, grid, EikonalConfig(
        tol=1e-3, max_iters=20, n_inner=2), impl="blocked")
    assert torch.allclose(T, T_b, rtol=0, atol=1e-5)
    # At the limit itself a field takes one cycle an iteration, as before.
    assert eikonal.cycles_per_iter((10, 9, 7)) == 1


def test_two_cycle_transport_matches_the_programs(two_cycle_threshold):
    """The adjoint above the limit: two cycles a counted iteration, as the
    program's plain ``transport_solve`` with ``cycles_per_iter=2``."""
    from mceik_tpu_torch.eikonal.adjoint_sweep import transport_solve

    shape, spacing = (10, 9, 8), (1.0, 1.0, 1.0)
    s, src = _batch(shape, 3, 8)
    T, _ = eikonal.solve(s, src, spacing, 1e-4, 30, 2, 3.0)
    _, frozen = eikonal.seed(s, src, spacing, 3.0)
    ws = eikonal.transport_weights(T, s, frozen, spacing)
    g = torch.rand(T.shape, generator=torch.Generator().manual_seed(9))
    lam = eikonal.transport_solve(g, ws, 1e-4, 30, 2)
    lam_p = transport_solve(g, ws, 1e-4, 30, 2, cycles_per_iter=2)
    assert torch.isfinite(lam).all()
    assert torch.allclose(lam, lam_p, rtol=1e-5, atol=1e-5)


def test_homogeneous_medium_is_near_the_distance():
    shape = (20, 20, 20)
    s = torch.full((1,) + shape, 0.5)
    src = torch.tensor([[2.0, 3.0, 4.0]])
    T, _ = eikonal.solve(s, src, (1.0, 1.0, 1.0), 1e-6, 50, 2, 3.0)
    ax = [torch.arange(n, dtype=torch.float32) for n in shape]
    X, Y, Z = torch.meshgrid(*ax, indexing="ij")
    exact = 0.5 * torch.sqrt((X - 2) ** 2 + (Y - 3) ** 2 + (Z - 4) ** 2)
    # First-order upwind: an error that grows slowly with the distance.
    assert float((T[0] - exact).abs().max()) < 0.06 * float(exact.max())
    assert float((T[0] - exact).min()) > -1e-4


@pytest.mark.parametrize("cfg", [CFG3, CFG2], ids=["3d", "2d"])
def test_posterior_matches_the_program(cfg):
    from mceik_tpu_torch.model.params import Params
    from mceik_tpu_torch.model.posterior import value_and_grad

    data = tomo.make_data(cfg, 2 ** 31 + 11, "cpu")
    ref = tomo.for_config(cfg, data, "cpu")
    u = 0.1 * torch.randn((3,) + tuple(cfg["model"]["inv_shape"]),
                          generator=torch.Generator().manual_seed(5))
    lp, g = value_and_grad(_program(cfg, data).logpost)(Params(u=u))
    r = ref.gradient_terms(u)
    scale = r["prior"].abs() + r["lik"].abs()
    assert float(((lp - r["prior"] - r["lik"]).abs() / scale).max()) < 1e-5
    norm = lambda x: x.flatten(1).norm(dim=1)
    gap = norm(g.u - r["g_prior"] - r["g_lik"]) / (
        norm(r["g_prior"]) + norm(r["g_lik"]))
    assert float(gap.max()) < 1e-4
    prior, lik = ref.terms(u)
    assert torch.equal(prior + lik, ref.logpost(u))
    assert torch.allclose(lik, r["lik"], rtol=1e-6)


def test_data_is_the_seeds():
    a = tomo.make_data(CFG2, 7, "cpu")
    b = tomo.make_data(CFG2, 7, "cpu")
    c = tomo.make_data(CFG2, 8, "cpu")
    assert torch.equal(a["t_obs"], b["t_obs"])
    assert not torch.equal(a["t_obs"], c["t_obs"])
    assert a["t_obs"].shape == (4, 6)


def test_upsample_matrix_rows_sum_to_one():
    A = tomo.resample_matrix(12, 64, "cpu")
    assert torch.allclose(A.sum(1), torch.ones(64))
    # Half-pixel centres: output 0 reads input position max(-0.40625, 0).
    assert float(A[0, 0]) == 1.0
    assert math.isclose(float(A[10, 1]), 1.0 - (10.5 * 12 / 64 - 0.5 - 1),
                        rel_tol=1e-6)


@pytest.mark.parametrize("step", [0.005, 0.05], ids=["moves", "stays"])
def test_mala_ratio_matches_the_program(step):
    """The reference's MALA acceptance, from the program's state with its
    draws, step and preconditioner, against the program's step (at these
    starts every chain moves at the small step and none at the large)."""
    from mceik_tpu_torch.model.params import Params
    from mceik_tpu_torch.samplers import mala
    from mceik_tpu_torch.samplers.base import draw_normal_uniform

    from reference import mala as mala_ref

    data = tomo.make_data(CFG3, 2 ** 31 + 13, "cpu")
    post = _program(CFG3, data)
    ref = tomo.for_config(CFG3, data, "cpu")
    inv = tuple(CFG3["model"]["inv_shape"])
    g = torch.Generator().manual_seed(9)
    hyper = mala.init_hyper(post.prior_scales, step)
    states = mala.init_states(
        post.logpost,
        lambda gen, n: Params(u=0.02 * torch.randn((n,) + inv, generator=gen)),
        g, 8)
    normal, uniform = draw_normal_uniform(g, states)
    new, info = mala.make_kernel(post.logpost)(states, hyper, normal, uniform)
    lr = mala_ref.log_ratio(ref, states.params.u, normal.u.reshape(8, -1),
                            torch.exp(hyper.log_step),
                            mala._chol_unmasked(hyper),
                            (hyper.scales_flat > 0).to(torch.float32))
    assert torch.allclose(torch.exp(lr.clamp(max=0.0)), info["accept_prob"],
                          rtol=0, atol=1e-3)
    moved = (new.params.u != states.params.u).flatten(1).any(1)
    assert bool((moved == (step < 0.01)).all())
    log_u = torch.log(uniform)
    assert float(mala_ref.wrong_side(lr, log_u, moved).max()) < 1e-3
    # Each chain made to do the other thing reads above 0.
    assert float(mala_ref.wrong_side(lr, log_u, ~moved).min()) > 0
