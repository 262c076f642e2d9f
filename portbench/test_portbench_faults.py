"""Each fault a cell can have, planted in the program underneath a run on
the CPU at a small size, turns ``correct`` false: a step that returns its
state unchanged; a step that hands half of the chains (particles) back as
they came; half of the batch left out, the mean taken over the rest; an
answer altered where it is produced. (No cell runs across chips, so the
exchange between them has no fault to plant.)"""

import dataclasses
import time

import pytest
import torch

from benchlib import cell

from test_portbench_run import shrink  # noqa: E402


def _run(name):
    return cell.run_cell(name, 2 ** 31 + 21, 0.5, False, time.perf_counter(),
                         device="cpu", adjust=shrink)


def unchanged_step(monkeypatch):
    """Every sampler step (MCMC) or SMC stage hands its state back as it
    came."""
    from mceik_tpu_torch.samplers import am, mala, smc

    def frozen(make):
        def make_kernel(*a, **k):
            def kernel(state, hyper, *draws):
                zero = torch.zeros_like(state.logpost)
                return state, {"accept_prob": zero, "accepted": zero}
            return kernel
        return make_kernel

    monkeypatch.setattr(am, "make_kernel", frozen(am.make_kernel))
    monkeypatch.setattr(mala, "make_kernel", frozen(mala.make_kernel))
    real = smc.stage

    def stage(post, state, beta, *a, **k):
        _, beta_new, *rest = real(post, state, beta, *a, **k)
        return (state, beta_new, *rest)

    monkeypatch.setattr(smc, "stage", stage)


def half_frozen(monkeypatch):
    """Every sampler step hands the first half of the chains back as they
    came; every SMC mutation the first half of the particles as resampling
    put them."""
    from mceik_tpu_torch.samplers import am, mala, smc
    from mceik_tpu_torch.utils import tree_where

    def first_half(n, device):
        return torch.arange(n, device=device) < n // 2

    def frozen(make):
        def make_kernel(*a, **k):
            real = make(*a, **k)

            def kernel(state, hyper, *draws):
                new, info = real(state, hyper, *draws)
                keep = first_half(new.logpost.shape[0], new.logpost.device)
                return tree_where(keep, state, new), info
            return kernel
        return make_kernel

    monkeypatch.setattr(am, "make_kernel", frozen(am.make_kernel))
    monkeypatch.setattr(mala, "make_kernel", frozen(mala.make_kernel))
    real_mutate = smc.mutate

    def mutate(state, *a, **k):
        new, acc = real_mutate(state, *a, **k)
        keep = first_half(new.log_lik.shape[0], new.log_lik.device)
        return dataclasses.replace(
            new, params=tree_where(keep, state.params, new.params),
            log_prior=torch.where(keep, state.log_prior, new.log_prior),
            log_lik=torch.where(keep, state.log_lik, new.log_lik)), acc

    monkeypatch.setattr(smc, "mutate", mutate)


def half_the_batch(monkeypatch):
    """The prediction of the first half of the chains (particles) only; the
    rest take its mean."""
    from mceik_tpu_torch.model import posterior

    real = posterior.predict_tomo

    def predict(slowness, *a, **k):
        h = max(1, slowness.shape[0] // 2)
        t = real(slowness[:h], *a, **k)
        rest = t.mean(0, keepdim=True).expand((slowness.shape[0] - h,)
                                              + t.shape[1:])
        return torch.cat([t, rest])

    monkeypatch.setattr(posterior, "predict_tomo", predict)


def altered_answer(monkeypatch):
    """Every chain's (particle's) traveltime field from its last source comes
    out of the solve 0.1% slow."""
    from mceik_tpu_torch.forward import predict

    def slow(real):
        def solve(s, srcs, *a, **k):
            T = real(s, srcs, *a, **k)
            last = (srcs == srcs[-1]).all(1)
            scale = torch.where(last, 1.001, 1.0).to(T.dtype)
            return T * scale.reshape((-1,) + (1,) * (T.ndim - 1))
        return solve

    for name in ("solve_eikonal_batched", "solve_eikonal_diff_batched"):
        monkeypatch.setattr(predict, name, slow(getattr(predict, name)))


def altered_gradient(monkeypatch):
    """Half of the transport fields' lambda left at zero."""
    from mceik_tpu_torch.eikonal import adjoint

    real = adjoint.transport_solve_batched

    def transport(g, *a, **k):
        lam = real(g, *a, **k)
        return torch.cat([lam[: lam.shape[0] // 2],
                          torch.zeros_like(lam[lam.shape[0] // 2:])])

    monkeypatch.setattr(adjoint, "transport_solve_batched", transport)


FAULTS = {"unchanged_step": unchanged_step, "half_frozen": half_frozen,
          "half_the_batch": half_the_batch, "altered_answer": altered_answer}
CASES = [(c, f) for c in ("c2.am16", "c2.mala16", "c4.smc10k")
         for f in FAULTS] + [("c2.mala16", "altered_gradient")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault, monkeypatch):
    plant = FAULTS.get(fault, altered_gradient)
    plant(monkeypatch)
    out = _run(name)
    assert not out["correct"], out["checks"]


def test_sound_run_is_correct():
    out = _run("c2.am16")
    assert out["correct"], out["checks"]
