"""The port's tracing (``mceik_tpu_torch/io/trace.py``) on the CPU: the
``mceik.*`` spans (a shared no-op with no profiler running; under
``torch.profiler`` one per call, nested as the layers call each other) and
the host-sync counter over the solve loops and an SMC stage. This file
imports no JAX."""

import pytest
import torch

from mceik_tpu_torch.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu_torch.datasets import synthetic as tsyn
from mceik_tpu_torch.dist.dryrun import GaussToy
from mceik_tpu_torch.eikonal.adjoint_sweep import (transport_cycle_plain,
                                                   transport_solve,
                                                   transport_weights)
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, sweep_cycle_plain,
                                           sweep_solve)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io import trace
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import am, mala, smc
from mceik_tpu_torch.samplers.base import init_chain_states, run_mcmc


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny plain solves: one intra-op thread runs them as fast and keeps
    them from contending with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_span_without_profiler_is_one_shared_noop(monkeypatch):
    """With no profiler running a span enters no ``record_function``: every
    name gets the same no-op context, which nests."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("mceik.a"), trace.span("mceik.b")
    assert a is b
    with a, b:
        pass


def _spans(prof):
    """``{(span, parent span or None): count}`` of the ``mceik.*`` ranges in
    a profile, each parent the nearest enclosing ``mceik.*`` range."""
    out = {}
    for e in prof.events():
        if not e.name.startswith("mceik."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("mceik."):
            p = p.cpu_parent
        key = (e.name, None if p is None else p.name)
        out[key] = out.get(key, 0) + 1
    return out


def _posterior3d(differentiable):
    grid = Grid((10, 10, 10), (1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(3, 3, 3), prior_sigma_u=0.2,
                    sigma=0.01)
    data, _ = tsyn.checkerboard3d_dataset(
        grid, DataCfg(dataset="checkerboard3d", n_src=2, n_rec=3,
                      checker_cells=(2, 2, 2), checker_amplitude=0.1), mcfg,
        EikonalConfig(tol=1e-3, max_iters=30))
    return build_posterior(mcfg, data, grid, EikonalCfg(tol=1e-3,
                                                        max_iters=30),
                           differentiable=differentiable)


def _posterior2d():
    grid = Grid((12, 12), (1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(3, 3), prior_sigma_u=0.2,
                    sigma=0.01)
    data, _ = tsyn.crosswell_dataset(
        grid, DataCfg(n_src=2, n_rec=3, checker_cells=(2, 2),
                      checker_amplitude=0.1), mcfg,
        EikonalConfig(tol=1e-3, max_iters=30))
    return build_posterior(mcfg, data, grid, EikonalCfg(tol=1e-3,
                                                        max_iters=30))


STEP, RECORD = "mceik.mcmc.step", "mceik.mcmc.record"
LOGPOST, VAG = "mceik.posterior.logpost", "mceik.posterior.value_and_grad"
SLOWNESS, SOLVE = "mceik.forward.slowness", "mceik.eikonal.solve"
TRANSPORT = "mceik.adjoint.transport"


@pytest.mark.parametrize("sampler", ["am", "mala"])
def test_mcmc_spans_nest_as_the_layers_call(sampler):
    """Two sampling steps under the profiler: a step span per step holding
    the posterior's (MALA: value_and_grad holding logpost and the adjoint
    transport), the upsample and the solve under logpost, and run_mcmc's
    bookkeeping after each step, after each kept draw and once at the
    end."""
    gen = torch.Generator().manual_seed(3)
    post = _posterior3d(differentiable=sampler == "mala")
    if sampler == "am":
        states = init_chain_states(post.logpost, post.init_params, gen, 2)
        kernel = am.make_kernel(post.logpost)
        hyper = am.init_hyper(post.prior_scales, 0.1,
                              post.init_params(gen, 1))
    else:
        states = mala.init_states(post.logpost, post.init_params, gen, 2)
        kernel = mala.make_kernel(post.logpost)
        hyper = mala.init_hyper(post.prior_scales, 0.05)
    with torch.profiler.profile() as prof:
        run_mcmc(kernel, None, states, hyper, gen, n_warmup=0, n_steps=2)
    expect = {(STEP, None): 2, (RECORD, None): 5, (SLOWNESS, LOGPOST): 2,
              (SOLVE, LOGPOST): 2}
    if sampler == "am":
        expect[(LOGPOST, STEP)] = 2
    else:
        expect.update({(VAG, STEP): 2, (LOGPOST, VAG): 2,
                       (TRANSPORT, VAG): 2})
    assert _spans(prof) == expect


def test_smc_spans_nest_as_the_layers_call():
    """A fresh population and one stage of two mutation steps: the stage
    holds next_beta, the resampling and the mutation, the mutation an
    upsample and a solve per step, the fresh population one of each."""
    post = _posterior2d()
    gen = torch.Generator().manual_seed(5)
    with torch.profiler.profile() as prof:
        state = smc.init_particles(post, gen, 16, 0.1)
        smc.stage(post, state, 0.0, gen, 2, 8.0)
    assert _spans(prof) == {
        ("mceik.smc.init", None): 1, (SLOWNESS, "mceik.smc.init"): 1,
        (SOLVE, "mceik.smc.init"): 1, ("mceik.smc.stage", None): 1,
        ("mceik.smc.next_beta", "mceik.smc.stage"): 1,
        ("mceik.smc.resample", "mceik.smc.stage"): 1,
        ("mceik.smc.mutate", "mceik.smc.stage"): 1,
        (SLOWNESS, "mceik.smc.mutate"): 2, (SOLVE, "mceik.smc.mutate"): 2}


def _flagged(plain):
    """A cycle that, as the kernels do, takes the done flags on the device
    and reads nothing to the host: ``plain`` on every field, the done ones
    put back."""
    def cycle(x, a, b, n_inner, done):
        return torch.where(done.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                           plain(x, a, b, n_inner))
    return cycle


def _sweep_inputs():
    grid = Grid((14, 12), (1.0, 1.0))
    gen = torch.Generator().manual_seed(7)
    s = 1.0 + 0.3 * torch.rand((3, 14, 12), generator=gen)
    srcs = torch.tensor([[1.0, 2.0], [12.0, 10.0], [6.5, 5.5]])
    T0, frozen = seed_source(s, srcs, grid, 2.0)
    return grid, s, T0, frozen


@pytest.mark.parametrize("solver", ["sweep", "transport"])
@pytest.mark.parametrize("cycle", ["flagged", "plain"])
def test_host_syncs_count_the_solve_loops_reads(solver, cycle):
    """``host_syncs`` rises by one per counted iteration of the solve loop
    (the done test), one more for the transport's tolerance copied to the
    device, and, under the plain cycle, by its own reads: the any-done test
    on each iteration, and the all-done test and the active fields' indices
    on each iteration that starts with a field done."""
    grid, s, T0, frozen = _sweep_inputs()
    floor = seed_floor(T0, frozen)
    sp = grid.spacing
    if solver == "sweep":
        plain = lambda T, s_, f, n_inner, done=None: sweep_cycle_plain(
            T, s_, f, sp, n_inner, done)
        run = lambda c: sweep_solve(
            T0, floor, s, sp, 1e-4, 50, 2, return_cycles=True,
            cycle=lambda T, s_, f, _sp, n, done=None: c(T, s_, f, n, done))
        extra = 0
    else:
        T = sweep_solve(T0, floor, s, sp, 1e-5, 50, 2)
        ws = transport_weights(T, s, frozen, sp)
        g = 0.1 * torch.randn(T.shape, generator=torch.Generator()
                              .manual_seed(8))
        plain = lambda lam, g_, w, n_inner, done=None: transport_cycle_plain(
            lam, g_, w, n_inner, done)
        run = lambda c: transport_solve(g, ws, 1e-4, 50, 2, cycle=c,
                                        return_cycles=True)
        extra = 1
    c = _flagged(plain) if cycle == "flagged" else plain
    before = trace.COUNTERS.host_syncs
    _, cycles = run(c)
    syncs = trace.COUNTERS.host_syncs - before
    iters, fresh = int(cycles.max()), int(cycles.min())
    assert iters > fresh >= 1
    if cycle == "flagged":
        assert syncs == extra + iters
    else:
        assert syncs == extra + iters + fresh + 3 * (iters - fresh)


@pytest.mark.parametrize("sigma,probes", [(0.05, 31), (100.0, 1)])
def test_host_syncs_over_one_smc_stage(sigma, probes):
    """One stage on a conjugate toy (no solve): ``next_beta``'s probes
    (beta = 1 alone when the whole step keeps the ESS, else it and the 30
    bisection steps), each two increments copied to the device and an ESS
    read back; the stage's ESS likewise; the resampling's increments (2),
    the mutation's beta (1), and the log-evidence increment and the
    acceptance read back (2)."""
    toy = GaussToy([0.3, -0.2], sigma)
    gen = torch.Generator().manual_seed(11)
    state = smc.init_particles(toy, gen, 256, 0.5)
    before = trace.COUNTERS.host_syncs
    _, beta, *_ = smc.stage(toy, state, 0.0, gen, 3, 128.0)
    assert (beta == 1.0) == (probes == 1)
    assert trace.COUNTERS.host_syncs - before == 3 * probes + 3 + 2 + 1 + 2
