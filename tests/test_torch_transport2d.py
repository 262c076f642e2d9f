"""Parity of the PyTorch port's 2-D adjoint transport with the JAX package
on the CPU, and the 2-D gradient path it opens (config 1's geometry under
the gradient samplers). The plain 2-D transport cycle is what the CUDA
kernel K6 (``csrc/transport2d.cu``) is held against on the card; here it is
held against the TPU kernel it replaces, ``transport_axis0`` through
``transport_cycle_pallas`` in interpret mode, and its solve, batched and
field by field (the plain version of K6's solve entry), against JAX's
plain solve. Then the per-field loop against the batch host loop, bit for
bit with the cycle counts, the CPU dispatch of
``cuda_transport.transport_cycle`` on 2-D batches, divergence, K6's
shared-memory limit, the c1-shaped logpost
gradient against ``jax.value_and_grad`` and a finite difference, and HMC
with the annealed spike-slab Gibbs scan on a crosswell. Inputs are made
with numpy from seeds; tolerances are stated per test. K6 itself is tested
on the card in test_torch_cuda.py."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.eikonal import adjoint_sweep as jas
from mceik_tpu.eikonal.pallas_transport import transport_cycle_pallas
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior

from mceik_tpu_torch import api
from mceik_tpu_torch.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import tomo_data_from_jax
from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.eikonal import adjoint_sweep as tas
from mceik_tpu_torch.eikonal import cuda_transport, cuda_transport2d
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import EikonalConfig, seed_source
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.model.posterior import build_posterior, value_and_grad
from mceik_tpu_torch.samplers import hmc
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


C1_SHAPE = (17, 17)
C1_INV = (4, 4)
N_CHAINS = 3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def batch33():
    """An odd batch of three 33x29 fields at spacing (1.0, 1.25): signed
    weights from the port's own solves at tol 1e-6 (their parity with JAX's
    weights is test_torch_adjoint.py's), and cotangents g."""
    rng = np.random.default_rng(4)
    grid = Grid((33, 29), (1.0, 1.25))
    s = torch.from_numpy((1.0 + 0.4 * rng.uniform(size=(3,) + grid.shape))
                         .astype(np.float32))
    srcs = torch.tensor([[7.0, 20.5], [30.5, 2.0], [16.0, 34.0]])
    T = solve_eikonal_batched(s, srcs, grid, EikonalConfig(tol=1e-6,
                                                           max_iters=100))
    _, frozen = seed_source(s, srcs, grid, 3.0)
    ws = tas.transport_weights(T, s, frozen, grid.spacing)
    g = torch.from_numpy((0.1 * rng.standard_normal((3,) + grid.shape))
                         .astype(np.float32))
    return ws, g


@pytest.mark.parametrize("n", [1, 3], ids=["one-field", "odd-batch"])
def test_plain_cycle_matches_pallas_interpret(batch33, n):
    """One plain 2-D cycle of one 33x29 field, and of the odd batch of
    three in one call, each field against the TPU kernel's cycle
    (``transport_cycle_pallas``, interpret mode) on the same weights: atol
    1e-5 (the two sum in the same order; XLA may contract FMAs)."""
    ws, g = batch33
    out = tas.transport_cycle_plain(g[:n], g[:n], tuple(w[:n] for w in ws), 2)
    for b in range(n):
        ref = np.asarray(transport_cycle_pallas(
            jnp.asarray(g[b].numpy()), jnp.asarray(g[b].numpy()),
            tuple(jnp.asarray(w[b].numpy()) for w in ws), 2, interpret=True))
        np.testing.assert_allclose(out[b].numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("solver", ["batched", "per_field"])
def test_plain_solve_matches_jax_plain_solve(batch33, solver):
    """The port's plain 2-D solve, batched and field by field
    (``transport_solve_fields_plain``, the plain version of K6's solve
    entry), against JAX's ``transport_solve(use_pallas="off")`` at tol
    1e-7, per field: atol 1e-5 (the bar of test_torch_adjoint.py in 3-D),
    and a fixed-point residual under ``apply_WT`` below 1e-5."""
    ws, g = batch33
    if solver == "batched":
        lam = tas.transport_solve(g, ws, 1e-7, 100)
    else:
        lam = tas.transport_solve_fields_plain(g, ws, 1e-7, 100)[0]
    for b in range(g.shape[0]):
        ref = np.asarray(jas.transport_solve(
            jnp.asarray(g[b].numpy()),
            tuple(jnp.asarray(w[b].numpy()) for w in ws), tol=1e-7,
            max_cycles=100, use_pallas="off"))
        np.testing.assert_allclose(lam[b].numpy(), ref, atol=1e-5)
    resid = lam - (tas.apply_WT(lam, ws) + g)
    assert float(resid.abs().max()) < 1e-5


def test_cpu_dispatch_reaches_plain_cycle_and_divergence_is_nan(batch33):
    """A CPU 2-D batch through ``cuda_transport.transport_cycle`` equals
    the plain cycle bit for bit, a done field passes through, K6's launch
    count stays put, and nothing raises. A solve of the batch with a
    divergent field appended (node pairs feeding each other with weight
    1.3) gives NaN in that field alone and the others' lone solves."""
    ws, g = batch33
    done = torch.tensor([False, True, False])
    launches = cuda_transport2d.TRANSPORT2D.launches
    out = cuda_transport.transport_cycle(g, g, ws, 2, done)
    assert cuda_transport2d.TRANSPORT2D.launches == launches
    assert torch.equal(out, tas.transport_cycle_plain(g, g, ws, 2, done))
    assert torch.equal(out[1], g[1])
    div = []
    for d, n in enumerate(g.shape[1:]):
        idx = torch.arange(n).reshape([-1 if e == d else 1 for e in range(2)])
        div.append(torch.where(idx % 2 == 0, -1.3, 1.3).expand(g.shape[1:]))
    wd = tuple(torch.cat([w, dv[None]]) for w, dv in zip(ws, div))
    gd = torch.cat([g, torch.ones_like(g[:1])])
    lam = tas.transport_solve(gd, wd, 1e-6, 30,
                              cycle=cuda_transport.transport_cycle)
    assert torch.isnan(lam[3]).all() and torch.isfinite(lam[:3]).all()
    assert torch.equal(lam[:3], tas.transport_solve(g, ws, 1e-6, 30))


@pytest.mark.parametrize("kernel", ["TRANSPORT3D", "TRANSPORT3D_LARGE"])
def test_3d_kernel_on_2d_batch_raises(batch33, kernel):
    """Forcing a 3-D transport kernel (K4 or K5) on a ``(B, n0, n1)`` batch
    raises ValueError rather than running K6 or the plain cycle in its
    place; no launch count moves."""
    ws, g = batch33
    k = getattr(cuda_transport, kernel)
    counts = (k.launches, cuda_transport2d.TRANSPORT2D.launches)
    with pytest.raises(ValueError, match="takes K6"):
        cuda_transport.transport_cycle(g, g, ws, 2, kernel=k)
    assert (k.launches, cuda_transport2d.TRANSPORT2D.launches) == counts


def _bits(x):
    return x.contiguous().view(torch.int32)


def _divergent(ws, g):
    """The batch with a divergent field appended: node pairs feeding each
    other with weight 1.3, g = 1."""
    div = []
    for d, n in enumerate(g.shape[1:]):
        idx = torch.arange(n).reshape([-1 if e == d else 1 for e in range(2)])
        div.append(torch.where(idx % 2 == 0, -1.3, 1.3).expand(g.shape[1:]))
    return (tuple(torch.cat([w, dv[None]]) for w, dv in zip(ws, div)),
            torch.cat([g, torch.ones_like(g[:1])]))


@pytest.mark.parametrize("case", ["mixed", "divergent", "nan_in_g"])
def test_per_field_loop_equals_batch_loop(batch33, case):
    """The plain per-field transport loop (each field alone until it
    converges or diverges) equals the batch host loop ``transport_solve``
    bit for bit, compared as int32 (NaN included), with the same per-field
    cycle counts, on the odd batch at tol 1e-6 (fields converge at
    different cycles), with a divergent field appended (all NaN in both,
    stopped by the divergence test), and with a NaN in one field's g; and
    ``cuda_transport.solve`` on these CPU tensors is that host loop."""
    ws, g = batch33
    g = g * torch.tensor([1.0, 30.0, 0.01]).reshape(3, 1, 1)
    if case == "divergent":
        ws, g = _divergent(ws, g)
    if case == "nan_in_g":
        g = g.clone()
        g[1, 4, 7] = float("nan")
    ref, ref_cycles = tas.transport_solve(g, ws, 1e-6, 40,
                                          return_cycles=True)
    out, cycles = tas.transport_solve_fields_plain(g, ws, 1e-6, 40)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(cycles, ref_cycles)
    launches = cuda_transport2d.TRANSPORT2D.launches
    assert torch.equal(_bits(cuda_transport.solve(g, ws, 1e-6, 40)),
                       _bits(ref))
    assert cuda_transport2d.TRANSPORT2D.launches == launches
    counts = cycles.tolist()
    if case == "mixed":
        assert len(set(counts)) > 1 and max(counts) < 40
    elif case == "divergent":
        assert torch.isnan(out[3]).all() and torch.isfinite(out[:3]).all()
        assert counts[3] < 40
    else:
        assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()


def test_k6_wrapper_limits_and_refusals():
    """K6's wrapper states its shared-memory limit (four fp32 fields: 120^2
    but not 121^2) before it looks at the device, refuses CPU tensors, a
    wrong weight count, a line longer than a warp holds and a solve of more
    than one cycle per iteration; without nvcc its build raises."""
    assert cuda_transport2d.field_limit().startswith(
        "4 fp32 fields of the whole grid fit 120^2 (14400 nodes) but not "
        "121^2")
    assert cuda_transport2d.smem_bytes((65, 65)) == 4 * 4 * 65 * 65
    big = torch.zeros((1, 121, 121))
    with pytest.raises(ValueError, match="120\\^2 .* but not 121\\^2"):
        cuda_transport2d.TRANSPORT2D.cycle(big, big, (big, big), 2)
    x = torch.zeros((2, 65, 65))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_transport2d.TRANSPORT2D.cycle(x, x, (x, x), 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_transport2d.TRANSPORT2D.solve(x, (x, x), 1e-6, 10)
    with pytest.raises(ValueError, match="two weight fields"):
        cuda_transport2d.TRANSPORT2D.cycle(x, x, (x, x, x), 2)
    with pytest.raises(ValueError, match="at most 1024 nodes"):
        long = torch.zeros((1, 3, 1025))
        cuda_transport2d.TRANSPORT2D.cycle(long, long, (long, long), 2)
    with pytest.raises(ValueError, match="one cycle per counted"):
        cuda_transport2d.TRANSPORT2D.solve(x, (x, x), 1e-6, 10,
                                           cycles_per_iter=2)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_transport2d.Transport2dKernel().build()


def _c1_cfgs(use_pallas="off", tol=1e-5):
    dkw = dict(dataset="crosswell2d", n_src=4, n_rec=6, noise=0.01, seed=3,
               checker_cells=(2, 2), checker_amplitude=0.1)
    mkw = dict(mode="tomo", inv_shape=C1_INV, prior_sigma_u=0.2, sigma=0.01)
    ekw = dict(method="sweep", tol=tol, max_iters=100, use_pallas=use_pallas)
    return dkw, mkw, ekw


@pytest.fixture(scope="module")
def c1_models():
    """Config 1's model at a cut size (17^2 crosswell, 4^2 basis, 4
    sources, 6 receivers) in both packages on JAX's data, and JAX's
    ``value_and_grad`` of the logpost for three chains."""
    dkw, mkw, ekw = _c1_cfgs()
    jgrid = JGrid(C1_SHAPE, (1.0, 1.0))
    jdata, _ = j_make_dataset(jgrid, JDataCfg(**dkw), JModelCfg(**mkw))
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**ekw), differentiable=True)
    u = np.random.default_rng(0).normal(0, 0.05, (N_CHAINS,) + C1_INV)
    u = u.astype(np.float32)
    jlp, jg = jax.jit(jax.vmap(jax.value_and_grad(jpost.logpost)))(
        JParams(u=jnp.asarray(u)))
    return dict(data=tomo_data_from_jax(jdata), u=u, jlp=np.asarray(jlp),
                jgrad=np.asarray(jg.u))


def _rel_l2(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


@pytest.mark.parametrize("use_pallas", ["on", "off"])
def test_c1_shaped_gradient_matches_jax(c1_models, use_pallas):
    """The port's 2-D logpost and gradient (its own solves, then the
    implicit adjoint with the 2-D transport) against
    ``jax.value_and_grad`` of JAX's posterior per chain, at the bars
    test_torch_adjoint.py holds 3-D to: logpost rtol 2e-5, gradient
    relative L2 <= 1e-4. With the kernels' route on ("on": the forward
    through ``cuda_sweep.solve`` and the transport through
    ``cuda_transport.solve``, each of which takes its plain version for
    these CPU tensors) and off."""
    m = c1_models
    _, mkw, ekw = _c1_cfgs(use_pallas)
    post = build_posterior(ModelCfg(**mkw), m["data"], Grid(C1_SHAPE, (1.0, 1.0)),
                           EikonalCfg(**ekw), differentiable=True)
    lp, g = value_and_grad(post.logpost)(Params(u=_t(m["u"])))
    np.testing.assert_allclose(lp.numpy(), m["jlp"], rtol=2e-5)
    for c in range(N_CHAINS):
        assert _rel_l2(g.u[c].numpy(), m["jgrad"][c]) <= 1e-4


def test_c1_shaped_gradient_matches_finite_difference(c1_models):
    """The port's 2-D gradient against a central finite difference of its
    own logpost along a random direction per chain, at solver tol 1e-7:
    relative error < 0.1 (the bar of tests/test_adjoint.py)."""
    m = c1_models
    _, mkw, ekw = _c1_cfgs("on", tol=1e-7)
    post = build_posterior(ModelCfg(**mkw), m["data"], Grid(C1_SHAPE, (1.0, 1.0)),
                           EikonalCfg(**ekw), differentiable=True)
    u = _t(m["u"])
    _, g = value_and_grad(post.logpost)(Params(u=u))
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (N_CHAINS,) + C1_INV).astype(np.float32))
    v = v / v.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    eps = 1e-3
    fd = (post.logpost(Params(u=u + eps * v))
          - post.logpost(Params(u=u - eps * v))) / (2 * eps)
    ad = (g.u * v).flatten(1).sum(1)
    rel = ((ad - fd).abs() / torch.maximum(ad.abs(), fd.abs())).max()
    assert float(rel) < 0.1


def test_hmc_with_annealed_gibbs_on_crosswell(monkeypatch):
    """tests/test_spike_slab.py's pairing, HMC over the continuous leaves
    and the exact Gibbs scan over the station indicators after the annealed
    warmup, on the port's crosswell cut to 17^2, 8 sources, 4 receivers, 2
    chains, 1 leapfrog step, the shortest annealed warmup (one step per
    rung and one more) and 2 sampling steps at tol 1e-3, with the kernels'
    route on: every transport cycle goes through
    ``cuda_transport.transport_cycle`` (its plain version on these CPU
    tensors); logposts stay finite and the indicators in {0, 1}. (The
    recovery itself is test_torch_noise.py::
    test_spike_slab_recovers_noisy_stations.)"""
    grid = Grid(C1_SHAPE, (1.0, 1.0))
    dkw, _, ekw = _c1_cfgs("on", tol=1e-3)
    dkw.update(n_src=8, n_rec=4, noise=0.005)
    mcfg = ModelCfg(mode="tomo", inv_shape=C1_INV, prior_sigma_u=0.15,
                    sigma=0.005, noise_model="spike_slab", noise_p0=0.15,
                    sigma_hyper=1.5)
    ecfg = EikonalCfg(**ekw)
    data, _ = make_dataset(grid, DataCfg(**dkw), mcfg, ecfg)
    post = build_posterior(mcfg, data, grid, ecfg, differentiable=True)
    calls = []
    cycle = cuda_transport.transport_cycle

    def counting(lam, *a, **kw):
        calls.append(lam.shape)
        return cycle(lam, *a, **kw)

    monkeypatch.setattr(cuda_transport, "transport_cycle", counting)
    gen = torch.Generator().manual_seed(1)
    base = hmc.make_kernel(post.logpost, n_leapfrog=1)
    states = init_chain_states(post.logpost, post.init_params, gen, 2)
    hyper = hmc.init_hyper(post.prior_scales, 0.02, post.prior_scales)
    kernel, states, hyper, _ = api.with_noise_gibbs(
        post, base, hmc.make_adapter(), states, hyper, hmc.finalize, gen, 4)
    result = run_mcmc(kernel, None, states, hyper, gen, n_warmup=0, n_steps=2)
    assert calls and all(len(s) == 3 for s in calls)
    assert torch.isfinite(result.states.logpost).all()
    z = result.samples.noise_z
    assert bool(((z == 0) | (z == 1)).all())
