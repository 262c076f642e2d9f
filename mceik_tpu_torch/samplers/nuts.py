"""The No-U-Turn sampler: iterative multinomial NUTS, in lockstep across
chains.

Counterpart of ``mceik_tpu/samplers/nuts.py``. The trajectory doubles up
to ``max_tree_depth`` times; doubling ``d`` simulates ``2^d`` leapfrog
steps in one direction with

- one checkpoint slot per level for the sub-tree U-turn checks: a complete
  subtree of size ``2^k`` ends at in-subtree leaf ``i`` iff
  ``(i + 1) % 2^k == 0``, and its first leaf is the last stored level-k
  block start;
- multinomial (reservoir) sampling of the proposal within the subtree,
  with log-weights ``H0 - H``, and biased progressive acceptance of the
  subtree's proposal against the trajectory so far;
- divergence (energy error > 1000) and the generalized U-turn criterion
  ``(z+ - z-) . (M^-1 r-+) < 0`` on forward-time momenta.

Chains advance in lockstep: every leaf is ONE batched ``value_and_grad``
for all C chains (one forward and one transport solve of the whole batch),
and per-chain masks stand in for the reference's ``tree_where``. Positions,
momenta and gradients are flat ``(C, d)`` tensors, the checkpoint stacks
one ``(C, d)`` slot per level.

The reference runs the full ``2^max_tree_depth - 1`` leaves for every
chain (vmap cannot stop early). Once every chain has stopped, later
doublings change nothing, and once every chain's subtree has gone inactive
(one leaf past its turn or divergence, which can still flag divergence)
later leaves change nothing; the port ends those loops there, at one host
sync per leaf. The results equal the full budget's. With the chains
sharded over ranks (``mesh``) both exits are decided over every rank's
chains, so that the ranks leave their loops together.

Step size and mass adaptation are hmc.py's (``hmc.make_adapter``,
``hmc.finalize``). The kernel takes its draws as tensors (``draw`` below):
the momentum normals, per depth a direction bit and an acceptance uniform,
and per leaf a reservoir uniform, so a test can replay JAX's.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from mceik_tpu_torch.dist.mesh import Mesh, any_rank
from mceik_tpu_torch.model.posterior import value_and_grad
from mceik_tpu_torch.samplers.am_full import _ravel, _unravel_fn
from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.samplers.hmc import HMCHyper
from mceik_tpu_torch.utils import tree_random_normal


def _col(x: torch.Tensor) -> torch.Tensor:
    """``(C,)`` -> ``(C, 1)``, to broadcast over the flat parameter axis."""
    return x.unsqueeze(1)


def _where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(_col(pred) if a.ndim == 2 else pred, a, b)


def make_kernel(logpost_fn: Callable, max_tree_depth: int = 6,
                divergence_threshold: float = 1000.0,
                mesh: Mesh = Mesh()) -> Callable:
    """NUTS transition over all chains: ``(state, hyper, normal, go_right,
    u_accept, u_leaf) -> (state, info)`` with ``go_right`` ``(C, depth)``
    bool, ``u_accept`` ``(C, depth)`` and ``u_leaf`` ``(C, 2^depth - 1)``
    (doubling ``d``'s leaves at ``2^d - 1 + i``). ``logpost_fn`` is built
    with ``differentiable=True``; ``mesh`` is the ranks the chains are
    sharded over."""
    vag_tree = value_and_grad(logpost_fn)
    n_leaf_draws = 2 ** max_tree_depth - 1

    def kernel(state: MHState, hyper: HMCHyper, normal: Any,
               go_right: torch.Tensor, u_accept: torch.Tensor,
               u_leaf: torch.Tensor):
        unravel = _unravel_fn(state.params, batch_dims=1)

        def vag(x):
            lp, g = vag_tree(unravel(x))
            return lp, _ravel(g, batch_dims=1)

        inv_mass = _ravel(hyper.inv_mass)                      # (d,)
        eps = torch.exp(hyper.da.log_eps)

        def kin(r):
            return 0.5 * (r * (inv_mass * r)).sum(1)

        def turn(dz, r_a, r_b):
            return (((dz * (inv_mass * r_a)).sum(1) < 0.0)
                    | ((dz * (inv_mass * r_b)).sum(1) < 0.0))

        r0 = _ravel(normal, batch_dims=1) * torch.rsqrt(
            torch.clamp(inv_mass, min=1e-12))
        z0 = _ravel(state.params, batch_dims=1)
        lp0 = state.logpost
        _, g0 = vag(z0)                  # afresh, as the reference does
        H0 = -lp0 + kin(r0)
        C = z0.shape[0]
        dev = z0.device
        false = torch.zeros(C, dtype=torch.bool, device=dev)
        zero = torch.zeros(C, dtype=torch.float32, device=dev)

        z_minus, r_minus, g_minus = z0, r0, g0
        z_plus, r_plus, g_plus = z0, r0, g0
        z_prop, lp_prop = z0, lp0
        log_w_total = zero
        stopped, diverged, moved = false, false, false
        accept_sum, n_leaves = zero, zero
        depth_reached = torch.zeros(C, dtype=torch.int64, device=dev)

        for depth in range(max_tree_depth):
            if not any_rank(~stopped.all(), mesh):
                break                    # later doublings change nothing
            right = go_right[:, depth]
            step = _col(torch.where(right, 1.0, -1.0) * eps)
            z = _where(right, z_plus, z_minus)
            r = _where(right, r_plus, r_minus)
            g = _where(right, g_plus, g_minus)
            zc = [z] * max_tree_depth
            rc = [r] * max_tree_depth
            z_sub, lp_sub = z, zero
            log_w_sub = torch.full((C,), -math.inf, device=dev)
            turned, sub_div, sub_acc = false, false, zero
            was_active = ~stopped

            for i in range(2 ** depth):
                active = ~(turned | sub_div)
                r_n = r + 0.5 * step * g
                z_n = z + step * inv_mass * r_n
                lp_n, g_n = vag(z_n)
                r_n = r_n + 0.5 * step * g_n
                dH = H0 - (-lp_n + kin(r_n))
                dH = torch.where(torch.isfinite(dH), dH,
                                 torch.full_like(dH, -math.inf))
                div_n = dH < -divergence_threshold
                acc_n = torch.exp(torch.clamp(dH, max=0.0))

                # Reservoir multinomial sampling within the subtree.
                log_w_n = torch.logaddexp(log_w_sub, dH)
                take = torch.log(u_leaf[:, 2 ** depth - 1 + i]) < dH - log_w_n
                z_sub_n = _where(take, z_n, z_sub)
                lp_sub_n = torch.where(take, lp_n, lp_sub)

                # Slot k holds the start of the current level-k block.
                zc_n = [z_n if i % 2 ** k == 0 else zc[k]
                        for k in range(max_tree_depth)]
                rc_n = [r_n if i % 2 ** k == 0 else rc[k]
                        for k in range(max_tree_depth)]
                turned_n = false
                for k in range(1, min(depth, max_tree_depth - 1) + 1):
                    if (i + 1) % 2 ** k == 0:
                        turned_n = turned_n | turn(
                            _col(torch.where(right, 1.0, -1.0))
                            * (z_n - zc_n[k]), rc_n[k], r_n)

                # Frozen once inactive (turned or diverged mid-subtree).
                z, r, g = (_where(active, a, b) for a, b in
                           ((z_n, z), (r_n, r), (g_n, g)))
                zc = [_where(active, a, b) for a, b in zip(zc_n, zc)]
                rc = [_where(active, a, b) for a, b in zip(rc_n, rc)]
                z_sub = _where(active, z_sub_n, z_sub)
                lp_sub = torch.where(active, lp_sub_n, lp_sub)
                log_w_sub = torch.where(active, log_w_n, log_w_sub)
                sub_acc = torch.where(active, sub_acc + acc_n, sub_acc)
                turned = turned | turned_n
                sub_div = sub_div | div_n
                # A chain inactive at this leaf's start has computed its one
                # leaf past the turn; the rest would repeat it.
                if not any_rank((was_active & active).any(), mesh):
                    break

            # The subtree counts only if the whole doubling is clean and
            # the chain had not stopped; biased progressive acceptance.
            clean = ~(turned | sub_div)
            use = was_active & clean
            take_new = use & (torch.log(u_accept[:, depth])
                              < log_w_sub - log_w_total)
            z_prop = _where(take_new, z_sub, z_prop)
            lp_prop = torch.where(take_new, lp_sub, lp_prop)
            moved = moved | take_new
            log_w_total = torch.where(
                use, torch.logaddexp(log_w_total, log_w_sub), log_w_total)

            upd_plus, upd_minus = use & right, use & ~right
            z_plus, r_plus, g_plus = (_where(upd_plus, a, b) for a, b in
                                      ((z, z_plus), (r, r_plus), (g, g_plus)))
            z_minus, r_minus, g_minus = (
                _where(upd_minus, a, b) for a, b in
                ((z, z_minus), (r, r_minus), (g, g_minus)))
            overall_turn = turn(z_plus - z_minus, r_minus, r_plus)

            accept_sum = accept_sum + torch.where(was_active, sub_acc, zero)
            n_leaves = n_leaves + torch.where(was_active,
                                              torch.full_like(zero, 2 ** depth),
                                              zero)
            depth_reached = torch.where(was_active,
                                        torch.full_like(depth_reached,
                                                        depth + 1),
                                        depth_reached)
            diverged = diverged | (was_active & sub_div)
            stopped = stopped | ~clean | overall_turn

        info = {"accept_prob": accept_sum / torch.clamp(n_leaves, min=1.0),
                "accepted": moved.to(torch.float32),
                "divergent": diverged.to(torch.float32),
                "tree_depth": depth_reached.to(torch.float32)}
        return MHState(params=unravel(z_prop), logpost=lp_prop), info

    def draw(gen: torch.Generator, state: MHState):
        shape = state.logpost.shape + (max_tree_depth,)
        u = lambda s: torch.rand(s, generator=gen, dtype=torch.float32,
                                 device=state.logpost.device)
        return (tree_random_normal(gen, state.params), u(shape) < 0.5,
                u(shape), u(state.logpost.shape + (n_leaf_draws,)))

    kernel.draw = draw
    return kernel
