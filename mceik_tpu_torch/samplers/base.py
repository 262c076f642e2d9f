"""Generic MCMC runner: warmup with adaptation, then sampling with online
Welford moments and thinned collection.

Counterpart of ``mceik_tpu/samplers/base.py``. The chain axis is the
leading axis of every state leaf, so one kernel call advances all chains,
and the JAX package's ``scan`` becomes a Python loop. A kernel takes its
random draws as tensors, ``kernel(state, hyper, *draws)``: by default the
runner draws ``normal`` (a tree like the params) and ``uniform`` (one per
chain) from its generator; a kernel with other draws carries its own
``kernel.draw(gen, state)`` (HMC, NUTS). So a test can hand a kernel JAX's
draws instead.

Sharded over ranks (a ``mesh``, ``dist/mesh.py``) each rank holds its rows of
the chain batch. Every rank draws the whole batch's random numbers from its
generator, seeded as the others, and keeps its own rows; the pooled
acceptance is the mean over every rank's chains, the adapter sees every
rank's chains, and the traces come back gathered. So a sharded run takes the
unsharded run's steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from mceik_tpu_torch.diag.moments import Welford, welford_init, welford_update
from mceik_tpu_torch.dist.mesh import Mesh, all_gather0, draw_rows, gather_chains
from mceik_tpu_torch.io.trace import span
from mceik_tpu_torch.utils import tree_map, tree_random_normal


# The span of run_mcmc's bookkeeping between steps: the Welford update and
# the draws kept each step, the traces stacked and gathered at the end.
RECORD = "mceik.mcmc.record"


@dataclasses.dataclass
class MHState:
    """Metropolis-family chain state (leading chain axis on every leaf)."""

    params: Any
    logpost: torch.Tensor  # (C,)


@dataclasses.dataclass
class MCMCResult:
    states: MHState        # final states
    hyper: Any             # final adaptation parameters
    welford: Welford       # per-chain online moments of track_fn output
    samples: Any           # thinned draws: tree of (n_collect, C, ...)
    logpost_trace: torch.Tensor  # (n_collect, C)
    accept_trace: torch.Tensor   # (n_collect, C) mean accept prob
    # Every per-chain info entry of the kernel (accept_prob, divergent,
    # tree_depth, ...) averaged over each thinning interval: (n_collect, C).
    info_trace: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # Sharded: ``states`` and ``welford`` hold this rank's chains, the
    # traces and samples every rank's.


def init_chain_states(logpost_fn: Callable, init_params_fn: Callable,
                      gen: torch.Generator, n_chains: int) -> MHState:
    """Draw every chain's start from the model's init distribution."""
    params = init_params_fn(gen, n_chains)
    return MHState(params=params, logpost=logpost_fn(params))


def draw_normal_uniform(gen: torch.Generator, states: MHState):
    """The default draws: a standard-normal tree like the params and one
    uniform per chain, made on the generator's device (a host generator
    draws the same numbers for a run on any device)."""
    normal = tree_random_normal(gen, states.params)
    uniform = torch.rand(states.logpost.shape, generator=gen,
                         dtype=torch.float32, device=gen.device).to(
                             states.logpost.device)
    return normal, uniform


def _one_step(kernel, states: MHState, hyper, gen: torch.Generator,
              mesh: Mesh):
    with span("mceik.mcmc.step"):
        draw = getattr(kernel, "draw", draw_normal_uniform)
        return kernel(states, hyper, *draw_rows(draw, gen, states, mesh))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def run_mcmc(kernel: Callable, adapt_fn: Optional[Callable],
             init_states: MHState, init_hyper: Any, gen: torch.Generator,
             n_warmup: int, n_steps: int, thin: int = 1,
             track_fn: Optional[Callable] = None,
             finalize_fn: Optional[Callable] = None,
             collect_fn: Optional[Callable] = None,
             init_welford: Optional[Welford] = None,
             mesh: Mesh = Mesh()) -> MCMCResult:
    """Run warmup (with adaptation) then sampling (with collection).

    kernel:      (state, hyper, *draws) -> (state, info); info holds
                 "accept_prob" per chain.
    adapt_fn:    (hyper, pooled_info, states, t) -> hyper, or None.
    track_fn:    params -> tree whose online moments are accumulated every
                 sampling step (default: the params).
    collect_fn:  params -> tree stored every ``thin`` steps (default:
                 track_fn).
    finalize_fn: hyper -> hyper, applied once after warmup.
    init_welford: the previous segment's accumulator, for segmented runs.
    mesh:        the ranks the chains are sharded over (``init_states``
                 holds this rank's rows); the adapter gets every rank's
                 chains.
    """
    if track_fn is None:
        track_fn = lambda p: p
    if collect_fn is None:
        collect_fn = track_fn

    states, hyper = init_states, init_hyper
    for t in range(n_warmup):
        states, info = _one_step(kernel, states, hyper, gen, mesh)
        if adapt_fn is not None:
            # Pooled over every rank's chains.
            pooled = {k: all_gather0(v, mesh).mean(0) for k, v in info.items()}
            hyper = adapt_fn(hyper, pooled, gather_chains(states, mesh), t)
    if finalize_fn is not None:
        hyper = finalize_fn(hyper)

    n_chains = states.logpost.shape[0]
    welford = init_welford
    if welford is None:
        tracked0 = track_fn(states.params)
        welford = welford_init(tree_map(lambda x: x[0], tracked0),
                               batch_shape=(n_chains,))
    draws, lps, infos = [], [], []
    for _ in range(n_steps // thin):
        sums = None
        for _ in range(thin):
            states, info = _one_step(kernel, states, hyper, gen, mesh)
            with span(RECORD):
                welford = welford_update(welford, track_fn(states.params))
                sums = info if sums is None else {k: sums[k] + v
                                                  for k, v in info.items()}
        with span(RECORD):
            draws.append(collect_fn(states.params))
            lps.append(states.logpost)
            infos.append({k: v / thin for k, v in sums.items()})

    with span(RECORD):
        dev = states.logpost.device
        empty = torch.zeros((0, n_chains * mesh.world), dtype=torch.float32,
                            device=dev)
        # The traces of every rank's chains: (n_collect, C) on every rank.
        gather1 = lambda x: all_gather0(x.movedim(1, 0), mesh).movedim(0, 1)
        info_trace = _stack(infos) if infos else {}
        info_trace = {k: gather1(v) for k, v in info_trace.items()}
        return MCMCResult(
            states=states, hyper=hyper, welford=welford,
            samples=tree_map(gather1, _stack(draws)) if draws else None,
            logpost_trace=gather1(torch.stack(lps)) if lps else empty,
            accept_trace=info_trace.get("accept_prob", empty),
            info_trace=info_trace,
        )
