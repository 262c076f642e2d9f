"""The MCMC driver: a chain sampler of the program, stepped in chunks.

Set-up, as the program's own profiler sets a sampler up: the posterior over
the benchmark's data, ``api._dispatch_sampler`` (the chains' starts, and
MALA's Laplace set-up: the MAP ascent and the Gauss-Newton covariance),
``api.with_noise_gibbs``, then the sampler's ``n_warmup`` adapted steps
and one sampling chunk, so that every shape of the window has run. The
window calls ``samplers.base.run_mcmc(kernel, None, states, hyper, gen,
n_warmup=0, n_steps=chunk_steps)``.

Work: a step is one step of every chain, and it solves one eikonal field
per chain and source (one batched ``logpost``); a gradient sampler's step
also one transport field each (one batched ``value_and_grad``).

The checks, at the window's last states, every chain, against the
reference's log prior and log likelihood (and with a gradient sampler their
gradients) at the chain's ``u``: ``lp_rel_gap``, the chain's cached log
posterior against theirs, ``|lp - (prior + lik)| / max(1, |prior| +
|lik|)``; ``grad_rel_gap``, its cached gradient against theirs, ``|g -
(g_prior + g_lik)| / (|g_prior| + |g_lik|)`` (L2 norms over the chain's
coordinates); ``stuck``, the share of chains whose ``u`` the window left
unchanged. The scales are the two terms' sizes, not their sum's: near the
posterior's mode the two nearly cancel.

MALA also ``accept_gap``: the window's last step, every chain, replayed by
the reference (``reference/mala.py``) from the state the program stepped
from, with the program's own draws for that step, step size and
preconditioner (the program's state, which the reference cannot work out
again). It is the largest distance, in log probability, by which a chain's
move or stay lies on the wrong side of the reference's decision: a chain
that stays where the reference accepts, or moves where it rejects.
"""

from __future__ import annotations

from typing import Dict

import torch
from mceik_tpu_torch.api import (_dispatch_sampler, _uses_gradients,
                                 with_noise_gibbs)
from mceik_tpu_torch.dist.mesh import Mesh, draw_rows
from mceik_tpu_torch.samplers import mala
from mceik_tpu_torch.samplers.base import draw_normal_uniform, run_mcmc

from benchlib import port
from benchlib.compare import unchanged
from reference import mala as mala_ref


class Run:
    phases: Dict[str, float]   # set-up seconds by phase

    def __init__(self, cell, data, seed: int, device):
        w = cell.workload
        self.cfg = cfg = port.run_config(cell, seed)
        scfg = cfg.sampler
        self.gradient = _uses_gradients(scfg)
        self.mala = scfg.algorithm == "mala"
        self.post = port.posterior(cfg, data, device, self.gradient)
        self.gen = torch.Generator(device=device).manual_seed(scfg.seed)
        clock = port.Clock(device)
        kernel, adapter, hyper, finalize, states, _ = _dispatch_sampler(
            scfg, self.post, self.gen, None)
        kernel, states, hyper, n_warm = with_noise_gibbs(
            self.post, kernel, adapter, states, hyper, finalize, self.gen,
            scfg.n_warmup)
        clock.lap("sampler")
        r = run_mcmc(kernel, adapter, states, hyper, self.gen,
                     n_warmup=n_warm, n_steps=0, finalize_fn=finalize)
        self.kernel, self.states, self.hyper = kernel, r.states, r.hyper
        self.k = w["chunk_steps"]
        self.n_chains = scfg.n_chains
        self.fields = scfg.n_chains * min(data["src"].shape[0],
                                          data["rec"].shape[0])
        self.chunk()
        clock.lap("warmup")
        self.phases = clock.laps
        self.start = None

    def shapes(self):
        return port.shapes(self.cfg, self.fields)

    def chunk(self):
        self.last = (self.states, self.gen.get_state())
        r = run_mcmc(self.kernel, None, self.states, self.hyper, self.gen,
                     n_warmup=0, n_steps=self.k)
        self.states, self.samples = r.states, r.samples
        fields = self.k * self.fields
        return {"steps": self.k * self.n_chains, "forward_fields": fields,
                "transport_fields": fields if self.gradient else 0}

    def start_window(self):
        self.start = self.states.params.u.clone()

    def release(self):
        s = self.states
        self.final = {"u": s.params.u, "lp": s.logpost,
                      "grad": s.grad.u if self.gradient else None}
        self.step = self._last_step() if self.mala else None
        self.kernel = self.states = self.hyper = self.post = None
        self.last = self.samples = None

    def _last_step(self):
        """The window's last step as the reference replays it: the state it
        stepped from, the program's draws for it (drawn again from the
        generator's state before the last chunk), its step size and
        preconditioner, and which chains moved."""
        before, gen_state = self.last
        u = self.samples.u
        x = u[-2] if u.shape[0] > 1 else before.params.u
        if mala._ravel(self.states.params, batch_dims=1).shape[1] \
                != x[0].numel():
            raise ValueError("the replay covers chains whose only leaf is u")
        gen = torch.Generator(device=self.gen.device)
        gen.set_state(gen_state)
        draw = getattr(self.kernel, "draw", draw_normal_uniform)
        for _ in range(u.shape[0]):
            normal, uniform = draw_rows(draw, gen, self.states, Mesh())
        h = self.hyper
        return {"x": x, "xi": normal.u.reshape(x.shape[0], -1),
                "log_u": torch.log(uniform), "eps": torch.exp(h.log_step),
                "L": mala._chol_unmasked(h),
                "active": (h.scales_flat > 0).to(x.dtype),
                "moved": (u[-1] != x).flatten(1).any(1)}

    def as_control(self, ref):
        """The reference ``ref`` put in the program's place: its own values
        at the program's last states become the ones checked."""
        u = self.final["u"]
        if self.gradient:
            r = ref.gradient_terms(u)
            self.final = {"u": u, "lp": r["prior"] + r["lik"],
                          "grad": r["g_prior"] + r["g_lik"]}
        else:
            prior, lik = ref.terms(u)
            self.final = {"u": u, "lp": prior + lik, "grad": None}

    def check(self, ref):
        f = self.final
        u = f["u"]
        if self.gradient:
            r = ref.gradient_terms(u)
        else:
            r = dict(zip(("prior", "lik"), ref.terms(u)))
        scale = (r["prior"].abs() + r["lik"].abs()).clamp(min=1.0)
        out = {"lp_rel_gap": ((f["lp"] - (r["prior"] + r["lik"])).abs()
                              / scale, "max"),
               "stuck": (unchanged(u, self.start), "mean")}
        if self.gradient:
            norm = lambda x: x.flatten(1).norm(dim=1)
            g_ref = r["g_prior"] + r["g_lik"]
            out["grad_rel_gap"] = (norm(f["grad"] - g_ref)
                                   / (norm(r["g_prior"]) + norm(r["g_lik"])),
                                   "max")
        if self.step is not None:
            st = self.step
            lr = mala_ref.log_ratio(ref, st["x"], st["xi"], st["eps"],
                                    st["L"], st["active"])
            out["accept_gap"] = (mala_ref.wrong_side(lr, st["log_u"],
                                                     st["moved"]), "max")
        return out
