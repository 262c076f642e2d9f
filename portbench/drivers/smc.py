"""The SMC driver: the program's tempered SMC, stage after stage, the ladder
started again from fresh prior particles whenever it reaches beta = 1.

Set-up, as the program's ``samplers.smc.setup`` and ``init_particles`` (the
posterior over the benchmark's data instead of the program's own dataset):
the particles drawn from the prior with their log prior and log likelihood,
then ``warmup_stages`` stages, so that every shape of the window has run.
The window calls ``samplers.smc.stage``; a stage that ends at beta = 1 is
followed, inside the window, by ``init_particles`` of a fresh population
from the same generator and beta = 0.

Work: a stage is ``n_mutation_steps`` steps of every particle, each one
eikonal field per particle and source; a fresh population solves one field
per particle and source more.

The checks, at the population the window's last stage made (before a
restart, where that stage ended the ladder), on ``check_particles``
particles drawn from the run's seed: ``lp_rel_gap``, the larger of the
particle's cached log likelihood's and log prior's gaps to the reference's,
``|x - x_ref| / max(1, |x_ref|)``; and ``stuck``, the share of all the
particles whose ``u`` is a row of the population that stage started from:
its mutation moved none of them (resampling only copies rows). A stage
handed back as it came, or one whose mutation leaves half the particles
where resampling put them, reads 1 or more than half.
"""

from __future__ import annotations

from typing import Dict

import torch
from mceik_tpu_torch.samplers import smc

from benchlib import port
from benchlib.compare import rel_gap, seen


class Run:
    phases: Dict[str, float]   # set-up seconds by phase

    def __init__(self, cell, data, seed: int, device):
        w = cell.workload
        self.cfg = cfg = port.run_config(cell, seed)
        scfg = cfg.sampler
        self.post = port.posterior(cfg, data, device, False)
        self.gen = torch.Generator(device=device).manual_seed(scfg.seed)
        self.n, self.k = scfg.n_particles, scfg.n_mutation_steps
        self.step_size = scfg.step_size
        self.target = scfg.ess_threshold * self.n
        n_tab = min(data["src"].shape[0], data["rec"].shape[0])
        self.fields = self.n * n_tab
        clock = port.Clock(device)
        self.state = smc.init_particles(self.post, self.gen, self.n,
                                        self.step_size)
        self.beta = 0.0
        self.last = None
        clock.lap("sampler")
        for _ in range(w["warmup_stages"]):
            self.chunk()
        clock.lap("warmup")
        self.phases = clock.laps
        g = torch.Generator().manual_seed(seed % (1 << 63))
        self.sample = torch.randperm(self.n, generator=g)[
            :w["check_particles"]].to(device)

    def shapes(self):
        return port.shapes(self.cfg, self.fields)

    def chunk(self):
        before = self.state
        self.state, self.beta, *_ = smc.stage(
            self.post, before, self.beta, self.gen, self.k, self.target)
        self.last = (before, self.state)
        fields = self.k * self.fields
        if self.beta >= 1.0:
            self.state = smc.init_particles(self.post, self.gen, self.n,
                                                 self.step_size)
            self.beta = 0.0
            fields += self.fields
        return {"steps": self.k * self.n, "forward_fields": fields,
                "transport_fields": 0}

    def start_window(self):
        self.last = None

    def release(self):
        (before, s), i = self.last, self.sample
        self.final = {"u": s.params.u[i], "prior": s.log_prior[i],
                      "lik": s.log_lik[i]}
        self.before, self.after = before.params.u, s.params.u
        self.state = self.post = self.last = None

    def as_control(self, ref):
        """The reference ``ref`` put in the program's place."""
        u = self.final["u"]
        prior, lik = ref.terms(u)
        self.final = {"u": u, "prior": prior, "lik": lik}

    def check(self, ref):
        f = self.final
        prior, lik = ref.terms(f["u"])
        gap = torch.maximum(rel_gap(f["lik"], lik), rel_gap(f["prior"], prior))
        return {"lp_rel_gap": (gap, "max"),
                "stuck": (seen(self.after, self.before), "mean")}
