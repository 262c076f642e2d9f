#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mceik_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build of every kernel on the main paths from the sources in the
   checkout, one ``nvcc`` per source, all started together: K1, the 3-D
   sweep cycle with the seed floor computed in the kernel from four scalars
   per field (``csrc/sweep3d.cu``; every 3-D route, the gridbatch one
   included), K4, the adjoint transport cycle
   (``csrc/transport3d.cu``), K3, the 2-D sweep cycle
   (``csrc/sweep2d.cu``), K5, the adjoint transport cycle of fields
   whose planes K4 cannot hold (the second entry point of
   ``csrc/transport3d.cu``, built with K4), K6, the 2-D adjoint transport
   (``csrc/transport2d.cu``); K3 and K6 run a cycle, or each field's whole
   solve, per launch, and include ``csrc/line2d.cuh``; K3 has two routes
   (kernels) in its source, a warp per field and a CTA per field;
3. K1 against its plain PyTorch version on the card, at the main path's
   shapes and on edge cases (bar: bit for bit, ``torch.equal``, one cycle
   against ``sweep_seeded_cycle_plain`` and whole solves against the plain
   route's);
4. K4 against its plain version (bar: bit for bit, compared as int32 so
   that NaN and signed zeros count; one cycle and a whole solve): the
   main-path batch (16 chains x 8 sources of 64^3, cotangents of the
   config-2 log-likelihood), an odd anisotropic non-cube batch, and a mixed
   batch with a zero, contractive and divergent field (the divergent one
   must come back all NaN, the others finite); and K5 forced on the
   main-path batch against K4 (bar as K4's);
5. the logpost gradient of 16 chains at config-2 width through K1 + K4
   against the same gradient through the plain solves on the card (bar:
   1e-5 of its max abs), and against a central finite difference along one
   random direction of all chains' parameters (bar: relative error < 0.1);
6. the MALA path through the normal entry point,
   ``mceik_tpu_torch.cli.main(["run", "configs/c2_mala.json", ...])`` at the
   config's full width (16 chains, 64^3 grid, 12^3 basis, 8 sources, 12
   receivers) with only the depth cut, every kernel's launch count reset
   just before and read just after: both kernels launched, the Laplace MAP
   trace rising, every logpost finite, the acceptance in (0.05, 0.99); it
   writes a checkpoint every 30 steps (``io.checkpoint_path``);
7. the AM path of slice 1, ``configs/c2_checkerboard3d.json`` at 16
   chains, depth cut, counts reset and read the same way: K1 launched,
   logposts finite and rising; a checkpoint every 40 steps;
8. K3 against its plain versions on the card (bar: bit for bit, NaN at
   the same places, and the same per-field cycle counts), on each of its
   routes (warp and block) forced, where the grid fits it: its cycle entry
   against ``sweep_seeded_cycle_plain`` and its solve entry (each field's
   whole solve in one launch) against the host loop ``sweep_solve`` around
   it, and ``seeded_cycle`` and ``solve_eikonal_batched`` one K3 launch
   each on the route the wrapper picks, on (a) config
   4's batch, 10,000 prior-drawn particles x 8 crosswell sources = 80,000
   fields of 48^2 at tol 1e-3, (b) config 1's batch, 4 chains x 8 sources =
   32 fields of 65^2 at tol 1e-4, and (c) an odd anisotropic non-square
   batch with done flags set, whose fields must come back untouched, and a
   field with a NaN in its slowness, NaN after its one cycle; then config
   4's log-likelihood of the 10,000 particles through K3 and through the
   plain solve (bar: rtol 1e-6);
9. config 4's tempered SMC at full width (10,000 particles, 48^2 grid)
   through ``mceik_tpu_torch.samplers.smc.run_smc_config``, the function
   the CLI calls, with the ladder capped at 3 stages, counts reset and
   read: K3's warp route launched (one launch per solve; the cycles it
   counted printed),
   beta strictly rising, each stage's ESS at its target 0.5 N (or beta =
   1), log Z and acceptance finite;
10. config 1's RWM at full width (4 chains, 65^2 grid) through
   ``mceik_tpu_torch.cli.main(["run", "configs/c1_crosswell.json", ...])``
   with the depth cut, counts reset and read: K3 launched, logposts finite
   and rising, acceptance in (0.05, 0.99);
11. K1 and K4 at config 3's batch, 8 prior-drawn chains x 16 surface
   stations = 128 fields of 48x48x32 (the non-cube route whose TPU cycle is
   ``sweep_axes01_fused`` + ``sweep_axis0``): K1 one cycle and a solve at
   the config's tol against the plain versions (bar: bit for bit, cycles
   per solve printed), K4 one cycle and a solve with cotangents of config
   3's joint log-likelihood (bar: bit for bit, as K4's above);
12. the joint gradient of 8 chains (u, hypo_raw, t0) through K1 + K4
   against the plain solves on the card (bar 1e-5 of each leaf's max abs)
   and against a central finite difference along one random direction of
   all three leaves together (bar: relative error < 0.1);
13. config 3's NUTS at full width (8 chains, 48x48x32 grid, 10x10x8 basis,
   12 events, 16 stations) through ``mceik_tpu_torch.cli.main(["run",
   "configs/c3_joint_events.json", ...])`` with only the depth cut (warmup,
   samples, max tree depth), counts reset and read: K1 and K4 launched,
   logposts finite and rising; mean tree depth, divergences and the
   acceptance statistic printed;
14. a short HMC run on config 3 through the CLI (8 leapfrog steps, 6
   warmup steps for the dual averaging to pull the config's step down): K1
   and K4 launched, logposts finite and rising;
15. K1 and K5 at config 5's 128^3 batch, 4 prior-drawn chains x 24
   surface stations = 96 fields (the route whose TPU solves are the
   blocked ones, ``sweep_solve_pallas_blocked`` and
   ``transport_solve_pallas_blocked``, whose iteration is two whole-field
   cycles, as the port's on this route): K1 one cycle against the plain
   cycle (bar: bit for bit) and a solve at the config's tol and ``max_iters`` 20
   (cycles counted, and its error to the field converged without the
   ``max_iters``), K5
   one cycle with cotangents of config 5's joint log-likelihood against the
   plain cycle (bar: bit for bit, as K4's) and a solve (cycles counted);
16. config 5's joint NUTS with spike-slab noise through
   ``mceik_tpu_torch.cli.main(["run", "configs/c5_pod_nuts.json", ...])``
   at full width (128^3 grid, 16^3 basis, 32 events, 24 stations,
   ``dist.multihost`` on, which warns and runs as one process) with 4
   chains and the depth cut (max tree depth 1, 4 warmup and 2 sampling
   steps), counts reset and read: K1 and K5 launched, logposts finite and
   rising, every indicator in {0, 1};
17. K6 against its plain versions (bar: bit for bit as int32 words, and
   the same per-field cycle counts), its cycle entry against
   ``transport_cycle_plain`` and its solve entry against the host loop
   ``transport_solve``, ``cuda_transport.solve`` one launch, on three
   batches: config 1's 32 fields of 65^2 with weights from K3's solves and
   cotangents of the config-1 log-likelihood, 80,000 prior-drawn config-4
   fields of 48^2 with weights from K3's solves, and an odd anisotropic
   batch with done flags and a divergent field, which must come back all
   NaN from both solves;
18. config 1's logpost gradient of 4 chains through K3 + K6 against the
   plain solves on the card (bar 1e-5 of its max abs) and against a central
   finite difference (bar: relative error < 0.1);
19. config 1 through ``mceik_tpu_torch.cli.main`` at full width (65^2
   grid, 16^2 basis, 8 sources, 12 receivers, 4 chains) with
   ``sampler.algorithm=nuts`` (depth cut: max tree depth 5, 30 + 30 steps)
   and with ``sampler.algorithm=mala`` (Laplace setup on 256 dims cut to 40
   MAP steps, 30 + 60 steps), counts reset and read for each: K3 (its
   block route) and K6 launched (launches and kernel-counted cycles
   printed), logposts finite
   and rising;
20. the gridbatch route on config 2's 128 fields of 64^3: the whole
   ``solve_eikonal_batched(..., impl="gridbatch")`` against
   ``impl="field"`` (bar: bit for bit; it is the same route), its K1
   launches counted from 0 over that solve;
21. (a) locate tables on config 3's geometry at full width (48x48x32, 16
   stations), the fixed model the events3d truth written with
   ``io.loaders.save_slowness`` to a ``.pt``: the first
   ``cached_traveltime_tables`` call launches K1 and writes one
   ``tables_*.pt``, the second returns ``torch.equal`` tables with zero K1
   launches, and the tables equal the plain solve's bit for bit (the
   solver config and stations of the CLI's locate posterior, so that 23
   hits the same key);
22. (b) the grid search at catalogue size: 4096 synthetic events against
   the 16 tables (4.8e9 station-node misfits, in chunks), held against the
   same function at one event per chunk on 64 of them (bar: the same
   nodes, t0 and loglik at rtol 1e-6, t0 with an atol of 1e-7 s); seconds,
   events per second and the hypocentre error in cells printed;
23. (c) locate NUTS through ``mceik_tpu_torch.cli.main(["run",
   "configs/c3_joint_events.json", "model.mode=locate", ...])`` at full
   width (8 chains, 12 events, 16 stations), depth cut, counts reset and
   read: K1 launched for the data's solve alone (as many launches as that
   solve takes by itself: the tables come from 21's cache), K4 and K5 not
   launched, logposts finite and rising, no slowness tracked and no
   recovery correlation;
24. (d) resume of the main path: phase 7's checkpoint resumed for 40 more
   samples through the CLI: K1 launched, no warmup, the adapted step
   carried over within 1e-6, the acceptance in (0.05, 0.99);
25. (e) resume of phase 6's MALA run for 30 more samples: no ``laplace``
   record, K1 and K4 launched, the acceptance in (0.05, 0.99);
26. (f) config 4's SMC at full width (10,000 particles) capped at 2 stages
   with a checkpoint, then resumed to the 3-stage cap, against phase 9's
   uninterrupted run (bars of tests/test_dist.py: betas rtol 1e-6, log Z
   rtol and atol 1e-5, particles rtol and atol 1e-6; bit for bit
   printed): K3's warp route launched on the resumed ladder;
27. distribution, each run launched by ``torchrun --standalone
   --nproc_per_node=2`` through the port's rank entry
   ``mceik_tpu_torch.dist.dryrun``, its two gloo ranks sharing the one card
   (NCCL refuses two ranks on one device), each rank's kernel launch counts
   read back: phase 7's c2 AM run (16 chains, 8 per rank) through the CLI,
   its records against phase 7's (bar: rtol 2e-4 on every logpost and the
   step size; the gap printed), K1 launched on both ranks;
28. config 4's SMC at 10,000 particles over the 2 ranks through
   ``run_smc_config``, 3 stages, against phase 9 (the bars of
   tests/test_dist.py: betas atol 1e-4, the same stage count, log Z within
   0.05, particle means within 0.08, variances within 30%; the gaps
   printed), K3's warp route launched on both ranks;
29. config 5's geometry: its 24 station tables on the 128^3 grid through
   ``solve_eikonal_sharded`` on the 2 ranks (plain cycles on slabs of 64
   planes, tol 1e-5, ``max_iters`` 200) against the unsharded K1 solve
   (bar: atol 2e-3), then the reshard and the prediction of its 32 events
   against ``predict_events`` on the same tables (bar: atol 1e-5);
30. a one-rank NCCL group on the card driving every collective helper of
   ``dist/mesh.py`` on CUDA tensors, and a one-rank gloo group beside it
   (the host staging), each helper's result equal to its input, with ms
   per collective;
31. the port's dryrun (legs A-E) on the 2 ranks on the card: every leg
   against its unsharded run, each rank's launches printed;
32. the C++ serial fast-sweeping oracle (``mceik_tpu_torch.native``,
   ``native/fsm.cc`` built by g++) against the kernels' solves at tol 1e-6
   (``fsm_solve`` at tol 1e-8; bar: atol 2e-3, tests/test_native.py's): K3
   on one field (its block route) of (33, 29) and of the anisotropic
   (25, 19) grid with origin (1, -2), K1 on (17, 15, 13) and on one c2
   field of 64^3; the FSM's passes and both times printed;
33. the Jacobi solve on the card: (a) on the main-path batch (128 fields
   of 64^3) at tol 1e-6 against K1's solve at tol 1e-6 (bar: atol 5e-4,
   tests/test_eikonal.py's; no kernel launched; its passes and wall
   printed), (b) the c2 AM path through ``mceik_tpu_torch.cli.main`` with
   ``eikonal.method=jacobi eikonal.max_iters=400`` at 16 chains, depth cut
   to 4 + 4 steps, counts reset and read: K1 launched exactly as often as
   the data's own solve (the default sweep config) takes when the dataset
   is made alone, so the chain steps launched none; logposts finite and
   rising;
34. the sanity tool ``mceik_tpu_torch.diag.sanity`` (the counterpart of
   tools/tpu_sanity.py): every batched forward route on 64 fields of 64^3
   (and K3's two routes on 64 fields of 64^2) against a tight plain solve
   at the reference's bar 5e-2, every transport route (K4, K5 forced, K6)
   against the plain transport solve (bar 1e-5 of max), each with its
   launches; every row OK, with ms per batch;
35. each golden problem's posterior on the card (the kernels) against
   the CPU's (the plain solves) at the golden's mean, its MAP and 32 draws
   around them (``golden.device_parity``; bars: logpost rtol 2e-5, the
   MALA problems' gradient relative L2 1e-4 per point and the same bits on
   a second call), then the golden checks (``mceik_tpu_torch.diag.golden``)
   of all four problems through the kernels (``use_pallas`` "on"), their
   random numbers drawn on the host as on the CPU, at the reference's
   check budgets, seeds and bars (max |z| < 3.5, median < 1.5, acceptance
   > 0.05, median ESS > 20, c1_small's recovery correlation > 0.5):
   c1_small through K3 alone, c2_small through K1 alone, c2_mid and
   c3_joint_small through K1 and K4.

The line before the last is a JSON object listing the kernels' entries
with their launch counts (K1 and K4 on the MALA path, K3 on the SMC path,
K5 on the config-5 path, K6 on config 1's NUTS path, K1 again on the
gridbatch solve for the TPU's gridbatch kernel; K3's and K6's cycle and
solve entries share their kernel's count and list the cycles it counted;
K1's and K4's config-3 NUTS counts and times, K1's config-5 counts and
times, K1's launches on the locate path, on the table cache's miss and on
the resumed AM and MALA runs, K4's on the resumed MALA run, K3's warp
route's on the resumed SMC ladder, K5's time forced on config 2's batch, K3's config-1 times, K6's
config-1 MALA count and config-4 times; each rank's K1 launches on the
sharded AM run, the sharded tables and the dryrun, K3's warp launches on
the sharded SMC ladder; K1's, K3's and K4's launches in the golden checks,
K1's launches on the Jacobi run and on its data's solve, the FSM oracle's
largest difference), errors, times and bounds (the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s fp32,
counted from each kernel's source at the shapes timed; a solve's bound
moves its bytes once and does the operations of every cycle its fields
ran); the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA device and the repository
around this file; without either it fails before printing any result.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
AM_CONFIG = os.path.join(REPO, "configs", "c2_checkerboard3d.json")
MALA_CONFIG = os.path.join(REPO, "configs", "c2_mala.json")
C1_CONFIG = os.path.join(REPO, "configs", "c1_crosswell.json")
C4_CONFIG = os.path.join(REPO, "configs", "c4_smc.json")
C3_CONFIG = os.path.join(REPO, "configs", "c3_joint_events.json")
C5_CONFIG = os.path.join(REPO, "configs", "c5_pod_nuts.json")
LL_RTOL = 1e-6      # c4 log-likelihood through K3 vs through the plain solve
SMC_STAGES = 3      # c4 ladder cap (depth cut)
GRAD_REL_BAR = 1e-5  # kernel vs plain gradient, max abs diff / max abs
FD_BAR = 0.1        # gradient vs central finite difference, relative
SOLVE_TOL = 1e-5    # solver tolerance of the K1 comparison solves
N_CHAINS = 16
AM_ARGS = ["sampler.n_chains=16", "sampler.n_warmup=40",
           "sampler.n_samples=80", "sampler.thin=4", "io.log_every=40"]
# c2_mala.json at full width; depth cut from 150 MAP steps, 60 warmup and
# 600 sampling steps.
MALA_ARGS = ["sampler.n_map_steps=40", "sampler.n_warmup=30",
             "sampler.n_samples=60", "io.log_every=30"]
# c1_crosswell.json at full width; depth cut from 2000 warmup and 6000
# sampling steps.
C1_ARGS = ["sampler.n_warmup=400", "sampler.n_samples=400", "io.log_every=200"]
# c3_joint_events.json at full width; depth cut from 500 warmup and 1000
# sampling steps at max tree depth 6.
C3_NUTS_ARGS = ["sampler.n_warmup=8", "sampler.n_samples=8",
                "sampler.max_tree_depth=4", "io.log_every=4"]
# c3_joint_events.json under model.mode=locate at full width (8 chains, 12
# events, 16 stations); depth cut from 500 warmup and 1000 sampling steps
# at max tree depth 6.
C3_LOC_ARGS = ["sampler.n_warmup=20", "sampler.n_samples=20",
               "sampler.max_tree_depth=5", "io.log_every=10"]
C3_HMC_ARGS = ["sampler.algorithm=hmc", "sampler.n_leapfrog=8",
               "sampler.n_warmup=6", "sampler.n_samples=4", "io.log_every=4"]
# c5_pod_nuts.json at full width but 4 of its 1024 chains (1024 x 24 fields
# of 8 MB do not fit one card); depth cut from 500 warmup and 2000 sampling
# steps at max tree depth 7 (to depth 1: its solves run up to 40 cycles,
# the reference's count at 128^3, twice what depth 2 paid before).
C5_CHAINS = 4
C5_ARGS = [f"sampler.n_chains={C5_CHAINS}", "sampler.max_tree_depth=1",
           "sampler.n_warmup=4", "sampler.n_samples=2", "sampler.thin=1",
           "io.log_every=1"]
# c1_crosswell.json at full width under the gradient samplers; depth cut
# from 2000 warmup and 6000 sampling steps (thinned 4) at max tree depth 6,
# and the Laplace setup's 150 MAP steps to 40.
C1_NUTS_ARGS = ["sampler.algorithm=nuts", "sampler.n_warmup=30",
                "sampler.n_samples=30", "sampler.thin=1",
                "sampler.max_tree_depth=5", "io.log_every=15"]
C1_MALA_ARGS = ["sampler.algorithm=mala", "sampler.n_map_steps=40",
                "sampler.n_warmup=30", "sampler.n_samples=60",
                "sampler.thin=1", "io.log_every=30"]

# c2_checkerboard3d.json at 16 chains under eikonal.method=jacobi (and
# max_iters 400); depth cut to 4 warmup and 4 sampling steps.
JACOBI_ARGS = ["sampler.n_chains=16", "sampler.n_warmup=4",
               "sampler.n_samples=4", "sampler.thin=1", "io.log_every=2"]

# The card's peaks (H100 SXM data sheet, at 700 W): fp32 outside the tensor
# cores and HBM bandwidth.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _bound(nodes, bytes_per_node, ops_per_node):
    """(ms, "bytes" or "operations"): the least time for one launch, each
    input read once and the output written once, against the ops its
    source does per node (counted below)."""
    t_b = nodes * bytes_per_node / PEAK_BYTES * 1e3
    t_o = nodes * ops_per_node / PEAK_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# Operations per node and cycle, counted from the sources for the
# isotropic local solves these grids take (every axis, both directions,
# n_inner Jacobi steps, plus the axial minimum once per pass):
# K1 (sweep3d.cu): local_iso ~38 (sorting 6, t1 2, t2 9, t3 15, selects 4),
#   neighbour minima 6, the min/max with T and the floor 2 -> 46 per step,
#   and the floor's 15 (three differences, scalings and squares, three
#   adds, sqrt, compare, product) once per node and cycle: the floor
#   depends on the node alone, so that is all the function needs (the
#   kernel computes it on the planes that meet the seed ball, at each
#   step there);
# K3 (sweep2d.cu): local2 ~17, line minimum 3, min/max 2 -> 22 per step;
# K4 (transport3d.cu): the axial inflow and base 6 per pass, 12 per step
#   (four guarded weight x lam products and their sum);
# K6 (transport2d.cu): the axial inflow and base 6 per pass, 6 per step
#   (two guarded weight x lam products and their sums);
def _k1_ops(n_inner):
    return 6 * (46 * n_inner + 1) + 15


def _k1_bound(T, n_inner):
    """K1's bound for one cycle of the batch ``T``: T and s read and T
    written (12 B per node), four source scalars per field (16 B)."""
    return _bound(T.numel(), 12 + 16 * T.shape[0] / T.numel(),
                  _k1_ops(n_inner))


def _k6_ops(n_inner):
    return 4 * (6 + 6 * n_inner)


def _k3_ops(n_inner):
    return 4 * (22 * n_inner + 1)


def _k3_bound(nodes, fields, n_inner, field_cycles=None):
    """K3's bound for one cycle of every field (``field_cycles`` None) or
    for whole solves whose cycles, summed over the fields, are
    ``field_cycles``: T and s read and T written once (12 B per node),
    three source scalars per field (12 B), the operations of every cycle
    run, and the floor's 15 per node once (it is constant through a
    solve). A cycle moves the bytes once per launch as well."""
    cycles = fields if field_cycles is None else field_cycles
    return _bound(nodes, 12 + 12 * fields / nodes,
                  _k3_ops(n_inner) * cycles / fields + 15)


def _k6_bound(nodes, n_inner, field_cycles=None, fields=None):
    """K6's bound, as K3's: lam (or g), g, w0 and w1 read and lam written
    (20 B per node per cycle; a solve reads g, w0 and w1 and writes lam
    once, 16 B per node)."""
    if field_cycles is None:
        return _bound(nodes, 20, _k6_ops(n_inner))
    return _bound(nodes, 16, _k6_ops(n_inner) * field_cycles / fields)


def _bits(x):
    """The fp32 tensor as int32 words (NaN payloads and signed zeros
    count)."""
    import torch

    return x.contiguous().view(torch.int32)


def _same_bits(a, b):
    """Bit for bit on every non-NaN value, NaN at the same places (the
    card's arithmetic writes its own NaN payload where torch may pass an
    operand's on)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        _bits(torch.where(na, 0.0, a)), _bits(torch.where(nb, 0.0, b)))


def _abs_err(a, b):
    """max |a - b| where both are finite (0.0 for empty)."""
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0


def _k4_ops(n_inner):
    return 6 * (6 + 12 * n_inner)


class _Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def _timed(fn, reps=1):
    """(result, ms per call) with CUDA events around ``reps`` calls after a
    warm-up call; with ``reps`` 0, the first call itself (the plain host
    loops, seconds long, need no warm-up)."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()  # warm-up (and the result)
    e1.record()
    torch.cuda.synchronize()
    if reps == 0:
        return out, e0.elapsed_time(e1)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1) / reps


def _build_all(kernels):
    """Build every kernel at once (one nvcc per source; entry points of one
    source share its build); raise the first error."""
    errors = []

    def build(k):
        try:
            k.build()
        except Exception as e:  # reported below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a kernel build did not finish")
    n_src = len({k.source for k in kernels})
    print(f"build: {len(kernels)} kernels from {n_src} sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        print(f"build: {k.symbol} ({k.source.relative_to(REPO)}) in "
              f"{k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                print(f"  ptxas: {line.strip()}")


def _run_cli(cli, argv):
    """``cli.main(argv)`` with stdout kept; returns (JSONL records, lines,
    wall seconds)."""
    tee = _Tee(sys.stdout)
    print(f"main path: mceik_tpu_torch.cli.main({argv})")
    t0 = time.perf_counter()
    sys.stdout = tee
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout = tee.out
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    lines = tee.buf.getvalue().splitlines()
    recs = [json.loads(line.split("] ", 1)[1]) for line in lines
            if line.startswith("[mceik] ")]
    return recs, lines, wall


def _torchrun(n, args, label, timeout=600):
    """``torchrun --standalone --nproc_per_node=n <args>`` from the
    repository root in a session of its own (killed whole on a timeout);
    returns (stdout, wall seconds). Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", *args]
    print(f"{label}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError(f"{label}: the ranks did not finish in "
                           f"{timeout} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: torchrun exited {proc.returncode}:\n"
                           f"{out[-3000:]}\n{err[-6000:]}")
    return out, wall


def _rank_results(out_dir, n):
    """What each rank of a ``mceik_tpu_torch.dist.dryrun`` launch wrote."""
    import torch
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def _collectives_on_card(x, tab):
    """Phase 30: a one-rank NCCL group and a one-rank gloo group on the
    card, every collective helper of ``dist/mesh.py`` on CUDA tensors (each
    must return its input), and ms per collective on ``x`` (``tab`` for the
    all-to-all). Returns ``{backend: {helper: ms}}``."""
    import socket

    import torch
    import torch.distributed as dist

    from mceik_tpu_torch.dist import mesh as dmesh

    dev = x.device
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    coll_ms = {}
    try:
        meshes = {"nccl": dmesh.Mesh(world=1, rank=0, device=dev,
                                     backend="nccl"),
                  "gloo": dmesh.Mesh(world=1, rank=0, device=dev,
                                     backend="gloo",
                                     group=dist.new_group([0],
                                                          backend="gloo"))}
        for name, m in meshes.items():
            checks = {
                "all_reduce_sum": torch.equal(dmesh.all_reduce_sum(x, m), x),
                "all_reduce_max": torch.equal(dmesh.all_reduce_max(x, m), x),
                "all_gather0": torch.equal(dmesh.all_gather0(x, m), x),
                "all_to_all01": torch.equal(dmesh.all_to_all01(tab, m), tab),
                "broadcast0": torch.equal(dmesh.broadcast0(x, m), x),
                "any_rank": dmesh.any_rank(torch.tensor(True, device=dev), m)
                and not dmesh.any_rank(torch.tensor(False, device=dev), m),
                "gather_chains": torch.equal(
                    dmesh.gather_chains({"x": x}, m)["x"], x),
                "replicate": torch.equal(dmesh.replicate({"x": x}, m)["x"],
                                         x),
                "shard_chains": torch.equal(
                    dmesh.shard_chains({"x": x}, m)["x"], x),
            }
            if not all(checks.values()):
                raise RuntimeError(f"phase 30 ({name}): {checks}")
            ms = {op: _timed(lambda: getattr(dmesh, op)(x, m), reps=20)[1]
                  for op in ("all_reduce_sum", "all_gather0", "broadcast0")}
            ms["all_to_all01"] = _timed(lambda: dmesh.all_to_all01(tab, m),
                                        reps=20)[1]
            coll_ms[name] = ms
        print(f"phase 30: one-rank NCCL and gloo groups on the card: every "
              f"helper returns its input on CUDA tensors; ms per collective "
              f"(a {tuple(x.shape)} fp32 operand, {x.numel() * 4} bytes; "
              f"all_to_all01 {tuple(tab.shape)}) {json.dumps(coll_ms)}")
    finally:
        dist.destroy_process_group()
    return coll_ms


def _check_run(recs, label, n_warm, n_chains=N_CHAINS):
    """Init and sample records present, logposts finite; returns
    (init, sample records, steps after init, chain-steps/s overall, in the
    last segment)."""
    init = [r for r in recs if r["phase"] == "init"]
    samp = [r for r in recs if r["phase"] == "sample"]
    if len(init) != 1 or not samp:
        raise RuntimeError(f"{label}: expected init + sample records, got "
                           f"{len(init)} + {len(samp)}")
    vals = [r[k] for r in init + samp
            for k in ("logpost_mean", "logpost_min", "logpost_max")]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"{label}: non-finite logpost")
    steps = n_warm + samp[-1]["step"]
    rate_all = steps * n_chains / (samp[-1]["t"] - init[0]["t"])
    rate_last = float("nan")
    if len(samp) >= 2:
        rate_last = ((samp[-1]["step"] - samp[-2]["step"]) * n_chains
                     / (samp[-1]["t"] - samp[-2]["t"]))
    return init[0], samp, steps, rate_all, rate_last


def _smooth_slowness(grid, seed, amp=0.3):
    """tests/test_native.py's medium with numpy's draw: exp of a 5^D
    normal field upsampled linearly."""
    import numpy as np
    import torch

    from mceik_tpu_torch.model.params import slowness_from_u
    u = np.random.default_rng(seed).standard_normal((5,) * grid.ndim)
    return slowness_from_u(torch.tensor(amp * u, dtype=torch.float32),
                           grid, torch.tensor(1.0))


def _phases_32_35(dev, cli, s_true, src, s_a, srcs_a):
    """Phases 32-35: the FSM oracle against K3 and K1, the Jacobi solve on
    the card (against K1, and the c2 AM path under ``eikonal.method=
    jacobi``), the sanity tool, and the golden checks through the kernels.
    Raises on a failed bar; returns what the kernel line reports."""
    import torch

    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.diag import golden, profile, sanity
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.solve import EikonalConfig
    from mceik_tpu_torch.grid import Grid
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config
    from mceik_tpu_torch.native import fsm_solve

    reset = profile.reset

    def launched():
        return {n: c for n, c in profile.counts().items()
                if c and not n.endswith("_field_cycles")}

    out = {}
    # 32. The FSM oracle against the kernels: K3 (one field, the block
    # route) and K1, each solve at tol 1e-6 against fsm_solve at tol 1e-8.
    t32 = time.perf_counter()
    c2_grid = Grid(tuple(s_true.shape), (1.0, 1.0, 1.0))
    cases = [
        ("K3 (33, 29)", Grid((33, 29), (1.0, 1.0)), None, [3.0, 3.0]),
        ("K3 (25, 19) anisotropic", Grid((25, 19), (0.5, 1.0), (1.0, -2.0)),
         "ones", [6.0, 5.0]),
        ("K1 (17, 15, 13)", Grid((17, 15, 13), (1.0, 1.0, 1.0)), None,
         [3.0, 3.0, 3.0]),
        ("K1 c2 field 64^3", c2_grid, s_true, src[0].tolist()),
    ]
    cfg32 = EikonalConfig(tol=1e-6, max_iters=200)
    oracle = []
    for label, g, s_spec, x in cases:
        if s_spec is None:
            s = _smooth_slowness(g, 5)
        elif isinstance(s_spec, str):
            s = torch.ones(g.shape)
        else:
            s = s_spec.detach().cpu()
        reset()
        t0 = time.perf_counter()
        T_k = solve_eikonal_batched(s.to(dev)[None], torch.tensor(
            [x], dtype=torch.float32, device=dev), g, cfg32)[0]
        torch.cuda.synchronize()
        ms_k = (time.perf_counter() - t0) * 1e3
        counts = launched()
        t0 = time.perf_counter()
        T_f, passes = fsm_solve(s, x, g, tol=1e-8, max_passes=100)
        ms_f = (time.perf_counter() - t0) * 1e3
        diff = float((T_k.cpu() - torch.from_numpy(T_f)).abs().max())
        kernel = "sweep2d" if g.ndim == 2 else "sweep3d_cycle"
        ok = (diff <= 2e-3 and counts.get(kernel, 0) > 0
              and (g.ndim == 3 or counts.get("sweep2d_block_launches", 0)))
        print(f"phase 32, FSM oracle, {label}: max|kernel-FSM| = {diff:.3e} "
              f"(bar 2e-3); FSM {passes} passes in {ms_f:.1f} ms, the "
              f"kernel's solve {ms_k:.1f} ms; launches {counts}")
        if not ok:
            raise RuntimeError(f"phase 32 ({label}): {diff} or {counts}")
        oracle.append({"case": label, "max_abs_diff": diff, "passes": passes,
                       "fsm_ms": ms_f, "kernel_ms": ms_k})
    out["oracle"] = oracle
    print(f"phase 32 wall {time.perf_counter() - t32:.1f} s")

    # 33 (a). Jacobi on c2's main-path batch (128 fields of 64^3) against
    # K1's solve, both at tol 1e-6 (the bar of tests/test_eikonal.py).
    reset()
    t0 = time.perf_counter()
    T_j, iters = _jacobi_with_iters(s_a, srcs_a, c2_grid)
    torch.cuda.synchronize()
    wall_j = time.perf_counter() - t0
    jac_counts = launched()
    T_s = solve_eikonal_batched(s_a, srcs_a, c2_grid, EikonalConfig(
        tol=1e-6, max_iters=200))
    diff = float((T_j - T_s).abs().max())
    print(f"phase 33 (a): Jacobi on {s_a.shape[0]} fields of 64^3 at tol "
          f"1e-6: {int(iters.max())} passes (per field {int(iters.min())}-"
          f"{int(iters.max())}) in {wall_j:.2f} s; max|Jacobi-K1| = "
          f"{diff:.3e} (bar 5e-4); launches in the Jacobi solve "
          f"{jac_counts}")
    if diff > 5e-4 or jac_counts or not bool(torch.isfinite(T_j).all()):
        raise RuntimeError(f"phase 33 (a): Jacobi vs K1 {diff}, launches "
                           f"{jac_counts}")
    out["jacobi"] = {"passes": int(iters.max()), "seconds": wall_j,
                     "max_abs_diff_k1": diff}

    # 33 (b). The c2 AM path through the CLI with eikonal.method=jacobi: the
    # chain steps launch no K1 (the data's solve, with the default sweep
    # config, is K1's alone; measured by making the dataset alone first).
    over = ["eikonal.method=jacobi", "eikonal.max_iters=400", *JACOBI_ARGS]
    cfg_j = apply_overrides(load_config(AM_CONFIG), over)
    reset()
    make_dataset(cfg_j.grid.build(), cfg_j.data, cfg_j.model, device=dev)
    data_launches = launched()
    reset()
    recs, _, wall = _run_cli(cli, ["run", AM_CONFIG, *over])
    run_launches = launched()
    init, samp, steps, rate, _ = _check_run(recs, "phase 33 (b)",
                                            cfg_j.sampler.n_warmup)
    print(f"phase 33 (b): c2 AM under Jacobi, {steps} steps at 16 chains in "
          f"{wall:.1f} s ({rate:.2f} chain-steps/s); logpost "
          f"{init['logpost_mean']} -> {samp[-1]['logpost_mean']}; launches "
          f"{run_launches}, the data's solve alone {data_launches}")
    if (run_launches != data_launches
            or not samp[-1]["logpost_mean"] > init["logpost_mean"]):
        raise RuntimeError(f"phase 33 (b): launches {run_launches} vs the "
                           f"data's {data_launches}, or logpost not rising")
    out["jacobi_cli"] = {"launches": run_launches, "data": data_launches,
                         "chain_steps_per_s": rate}

    # 34. The sanity tool: every route OK.
    t34 = time.perf_counter()
    rows = sanity.run()
    if not all(r["ok"] for r in rows):
        raise RuntimeError(f"phase 34: BAD routes "
                           f"{[r['route'] for r in rows if not r['ok']]}")
    out["sanity"] = {r["route"]: r["ms"] for r in rows}
    print(f"phase 34: {len(rows)} routes OK in "
          f"{time.perf_counter() - t34:.1f} s")

    # 35. The golden checks through the kernels at the reference's budgets
    # and bars; first each problem's posterior on the card (the kernels)
    # against the CPU's (the plain solves) at the golden's points and 32
    # draws around them (golden.device_parity: logpost within 2e-5, the
    # MALA problems' gradient within 1e-4 in L2, each relative to the
    # points' root mean square, and the same bits on a second call). The
    # checks draw their random numbers on the host, as the CPU check does.
    t35 = time.perf_counter()
    parity = [golden.device_parity(name, dev, "on")
              for name in golden.PROBLEMS]
    for p in parity:
        print(f"phase 35, parity of the card's posterior with the CPU's: "
              f"{json.dumps(p)}")
    if not all(p["ok"] for p in parity):
        raise RuntimeError(f"phase 35: the card's posterior is not the "
                           f"CPU's: {parity}")
    results = golden.check(list(golden.PROBLEMS), dev, "on", rng="host")
    expect = {"c1_small": {"sweep2d"}, "c2_small": {"sweep3d_cycle"},
              "c2_mid": {"sweep3d_cycle", "transport3d_cycle"},
              "c3_joint_small": {"sweep3d_cycle", "transport3d_cycle"}}
    kinds = ("sweep3d_cycle", "sweep2d", "transport3d_cycle",
             "transport3d_large_cycle", "transport2d")
    for r in results:
        ran = {k for k in kinds if r["launches"][k]}
        if not r["ok"] or ran != expect[r["problem"]]:
            raise RuntimeError(f"phase 35 ({r['problem']}): bars "
                               f"{r['bars']}, kernels {ran}")
    out["parity"] = {p["problem"]: {k: v for k, v in p.items()
                                    if k not in ("problem", "ok")}
                     for p in parity}
    out["golden"] = {r["problem"]: {
        "launches": {k: r["launches"][k] for k in kinds if r["launches"][k]},
        "seconds": r["seconds"],
        **{b: v for b, (v, _) in r["bars"].items()}} for r in results}
    print(f"phase 35: the four goldens within the bars through the kernels "
          f"in {time.perf_counter() - t35:.1f} s")
    return out


def _jacobi_with_iters(s, srcs, grid):
    """The Jacobi solve at tol 1e-6 and ``max_iters`` 2000, with each
    field's pass count."""
    from mceik_tpu_torch.eikonal.solve import jacobi_solve, seed_source
    T0, frozen = seed_source(s, srcs, grid, 3.0)
    return jacobi_solve(T0, frozen, s, grid.spacing, 1e-6, 2000,
                        return_cycles=True)


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from mceik_tpu_torch import cli
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.datasets.synthetic import (borehole_3d_geometry,
                                                    checkerboard_slowness)
    from mceik_tpu_torch.eikonal import (cuda_sweep, cuda_sweep2d,
                                         cuda_transport, cuda_transport2d)
    from mceik_tpu_torch.eikonal.adjoint_sweep import (batch_weights,
                                                       transport_cycle_plain,
                                                       transport_solve,
                                                       transport_weights)
    from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
    from mceik_tpu_torch.eikonal.solve import (CYCLES_PER_ITER, EikonalConfig,
                                               seed_floor, seed_source,
                                               solve_route, source_scalars,
                                               sweep_seeded_cycle_plain,
                                               sweep_solve)
    from mceik_tpu_torch.forward.locate import locate_grid_search
    from mceik_tpu_torch.forward.predict import (interp_tables,
                                                 predict_events,
                                                 traveltime_tables)
    from mceik_tpu_torch.forward.tables_cache import cached_traveltime_tables
    from mceik_tpu_torch.grid import Grid
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config
    from mceik_tpu_torch.io.loaders import load_slowness, save_slowness
    from mceik_tpu_torch.model.params import (Params, box_from_raw,
                                              slowness_from_u)
    from mceik_tpu_torch.model.posterior import (_eik_config,
                                                 _gaussian_loglik,
                                                 build_posterior,
                                                 value_and_grad)
    from mceik_tpu_torch.samplers.smc import run_smc_config

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    t_start = time.perf_counter()
    # Checkpoints, the fixed locate model and the table cache.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    mala_ck, am_ck = os.path.join(tmp, "mala.pt"), os.path.join(tmp, "am.pt")

    # 1. The card: nvidia-smi's own line (name, power limit), then versions.
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device 0: {kind}")

    # 2. Build.
    k1, k4 = cuda_sweep.SWEEP3D, cuda_transport.TRANSPORT3D
    k3, k5 = cuda_sweep2d.SWEEP2D, cuda_transport.TRANSPORT3D_LARGE
    k6 = cuda_transport2d.TRANSPORT2D
    _build_all([k1, k4, k3, k5, k6])

    # 3. K1 vs plain, on the card.
    cfg = load_config(AM_CONFIG)
    grid = cfg.grid.build()
    on = EikonalConfig(tol=SOLVE_TOL, max_iters=200, use_pallas="on")
    off = EikonalConfig(tol=SOLVE_TOL, max_iters=200, use_pallas="off")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {"sweep3d_cycle": [], "transport3d_cycle": [], "sweep2d": [],
            "transport3d_large_cycle": [], "transport2d": [],
            "gridbatch": []}

    def compare(label, s, srcs, g):
        launches0 = k1.launches
        T_k, ms_k = _timed(lambda: solve_eikonal_batched(s, srcs, g, on), 3)
        launched = k1.launches - launches0
        T_p, ms_p = _timed(lambda: solve_eikonal_batched(s, srcs, g, off), 1)
        if not launched:
            raise RuntimeError(f"{label}: the kernel was not launched")
        err = float((T_k - T_p).abs().max())
        finite = bool(torch.isfinite(T_k).all())
        print(f"K1 compare {label}: B={s.shape[0]} grid={g.shape} "
              f"spacing={g.spacing}: max|kernel-plain| = {err:.3e}; "
              f"ms per batch solve: kernel {ms_k:.3f}, plain {ms_p:.3f}")
        if not finite or not torch.equal(T_k, T_p):
            raise RuntimeError(f"{label}: kernel disagrees with plain "
                               f"(max abs {err}, finite {finite})")
        errs["sweep3d_cycle"].append(err)
        return T_k

    def k1_cycle_pair(label, T0, s, srcs, g, ecfg, reps):
        """One K1 cycle against the plain seeded cycle on every field, bit
        for bit; returns (kernel's cycle, ms per launch, plain ms)."""
        scal = torch.cat(source_scalars(s, srcs, g), dim=1).contiguous()
        done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)
        launches0 = k1.launches
        T1_k, ms_k = _timed(lambda: cuda_sweep.seeded_cycle(
            T0, s, scal, g.spacing, ecfg.n_inner, done,
            seed_radius=ecfg.seed_radius), reps=reps)
        if k1.launches == launches0:
            raise RuntimeError(f"K1 cycle {label}: the kernel was not "
                               "launched")
        T1_p, ms_p = _timed(lambda: sweep_seeded_cycle_plain(
            T0, s, scal, g.spacing, ecfg.n_inner, done,
            seed_radius=ecfg.seed_radius))
        err = float((T1_k - T1_p).abs().max())
        print(f"K1 compare one cycle, {label} B={T0.shape[0]} grid={g.shape}: "
              f"max|kernel-plain| = {err:.3e}; ms per launch: kernel "
              f"{ms_k:.3f}, plain {ms_p:.3f}")
        if not torch.equal(T1_k, T1_p):
            raise RuntimeError(f"K1 cycle {label}: kernel disagrees with "
                               f"plain ({err})")
        errs["sweep3d_cycle"].append(err)
        return T1_k, ms_k, ms_p

    # (a) the main path's batch: 16 chains x c2's 8 sources on its 64^3
    # checkerboard, each chain's slowness perturbed as an AM proposal is.
    s_true = checkerboard_slowness(grid, cfg.data.checker_cells,
                                   cfg.data.checker_amplitude,
                                   cfg.model.background_slowness, device=dev)
    src, rec = borehole_3d_geometry(grid, cfg.data.n_src, cfg.data.n_rec,
                                    device=dev)
    inv = tuple(cfg.model.inv_shape)
    u_a = 0.1 * cfg.model.prior_sigma_u * torch.randn(
        (N_CHAINS,) + inv, generator=gen, device=dev)
    s_a = (s_true * slowness_from_u(u_a, grid, torch.tensor(1.0, device=dev)))
    s_a = s_a.unsqueeze(1).expand((N_CHAINS, cfg.data.n_src) + grid.shape)
    s_a = s_a.reshape((-1,) + grid.shape).contiguous()
    srcs_a = src.repeat(N_CHAINS, 1)
    compare("a (main-path batch)", s_a, srcs_a, grid)

    # One cycle at the main path's shape: the unit a launch does.
    T0, frozen_a = seed_source(s_a, srcs_a, grid, cfg.eikonal.seed_radius)
    done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)
    _, ms_k1, ms_k1_plain = k1_cycle_pair("c2 batch", T0, s_a, srcs_a, grid,
                                          cfg.eikonal, reps=10)
    b_k1, by_k1 = _k1_bound(T0, cfg.eikonal.n_inner)

    # (b) odd batch, non-cube grid, unequal spacing (weighted local solve).
    g_b = Grid((48, 40, 32), (1.0, 1.2, 0.9))
    u_b = 0.3 * torch.randn((3, 6, 6, 6), generator=gen, device=dev)
    s_b = slowness_from_u(u_b, g_b, torch.tensor(1.0, device=dev))
    ext = torch.tensor(g_b.extent, device=dev)
    srcs_b = (0.1 + 0.8 * torch.rand((3, 3), generator=gen, device=dev)) * ext
    T_b = compare("b (odd anisotropic non-cube)", s_b, srcs_b, g_b)

    # (c) mixed convergence: homogeneous fields converge in a few cycles,
    # high-contrast ones take many more; per-field done flags must leave
    # the early ones alone.
    g_c = Grid((64, 64, 64), (1.0, 1.0, 1.0))
    n_easy = 4
    u_c = torch.cat([torch.zeros((n_easy, 4, 4, 4), device=dev),
                     0.8 * torch.randn((4, 4, 4, 4), generator=gen,
                                       device=dev)])
    s_c = slowness_from_u(u_c, g_c, torch.tensor(1.0, device=dev))
    srcs_c = torch.tensor([[10.0, 20.0, 30.0], [50.0, 12.0, 40.0],
                           [31.5, 31.5, 31.5], [5.0, 60.0, 7.0]] * 2,
                          device=dev)
    T_c = compare("c (mixed convergence)", s_c, srcs_c, g_c)
    T0c, _ = seed_source(s_c, srcs_c, g_c, 3.0)
    scal_c = torch.cat(source_scalars(s_c, srcs_c, g_c), dim=1).contiguous()
    history = []

    def recording_cycle(T, s, sc, sp, n_inner, done):
        history.append(done.clone())
        return cuda_sweep.seeded_cycle(T, s, sc, sp, n_inner, done,
                                       seed_radius=3.0)

    sweep_solve(T0c, scal_c, s_c, g_c.spacing, SOLVE_TOL, 200, 2,
                cycle=recording_cycle)
    cycles = (~torch.stack(history)).sum(0).tolist()
    print(f"K1 compare c: cycles per field {cycles}")
    if len(set(cycles)) < 2:
        raise RuntimeError("c: every field took the same number of cycles")
    xyz = torch.as_tensor(g_c.node_coords(), dtype=torch.float32, device=dev)
    r = torch.linalg.norm(xyz[None] - srcs_c[:n_easy, None, None, None], dim=-1)
    # First-order upwind overestimates point-source distances off the grid
    # axes: ~7.6% at most on these fields with the plain sweep (CPU).
    analytic = float(((T_c[:n_easy] - r).abs() / r.clamp(min=1.0)).max())
    print(f"K1 compare c: homogeneous fields vs analytic distance: max "
          f"relative error {analytic:.4f} (first-order upwind, bar 0.1)")
    if not analytic < 0.1:
        raise RuntimeError(f"c: homogeneous solve off the analytic ({analytic})")

    # 4. K4 vs plain, on the card: bit for bit (as int32 words, so NaN
    # and signed zeros count), finite where the reference is.
    def k4_check(label, out_k, out_p, finite_fields=None, name="K4"):
        sel = slice(None) if finite_fields is None else finite_fields
        scale = float(out_p[sel].abs().max())
        err = float((out_k[sel] - out_p[sel]).abs().max())
        same = torch.equal(out_k.contiguous().view(torch.int32),
                           out_p.contiguous().view(torch.int32))
        print(f"{name} compare {label}: bit for bit {same}, "
              f"max|kernel-reference| = {err:.3e} (max|reference| "
              f"{scale:.3e})")
        if not bool(torch.isfinite(out_k[sel]).all()) or not same:
            raise RuntimeError(f"{name} {label}: kernel differs from its "
                               f"reference ({err})")
        errs["transport3d_cycle" if name == "K4"
             else "transport3d_large_cycle"].append(err)

    def k4_solve_pair(label, g, ws, tol, max_cycles):
        # The gradient's path: the ring of g and the weights kept through
        # the solve.
        launches0 = k4.launches
        lam_k, ms_sk = _timed(lambda: transport_solve(
            g, ws, tol, max_cycles, 2,
            cycle=cuda_transport.solve_cycle(g, ws)))
        if k4.launches == launches0:
            raise RuntimeError(f"K4 {label}: the kernel was not launched")
        lam_p, ms_sp = _timed(lambda: transport_solve(g, ws, tol, max_cycles, 2))
        print(f"K4 solve {label}: B={g.shape[0]} grid={tuple(g.shape[1:])}: "
              f"ms per solve at tol {tol}: kernel {ms_sk:.3f}, plain {ms_sp:.3f}")
        return lam_k, lam_p

    # (a) the main-path batch: T from K1 at the config's tolerance, g the
    # cotangent of the config-2 log-likelihood at this AM-like state.
    data, _ = make_dataset(grid, cfg.data, cfg.model, device=dev)
    econf = EikonalConfig(tol=cfg.eikonal.tol, max_iters=cfg.eikonal.max_iters,
                          n_inner=cfg.eikonal.n_inner)
    T_a = solve_eikonal_batched(s_a, srcs_a, grid, econf).requires_grad_(True)
    resid = data.t_obs - interp_tables(
        T_a.reshape((N_CHAINS, cfg.data.n_src) + grid.shape), data.rec_xyz,
        grid)
    sigma = torch.full_like(resid, cfg.model.sigma)
    (g_a,) = torch.autograd.grad(_gaussian_loglik(resid, sigma, None).sum(), T_a)
    T_a = T_a.detach()
    ws_a = transport_weights(T_a, s_a, frozen_a, grid.spacing)
    launches0 = k4.launches
    lam1_k, ms_k4 = _timed(lambda: cuda_transport.transport_cycle(
        g_a, g_a, ws_a, cfg.eikonal.n_inner, done), reps=10)
    if k4.launches == launches0:
        raise RuntimeError("K4 cycle: the kernel was not launched")
    lam1_p, ms_k4_plain = _timed(lambda: transport_cycle_plain(
        g_a, g_a, ws_a, cfg.eikonal.n_inner, done), reps=1)
    # The same cycle on a ring kept from cycle to cycle, as in a solve: the
    # first call fills it with g and the weights, the later ones copy lam.
    ring_a = k4.solve_ring(g_a.shape, dev)
    _, ms_k4_kept = _timed(lambda: k4(
        g_a, g_a, ws_a, cfg.eikonal.n_inner, done, ring=ring_a), reps=10)
    lam1_kept = k4(g_a, g_a, ws_a, cfg.eikonal.n_inner, done, ring=ring_a)
    del ring_a
    print(f"K4 one cycle, B={g_a.shape[0]} grid={grid.shape}: ms per launch: "
          f"kernel {ms_k4:.3f} (on a ring kept from cycle to cycle, as in a "
          f"solve: {ms_k4_kept:.3f}), plain {ms_k4_plain:.3f}")
    k4_check("a (main-path batch, one cycle)", lam1_k, lam1_p)
    k4_check("a (main-path batch, one cycle on a kept ring)", lam1_kept,
             lam1_p)
    k4_check("a (main-path batch, solve)",
             *k4_solve_pair("a", g_a, ws_a, cfg.eikonal.tol,
                            cfg.eikonal.max_iters))
    # K5 forced on the same batch: the same cycle with the in-plane weights
    # read from global memory, so it must equal K4.
    launches0 = k5.launches
    lam1_k5, ms_k5_c2 = _timed(lambda: cuda_transport.transport_cycle(
        g_a, g_a, ws_a, cfg.eikonal.n_inner, done, kernel=k5), reps=10)
    if k5.launches == launches0:
        raise RuntimeError("K5 forced on c2: the kernel was not launched")
    print(f"K5 forced on c2's batch B={g_a.shape[0]} grid={grid.shape}: ms "
          f"per launch {ms_k5_c2:.3f} (K4 {ms_k4:.3f})")
    k4_check("c2 batch, forced, against K4 (one cycle)", lam1_k5, lam1_k,
             name="K5")

    # (b) odd batch, non-cube grid, unequal spacing.
    _, frozen_b = seed_source(s_b, srcs_b, g_b, 3.0)
    ws_b = transport_weights(T_b, s_b, frozen_b, g_b.spacing)
    g_rand = 0.1 * torch.randn(T_b.shape, generator=gen, device=dev)
    k4_check("b (odd anisotropic non-cube, one cycle)",
             cuda_transport.transport_cycle(g_rand, g_rand, ws_b, 2),
             transport_cycle_plain(g_rand, g_rand, ws_b, 2))
    k4_check("b (odd anisotropic non-cube, solve)",
             *k4_solve_pair("b", g_rand, ws_b, 1e-6, 100))

    # (c) mixed: a zero-g field, two contractive fields, and a divergent one
    # (pairs of nodes feeding each other with weight 1.3 along every axis).
    div = []
    for d, n in enumerate(g_b.shape):
        idx = torch.arange(n, device=dev).reshape(
            [-1 if e == d else 1 for e in range(3)])
        div.append(torch.where(idx % 2 == 0, -1.3, 1.3).expand(g_b.shape))
    ws_c = tuple(torch.cat([w, dv[None]]).contiguous()
                 for w, dv in zip(ws_b, div))
    g_mix = torch.cat([torch.zeros_like(g_rand[:1]), g_rand[1:],
                       torch.ones_like(g_rand[:1])])
    active_k = []

    cycle_c = cuda_transport.solve_cycle(g_mix, ws_c)

    def recording_k4(lam, g, ws, n_inner, done):
        active_k.append((~done).clone())
        return cycle_c(lam, g, ws, n_inner, done)

    lam_ck = transport_solve(g_mix, ws_c, 1e-6, 30, 2, cycle=recording_k4)
    lam_cp = transport_solve(g_mix, ws_c, 1e-6, 30, 2)
    per_field = torch.stack(active_k).sum(0).tolist()
    print(f"K4 compare c: cycles per field {per_field} (zero, contractive, "
          f"contractive, divergent)")
    if not (bool(torch.isnan(lam_ck[3]).all())
            and bool(torch.isnan(lam_cp[3]).all())):
        raise RuntimeError("K4 c: the divergent field is not all NaN")
    if per_field[0] != 1 or not bool((lam_ck[0] == 0).all()):
        raise RuntimeError("K4 c: the zero field did not finish in one cycle")
    k4_check("c (mixed, the divergent field NaN in both)", lam_ck, lam_cp,
             finite_fields=slice(0, 3))

    # 5. The gradient on the card: K1 + K4 against the plain solves.
    post_k = build_posterior(cfg.model, data, grid, cfg.eikonal,
                             differentiable=True)
    ecfg_off = apply_overrides(cfg, ["eikonal.use_pallas=off"]).eikonal
    post_p = build_posterior(cfg.model, data, grid, ecfg_off,
                             differentiable=True)
    params = Params(u=u_a)
    l1, l4 = k1.launches, k4.launches
    (lp_k, g_k), ms_gk = _timed(lambda: value_and_grad(post_k.logpost)(params))
    if k1.launches == l1 or k4.launches == l4:
        raise RuntimeError("gradient: a kernel was not launched")
    (lp_p, g_p), ms_gp = _timed(lambda: value_and_grad(post_p.logpost)(params))
    gscale = float(g_p.u.abs().max())
    gerr = float((g_k.u - g_p.u).abs().max())
    lperr = float((lp_k - lp_p).abs().max())
    print(f"gradient, {N_CHAINS} chains at c2 width: max|kernel-plain| = {gerr:.3e} "
          f"(max|grad| {gscale:.3e}), logpost max|diff| {lperr:.3e}; ms per "
          f"value_and_grad: kernels {ms_gk:.3f}, plain {ms_gp:.3f}")
    if not bool(torch.isfinite(g_k.u).all()) or not gerr <= GRAD_REL_BAR * gscale:
        raise RuntimeError(f"gradient: kernels disagree with plain ({gerr})")
    post_fd = build_posterior(
        cfg.model, data, grid,
        apply_overrides(cfg, ["eikonal.tol=1e-6",
                              "eikonal.max_iters=300"]).eikonal,
        differentiable=True)
    v = torch.randn(u_a.shape, generator=gen, device=dev)
    v = v / v.flatten(1).norm(dim=1).reshape((-1,) + (1,) * len(inv))
    _, g_fd = value_and_grad(post_fd.logpost)(params)
    eps = 1e-3
    fd = (post_fd.logpost(Params(u=u_a + eps * v))
          - post_fd.logpost(Params(u=u_a - eps * v))) / (2 * eps)
    ad = (g_fd.u * v).flatten(1).sum(1)
    # One direction in the space of all chains' parameters (the sum over
    # chains); the worst single chain is printed beside it.
    rel = float((ad.sum() - fd.sum()).abs()
                / torch.maximum(ad.sum().abs(), fd.sum().abs()))
    worst = float(((ad - fd).abs() / torch.maximum(ad.abs(), fd.abs())).max())
    print(f"gradient vs central finite difference along one random direction "
          f"of all {N_CHAINS} chains' parameters at tol 1e-6: relative error "
          f"{rel:.3e} (bar {FD_BAR}); worst single chain {worst:.3e}")
    if not rel < FD_BAR:
        raise RuntimeError(f"gradient: finite difference disagrees ({rel})")

    # 6. The MALA path through the CLI, at full width.
    k1.launches = k4.launches = 0
    recs, lines, wall = _run_cli(cli, [
        "run", MALA_CONFIG, *MALA_ARGS, f"io.checkpoint_path={mala_ck}",
        "io.checkpoint_every=30"])
    mala_launches = {"sweep3d_cycle": k1.launches,
                     "transport3d_cycle": k4.launches}
    if min(mala_launches.values()) <= 0:
        raise RuntimeError(f"MALA path: a kernel was never launched "
                           f"({mala_launches})")
    lap = [r for r in recs if r["phase"] == "laplace"]
    if len(lap) != 1 or not lap[0]["logpost_last"] > lap[0]["logpost_first"]:
        raise RuntimeError(f"MALA path: the Laplace MAP trace did not rise "
                           f"({lap})")
    mala_cfg = apply_overrides(load_config(MALA_CONFIG), MALA_ARGS)
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "MALA path", mala_cfg.sampler.n_warmup)
    accept = sum(r["accept"] for r in samp) / len(samp)
    if not 0.05 < accept < 0.99:
        raise RuntimeError(f"MALA path: acceptance {accept} outside "
                           "(0.05, 0.99)")
    print(f"MALA path: launches {mala_launches}; Laplace setup "
          f"{lap[0]['seconds']:.3f} s (MAP trace {lap[0]['logpost_first']} -> "
          f"{lap[0]['logpost_last']} over {lap[0]['n_trace']} evaluations); "
          f"logpost_mean {init['logpost_mean']} -> {samp[-1]['logpost_mean']}; "
          f"acceptance {accept:.4f}; {rate_all:.2f} chain-steps/s over "
          f"{steps} steps x {N_CHAINS} chains after init, {rate_last:.2f} in "
          f"the last segment (cli wall {wall:.1f} s including data and "
          f"set-up)")

    # 7. The AM path of slice 1 through the CLI.
    k1.launches = k4.launches = 0
    recs, _, wall = _run_cli(cli, [
        "run", AM_CONFIG, *AM_ARGS, f"io.checkpoint_path={am_ck}",
        "io.checkpoint_every=40"])
    am_launches = k1.launches
    am_recs = recs
    if am_launches <= 0:
        raise RuntimeError("AM path: the sweep kernel was never launched")
    am_cfg = apply_overrides(load_config(AM_CONFIG), AM_ARGS)
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "AM path", am_cfg.sampler.n_warmup)
    am_step = samp[-1]["step_size"]
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"AM path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    print(f"AM path: {am_launches} K1 launches, {k4.launches} K4; "
          f"logpost_mean {init['logpost_mean']} -> {samp[-1]['logpost_mean']}; "
          f"{rate_all:.2f} chain-steps/s over {steps} steps x {N_CHAINS} "
          f"chains after init, {rate_last:.2f} in the last segment (cli wall "
          f"{wall:.1f} s)")

    # 8. K3 vs plain, on the card: its cycle entry and its solve entry, on
    # each of its two routes.
    def k3_pair(label, s, srcs, g, ecfg, done=None, nan_field=False):
        """One cycle and a whole solve through K3, on each route the grid
        fits, and the plain versions (bar: bit for bit, NaN included, and
        the same per-field cycle counts); the solve route of
        ``solve_eikonal_batched`` is one K3 launch, on the route
        ``route_for`` picks. Returns {route: (cycle ms, solve ms)}, the
        plain cycle ms and plain solve ms, the cycles summed over fields
        and the route picked. ``nan_field`` appends a field with a NaN in
        its slowness, which must stop after one cycle."""
        if nan_field:
            s = torch.cat([s, s[:1]]).contiguous()
            s[-1, g.shape[0] // 2, g.shape[1] // 2] = float("nan")
            srcs = torch.cat([srcs, srcs[:1]])
            if done is not None:
                done = torch.cat([done, done[:1]])
        T0, _ = seed_source(s, srcs, g, ecfg.seed_radius)
        scal = torch.cat(source_scalars(s, srcs, g), dim=1).contiguous()
        if done is None:
            done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)
        rad = ecfg.seed_radius
        picked = cuda_sweep2d.route_for(T0.shape[0], g.shape, dev)
        T1_p, ms_p = _timed(lambda: sweep_seeded_cycle_plain(
            T0, s, scal, g.spacing, ecfg.n_inner, done, seed_radius=rad),
            reps=0)
        (T_p, cyc_p), ms_sp = _timed(lambda: sweep_solve(
            T0, scal, s, g.spacing, ecfg.tol, ecfg.max_iters, ecfg.n_inner,
            cycle=functools.partial(sweep_seeded_cycle_plain,
                                    seed_radius=rad), return_cycles=True),
            reps=0)
        launches0 = k3.launches
        T1_auto = cuda_sweep.seeded_cycle(T0, s, scal, g.spacing,
                                          ecfg.n_inner, done, seed_radius=rad)
        if k3.launches != launches0 + 1:
            raise RuntimeError(f"K3 {label}: the kernel was not launched")
        launches0 = k3.launches
        T_r = solve_eikonal_batched(s, srcs, g,
                                    dataclasses.replace(ecfg, use_pallas="on"))
        one_launch = (k3.launches == launches0 + 1
                      and _same_bits(T1_auto, T1_p))
        times = {}
        for route in cuda_sweep2d.ROUTES:
            if (route == "block" and cuda_sweep2d.block_smem_bytes(g.shape)
                    > cuda_sweep2d.MAX_SMEM_BYTES):
                continue
            T1_k, ms_k = _timed(lambda: k3.cycle(
                T0, s, scal, g.spacing, ecfg.n_inner, done, seed_radius=rad,
                route=route), reps=10)
            same_cycle = _same_bits(T1_k, T1_p)
            kept = _same_bits(T1_k[done], T0[done])
            (T_k, cyc_k), ms_sk = _timed(lambda: k3.solve(
                T0, s, scal, g.spacing, ecfg.n_inner, ecfg.tol,
                ecfg.max_iters, seed_radius=rad, route=route), reps=3)
            same_solve = _same_bits(T_k, T_p) and torch.equal(cyc_k, cyc_p)
            one_launch = one_launch and _same_bits(T_r, T_k)
            err = _abs_err(T1_k, T1_p)
            err_s = _abs_err(T_k, T_p)
            nan_ok = True
            if nan_field:
                nan_ok = (bool(torch.isnan(T_k[-1]).any())
                          and int(cyc_k[-1]) == 1
                          and bool(torch.isfinite(T_k[:-1]).all()))
            print(f"K3 compare {label}, {route} route"
                  f"{' (picked)' if route == picked else ''}: "
                  f"B={T0.shape[0]} grid={g.shape} spacing={g.spacing}: one "
                  f"cycle bit for bit {same_cycle} (max|kernel-plain| "
                  f"{err:.3e}), ms per launch kernel {ms_k:.3f}, plain "
                  f"{ms_p:.3f}; solve at tol {ecfg.tol} bit for bit with "
                  f"equal per-field cycles {same_solve} (max|kernel-plain| "
                  f"{err_s:.3e}; cycles per field mean "
                  f"{float(cyc_k.float().mean()):.3f}, max "
                  f"{int(cyc_k.max())}, sum {int(cyc_k.sum())}), ms per "
                  f"solve kernel {ms_sk:.3f} (one launch), plain host loop "
                  f"{ms_sp:.3f}; done fields {int(done.sum())} untouched "
                  f"{kept}" + (f"; the NaN field NaN after 1 cycle {nan_ok}"
                               if nan_field else ""))
            if not (same_cycle and kept and same_solve and nan_ok):
                raise RuntimeError(
                    f"K3 {label}, {route} route: kernel disagrees with plain "
                    f"(cycle {err}, solve {err_s}, done fields kept {kept}, "
                    f"NaN field {nan_ok})")
            errs["sweep2d"].extend([err, err_s])
            times[route] = (ms_k, ms_sk)
        print(f"K3 {label}: the wrapper's route {picked}; seeded_cycle and "
              f"solve_eikonal_batched one launch each, same bits "
              f"{one_launch}")
        if not one_launch or picked not in times:
            raise RuntimeError(f"K3 {label}: the wrapper's route {picked} "
                               f"disagrees (one launch {one_launch})")
        return times, ms_p, ms_sp, int(cyc_p.sum()), picked

    # (a) config 4's batch: prior-drawn particles x its crosswell sources.
    c4 = load_config(C4_CONFIG)
    g4 = c4.grid.build()
    data4, _ = make_dataset(g4, c4.data, c4.model, device=dev)
    post4 = build_posterior(c4.model, data4, g4, c4.eikonal)
    n_part = c4.sampler.n_particles
    parts = post4.sample_prior(gen, n_part)
    ecfg4 = EikonalConfig(tol=c4.eikonal.tol, max_iters=c4.eikonal.max_iters,
                          n_inner=c4.eikonal.n_inner,
                          seed_radius=c4.eikonal.seed_radius)
    n_src4 = data4.src_xyz.shape[0]
    s4 = post4.slowness_of(parts).unsqueeze(1).expand(
        (n_part, n_src4) + g4.shape).reshape((-1,) + g4.shape).contiguous()
    k3_c4, ms_k3_plain, ms_k3s_plain, k3_cycles, _ = k3_pair(
        "a (c4 batch)", s4, data4.src_xyz.repeat(n_part, 1), g4, ecfg4)
    del s4
    # (b) config 1's batch: 4 chains (an RWM start) x its sources.
    c1 = load_config(C1_CONFIG)
    g1 = c1.grid.build()
    data1, _ = make_dataset(g1, c1.data, c1.model, device=dev)
    post1 = build_posterior(c1.model, data1, g1, c1.eikonal)
    u1 = post1.init_params(gen, c1.sampler.n_chains).u
    n_src1 = data1.src_xyz.shape[0]
    s1 = post1.slowness_of(Params(u=u1)).unsqueeze(1).expand(
        (c1.sampler.n_chains, n_src1) + g1.shape).reshape((-1,) + g1.shape)
    ecfg1 = EikonalConfig(tol=c1.eikonal.tol, max_iters=c1.eikonal.max_iters,
                          n_inner=c1.eikonal.n_inner,
                          seed_radius=c1.eikonal.seed_radius)
    k3_c1, ms_k3_c1_plain, ms_k3s_c1_plain, k3_cycles_c1, route_c1 = \
        k3_pair("b (c1 batch)", s1.contiguous(),
                data1.src_xyz.repeat(c1.sampler.n_chains, 1), g1, ecfg1)
    # (c) odd, anisotropic, non-square, with done flags.
    g_o = Grid((37, 23), (1.0, 1.25))
    u_o = 0.5 * torch.randn((7, 6, 6), generator=gen, device=dev)
    s_o = slowness_from_u(u_o, g_o, torch.tensor(1.0, device=dev))
    srcs_o = (0.05 + 0.9 * torch.rand((7, 2), generator=gen, device=dev)) \
        * torch.tensor(g_o.extent, device=dev)
    done_o = torch.tensor([False, True, False, False, True, False, True],
                          device=dev)
    k3_pair("c (odd anisotropic non-square, done flags, a NaN field)", s_o,
            srcs_o, g_o, EikonalConfig(tol=1e-5, max_iters=100), done=done_o,
            nan_field=True)

    # Config 4's log-likelihood of the 10,000 particles, K3 vs plain.
    post4_off = build_posterior(
        c4.model, data4, g4,
        apply_overrides(c4, ["eikonal.use_pallas=off"]).eikonal)
    l3 = k3.launches
    ll_k, ms_llk = _timed(lambda: post4.log_lik(parts))
    if k3.launches == l3:
        raise RuntimeError("c4 log-likelihood: K3 was not launched")
    ll_p, ms_llp = _timed(lambda: post4_off.log_lik(parts))
    ll_rel = float(((ll_k - ll_p).abs() / ll_p.abs()).max())
    print(f"c4 log-likelihood of {n_part} prior particles: max relative "
          f"|K3-plain| = {ll_rel:.3e} (bar {LL_RTOL}); ms per log_lik: K3 "
          f"{ms_llk:.3f}, plain {ms_llp:.3f}")
    if not bool(torch.isfinite(ll_k).all()) or not ll_rel <= LL_RTOL:
        raise RuntimeError(f"c4 log-likelihood: K3 disagrees ({ll_rel})")
    del parts, post4_off, ll_k, ll_p
    torch.cuda.empty_cache()

    # 9. Config 4's SMC at full width through the CLI's SMC entry point.
    k1.launches = k4.launches = k3.launches = k3.block_launches = 0
    k3_cycles0 = k3.field_cycles()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_smc_config(c4, device="cuda", verbose=True,
                         max_stages=SMC_STAGES)
    smc_wall = time.perf_counter() - t0
    smc_launches, smc_block = k3.launches, k3.block_launches
    smc_cycles = k3.field_cycles() - k3_cycles0
    if smc_launches - smc_block <= 0:
        raise RuntimeError("SMC path: K3's warp route was never launched")
    betas = res.betas
    target = c4.sampler.ess_threshold * n_part
    if not all(b1 > b0 for b0, b1 in zip(betas, betas[1:])):
        raise RuntimeError(f"SMC path: beta not strictly rising ({betas})")
    for b0, b1, e in zip(betas, betas[1:], res.ess_history[1:]):
        floored = b1 - b0 <= 1.000001e-6
        if not (b1 == 1.0 or floored or abs(e - target) <= 0.01 * target):
            raise RuntimeError(f"SMC path: ESS {e} at beta {b1} is off its "
                               f"target {target}")
    if not (math.isfinite(res.log_evidence)
            and all(math.isfinite(a) for a in res.accept_history)
            and bool(torch.isfinite(res.state.log_lik).all())):
        raise RuntimeError("SMC path: non-finite log Z, acceptance or "
                           "log-likelihood")
    per_stage = sum(res.stage_seconds) / res.n_stages
    pms = (n_part * c4.sampler.n_mutation_steps * res.n_stages
           / sum(res.stage_seconds))
    print(f"SMC path: {smc_launches} K3 launches (one per solve; "
          f"{smc_block} of them on the block route), "
          f"{smc_cycles} cycles counted by the kernel, summed over fields; "
          f"{res.n_stages} stages, "
          f"betas {betas}, ESS {res.ess_history}, acceptance "
          f"{res.accept_history}, log Z {res.log_evidence:.3f}; "
          f"{per_stage:.3f} s per stage (stages {res.stage_seconds}), "
          f"{pms:.1f} particle-mutation-steps/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; run wall "
          f"{smc_wall:.1f} s including data and the initial particles")

    # 10. Config 1's RWM at full width through the CLI.
    k1.launches = k4.launches = k3.launches = k3.block_launches = 0
    recs, _, wall = _run_cli(cli, ["run", C1_CONFIG, *C1_ARGS])
    rwm_launches = k3.launches
    if rwm_launches <= 0:
        raise RuntimeError("RWM path: K3 was never launched")
    c1_run = apply_overrides(c1, C1_ARGS)
    n1 = c1_run.sampler.n_chains
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "RWM path", c1_run.sampler.n_warmup, n1)
    accept = sum(r["accept"] for r in samp) / len(samp)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"RWM path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    if not 0.05 < accept < 0.99:
        raise RuntimeError(f"RWM path: acceptance {accept} outside "
                           "(0.05, 0.99)")
    print(f"RWM path: {rwm_launches} K3 launches ({k3.block_launches} on "
          f"the block route); logpost_mean "
          f"{init['logpost_mean']} -> {samp[-1]['logpost_mean']}; acceptance "
          f"{accept:.4f}; {rate_all:.2f} chain-steps/s over {steps} steps x "
          f"{n1} chains after init, {rate_last:.2f} in the last segment "
          f"(cli wall {wall:.1f} s); K3 ms per launch at c1's batch "
          f"{k3_c1[route_c1][0]:.3f} ({route_c1} route), plain "
          f"{ms_k3_c1_plain:.3f}")
    print(f"phases 1-10 wall {time.perf_counter() - t_start:.1f} s")

    # 11. K1 and K4 at config 3's batch: prior-drawn chains x stations.
    c3 = load_config(C3_CONFIG)
    g3 = c3.grid.build()
    data3, _ = make_dataset(g3, c3.data, c3.model, device=dev)
    post3 = build_posterior(c3.model, data3, g3, c3.eikonal,
                            differentiable=True)
    n3, n_sta = c3.sampler.n_chains, data3.sta_xyz.shape[0]
    p3 = post3.sample_prior(gen, n3)
    s3 = post3.slowness_of(p3).unsqueeze(1).expand(
        (n3, n_sta) + g3.shape).reshape((-1,) + g3.shape).contiguous()
    srcs3 = data3.sta_xyz.repeat(n3, 1)
    ecfg3 = EikonalConfig(tol=c3.eikonal.tol, max_iters=c3.eikonal.max_iters,
                          n_inner=c3.eikonal.n_inner,
                          seed_radius=c3.eikonal.seed_radius)
    T0_3, frozen3 = seed_source(s3, srcs3, g3, ecfg3.seed_radius)
    done3 = torch.zeros(T0_3.shape[0], dtype=torch.bool, device=dev)
    _, ms_k1_c3, ms_k1_c3_plain = k1_cycle_pair("c3 batch", T0_3, s3, srcs3,
                                                g3, ecfg3, reps=10)
    b_k1_c3, _ = _k1_bound(T0_3, ecfg3.n_inner)
    on3 = dataclasses.replace(ecfg3, use_pallas="on")
    off3 = dataclasses.replace(ecfg3, use_pallas="off")
    l1 = k1.launches
    T3, ms_s3k = _timed(lambda: solve_eikonal_batched(s3, srcs3, g3, on3))
    cycles3 = (k1.launches - l1) / 2     # the warm-up call and the timed one
    T3p, ms_s3p = _timed(lambda: solve_eikonal_batched(s3, srcs3, g3, off3))
    err_s3 = float((T3 - T3p).abs().max())
    print(f"K1 compare c3 batch: B={T0_3.shape[0]} grid={g3.shape}: solve "
          f"at tol {ecfg3.tol} max|kernel-plain| = {err_s3:.3e}, "
          f"{cycles3:.0f} cycles, ms per solve kernel {ms_s3k:.3f}, plain "
          f"{ms_s3p:.3f}")
    if not (bool(torch.isfinite(T3).all()) and torch.equal(T3, T3p)):
        raise RuntimeError(f"K1 c3: kernel solve disagrees with plain "
                           f"({err_s3})")
    errs["sweep3d_cycle"].append(err_s3)

    T3g = T3.clone().requires_grad_(True)
    resid3 = data3.t_obs - predict_events(
        T3g.reshape((n3, n_sta) + g3.shape), box_from_raw(p3.hypo_raw, g3),
        p3.t0, g3)
    (ct3,) = torch.autograd.grad(_gaussian_loglik(
        resid3, torch.full_like(resid3, c3.model.sigma), None).sum(), T3g)
    ws3 = transport_weights(T3, s3, frozen3, g3.spacing)
    l4 = k4.launches
    lam1k3, ms_k4_c3 = _timed(lambda: cuda_transport.transport_cycle(
        ct3, ct3, ws3, ecfg3.n_inner, done3), reps=10)
    if k4.launches == l4:
        raise RuntimeError("K4 c3 cycle: the kernel was not launched")
    lam1p3, ms_k4_c3_plain = _timed(lambda: transport_cycle_plain(
        ct3, ct3, ws3, ecfg3.n_inner, done3))
    print(f"K4 one cycle, c3 batch B={ct3.shape[0]} grid={g3.shape}: ms per "
          f"launch: kernel {ms_k4_c3:.3f}, plain {ms_k4_c3_plain:.3f}")
    k4_check("c3 batch (joint log-likelihood cotangents, one cycle)",
             lam1k3, lam1p3)
    k4_check("c3 batch (joint log-likelihood cotangents, solve)",
             *k4_solve_pair("c3", ct3, ws3, ecfg3.tol, ecfg3.max_iters))
    del T3p, T3g, lam1k3, lam1p3, ws3

    # 12. The joint gradient of 8 chains, K1 + K4 against the plain solves,
    # and against a central finite difference.
    post3_p = build_posterior(
        c3.model, data3, g3,
        apply_overrides(c3, ["eikonal.use_pallas=off"]).eikonal,
        differentiable=True)
    l1, l4 = k1.launches, k4.launches
    (lp3k, g3k), ms_g3k = _timed(lambda: value_and_grad(post3.logpost)(p3))
    if k1.launches == l1 or k4.launches == l4:
        raise RuntimeError("c3 gradient: a kernel was not launched")
    (lp3p, g3p), ms_g3p = _timed(lambda: value_and_grad(post3_p.logpost)(p3))
    leaves = ("u", "hypo_raw", "t0")
    rel3 = {}
    for f in leaves:
        a, b = getattr(g3k, f), getattr(g3p, f)
        rel3[f] = float((a - b).abs().max()) / float(b.abs().max())
        if not bool(torch.isfinite(a).all()) or not rel3[f] <= GRAD_REL_BAR:
            raise RuntimeError(f"c3 gradient {f}: kernels disagree with "
                               f"plain ({rel3[f]})")
    print(f"c3 joint gradient, {n3} chains: max|kernel-plain| / max|grad| "
          f"{rel3}; logpost max|diff| {float((lp3k - lp3p).abs().max()):.3e}; "
          f"ms per value_and_grad: kernels {ms_g3k:.3f}, plain {ms_g3p:.3f}")
    post3_fd = build_posterior(
        c3.model, data3, g3,
        apply_overrides(c3, ["eikonal.tol=1e-6",
                             "eikonal.max_iters=300"]).eikonal,
        differentiable=True)
    _, g3fd = value_and_grad(post3_fd.logpost)(p3)
    vdir = {f: torch.randn(getattr(p3, f).shape, generator=gen, device=dev)
            for f in leaves}
    norm = torch.sqrt(sum(v.flatten(1).pow(2).sum(1) for v in vdir.values()))
    vdir = {f: v / norm.reshape((-1,) + (1,) * (v.ndim - 1))
            for f, v in vdir.items()}
    eps = 1e-3
    shifted = lambda sgn: Params(**{f: getattr(p3, f) + sgn * eps * vdir[f]
                                    for f in leaves})
    fd3 = (post3_fd.logpost(shifted(1.0))
           - post3_fd.logpost(shifted(-1.0))) / (2 * eps)
    ad3 = sum((getattr(g3fd, f) * vdir[f]).flatten(1).sum(1) for f in leaves)
    rel_fd3 = float((ad3.sum() - fd3.sum()).abs()
                    / torch.maximum(ad3.sum().abs(), fd3.sum().abs()))
    worst3 = float(((ad3 - fd3).abs()
                    / torch.maximum(ad3.abs(), fd3.abs())).max())
    print(f"c3 joint gradient vs central finite difference along one random "
          f"direction of u, hypo_raw and t0 of all {n3} chains at tol 1e-6: "
          f"relative error {rel_fd3:.3e} (bar {FD_BAR}); worst single chain "
          f"{worst3:.3e}")
    if not rel_fd3 < FD_BAR:
        raise RuntimeError(f"c3 gradient: finite difference disagrees "
                           f"({rel_fd3})")
    del post3_p, post3_fd, g3fd
    torch.cuda.empty_cache()

    # 13. Config 3's NUTS at full width through the CLI.
    k1.launches = k4.launches = k3.launches = 0
    torch.cuda.reset_peak_memory_stats()
    recs, _, wall = _run_cli(cli, ["run", C3_CONFIG, *C3_NUTS_ARGS])
    nuts_launches = {"sweep3d_cycle": k1.launches,
                     "transport3d_cycle": k4.launches}
    if min(nuts_launches.values()) <= 0:
        raise RuntimeError(f"NUTS path: a kernel was never launched "
                           f"({nuts_launches})")
    c3_nuts = apply_overrides(c3, C3_NUTS_ARGS)
    init, samp, steps, rate_all, rate_last = _check_run(
        recs, "NUTS path", c3_nuts.sampler.n_warmup, n3)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"NUTS path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    mean = lambda k: sum(r[k] for r in samp) / len(samp)
    print(f"NUTS path (c3): launches {nuts_launches} "
          f"({nuts_launches['sweep3d_cycle'] / steps:.1f} K1 and "
          f"{nuts_launches['transport3d_cycle'] / steps:.1f} K4 per step over "
          f"{steps} steps); logpost_mean {init['logpost_mean']} -> "
          f"{samp[-1]['logpost_mean']}; mean tree depth {mean('tree_depth'):.3f}, "
          f"divergent share {mean('divergent'):.3f}, acceptance statistic "
          f"{mean('accept'):.4f} (sampling segments); {rate_all:.3f} "
          f"chain-steps/s over {steps} steps x {n3} chains after init, "
          f"{rate_last:.3f} in the last segment; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (cli wall "
          f"{wall:.1f} s)")

    # 14. A short HMC run on config 3 through the CLI.
    k1.launches = k4.launches = 0
    recs, _, wall = _run_cli(cli, ["run", C3_CONFIG, *C3_HMC_ARGS])
    hmc_launches = {"sweep3d_cycle": k1.launches,
                    "transport3d_cycle": k4.launches}
    if min(hmc_launches.values()) <= 0:
        raise RuntimeError(f"HMC path: a kernel was never launched "
                           f"({hmc_launches})")
    c3_hmc = apply_overrides(c3, C3_HMC_ARGS)
    init, samp, steps, rate_all, _ = _check_run(
        recs, "HMC path", c3_hmc.sampler.n_warmup, n3)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"HMC path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    print(f"HMC path (c3, {c3_hmc.sampler.n_leapfrog} leapfrogs): launches "
          f"{hmc_launches}; logpost_mean {init['logpost_mean']} -> "
          f"{samp[-1]['logpost_mean']}; acceptance {mean('accept'):.4f}; "
          f"{rate_all:.3f} chain-steps/s over {steps} steps (cli wall "
          f"{wall:.1f} s)")
    del post3, data3, p3, s3, srcs3, T3, ct3
    torch.cuda.empty_cache()
    print(f"phases 1-14 wall {time.perf_counter() - t_start:.1f} s")

    # 15. K1 and K5 at config 5's 128^3 batch: prior-drawn chains x stations.
    c5 = load_config(C5_CONFIG)
    g5 = c5.grid.build()
    data5, _ = make_dataset(g5, c5.data, c5.model, device=dev)
    post5 = build_posterior(c5.model, data5, g5, c5.eikonal)
    n_sta5 = data5.sta_xyz.shape[0]
    p5 = post5.sample_prior(gen, C5_CHAINS)
    s5 = post5.slowness_of(p5).unsqueeze(1).expand(
        (C5_CHAINS, n_sta5) + g5.shape).reshape((-1,) + g5.shape).contiguous()
    srcs5 = data5.sta_xyz.repeat(C5_CHAINS, 1)
    ecfg5 = EikonalConfig(tol=c5.eikonal.tol, max_iters=c5.eikonal.max_iters,
                          n_inner=c5.eikonal.n_inner,
                          seed_radius=c5.eikonal.seed_radius)
    T0_5, frozen5 = seed_source(s5, srcs5, g5, ecfg5.seed_radius)
    done5 = torch.zeros(T0_5.shape[0], dtype=torch.bool, device=dev)
    _, ms_k1_c5, ms_k1_c5_plain = k1_cycle_pair("c5 batch", T0_5, s5, srcs5,
                                                g5, ecfg5, reps=3)
    b_k1_c5, _ = _k1_bound(T0_5, ecfg5.n_inner)
    l1 = k1.launches
    T5, ms_s5k = _timed(lambda: solve_eikonal_batched(
        s5, srcs5, g5, dataclasses.replace(ecfg5, use_pallas="on")))
    cycles5 = (k1.launches - l1) / 2     # the warm-up call and the timed one
    route5 = solve_route(g5.shape, "on", dev)
    print(f"K1 compare c5 batch: B={T0_5.shape[0]} grid={g5.shape}: kernel "
          f"solve at tol "
          f"{ecfg5.tol}, max_iters {ecfg5.max_iters}, route {route5} "
          f"({CYCLES_PER_ITER[route5]} cycles per iteration): {cycles5:.0f} "
          f"cycles, {ms_s5k:.3f} ms")
    if route5 != "blocked":
        raise RuntimeError(f"c5: route {route5}, not the blocked count")
    # The plain solve with the blocked route's count (two cycles per
    # counted iteration) must give the kernel solve's bits.
    T5p = sweep_solve(T0_5, seed_floor(T0_5, frozen5), s5, g5.spacing,
                      ecfg5.tol, ecfg5.max_iters, ecfg5.n_inner,
                      cycles_per_iter=CYCLES_PER_ITER[route5])
    err_s5 = float((T5 - T5p).abs().max())
    print(f"K1 c5 batch: blocked solve max|kernel-plain| = {err_s5:.3e}")
    if not (bool(torch.isfinite(T5).all()) and torch.equal(T5, T5p)):
        raise RuntimeError(f"K1 c5: kernel solve disagrees with plain "
                           f"({err_s5})")
    errs["sweep3d_cycle"].append(err_s5)
    del T0_5, T5p
    # The error at the config's max_iters to the converged field (tol
    # 1e-5, no max_iters to speak of).
    l1 = k1.launches
    T5c = solve_eikonal_batched(s5, srcs5, g5, dataclasses.replace(
        ecfg5, tol=1e-5, max_iters=300))
    gap = (T5 - T5c).abs().flatten(1).amax(1)
    print(f"K1 c5 batch converged to tol 1e-5: {k1.launches - l1} cycles; "
          f"at tol {ecfg5.tol} and max_iters {ecfg5.max_iters} the "
          f"traveltimes are up to {float(gap.max()):.6f} from it (max T "
          f"{float(T5c.max()):.2f}), on {int((gap > c5.model.sigma).sum())} "
          f"of {gap.numel()} fields by more than sigma {c5.model.sigma}")
    del T5c, gap

    T5g = T5.clone().requires_grad_(True)
    resid5 = data5.t_obs - predict_events(
        T5g.reshape((C5_CHAINS, n_sta5) + g5.shape),
        box_from_raw(p5.hypo_raw, g5), p5.t0, g5)
    (ct5,) = torch.autograd.grad(_gaussian_loglik(
        resid5, torch.full_like(resid5, c5.model.sigma), None).sum(), T5g)
    del T5g, resid5
    ws5 = transport_weights(T5, s5, frozen5, g5.spacing)
    if cuda_transport.transport_kernel_for(g5.shape) is not k5:
        raise RuntimeError("c5: the transport dispatch did not pick K5")
    l5 = k5.launches
    lam1k5, ms_k5 = _timed(lambda: cuda_transport.transport_cycle(
        ct5, ct5, ws5, ecfg5.n_inner, done5), reps=3)
    if k5.launches == l5:
        raise RuntimeError("K5 c5 cycle: the kernel was not launched")
    lam1p5, ms_k5_plain = _timed(lambda: transport_cycle_plain(
        ct5, ct5, ws5, ecfg5.n_inner, done5))
    print(f"K5 one cycle, c5 batch B={ct5.shape[0]} grid={g5.shape}: ms per "
          f"launch: kernel {ms_k5:.3f}, plain {ms_k5_plain:.3f}")
    k4_check("c5 batch (joint log-likelihood cotangents, one cycle)",
             lam1k5, lam1p5, name="K5")
    del lam1k5, lam1p5
    l5 = k5.launches
    lam5, ms_sk5 = _timed(lambda: transport_solve(
        ct5, ws5, ecfg5.tol, ecfg5.max_iters, ecfg5.n_inner,
        cycle=cuda_transport.transport_cycle,
        cycles_per_iter=CYCLES_PER_ITER[route5]))
    tcycles5 = (k5.launches - l5) / 2
    print(f"K5 solve c5 batch at tol {ecfg5.tol}: {tcycles5:.0f} cycles, "
          f"{ms_sk5:.3f} ms, finite {bool(torch.isfinite(lam5).all())}")
    if not bool(torch.isfinite(lam5).all()):
        raise RuntimeError("K5 c5 solve: non-finite adjoint")
    b_k5, by_k5 = _bound(s5.numel(), 24, _k4_ops(ecfg5.n_inner))
    b_k5_c2, _ = _bound(s_a.numel(), 24, _k4_ops(cfg.eikonal.n_inner))
    del post5, data5, p5, s5, srcs5, T5, frozen5, ct5, ws5, lam5
    torch.cuda.empty_cache()

    # 16. Config 5's NUTS with spike-slab noise at full width, 4 chains,
    # through the CLI. The run's summary is kept (the CLI prints it and
    # returns 0) to read the indicators.
    from mceik_tpu_torch import api
    summaries = []
    api_run = api.run

    def keep_summary(*a, **kw):
        summaries.append(api_run(*a, **kw))
        return summaries[-1]

    k1.launches = k4.launches = k3.launches = k5.launches = 0
    torch.cuda.reset_peak_memory_stats()
    api.run = keep_summary
    try:
        recs, _, wall = _run_cli(cli, ["run", C5_CONFIG, *C5_ARGS])
    finally:
        api.run = api_run
    c5_launches = {"sweep3d_cycle": k1.launches,
                   "transport3d_large_cycle": k5.launches}
    if min(c5_launches.values()) <= 0:
        raise RuntimeError(f"c5 path: a kernel was never launched "
                           f"({c5_launches})")
    c5_run = apply_overrides(c5, C5_ARGS)
    # The annealed warmup takes one more step on each of its 4 rungs.
    init, samp, steps, rate_all, _ = _check_run(
        recs, "c5 path", c5_run.sampler.n_warmup + 4, C5_CHAINS)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"c5 path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    z5 = torch.as_tensor(summaries[-1].samples.noise_z)
    zs = summaries[-1].result.states.params.noise_z
    if not (bool(((z5 == 0) | (z5 == 1)).all())
            and bool(((zs == 0) | (zs == 1)).all())):
        raise RuntimeError("c5 path: an indicator left {0, 1}")
    warm = [r for r in recs if r["phase"] == "warmup"]
    print(f"c5 path (joint NUTS, spike-slab, {C5_CHAINS} chains x {n_sta5} "
          f"stations of 128^3): launches {c5_launches} (K4 {k4.launches}); "
          f"logpost_mean {init['logpost_mean']} -> "
          f"{warm[0]['logpost_mean'] if warm else None} after the annealed "
          f"warmup -> {samp[-1]['logpost_mean']}; inclusion "
          f"{[r['noise_inclusion'] for r in warm + samp]}; mean tree depth "
          f"{mean('tree_depth'):.3f}; {rate_all:.4f} chain-steps/s over "
          f"{steps} steps after init; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (cli wall "
          f"{wall:.1f} s)")
    print(f"phases 1-16 wall {time.perf_counter() - t_start:.1f} s")

    # 17. K6 against its plain version on three batches, its cycle entry
    # and its solve entry (bar: bit for bit as int32, NaN included, and the
    # same per-field cycle counts).
    def k6_pair(label, g_, ws_, tol, max_cycles, n_inner, done=None,
                diverged=None):
        """One cycle (with ``done`` flags) and a whole solve through K6 and
        the plain versions; ``diverged`` indexes a field that must come back
        all NaN from both solves. Returns (cycle ms, plain cycle ms, solve
        ms, plain solve ms, cycles summed over fields)."""
        if done is None:
            done = torch.zeros(g_.shape[0], dtype=torch.bool, device=dev)
        l6 = k6.launches
        out_k, ms_c = _timed(lambda: cuda_transport.transport_cycle(
            g_, g_, ws_, n_inner, done), reps=10)
        if k6.launches == l6:
            raise RuntimeError(f"K6 {label}: the kernel was not launched")
        out_p, ms_cp = _timed(lambda: transport_cycle_plain(
            g_, g_, ws_, n_inner, done), reps=0)
        same_cycle = torch.equal(_bits(out_k), _bits(out_p))
        kept = torch.equal(_bits(out_k[done]), _bits(g_[done]))
        (lam_k, cyc_k), ms_s = _timed(lambda: k6.solve(
            g_, ws_, tol, max_cycles, n_inner), reps=3)
        (lam_p, cyc_p), ms_sp = _timed(lambda: transport_solve(
            g_, ws_, tol, max_cycles, n_inner, return_cycles=True), reps=0)
        same_solve = (torch.equal(_bits(lam_k), _bits(lam_p))
                      and torch.equal(cyc_k, cyc_p))
        l6 = k6.launches
        lam_r = cuda_transport.solve(g_, ws_, tol, max_cycles, n_inner)
        one_launch = (k6.launches == l6 + 1
                      and torch.equal(_bits(lam_r), _bits(lam_k)))
        div_ok = True
        finite = lam_k
        if diverged is not None:
            div_ok = bool(torch.isnan(lam_k[diverged]).all())
            finite = torch.cat([lam_k[:diverged], lam_k[diverged + 1:]])
        finite = bool(torch.isfinite(finite).all()) and bool(
            torch.isfinite(out_k).all())
        err = _abs_err(out_k, out_p)
        err_s = _abs_err(lam_k, lam_p)
        print(f"K6 compare {label}: B={g_.shape[0]} grid="
              f"{tuple(g_.shape[1:])}: one cycle bit for bit {same_cycle} "
              f"(max|kernel-plain| {err:.3e}, max|plain| "
              f"{float(out_p.abs().max()):.3e}), ms per launch kernel "
              f"{ms_c:.3f}, plain {ms_cp:.3f}; done fields {int(done.sum())} "
              f"untouched {kept}; solve at tol {tol} bit for bit with equal "
              f"per-field cycles {same_solve} (cycles per field mean "
              f"{float(cyc_k.float().mean()):.3f}, max {int(cyc_k.max())}, "
              f"sum {int(cyc_k.sum())}), ms per solve kernel {ms_s:.3f} "
              f"(one launch), plain host loop {ms_sp:.3f}; "
              f"cuda_transport.solve one launch {one_launch}"
              + (f"; the divergent field all NaN {div_ok}"
                 if diverged is not None else ""))
        if not (same_cycle and kept and same_solve and one_launch and div_ok
                and finite):
            raise RuntimeError(f"K6 {label}: kernel disagrees with plain "
                               f"(cycle {err}, solve {err_s}, kept {kept}, "
                               f"one launch {one_launch}, divergent NaN "
                               f"{div_ok}, finite {finite})")
        errs["transport2d"].extend([err, err_s])
        return ms_c, ms_cp, ms_s, ms_sp, int(cyc_k.sum())

    # (a) config 1's batch: K3's solves of its 4 chains x 8 sources and the
    # cotangents of its log-likelihood there.
    n1c = c1.sampler.n_chains
    s1c = s1.contiguous()
    srcs1 = data1.src_xyz.repeat(n1c, 1)
    T1 = solve_eikonal_batched(s1c, srcs1, g1, ecfg1).requires_grad_(True)
    resid1 = data1.t_obs - interp_tables(
        T1.reshape((n1c, n_src1) + g1.shape), data1.rec_xyz, g1)
    (ct1,) = torch.autograd.grad(_gaussian_loglik(
        resid1, torch.full_like(resid1, c1.model.sigma), None).sum(), T1)
    T1 = T1.detach()
    ws1 = batch_weights(T1, s1c, srcs1, g1, ecfg1.seed_radius)
    ms_k6, ms_k6_plain, ms_k6s, ms_k6s_plain, k6_cycles = k6_pair(
        "a (c1 batch, log-likelihood cotangents)", ct1.contiguous(), ws1,
        ecfg1.tol, ecfg1.max_iters, ecfg1.n_inner)

    # (b) a config-4 batch: 10,000 prior-drawn particles x 8 sources,
    # weights from K3's solves, random cotangents.
    parts4 = post4.sample_prior(gen, n_part)
    s4 = post4.slowness_of(parts4).unsqueeze(1).expand(
        (n_part, n_src4) + g4.shape).reshape((-1,) + g4.shape).contiguous()
    srcs4 = data4.src_xyz.repeat(n_part, 1)
    T4 = solve_eikonal_batched(s4, srcs4, g4, ecfg4)
    ws4 = batch_weights(T4, s4, srcs4, g4, ecfg4.seed_radius)
    del T4, s4, parts4
    ct4 = 0.1 * torch.randn(ws4[0].shape, generator=gen, device=dev)
    ms_k6_c4, ms_k6_c4_plain, ms_k6s_c4, ms_k6s_c4_plain, k6_cycles_c4 = \
        k6_pair("b (c4 batch, K3-solved weights)", ct4, ws4, ecfg4.tol,
                ecfg4.max_iters, ecfg4.n_inner)
    del ct4, ws4, srcs4
    torch.cuda.empty_cache()

    # (c) the odd anisotropic batch of phase 8 with its done flags, and a
    # divergent field (node pairs feeding each other with weight 1.3).
    T_o = solve_eikonal_batched(s_o, srcs_o, g_o,
                                EikonalConfig(tol=1e-5, max_iters=100))
    ws_o = batch_weights(T_o, s_o, srcs_o, g_o, 3.0)
    div2 = []
    for d, n in enumerate(g_o.shape):
        idx = torch.arange(n, device=dev).reshape(
            [-1 if e == d else 1 for e in range(2)])
        div2.append(torch.where(idx % 2 == 0, -1.3, 1.3).expand(g_o.shape))
    ws_od = tuple(torch.cat([w, dv[None]]).contiguous()
                  for w, dv in zip(ws_o, div2))
    g_od = torch.cat([0.1 * torch.randn(T_o.shape, generator=gen, device=dev),
                      torch.ones_like(T_o[:1])])
    done_od = torch.cat([done_o, torch.zeros(1, dtype=torch.bool,
                                             device=dev)])
    k6_pair(f"c (odd batch, spacing {g_o.spacing}, done flags, a divergent "
            "field)", g_od, ws_od, 1e-6, 30, 2, done=done_od,
            diverged=g_od.shape[0] - 1)

    # 18. Config 1's gradient on the card: K3 + K6 against the plain
    # solves, and against a central finite difference.
    post1_k = build_posterior(c1.model, data1, g1, c1.eikonal,
                              differentiable=True)
    post1_p = build_posterior(
        c1.model, data1, g1,
        apply_overrides(c1, ["eikonal.use_pallas=off"]).eikonal,
        differentiable=True)
    params1 = Params(u=u1)
    l3, l6 = k3.launches, k6.launches
    (lp1k, g1k), ms_g1k = _timed(lambda: value_and_grad(post1_k.logpost)(
        params1))
    if k3.launches == l3 or k6.launches == l6:
        raise RuntimeError("c1 gradient: a kernel was not launched")
    (lp1p, g1p), ms_g1p = _timed(lambda: value_and_grad(post1_p.logpost)(
        params1))
    gscale1 = float(g1p.u.abs().max())
    gerr1 = float((g1k.u - g1p.u).abs().max())
    print(f"c1 gradient, {n1c} chains: max|kernel-plain| = {gerr1:.3e} (max|"
          f"grad| {gscale1:.3e}), logpost max|diff| "
          f"{float((lp1k - lp1p).abs().max()):.3e}; ms per value_and_grad: "
          f"kernels {ms_g1k:.3f}, plain {ms_g1p:.3f}")
    if not bool(torch.isfinite(g1k.u).all()) or \
            not gerr1 <= GRAD_REL_BAR * gscale1:
        raise RuntimeError(f"c1 gradient: kernels disagree with plain "
                           f"({gerr1})")
    post1_fd = build_posterior(
        c1.model, data1, g1,
        apply_overrides(c1, ["eikonal.tol=1e-6",
                             "eikonal.max_iters=300"]).eikonal,
        differentiable=True)
    _, g1fd = value_and_grad(post1_fd.logpost)(params1)
    v1 = torch.randn(u1.shape, generator=gen, device=dev)
    v1 = v1 / v1.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    eps = 1e-3
    fd1 = (post1_fd.logpost(Params(u=u1 + eps * v1))
           - post1_fd.logpost(Params(u=u1 - eps * v1))) / (2 * eps)
    ad1 = (g1fd.u * v1).flatten(1).sum(1)
    rel1 = float((ad1.sum() - fd1.sum()).abs()
                 / torch.maximum(ad1.sum().abs(), fd1.sum().abs()))
    worst1 = float(((ad1 - fd1).abs() / torch.maximum(ad1.abs(),
                                                      fd1.abs())).max())
    print(f"c1 gradient vs central finite difference along one random "
          f"direction of all {n1c} chains' parameters at tol 1e-6: relative "
          f"error {rel1:.3e} (bar {FD_BAR}); worst single chain {worst1:.3e}")
    if not rel1 < FD_BAR:
        raise RuntimeError(f"c1 gradient: finite difference disagrees "
                           f"({rel1})")
    del post1_k, post1_p, post1_fd

    # 19. Config 1 under NUTS and under MALA through the CLI.
    def c1_leg(label, args):
        for k in (k1, k3, k4, k5, k6):
            k.launches = 0
        k3.block_launches = 0
        cycles0 = (k3.field_cycles(), k6.field_cycles())
        recs, lines, wall = _run_cli(cli, ["run", C1_CONFIG, *args])
        launches = {"sweep2d": k3.launches,
                    "sweep2d_block": k3.block_launches,
                    "transport2d": k6.launches}
        launches.update(
            sweep2d_field_cycles=k3.field_cycles() - cycles0[0],
            transport2d_field_cycles=k6.field_cycles() - cycles0[1])
        if min(launches.values()) <= 0:
            raise RuntimeError(f"{label}: a kernel was never launched "
                               f"({launches})")
        run_cfg = apply_overrides(c1, args)
        init, samp, steps, rate_all, rate_last = _check_run(
            recs, label, run_cfg.sampler.n_warmup, run_cfg.sampler.n_chains)
        if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
            raise RuntimeError(f"{label}: logpost did not rise "
                               f"({init['logpost_mean']} -> "
                               f"{samp[-1]['logpost_mean']})")
        return recs, launches, init, samp, steps, rate_all, rate_last, wall

    recs, c1_nuts_launches, init, samp, steps, rate_all, rate_last, wall = \
        c1_leg("c1 NUTS path", C1_NUTS_ARGS)
    print(f"c1 NUTS path: launches and kernel-counted cycles "
          f"{c1_nuts_launches} ({c1_nuts_launches['transport2d'] / steps:.1f}"
          f" K6 launches and "
          f"{c1_nuts_launches['transport2d_field_cycles'] / steps:.1f} K6 "
          f"field-cycles per step over {steps} steps); logpost_mean {init['logpost_mean']} -> "
          f"{samp[-1]['logpost_mean']}; mean tree depth "
          f"{mean('tree_depth'):.3f}, divergent share {mean('divergent'):.3f}, "
          f"acceptance statistic {mean('accept'):.4f}; {rate_all:.3f} "
          f"chain-steps/s over {steps} steps after init, {rate_last:.3f} in "
          f"the last segment (cli wall {wall:.1f} s)")
    recs, c1_mala_launches, init, samp, steps, rate_all, rate_last, wall = \
        c1_leg("c1 MALA path", C1_MALA_ARGS)
    lap = [r for r in recs if r["phase"] == "laplace"]
    if len(lap) != 1 or not lap[0]["logpost_last"] > lap[0]["logpost_first"]:
        raise RuntimeError(f"c1 MALA path: the Laplace MAP trace did not "
                           f"rise ({lap})")
    if not 0.05 < mean("accept") < 0.99:
        raise RuntimeError(f"c1 MALA path: acceptance {mean('accept')} "
                           "outside (0.05, 0.99)")
    print(f"c1 MALA path: launches and kernel-counted cycles "
          f"{c1_mala_launches}; Laplace setup "
          f"{lap[0]['seconds']:.3f} s (MAP trace {lap[0]['logpost_first']} -> "
          f"{lap[0]['logpost_last']}); logpost_mean {init['logpost_mean']} -> "
          f"{samp[-1]['logpost_mean']}; acceptance {mean('accept'):.4f}; "
          f"{rate_all:.2f} chain-steps/s over {steps} steps after init, "
          f"{rate_last:.2f} in the last segment (cli wall {wall:.1f} s)")

    # 20. The gridbatch route on config 2's batch: the field route under
    # the reference's name, so the same launches and the same bits.
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    T_gb = solve_eikonal_batched(s_a, srcs_a, grid, econf, impl="gridbatch")
    gb_launches = k1.launches
    if gb_launches <= 0 or k3.launches or k4.launches or k5.launches:
        raise RuntimeError(f"gridbatch solve: not through K1 alone "
                           f"(K1 {gb_launches})")
    _, ms_gb = _timed(lambda: solve_eikonal_batched(
        s_a, srcs_a, grid, econf, impl="gridbatch"))
    T_fd, ms_fd = _timed(lambda: solve_eikonal_batched(
        s_a, srcs_a, grid, econf, impl="field"))
    err_gb = float((T_gb - T_fd).abs().max())
    print(f"gridbatch solve, c2 batch at tol {econf.tol}: {gb_launches} K1 "
          f"launches; max|gridbatch-field| = {err_gb:.3e}; ms per solve "
          f"gridbatch {ms_gb:.3f}, field {ms_fd:.3f}")
    if not torch.equal(T_gb, T_fd):
        raise RuntimeError(f"gridbatch solve disagrees with field ({err_gb})")
    errs["gridbatch"].append(err_gb)
    # 21-26: locate mode, the table cache, the grid search, and resume.
    t_new = time.perf_counter()
    model_pt = os.path.join(tmp, "c3_model.pt")
    cache_dir = os.path.join(tmp, "tables")
    loc_args = ["model.mode=locate", f"model.fixed_slowness_path={model_pt}",
                f"model.table_cache_dir={cache_dir}"]

    # 21 (a). Locate tables and the cache on config 3's geometry: the fixed
    # model is the events3d truth, written with save_slowness; the solver
    # config and the stations are those the CLI's locate posterior builds,
    # so that phase 23 hits the same key.
    c3_loc = apply_overrides(c3, loc_args)
    data_l, truth_l = make_dataset(g3, c3_loc.data, c3_loc.model, device=dev)
    save_slowness(model_pt, truth_l["slowness"], g3)
    s_loc = load_slowness(model_pt, g3, device=dev)
    if not torch.equal(s_loc, truth_l["slowness"]):
        raise RuntimeError("locate model: the .pt round trip changed it")
    econf_l = _eik_config(c3_loc.eikonal)
    sta_l = data_l.sta_xyz
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tabs = cached_traveltime_tables(s_loc, sta_l, g3, econf_l, cache_dir)
    torch.cuda.synchronize()
    sec_miss = time.perf_counter() - t0
    miss_launches = k1.launches
    files = sorted(os.listdir(cache_dir))
    if miss_launches <= 0 or len(files) != 1 \
            or not files[0].startswith("tables_"):
        raise RuntimeError(f"table cache miss: K1 {miss_launches} launches, "
                           f"files {files}")
    k1.launches = 0
    t0 = time.perf_counter()
    tabs_hit = cached_traveltime_tables(s_loc, sta_l, g3, econf_l, cache_dir)
    torch.cuda.synchronize()
    sec_hit = time.perf_counter() - t0
    if k1.launches != 0 or not torch.equal(tabs_hit, tabs) \
            or os.listdir(cache_dir) != files:
        raise RuntimeError(f"table cache hit: {k1.launches} K1 launches, "
                           f"equal {torch.equal(tabs_hit, tabs)}")
    t0 = time.perf_counter()
    tabs_p = traveltime_tables(s_loc, sta_l, g3,
                               dataclasses.replace(econf_l, use_pallas="off"))
    torch.cuda.synchronize()
    sec_plain = time.perf_counter() - t0
    err_tab = float((tabs - tabs_p).abs().max())
    if not (bool(torch.isfinite(tabs).all()) and torch.equal(tabs, tabs_p)):
        raise RuntimeError(f"locate tables: K1 disagrees with plain "
                           f"({err_tab})")
    errs["sweep3d_cycle"].append(err_tab)
    print(f"locate tables (c3 geometry {g3.shape}, {sta_l.shape[0]} "
          f"stations, fixed model = events3d truth at amplitude "
          f"{c3.data.checker_amplitude}): cache miss {sec_miss:.3f} s with "
          f"{miss_launches} K1 launches wrote {files[0]}; hit "
          f"{sec_hit:.3f} s with 0 launches, torch.equal; max|K1-plain| = "
          f"{err_tab:.3e} (plain solve {sec_plain:.3f} s)")

    # 22 (b). The grid search at catalogue size: 4096 synthetic events
    # (uniform in the box's interior, t0 ~ 0.2 N(0, 1), noise at the
    # config's) against the 16 tables, in chunks; the first 64 again one
    # event per chunk.
    n_cat = 4096
    lo = torch.tensor(g3.origin, device=dev)
    ext = torch.tensor(g3.extent, device=dev)
    hypo_cat = lo + ext * (0.1 + 0.8 * torch.rand((n_cat, 3), generator=gen,
                                                  device=dev))
    t0_cat = 0.2 * torch.randn(n_cat, generator=gen, device=dev)
    t_cat = predict_events(tabs, hypo_cat, t0_cat, g3) \
        + c3.data.noise * torch.randn((n_cat, sta_l.shape[0]), generator=gen,
                                      device=dev)
    sig = c3.model.sigma
    locate_grid_search(tabs, t_cat[:64], g3, sig)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = locate_grid_search(tabs, t_cat, g3, sig)
    torch.cuda.synchronize()
    sec_gs = time.perf_counter() - t0
    one = locate_grid_search(tabs, t_cat[:64], g3, sig, chunk=1)
    if not torch.equal(found["node"][:64], one["node"]):
        raise RuntimeError("grid search: chunk of 1 picks other nodes")
    d_t0 = float((found["t0"][:64] - one["t0"]).abs().max())
    r_ll = float(((found["loglik"][:64] - one["loglik"]).abs()
                  / one["loglik"].abs().clamp(min=1e-30)).max())
    t0_ok = bool(((found["t0"][:64] - one["t0"]).abs()
                  <= 1e-6 * one["t0"].abs() + 1e-7).all())
    if not (t0_ok and r_ll <= 1e-6):
        raise RuntimeError(f"grid search: chunk of 1 disagrees (t0 {d_t0}, "
                           f"loglik rel {r_ll})")
    h = torch.tensor(g3.spacing, device=dev)
    cells = ((found["hypo"] - hypo_cat) / h).norm(dim=-1)
    n_mis = n_cat * sta_l.shape[0] * math.prod(g3.shape)
    print(f"grid search: {n_cat} events x {sta_l.shape[0]} stations x "
          f"{math.prod(g3.shape)} nodes = {n_mis:.4e} misfits in "
          f"{sec_gs:.4f} s, {n_cat / sec_gs:.1f} events/s; hypocentre error "
          f"median {float(cells.median()):.3f} cells, max "
          f"{float(cells.max()):.3f}; chunk of 1 on 64 events: same nodes, "
          f"max|dt0| {d_t0:.3e} s, max rel dloglik {r_ll:.3e}")

    # 23 (c). Locate NUTS through the CLI at full width: the tables come
    # from the cache of phase 21, so K1 runs for the data's solve alone.
    c3_nuts_l = apply_overrides(c3_loc, C3_LOC_ARGS)
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    make_dataset(g3, c3_nuts_l.data, c3_nuts_l.model, device=dev)
    data_launches = k1.launches
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    api.run = keep_summary
    try:
        recs, _, wall = _run_cli(cli, ["run", C3_CONFIG, *loc_args,
                                       *C3_LOC_ARGS])
    finally:
        api.run = api_run
    loc_launches = k1.launches
    if loc_launches <= 0 or loc_launches != data_launches \
            or k4.launches or k5.launches:
        raise RuntimeError(f"locate path: K1 {loc_launches} launches (the "
                           f"data's solve alone takes {data_launches}), K4 "
                           f"{k4.launches}, K5 {k5.launches}")
    if os.listdir(cache_dir) != files:
        raise RuntimeError("locate path: the table cache missed")
    init, samp, steps, rate_all, _ = _check_run(
        recs, "locate path", c3_nuts_l.sampler.n_warmup, n3)
    if not samp[-1]["logpost_mean"] > init["logpost_mean"]:
        raise RuntimeError(f"locate path: logpost did not rise "
                           f"({init['logpost_mean']} -> "
                           f"{samp[-1]['logpost_mean']})")
    loc = summaries[-1]
    if "slowness" in loc.post_mean or loc.recovery_corr is not None \
            or loc.post_mean["params"].u is not None:
        raise RuntimeError("locate path: a slowness was tracked")
    h_err = ((box_from_raw(torch.as_tensor(loc.post_mean["params"].hypo_raw,
                                           device=dev), g3)
              - truth_l["hypo"]) / h).norm(dim=-1)
    print(f"locate path (c3 at full width, model.mode=locate, 8 chains, 12 "
          f"events, 16 stations; depth cut to {C3_LOC_ARGS}): {loc_launches} "
          f"K1 launches (the data's solve alone: {data_launches}), K4 "
          f"{k4.launches}, K5 {k5.launches}; logpost_mean "
          f"{init['logpost_mean']} -> {samp[-1]['logpost_mean']}; mean tree "
          f"depth {sum(r['tree_depth'] for r in samp) / len(samp):.3f}; "
          f"posterior-mean hypocentre error median "
          f"{float(h_err.median()):.3f} cells, max {float(h_err.max()):.3f}; "
          f"{rate_all:.2f} chain-steps/s over {steps} steps (cli wall "
          f"{wall:.1f} s); no slowness tracked, recovery_corr None")

    # 24 (d). Resume of the main path: phase 7's AM run wrote its
    # checkpoint every 40 steps; resume it for 40 more samples.
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    api.run = keep_summary
    try:
        recs, lines, wall = _run_cli(cli, ["run", AM_CONFIG, *AM_ARGS,
                                           "sampler.n_samples=40",
                                           f"io.resume={am_ck}"])
    finally:
        api.run = api_run
    am_res_launches = k1.launches
    res_am = summaries[-1]
    step_res = api._step_size_of(res_am.result.hyper)
    no_warm = any(x.startswith(f"[mceik-tpu-torch] resumed from {am_ck}")
                  for x in lines) and any(
        x.startswith("[mceik-tpu-torch] am chains=16 warmup=0 ")
        for x in lines)
    init, samp, _, rate_all, _ = _check_run(recs, "AM resume", 0)
    if am_res_launches <= 0 or not no_warm \
            or not abs(step_res - am_step) <= 1e-6 \
            or not 0.05 < res_am.accept_rate < 0.99:
        raise RuntimeError(f"AM resume: K1 {am_res_launches}, no warmup "
                           f"{no_warm}, step {step_res} vs {am_step}, "
                           f"acceptance {res_am.accept_rate}")
    print(f"AM resume (c2, 16 chains, 40 more samples): {am_res_launches} "
          f"K1 launches, no warmup; step {step_res} (checkpointed run "
          f"{am_step}); acceptance {res_am.accept_rate:.4f}; logpost_mean "
          f"{init['logpost_mean']} -> {samp[-1]['logpost_mean']}; "
          f"{rate_all:.2f} chain-steps/s (cli wall {wall:.1f} s)")

    # 25 (e). Resume of c2 MALA from phase 6's checkpoint: no Laplace setup.
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    api.run = keep_summary
    try:
        recs, _, wall = _run_cli(cli, ["run", MALA_CONFIG, *MALA_ARGS,
                                       "sampler.n_samples=30",
                                       f"io.resume={mala_ck}"])
    finally:
        api.run = api_run
    res_mala = summaries[-1]
    mala_res_launches = {"sweep3d_cycle": k1.launches,
                         "transport3d_cycle": k4.launches}
    if [r for r in recs if r["phase"] == "laplace"] \
            or min(mala_res_launches.values()) <= 0 \
            or not 0.05 < res_mala.accept_rate < 0.99:
        raise RuntimeError(f"MALA resume: launches {mala_res_launches}, "
                           f"acceptance {res_mala.accept_rate}, records "
                           f"{[r['phase'] for r in recs]}")
    print(f"MALA resume (c2, 16 chains, 30 more samples): no Laplace "
          f"record; launches {mala_res_launches}; acceptance "
          f"{res_mala.accept_rate:.4f} (cli wall {wall:.1f} s)")

    # 26 (f). SMC resume at full width: a 2-stage ladder with a checkpoint,
    # resumed to the 3-stage cap, against phase 9's uninterrupted run.
    smc_ck = os.path.join(tmp, "smc.pt")
    t0 = time.perf_counter()
    part = run_smc_config(
        dataclasses.replace(c4, io=dataclasses.replace(
            c4.io, checkpoint_path=smc_ck)),
        device=dev, verbose=True, max_stages=SMC_STAGES - 1)
    for k in (k1, k3, k4, k5, k6):
        k.launches = 0
    k3.block_launches = 0
    rest = run_smc_config(
        dataclasses.replace(c4, io=dataclasses.replace(c4.io,
                                                       resume=smc_ck)),
        device=dev, verbose=True, max_stages=SMC_STAGES)
    smc_res_launches = k3.launches
    smc_res_warp = k3.launches - k3.block_launches
    smc_res_wall = time.perf_counter() - t0
    d_beta = max(abs(a - b) / abs(b) if b else abs(a)
                 for a, b in zip(rest.betas, res.betas))
    d_logz = abs(rest.log_evidence - res.log_evidence)
    d_part = float((rest.state.params.u - res.state.params.u).abs().max())
    ok = (part.n_stages == SMC_STAGES - 1
          and rest.n_stages == res.n_stages
          and len(rest.betas) == len(res.betas) and d_beta <= 1e-6
          and d_logz <= 1e-5 + 1e-5 * abs(res.log_evidence)
          and bool(torch.isclose(rest.state.params.u, res.state.params.u,
                                 rtol=1e-6, atol=1e-6).all())
          and smc_res_warp > 0)
    bitwise = (rest.betas == res.betas and rest.log_evidence == res.log_evidence
               and torch.equal(rest.state.params.u, res.state.params.u))
    print(f"SMC resume (c4, {n_part} particles): {part.n_stages} stages with "
          f"a checkpoint, resumed to {rest.n_stages}: {smc_res_launches} K3 "
          f"launches on the resumed ladder ({smc_res_warp} on the warp "
          f"route); against phase 9's run max rel "
          f"dbeta {d_beta:.3e}, |dlogZ| {d_logz:.3e}, max|dparticles| "
          f"{d_part:.3e}, bit for bit {bitwise} (wall {smc_res_wall:.1f} s, "
          f"both runs)")
    if not ok:
        raise RuntimeError("SMC resume: disagrees with the uninterrupted "
                           "ladder")
    print(f"phases 21-26 (locate, grid search, resume) wall "
          f"{time.perf_counter() - t_new:.1f} s")

    # 27-31. Distribution on the one card: two gloo ranks share cuda:0
    # (NCCL refuses two ranks on one device), and a one-rank NCCL group
    # drives the NCCL branch of the collectives. Speed across several
    # cards is not measured here: there is one card.
    t_dist = time.perf_counter()
    del summaries[:]
    torch.cuda.empty_cache()
    entry = ["-m", "mceik_tpu_torch.dist.dryrun"]

    # 27. Phase 7's c2 AM run, 16 chains, sharded over 2 ranks (8 each).
    out27 = os.path.join(tmp, "dist_am")
    text, wall = _torchrun(2, [*entry, "cli", out27, "run", AM_CONFIG,
                               *AM_ARGS], "phase 27 (c2 AM on 2 ranks)")
    ranks27 = _rank_results(out27, 2)
    am_rank_launches = [r["launches"]["sweep3d"] for r in ranks27]
    recs27 = [json.loads(x.split("] ", 1)[1]) for x in text.splitlines()
              if x.startswith("[mceik] ")]
    first27 = [x for x in text.splitlines() if x.startswith("[mceik")][0]
    keys = ("logpost_mean", "logpost_min", "logpost_max", "step_size")
    pairs = [(a[k], b[k]) for a, b in zip(recs27, am_recs) for k in keys
             if k in b]
    gap27 = max(abs(a - b) / abs(b) for a, b in pairs)
    same = ([r["phase"] for r in recs27] == [r["phase"] for r in am_recs]
            and [r.get("step") for r in recs27]
            == [r.get("step") for r in am_recs])
    print(f"phase 27: first line {first27!r}; {len(recs27)} records, max "
          f"relative gap to phase 7's unsharded records "
          f"{gap27:.3e} (bar 2e-4) over {len(pairs)} logpost and step "
          f"values; K1 launches per rank {am_rank_launches} (phase 7: "
          f"{am_launches}); {recs27[-1]['chain_steps_per_s']} chain-steps/s "
          f"in rank 0's last record (phase 7: "
          f"{am_recs[-1]['chain_steps_per_s']}); wall {wall:.1f} s with "
          f"start-up")
    if not (same and gap27 <= 2e-4 and min(am_rank_launches) > 0
            and "backend gloo" in first27):
        raise RuntimeError(f"phase 27: sharded c2 AM disagrees (records "
                           f"aligned {same}, gap {gap27}, launches "
                           f"{am_rank_launches}, {first27!r})")

    # 28. Config 4's SMC, 10,000 particles over 2 ranks, 3 stages.
    out28 = os.path.join(tmp, "dist_smc")
    os.makedirs(out28)
    torch.save({"config": C4_CONFIG, "max_stages": SMC_STAGES},
               os.path.join(out28, "in.pt"))
    text, wall = _torchrun(2, [*entry, "task", "smc_config", out28,
                               os.path.join(out28, "in.pt")],
                           "phase 28 (c4 SMC on 2 ranks)")
    ranks28 = _rank_results(out28, 2)
    sh = ranks28[0]
    smc_rank_warp = [r["launches"]["sweep2d"] - r["launches"]["sweep2d_block"]
                     for r in ranks28]
    u_sh = sh["params"].to(dev)
    u_un = res.state.params.u
    d_beta28 = max(abs(a - b) for a, b in zip(sh["betas"], res.betas))
    d_logz28 = abs(sh["log_evidence"] - res.log_evidence)
    d_mean28 = float((u_sh.mean(0) - u_un.mean(0)).abs().max())
    v_rel28 = float(((u_sh.var(0) - u_un.var(0)).abs()
                     / u_un.var(0).clamp(min=1e-30)).max())
    d_part28 = float((u_sh - u_un).abs().max())
    print(f"phase 28: {sh['n_stages']} stages over 2 ranks, betas "
          f"{sh['betas']}; against phase 9 max |dbeta| {d_beta28:.3e} (bar "
          f"1e-4), |dlogZ| {d_logz28:.3e} (bar 0.05), max |dmean| "
          f"{d_mean28:.3e} (bar 0.08), max relative dvar {v_rel28:.3e} (bar "
          f"0.3), max |dparticle| {d_part28:.3e}; K3 warp launches per rank "
          f"{smc_rank_warp}; s per stage {sh['stage_seconds']} (phase 9: "
          f"{res.stage_seconds}); wall {wall:.1f} s with start-up")
    if not (sh["n_stages"] == res.n_stages and len(sh["betas"]) ==
            len(res.betas) and d_beta28 <= 1e-4 and d_logz28 < 0.05
            and d_mean28 <= 0.08 and v_rel28 <= 0.3
            and min(smc_rank_warp) > 0):
        raise RuntimeError("phase 28: sharded SMC disagrees with phase 9")

    # 29. Config 5's 24 station tables on 128^3 through the grid-sharded
    # solve on 2 ranks, against the unsharded K1 solve; the reshard and the
    # prediction of its 32 events against predict_events.
    out29 = os.path.join(tmp, "dist_tables")
    os.makedirs(out29)
    torch.save({"config": C5_CONFIG, "tol": 1e-5, "max_iters": 200},
               os.path.join(out29, "in.pt"))
    text, wall = _torchrun(2, [*entry, "task", "tables", out29,
                               os.path.join(out29, "in.pt")],
                           "phase 29 (c5 tables on 2 ranks)")
    ranks29 = _rank_results(out29, 2)
    t29 = ranks29[0]
    tables_rank_launches = [r["launches"]["sweep3d"] for r in ranks29]
    print(f"phase 29: {t29['shape'][0]} tables of "
          f"{tuple(t29['shape'][1:4])}, slabs of {t29['shape'][1] // 2} "
          f"planes: sharded solve {t29['sharded_s']:.3f} s "
          f"({t29['sharded_cycles']} plain cycles), "
          f"unsharded K1 solve {t29['unsharded_s']:.3f} s, max |sharded - "
          f"K1| {t29['solve_gap']:.3e} (bar 2e-3; max T {t29['max_T']:.2f}); "
          f"reshard and prediction of {t29['shape'][4]} events "
          f"{t29['reshard_s']:.3f} s, max |resharded - predict_events| "
          f"{max(r['predict_gap'] for r in ranks29):.3e} (bar 1e-5); K1 "
          f"launches per rank {tables_rank_launches} (the data's solve on "
          f"both, the unsharded solve on rank 0); wall {wall:.1f} s")
    if not (t29["solve_gap"] <= 2e-3
            and max(r["predict_gap"] for r in ranks29) <= 1e-5
            and tables_rank_launches[0] > 0):
        raise RuntimeError("phase 29: the grid-sharded tables disagree")

    # 30. A one-rank NCCL group on the card drives every collective helper
    # on CUDA tensors; a one-rank gloo group beside it, the host staging.
    # The operand: c2's adaptation all-gather, every chain's position.
    x = torch.randn((N_CHAINS, math.prod(cfg.model.inv_shape)),
                    generator=gen, device=dev)
    _collectives_on_card(x, torch.randn((4, 8, 16, 16), generator=gen,
                                        device=dev))

    # 31. The port's dryrun (legs A-E) on 2 ranks on the card.
    text, wall = _torchrun(2, [*entry], "phase 31 (dryrun on 2 ranks)")
    ok31 = [x for x in text.splitlines() if x.startswith("dryrun over")]
    rank31 = [json.loads(x.split(": ", 1)[1]) for x in text.splitlines()
              if x.startswith("dryrun rank ")]
    print(f"phase 31: {ok31[0] if ok31 else text[-2000:]}; launches per "
          f"rank {rank31}; wall {wall:.1f} s with start-up")
    if not (ok31 and "ALL OK" in ok31[0] and len(rank31) == 2
            and min(r["sweep3d"] for r in rank31) > 0):
        raise RuntimeError("phase 31: the dryrun failed")
    print(f"phases 27-31 (distribution) wall "
          f"{time.perf_counter() - t_dist:.1f} s")

    # 32-35. The FSM oracle, the Jacobi solve, the sanity tool and the
    # golden checks on the card.
    t_new = time.perf_counter()
    torch.cuda.empty_cache()
    new = _phases_32_35(dev, cli, s_true, src, s_a, srcs_a)
    print(f"phases 32-35 wall {time.perf_counter() - t_new:.1f} s")
    gl = new["golden"]
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")

    # Bounds at the shapes timed: one cycle of the batch (every field
    # active, as in the timed launches).
    b_k4, by_k4 = _bound(s_a.numel(), 24, _k4_ops(cfg.eikonal.n_inner))
    b_k4_c3, _ = _bound(T0_3.numel(), 24, _k4_ops(ecfg3.n_inner))
    nodes4 = math.prod(g4.shape) * n_part * n_src4
    nodes1 = math.prod(g1.shape) * c1.sampler.n_chains * n_src1
    b_k3, by_k3 = _k3_bound(nodes4, n_part * n_src4, ecfg4.n_inner)
    b_k3_c1, by_k3_c1 = _k3_bound(nodes1, c1.sampler.n_chains * n_src1,
                                  ecfg1.n_inner)
    b_k3s, by_k3s = _k3_bound(nodes4, n_part * n_src4, ecfg4.n_inner,
                              k3_cycles)
    b_k3s_c1, by_k3s_c1 = _k3_bound(nodes1, c1.sampler.n_chains * n_src1,
                                    ecfg1.n_inner, k3_cycles_c1)
    b_k6, by_k6 = _k6_bound(nodes1, ecfg1.n_inner)
    b_k6_c4, _ = _k6_bound(nodes4, ecfg4.n_inner)
    b_k6s, by_k6s = _k6_bound(nodes1, ecfg1.n_inner, k6_cycles,
                              c1.sampler.n_chains * n_src1)
    b_k6s_c4, _ = _k6_bound(nodes4, ecfg4.n_inner, k6_cycles_c4,
                            n_part * n_src4)
    print(json.dumps({"kernels": [{
        "name": "sweep3d_cycle",
        "tpu_kernel": "sweep_axes012_fused, sweep_axes01_fused, sweep_axis0",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:372, :222, :132",
        "launches": mala_launches["sweep3d_cycle"],
        "max_abs_err": max(errs["sweep3d_cycle"]),
        "ms": ms_k1,
        "plain_ms": ms_k1_plain,
        "bound_ms": b_k1,
        "bound_by": by_k1,
        "library_ms": None,
        "c3_launches": nuts_launches["sweep3d_cycle"],
        "c3_ms": ms_k1_c3,
        "c3_plain_ms": ms_k1_c3_plain,
        "c3_bound_ms": b_k1_c3,
        "c5_launches": c5_launches["sweep3d_cycle"],
        "c5_ms": ms_k1_c5,
        "c5_plain_ms": ms_k1_c5_plain,
        "c5_bound_ms": b_k1_c5,
        "locate_launches": loc_launches,
        "locate_cache_miss_launches": miss_launches,
        "am_resume_launches": am_res_launches,
        "mala_resume_launches": mala_res_launches["sweep3d_cycle"],
        "dist_am_rank_launches": am_rank_launches,
        "dist_tables_rank_launches": tables_rank_launches,
        "dryrun_rank_launches": [r["sweep3d"] for r in rank31],
        "golden_launches": {n: gl[n]["launches"]["sweep3d_cycle"]
                            for n in ("c2_small", "c2_mid",
                                      "c3_joint_small")},
        "fsm_oracle_max_abs_diff": max(c["max_abs_diff"]
                                       for c in new["oracle"]),
        "jacobi_run_launches": new["jacobi_cli"]["launches"].get(
            "sweep3d_cycle", 0),
        "jacobi_data_solve_launches": new["jacobi_cli"]["data"].get(
            "sweep3d_cycle", 0),
    }, {
        "name": "transport3d_cycle",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/transport3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_transport.py:132",
        "launches": mala_launches["transport3d_cycle"],
        "max_abs_err": max(errs["transport3d_cycle"]),
        "ms": ms_k4,
        "plain_ms": ms_k4_plain,
        "bound_ms": b_k4,
        "bound_by": by_k4,
        "library_ms": None,
        "c3_launches": nuts_launches["transport3d_cycle"],
        "mala_resume_launches": mala_res_launches["transport3d_cycle"],
        "golden_launches": {n: gl[n]["launches"]["transport3d_cycle"]
                            for n in ("c2_mid", "c3_joint_small")},
        "c3_ms": ms_k4_c3,
        "c3_plain_ms": ms_k4_c3_plain,
        "c3_bound_ms": b_k4_c3,
    }, {
        "name": "sweep2d_cycle",
        "entry": "one cycle per launch (K3's C entry sweep2d_solve, solve 0), "
                 "warp route: one warp per field",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:890",
        "launches": smc_launches - smc_block,
        "launches_of": "K3's warp route, both entries (the SMC path runs the "
                       "solve entry)",
        "max_abs_err": max(errs["sweep2d"]),
        "ms": k3_c4["warp"][0],
        "plain_ms": ms_k3_plain,
        "bound_ms": b_k3,
        "bound_by": by_k3,
        "library_ms": None,
        "c1_ms": k3_c1["warp"][0],
        "c1_plain_ms": ms_k3_c1_plain,
        "c1_bound_ms": b_k3_c1,
    }, {
        "name": "sweep2d_solve",
        "entry": "each field's whole solve per launch (sweep2d_solve, "
                 "solve 1), warp route",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:890 under the "
                    "while_loop of :907",
        "launches": smc_launches - smc_block,
        "field_cycles": smc_cycles,
        "smc_resume_launches": smc_res_warp,
        "dist_smc_rank_launches": smc_rank_warp,
        "max_abs_err": max(errs["sweep2d"]),
        "ms": k3_c4["warp"][1],
        "plain_ms": ms_k3s_plain,
        "bound_ms": b_k3s,
        "bound_by": by_k3s,
        "library_ms": None,
        "solve_field_cycles": k3_cycles,
        "c1_ms": k3_c1["warp"][1],
        "c1_plain_ms": ms_k3s_c1_plain,
        "c1_bound_ms": b_k3s_c1,
        "c1_solve_field_cycles": k3_cycles_c1,
    }, {
        "name": "sweep2d_block_cycle",
        "entry": "one cycle per launch (sweep2d_solve, solve 0), block "
                 "route: a CTA of one thread per node of a line",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:890",
        "launches": c1_nuts_launches["sweep2d_block"],
        "launches_of": "K3's block route, both entries (the c1 NUTS path "
                       "runs the solve entry)",
        "max_abs_err": max(errs["sweep2d"]),
        "ms": k3_c1["block"][0],
        "plain_ms": ms_k3_c1_plain,
        "bound_ms": b_k3_c1,
        "bound_by": by_k3_c1,
        "library_ms": None,
        "c4_ms": k3_c4["block"][0],
        "c4_plain_ms": ms_k3_plain,
        "c4_bound_ms": b_k3,
    }, {
        "name": "sweep2d_block_solve",
        "entry": "each field's whole solve per launch (sweep2d_solve, "
                 "solve 1), block route",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:890 under the "
                    "while_loop of :907",
        "launches": c1_nuts_launches["sweep2d_block"],
        "field_cycles": c1_nuts_launches["sweep2d_field_cycles"],
        "max_abs_err": max(errs["sweep2d"]),
        "ms": k3_c1["block"][1],
        "plain_ms": ms_k3s_c1_plain,
        "bound_ms": b_k3s_c1,
        "bound_by": by_k3s_c1,
        "library_ms": None,
        "solve_field_cycles": k3_cycles_c1,
        "c1_mala_launches": c1_mala_launches["sweep2d_block"],
        "golden_c1_small_launches": gl["c1_small"]["launches"]["sweep2d"],
        "c4_ms": k3_c4["block"][1],
        "c4_plain_ms": ms_k3s_plain,
        "c4_bound_ms": b_k3s,
    }, {
        "name": "transport3d_large_cycle",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/transport3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_transport.py:132 (blocked "
                    "route :164, :181, :216)",
        "launches": c5_launches["transport3d_large_cycle"],
        "max_abs_err": max(errs["transport3d_large_cycle"]),
        "ms": ms_k5,
        "plain_ms": ms_k5_plain,
        "bound_ms": b_k5,
        "bound_by": by_k5,
        "library_ms": None,
        "c2_forced_ms": ms_k5_c2,
        "c2_bound_ms": b_k5_c2,
    }, {
        "name": "transport2d_cycle",
        "entry": "one cycle per launch (K6's C entry transport2d_solve, "
                 "solve 0)",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/transport2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_transport.py:132 (2-D fields, "
                    "via transport_cycle_pallas :148)",
        "launches": c1_nuts_launches["transport2d"],
        "launches_of": "K6, both entries (the NUTS path runs the solve "
                       "entry)",
        "max_abs_err": max(errs["transport2d"]),
        "ms": ms_k6,
        "plain_ms": ms_k6_plain,
        "bound_ms": b_k6,
        "bound_by": by_k6,
        "library_ms": None,
        "c4_ms": ms_k6_c4,
        "c4_plain_ms": ms_k6_c4_plain,
        "c4_bound_ms": b_k6_c4,
    }, {
        "name": "transport2d_solve",
        "entry": "each field's whole solve per launch (transport2d_solve, "
                 "solve 1)",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/transport2d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_transport.py:132 (2-D fields) "
                    "under the reference's per-field cycle loop",
        "launches": c1_nuts_launches["transport2d"],
        "field_cycles": c1_nuts_launches["transport2d_field_cycles"],
        "max_abs_err": max(errs["transport2d"]),
        "ms": ms_k6s,
        "plain_ms": ms_k6s_plain,
        "bound_ms": b_k6s,
        "bound_by": by_k6s,
        "library_ms": None,
        "solve_field_cycles": k6_cycles,
        "c1_mala_launches": c1_mala_launches["transport2d"],
        "c4_ms": ms_k6s_c4,
        "c4_plain_ms": ms_k6s_c4_plain,
        "c4_bound_ms": b_k6s_c4,
        "c4_solve_field_cycles": k6_cycles_c4,
    }, {
        "name": "sweep3d_cycle",
        "tpu_kernel": "sweep_axis0_gridbatch (the gridbatch route)",
        "route": "cuda",
        "source": "mceik_tpu_torch/csrc/sweep3d.cu",
        "replaces": "mceik_tpu/eikonal/pallas_sweep.py:740",
        "launches": gb_launches,
        "max_abs_err": max(errs["gridbatch"] + errs["sweep3d_cycle"]),
        "ms": ms_k1,
        "plain_ms": ms_k1_plain,
        "bound_ms": b_k1,
        "bound_by": by_k1,
        "library_ms": None,
        "solve_ms": ms_gb,
        "field_solve_ms": ms_fd,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
