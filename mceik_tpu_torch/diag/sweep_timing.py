"""Time the 3-D sweep kernel K1, or with ``--transport`` the 3-D transport
kernels K4 and K5, on the card, per cycle and per axis, beside an earlier
version of its source.

    python -m mceik_tpu_torch.diag.sweep_timing [--transport | --solve]
        [--baseline OLD.cu] [--variants A.cu,B.cu] [--cells c2,c3,c5]
        [--reps 10] [--axes]

For each cell, the batch its main path sweeps is drawn from the config's
prior (c2: 16 chains x 8 sources of 64^3; c3: 8 chains x 16 stations of
48x48x32; c5: 4 chains x 24 stations of 128^3) and seeded. Then one K1
cycle (its solve entry at one counted iteration of one cycle, whose copy
back also reduces the residual) is timed with CUDA events over ``--reps``
launches, in turns with the baseline (new, old, old, new), and the two
outputs must be equal bit for bit. ``--baseline`` is a ``sweep3d.cu`` with the floor-operand C entry
``sweep3d_cycle(T, S, F, done, B, n0, n1, n2, consts, iso, n_inner,
threads, device, stream)`` of earlier versions (for example ``git show
<commit>:mceik_tpu_torch/csrc/sweep3d.cu``); it is fed the
``seed_floor`` field. ``--axes`` also times instances of each source that
march a single axis (built from a copy of the source with the axis loop
cut to that axis), which split a cycle's time across the three axes.
``--variants`` times other sources with K1's own C entry beside it (new,
variant, variant, new), each held to K1's bits.

``--transport`` times the kernel ``cuda_transport.transport_kernel_for``
picks for the cell (K4 on c2 and c3, K5 on c5) on one transport cycle of
real inputs: the batch solved by K1 at the config's tolerance, its signed
weights (``adjoint_sweep.batch_weights``) and the cotangent of the
config's Gaussian log-likelihood at the prior draw (``lam = g``, as a
solve's first cycle). ``--baseline`` is then a ``transport3d.cu`` whose C
entries take no ring (``transport3d_cycle(lam, G, W0, W1, W2, done, B, n0,
n1, n2, n_inner, threads, device, stream)`` and
``transport3d_large_cycle`` alike, as in ``git show
<commit>:mceik_tpu_torch/csrc/transport3d.cu`` before the ring); ``--axes`` and
``--variants`` work as for K1, with K4's and K5's own C entries. Outputs
must be equal bit for bit (compared as int32, so NaN and signed zeros
count). On the K4 cells it also times, in turns, a cycle on a ring of
its own against one on a ring kept from an earlier cycle
(``solve_ring``: g and the weights already in it, only lam copied), and
the whole transport solve at the config's tolerance through
``transport_cycle`` against ``solve_cycle`` (the ring kept through the
solve, its first cycle included), each pair equal bit for bit.

``--2d`` times the 2-D kernels K3 (``csrc/sweep2d.cu``) and K6
(``csrc/transport2d.cu``) on config 4's batch (``--cells c4``: 10,000
prior-drawn particles x 8 sources of 48^2) and config 1's (``c1``: 4
chains x 8 sources of 65^2): per cycle, and per whole solve at the
config's tolerance, each in turns with the sources given by
``--baseline-k3`` and ``--baseline-k6`` (an earlier ``sweep2d.cu`` or
``transport2d.cu``, from ``git show``) and, for ``--variants``, sources
whose file name holds ``sweep2d`` or ``transport2d``. Each is bound by the
C entry ``sweep2d_solve`` / ``transport2d_solve`` (a cycle, or each
field's whole solve, per launch). K3's two routes ("warp" and "block",
``cuda_sweep2d.route_for``) are also timed forced, in turns with the
wrapper's choice. Outputs and per-field cycle counts must be equal (bits
compared as int32). K6 runs on the cell's own data: the
batch solved by K3, its weights and the cotangent of the config's Gaussian
log-likelihood. ``--split`` also times, in turns with each source,
copies of it with parts taken out (``SPLITS``: its block barriers, its
square roots, the Jacobi steps, the lane-edge shuffles, the whole sweep):
wrong results, a diagnostic of where a cycle's time goes.

``--solve`` times K1's whole solve at the config's tolerance and route
(two cycles per counted iteration on c5's blocked route) on the cell's
batch (default ``--cells c2,c3,c5``): the solve entry, one launch per
solve (``Sweep3dKernel.solve``), in turns with the host loop
``solve.sweep_solve`` (a launch, a clone and a done test per counted
iteration) around the one-cycle entry of ``--baseline``, a ``sweep3d.cu``
with the seeded cycle entry ``sweep3d_cycle(T, S, scal, scratch, done,
count, B, n0, n1, n2, consts, iso, n_inner, radius, threads, device,
stream)`` (``git show ea66d0a:mceik_tpu_torch/csrc/sweep3d.cu``): one,
loop, loop, one. Both must give the same bits and per-field cycle counts;
the row has the launches and host syncs per solve of each.

Prints the card's ``nvidia-smi`` line, then one JSON line per cell. Needs
a CUDA device; builds into ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.eikonal import (cuda_sweep2d, cuda_transport,
                                     cuda_transport2d)
from mceik_tpu_torch.eikonal.adjoint_sweep import (batch_weights,
                                                   transport_solve)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.cuda_build import (BUILD_DIR, NvccKernel,
                                                launch_config)
from mceik_tpu_torch.eikonal.cuda_sweep import SOURCE, Sweep3dKernel
from mceik_tpu_torch.eikonal.solve import (CYCLES_PER_ITER, EikonalConfig,
                                           seed_floor, seed_source,
                                           solve_route, source_scalars,
                                           sweep_solve)
from mceik_tpu_torch.forward.predict import interp_tables, predict_events
from mceik_tpu_torch.io.config_io import load_config
from mceik_tpu_torch.io.trace import COUNTERS
from mceik_tpu_torch.model.params import box_from_raw
from mceik_tpu_torch.model.posterior import _gaussian_loglik, build_posterior

REPO = Path(__file__).resolve().parents[2]
CELLS = {"c2": ("c2_checkerboard3d.json", 16),
         "c3": ("c3_joint_events.json", 8),
         "c5": ("c5_pod_nuts.json", 4),
         "c4": ("c4_smc.json", 10000),
         "c1": ("c1_crosswell.json", 4)}
# Scratch copies of a 2-D source for --split: tag -> (text, replacement)
# pairs, each applied where the source has it; wrong results, a diagnostic
# of where a cycle's time goes. nobarrier and nosqrt take the block
# barriers and the square roots out; nosteps the Jacobi steps (what is left
# is the line visits' loads, floor and stores), noshfl the lane-edge
# shuffles, nocycle the whole sweep (what is left is the field's load and
# store).
SPLITS = {
    "nobarrier": (("__syncthreads();", ";"),),
    "nosqrt": (("line2d::sqrt_rn(", "("), ("sqrtf(", "(")),
    "nosteps": (("for (int it = 0; it < c.n_inner; ++it) {",
                 "for (int it = 0; it < 0; ++it) {"),
                ("for (int it = 0; it < n_inner; ++it) {",
                 "for (int it = 0; it < 0; ++it) {")),
    "noshfl": (("line2d::lane_edges(t[0], t[NPL - 1], lane, kBig, dn, up);",
                "dn = up = kBig;"),
               ("line2d::lane_edges(t[0], t[NPL - 1], lane, 0.0f, dn, up);",
                "dn = up = 0.0f;")),
    "nocycle": (("    sweep_cycle<NPL, ISO>(sT, sS, n0, n1, ld, sa, sb, s_src, "
                 "c, lane);\n", ""),
                ("    transport_cycle<NPL>(sL, sG, sW0, sW1, n0, n1, ld, "
                 "n_inner, lane);\n", "")),
}
AXIS_LOOP = "for (int ax = 0; ax < 3; ++ax) {"


class FloorSweep3dKernel(NvccKernel):
    """The floor-operand C entry of earlier ``sweep3d.cu`` versions."""

    def __init__(self, source: Path):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(source, "sweep3d_cycle",
                         [vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, ci, ci, ci,
                          vp])

    def __call__(self, T, s, floor, spacing, n_inner, done):
        B, n0, n1, n2 = T.shape
        h = [float(x) for x in spacing]
        consts = (ctypes.c_float * 9)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        threads, index, stream = launch_config(T.shape, T.device)
        out = T.clone()
        rc = self.build()(out.data_ptr(), s.data_ptr(), floor.data_ptr(),
                          done.data_ptr(), B, n0, n1, n2, consts,
                          int(len(set(h)) == 1), n_inner, threads, index,
                          stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return out


class SeededSweep3dKernel(NvccKernel):
    """The seeded one-cycle C entry of earlier ``sweep3d.cu`` versions:
    one cycle of the fields not done per launch."""

    def __init__(self, source: Path):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(source, "sweep3d_cycle",
                         [vp] * 6 + [ci] * 4 + [vp, ci, ci, ctypes.c_float,
                                                ci, ci, vp])

    def __call__(self, T, s, scal, spacing, n_inner, done, *, seed_radius):
        B, n0, n1, n2 = T.shape
        h = [float(x) for x in spacing]
        consts = (ctypes.c_float * 9)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        threads, index, stream = launch_config(T.shape, T.device)
        out = T.clone()
        scratch = torch.empty((B, 2, n2, n0, n1), device=T.device)
        rc = self.build()(out.data_ptr(), s.data_ptr(), scal.data_ptr(),
                          scratch.data_ptr(), done.data_ptr(), None, B, n0,
                          n1, n2, consts, int(len(set(h)) == 1), n_inner,
                          ctypes.c_float(seed_radius * max(h)), threads,
                          index, stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        self.launches += 1
        return out


class RinglessTransport3dKernel(NvccKernel):
    """A C entry ``symbol`` of earlier ``transport3d.cu`` versions, which
    take no ring."""

    def __init__(self, source: Path, symbol: str):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(source, symbol, [vp] * 6 + [ci] * 7 + [vp])

    def __call__(self, lam, g, ws, n_inner, done):
        B, n0, n1, n2 = lam.shape
        threads, index, stream = launch_config(lam.shape, lam.device)
        out = lam.clone()
        rc = self.build()(out.data_ptr(), g.data_ptr(),
                          *[w.data_ptr() for w in ws], done.data_ptr(), B,
                          n0, n1, n2, n_inner, threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return out


def _axis_variant(source: Path, ax: int, tag: str) -> Path:
    """A copy of ``source`` whose cycle marches axis ``ax`` alone."""
    text = source.read_text()
    if AXIS_LOOP not in text:
        raise RuntimeError(f"{source}: no axis loop {AXIS_LOOP!r}")
    out = (BUILD_DIR.parent / "variants"
           / f"{source.stem}_{tag}_ax{ax}.cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text.replace(
        AXIS_LOOP, f"for (int ax = {ax}; ax < {ax + 1}; ++ax) {{"))
    return out


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _batch(cell, dev, gen):
    name, n_chains = CELLS[cell]
    cfg = load_config(REPO / "configs" / name)
    grid = cfg.grid.build()
    data, _ = make_dataset(grid, cfg.data, cfg.model, device=dev)
    post = build_posterior(cfg.model, data, grid, cfg.eikonal)
    srcs = getattr(data, "sta_xyz", None)
    srcs = data.src_xyz if srcs is None else srcs
    params = post.sample_prior(gen, n_chains)
    s = post.slowness_of(params).unsqueeze(1)
    s = s.expand((n_chains, srcs.shape[0]) + grid.shape)
    s = s.reshape((-1,) + grid.shape).contiguous()
    srcs = srcs.repeat(n_chains, 1)
    return cfg, grid, s, srcs, data, params


def _cotangent(cfg, grid, data, params, T):
    """d/dT of the config's Gaussian log-likelihood (at its base sigma) of
    the traveltime batch ``T`` (chains x sources or stations)."""
    n_chains = params.u.shape[0]
    Tg = T.detach().clone().requires_grad_(True)
    tables = Tg.reshape((n_chains, -1) + grid.shape)
    if cfg.model.mode == "tomo":
        pred = interp_tables(tables, data.rec_xyz, grid)
    else:
        hypo = box_from_raw(params.hypo_raw, grid)
        t0 = (params.t0 if params.t0 is not None
              else torch.zeros(hypo.shape[:-1], device=T.device))
        pred = predict_events(tables, hypo, t0, grid)
    resid = data.t_obs - pred
    (g,) = torch.autograd.grad(_gaussian_loglik(
        resid, torch.full_like(resid, cfg.model.sigma), None).sum(), Tg)
    return g.contiguous()


def _ptxas(log: str) -> dict:
    """``ptxas -v``'s lines per kernel instance, as {"NPT,kRowQ[,kLarge]":
    "registers/stack bytes/spill store bytes/spill load bytes"} (the lines
    of device functions called out of line are skipped)."""
    out, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\S+)", line)
        if m:
            k = re.search(r"kernelI(\S*?)EEv", m.group(1))
            inst = (re.sub(r"L[ib]", "", k.group(1)).replace("E", ",")
                    .strip(",") if k else None)
            if inst is not None:
                out.setdefault(inst, [0, 0, 0, 0])
            continue
        if inst is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            out[inst][1:] = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[inst][0] = int(m.group(1))
    return {k: "/".join(map(str, v)) for k, v in out.items()}


def _build(kernels):
    """Build every kernel at once; print the build times and, per source
    built here, each instance's registers, stack and spills."""
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    build_s = {}
    for k in kernels:   # entries of one source: the one that compiled it
        build_s[k.source.name] = max(build_s.get(k.source.name, 0.0),
                                     k.build_seconds)
    print(json.dumps({"build_s": build_s}))
    logs = {k.source.name: k.build_log for k in kernels if k.build_log}
    for name, log in logs.items():
        print(json.dumps({"ptxas_regs_stack_spill_st_ld": {
            name: _ptxas(log)}}))


def _turns(run_a, run_b, reps):
    """ms of a, b, b, a."""
    return [_ms(run_a, reps), _ms(run_b, reps), _ms(run_b, reps),
            _ms(run_a, reps)]


def _bits_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _transport3d(name: str, source: Path):
    """K4 or K5 (by entry ``name``) built from ``source``."""
    proto = {"transport3d": cuda_transport.TRANSPORT3D,
             "transport3d_large": cuda_transport.TRANSPORT3D_LARGE}[name]
    return cuda_transport.Transport3dKernel(name, proto.n_planes,
                                            proto.max_nodes, source)


def _transport_main(args, dev) -> int:
    """The ``--transport`` mode: K4/K5 per cell against the baseline."""
    names = ("transport3d", "transport3d_large")
    new = {n: _transport3d(n, cuda_transport.SOURCE) for n in names}
    old = ({n: RinglessTransport3dKernel(args.baseline, f"{n}_cycle")
            for n in names} if args.baseline else {})
    axes = {}
    if args.axes:
        for ax in range(3):
            src = _axis_variant(cuda_transport.SOURCE, ax, "new")
            axes[f"new_ax{ax}"] = {n: _transport3d(n, src) for n in names}
            if old:
                src = _axis_variant(args.baseline, ax, "old")
                axes[f"old_ax{ax}"] = {n: RinglessTransport3dKernel(
                    src, f"{n}_cycle") for n in names}
    variants = {Path(v).stem: {n: _transport3d(n, Path(v)) for n in names}
                for v in args.variants.split(",") if v}
    groups = [new] + ([old] if old else []) + list(axes.values()) + list(
        variants.values())
    _build([k for grp in groups for k in grp.values()])
    gen = torch.Generator(device=dev).manual_seed(11)
    for cell in args.cells.split(","):
        cfg, grid, s, srcs, data, params = _batch(cell, dev, gen)
        e = cfg.eikonal
        ecfg = EikonalConfig(tol=e.tol, max_iters=e.max_iters,
                             n_inner=e.n_inner, seed_radius=e.seed_radius)
        T = solve_eikonal_batched(s, srcs, grid, ecfg)
        ws = batch_weights(T, s, srcs, grid, e.seed_radius)
        g = _cotangent(cfg, grid, data, params, T)
        del T, s
        name = cuda_transport.transport_kernel_for(grid.shape).name
        done = torch.zeros(g.shape[0], dtype=torch.bool, device=dev)

        def run(k):
            return lambda: k(g, g, ws, e.n_inner, done)

        row = {"cell": cell, "kernel": name, "B": g.shape[0],
               "grid": list(grid.shape), "n_inner": e.n_inner}
        out_new = run(new[name])()
        row["finite"] = bool(torch.isfinite(out_new).all())
        if old:
            row["equal_to_baseline"] = _bits_equal(out_new, run(old[name])())
            turns = _turns(run(new[name]), run(old[name]), args.reps)
            row["ms_turns_new_old_old_new"] = turns
            row["ms_new"] = (turns[0] + turns[3]) / 2
            row["ms_baseline"] = (turns[1] + turns[2]) / 2
        else:
            row["ms_new"] = _ms(run(new[name]), args.reps)
        for key, grp in variants.items():
            row[f"equal_{key}"] = _bits_equal(out_new, run(grp[name])())
            row[f"ms_turns_new_{key}_{key}_new"] = _turns(
                run(new[name]), run(grp[name]), args.reps)
        if name == "transport3d":
            # The ring kept from cycle to cycle (the first call fills it).
            ring = new[name].solve_ring(g.shape, dev)

            def kept():
                return new[name](g, g, ws, e.n_inner, done, ring=ring)

            row["equal_ring_kept"] = (_bits_equal(out_new, kept())
                                      and _bits_equal(out_new, kept()))
            row["ms_turns_new_kept_kept_new"] = _turns(run(new[name]), kept,
                                                       args.reps)

            def solve(make_cycle):
                return lambda: transport_solve(g, ws, e.tol, e.max_iters,
                                               e.n_inner, cycle=make_cycle())

            per_cycle = solve(lambda: cuda_transport.transport_cycle)
            per_solve = solve(lambda: cuda_transport.solve_cycle(g, ws))
            launches = cuda_transport.TRANSPORT3D.launches
            lam = per_cycle()
            row["solve_cycles"] = cuda_transport.TRANSPORT3D.launches - launches
            row["equal_solve_kept"] = _bits_equal(lam, per_solve())
            row["ms_solve_turns_cycle_kept_kept_cycle"] = _turns(
                per_cycle, per_solve, max(1, args.reps // 3))
            del ring, lam
        visits = 2 * sum(grid.shape)
        row["us_per_visit_new"] = 1e3 * row["ms_new"] / visits
        for key, grp in axes.items():
            row[f"ms_{key}"] = _ms(run(grp[name]), args.reps)
        print(json.dumps(row), flush=True)
        del g, ws, out_new, done
        torch.cuda.empty_cache()
    return 0


def _bind2d(kind: str, source: Path, route=None):
    """K3 (``kind`` "sweep2d", on ``route``, None for the wrapper's choice)
    or K6 ("transport2d") built from ``source``, with ``cycle(cell)`` and
    ``solve(cell)`` (the latter returns the result and the per-field cycle
    counts)."""
    if kind == "sweep2d":
        k = cuda_sweep2d.Sweep2dKernel(source)
        return k, SimpleNamespace(
            cycle=lambda c: k.cycle(c.T0, c.s, c.scal, c.spacing, c.n_inner,
                                    c.done, seed_radius=c.seed_radius,
                                    route=route),
            solve=lambda c: k.solve(c.T0, c.s, c.scal, c.spacing, c.n_inner,
                                    c.tol, c.max_iters,
                                    seed_radius=c.seed_radius, route=route))
    k = cuda_transport2d.Transport2dKernel(source)
    return k, SimpleNamespace(
        cycle=lambda c: k.cycle(c.g, c.g, c.ws, c.n_inner, c.done),
        solve=lambda c: k.solve(c.g, c.ws, c.tol, c.max_iters, c.n_inner))


def _split_variant(source: Path, tag: str, pairs):
    """A copy of ``source`` with each ``(old, new)`` pair it has replaced,
    or None where it has none."""
    text = source.read_text()
    found = [(a, b) for a, b in pairs if a in text]
    if not found:
        return None
    for a, b in found:
        text = text.replace(a, b)
    out = BUILD_DIR.parent / "variants" / f"{source.stem}_{tag}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def _main_2d(args, dev) -> int:
    """The ``--2d`` mode: K3 and K6 per cell, against the baselines."""
    srcs = {"sweep2d": {"new": cuda_sweep2d.SOURCE},
            "transport2d": {"new": cuda_transport2d.SOURCE}}
    if args.baseline_k3:
        srcs["sweep2d"]["old"] = args.baseline_k3
    if args.baseline_k6:
        srcs["transport2d"]["old"] = args.baseline_k6
    for kind in srcs:
        for v in [Path(v) for v in args.variants.split(",") if v]:
            if kind in v.stem:
                srcs[kind][v.stem] = v
        if args.split:
            for key, src in list(srcs[kind].items()):
                for tag, pairs in SPLITS.items():
                    var = _split_variant(src, f"{key}_{tag}", pairs)
                    if var is not None:
                        srcs[kind][f"{key}_{tag}"] = var
    bound = {kind: {key: _bind2d(kind, src) for key, src in d.items()}
             for kind, d in srcs.items()}
    # K3's two routes forced, beside the wrapper's choice ("new").
    for route in cuda_sweep2d.ROUTES:
        bound["sweep2d"][route] = _bind2d("sweep2d", cuda_sweep2d.SOURCE,
                                          route)
    _build([k for d in bound.values() for k, _ in d.values()])
    gen = torch.Generator(device=dev).manual_seed(11)
    for cell in args.cells.split(","):
        cfg, grid, s, srcs_xyz, data, params = _batch(cell, dev, gen)
        e = cfg.eikonal
        T0, _ = seed_source(s, srcs_xyz, grid, e.seed_radius)
        c = SimpleNamespace(
            T0=T0, s=s,
            scal=torch.cat(source_scalars(s, srcs_xyz, grid),
                           dim=1).contiguous(),
            spacing=grid.spacing, n_inner=e.n_inner, tol=e.tol,
            max_iters=e.max_iters, seed_radius=e.seed_radius,
            done=torch.zeros(T0.shape[0], dtype=torch.bool, device=dev))
        for kind, d in bound.items():
            if kind == "transport2d":
                T = bound["sweep2d"]["new"][1].solve(c)[0]
                c.ws = batch_weights(T, s, srcs_xyz, grid, e.seed_radius)
                c.g = _cotangent(cfg, grid, data, params, T)
                del T
            row = {"cell": cell, "kernel": kind, "B": T0.shape[0],
                   "grid": list(grid.shape), "n_inner": e.n_inner,
                   "tol": e.tol}
            new = d["new"][1]
            out_new = new.cycle(c)
            lam_new, cyc_new = new.solve(c)
            row["finite"] = bool(torch.isfinite(out_new).all())
            row["cycles_per_field_mean"] = float(cyc_new.float().mean())
            row["cycles_per_field_max"] = int(cyc_new.max())
            row["ms_new"] = _ms(lambda: new.cycle(c), args.reps)
            for key, (_, other) in d.items():
                if key == "new":
                    continue
                row[f"equal_{key}"] = _bits_equal(out_new, other.cycle(c))
                row[f"ms_turns_new_{key}_{key}_new"] = _turns(
                    lambda: new.cycle(c), lambda o=other: o.cycle(c),
                    args.reps)
                if key.rsplit("_", 1)[-1] in SPLITS:  # cycles only
                    continue
                lam_o, cyc_o = other.solve(c)
                row[f"solve_equal_{key}"] = (_bits_equal(lam_new, lam_o)
                                             and torch.equal(cyc_new, cyc_o))
                row[f"ms_solve_turns_new_{key}_{key}_new"] = _turns(
                    lambda: new.solve(c), lambda o=other: o.solve(c),
                    max(1, args.reps // 5))
            visits = 2 * sum(grid.shape)
            row["us_per_line_visit_new"] = 1e3 * row["ms_new"] / visits
            print(json.dumps(row), flush=True)
            del out_new, lam_new
        del c, s, T0
        torch.cuda.empty_cache()
    return 0


def _solve_main(args, dev) -> int:
    """The ``--solve`` mode: K1's solve entry against the host loop around
    the baseline's cycle entry, per cell."""
    if args.baseline is None:
        raise SystemExit("sweep_timing --solve: needs --baseline, a "
                         "sweep3d.cu with the seeded cycle entry")
    k, base = Sweep3dKernel(), SeededSweep3dKernel(args.baseline)
    _build([k, base])
    gen = torch.Generator(device=dev).manual_seed(11)
    for cell in args.cells.split(","):
        cfg, grid, s, srcs, _, _ = _batch(cell, dev, gen)
        e = cfg.eikonal
        T0, _ = seed_source(s, srcs, grid, e.seed_radius)
        scal = torch.cat(source_scalars(s, srcs, grid), dim=1).contiguous()
        per_iter = CYCLES_PER_ITER[solve_route(grid.shape, "on", dev)]

        def one():
            return k.solve(T0, s, scal, grid.spacing, e.n_inner, e.tol,
                           e.max_iters, seed_radius=e.seed_radius,
                           cycles_per_iter=per_iter)

        def loop():
            return sweep_solve(
                T0, scal, s, grid.spacing, e.tol, e.max_iters, e.n_inner,
                cycle=lambda *a: base(*a, seed_radius=e.seed_radius),
                cycles_per_iter=per_iter, return_cycles=True)

        row = {"cell": cell, "B": T0.shape[0], "grid": list(grid.shape),
               "n_inner": e.n_inner, "tol": e.tol, "cycles_per_iter": per_iter}
        for name, run, kern in (("one", one, k), ("loop", loop, base)):
            launches, syncs = kern.launches, COUNTERS.host_syncs
            out, cycles = run()
            torch.cuda.synchronize()
            row[f"launches_{name}"] = kern.launches - launches
            row[f"host_syncs_{name}"] = COUNTERS.host_syncs - syncs
            if name == "one":
                ref, ref_cycles = out, cycles
        row["equal"] = _bits_equal(out, ref) and torch.equal(cycles,
                                                             ref_cycles)
        row["cycles_per_field_mean"] = float(ref_cycles.float().mean())
        row["cycles_per_field_max"] = int(ref_cycles.max())
        turns = _turns(one, loop, max(1, args.reps // 3))
        row["ms_solve_turns_one_loop_loop_one"] = turns
        row["ms_one"] = (turns[0] + turns[3]) / 2
        row["ms_loop"] = (turns[1] + turns[2]) / 2
        print(json.dumps(row), flush=True)
        del T0, scal, s, out, ref
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--cells", default="c2,c3,c5")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default="")
    ap.add_argument("--axes", action="store_true")
    ap.add_argument("--transport", action="store_true")
    ap.add_argument("--2d", dest="two_d", action="store_true")
    ap.add_argument("--baseline-k3", type=Path, default=None)
    ap.add_argument("--baseline-k6", type=Path, default=None)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_timing: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.transport:
        return _transport_main(args, dev)
    if args.solve:
        return _solve_main(args, dev)
    if args.two_d:
        if args.cells == ap.get_default("cells"):
            args.cells = "c4,c1"
        return _main_2d(args, dev)
    new = Sweep3dKernel()
    old = FloorSweep3dKernel(args.baseline) if args.baseline else None
    axes = {}
    if args.axes:
        for ax in range(3):
            axes[f"new_ax{ax}"] = Sweep3dKernel(_axis_variant(SOURCE, ax,
                                                              "new"))
            if old is not None:
                axes[f"old_ax{ax}"] = FloorSweep3dKernel(
                    _axis_variant(args.baseline, ax, "old"))
    variants = {Path(v).stem: Sweep3dKernel(Path(v))
                for v in args.variants.split(",") if v}
    _build([new] + ([old] if old else []) + list(axes.values())
           + list(variants.values()))
    gen = torch.Generator(device=dev).manual_seed(11)
    for cell in args.cells.split(","):
        cfg, grid, s, srcs, _, _ = _batch(cell, dev, gen)
        e = cfg.eikonal
        T0, frozen = seed_source(s, srcs, grid, e.seed_radius)
        scal = torch.cat(source_scalars(s, srcs, grid), dim=1).contiguous()
        done = torch.zeros(T0.shape[0], dtype=torch.bool, device=dev)

        def run_new(k=new):
            return k.solve(T0, s, scal, grid.spacing, e.n_inner, 0.0, 1,
                           seed_radius=e.seed_radius)[0]

        row = {"cell": cell, "B": T0.shape[0], "grid": list(grid.shape),
               "n_inner": e.n_inner}
        out_new = run_new()
        if old is not None:
            floor = seed_floor(T0, frozen)

            def run_old(k=old):
                return k(T0, s, floor, grid.spacing, e.n_inner, done)

            row["equal_to_baseline"] = bool(torch.equal(out_new, run_old()))
            turns = _turns(run_new, run_old, args.reps)
            row["ms_turns_new_old_old_new"] = turns
            row["ms_new"] = (turns[0] + turns[3]) / 2
            row["ms_baseline"] = (turns[1] + turns[2]) / 2
            del floor
        else:
            row["ms_new"] = _ms(run_new, args.reps)
        for key, k in variants.items():
            row[f"equal_{key}"] = bool(torch.equal(out_new, run_new(k)))
            row[f"ms_turns_new_{key}_{key}_new"] = _turns(
                run_new, lambda k=k: run_new(k), args.reps)
        visits = 2 * sum(grid.shape)
        row["us_per_visit_new"] = 1e3 * row["ms_new"] / visits
        for key, k in axes.items():
            if key.startswith("new"):
                row[f"ms_{key}"] = _ms(lambda k=k: run_new(k), args.reps)
            else:
                fl = seed_floor(T0, frozen)
                row[f"ms_{key}"] = _ms(
                    lambda k=k: k(T0, s, fl, grid.spacing, e.n_inner, done),
                    args.reps)
                del fl
        print(json.dumps(row), flush=True)
        del T0, frozen, scal, done, s, out_new
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
