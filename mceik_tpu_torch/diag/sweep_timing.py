"""Time the 3-D sweep kernel K1, or with ``--transport`` the 3-D transport
kernels K4 and K5, on the card, per cycle and per axis, beside an earlier
version of its source.

    python -m mceik_tpu_torch.diag.sweep_timing [--transport]
        [--baseline OLD.cu] [--variants A.cu,B.cu] [--cells c2,c3,c5]
        [--reps 10] [--axes]

For each cell, the batch its main path sweeps is drawn from the config's
prior (c2: 16 chains x 8 sources of 64^3; c3: 8 chains x 16 stations of
48x48x32; c5: 4 chains x 24 stations of 128^3) and seeded. Then one K1
cycle is timed with CUDA events over ``--reps`` launches, in turns with the
baseline (new, old, old, new), and the two outputs must be equal bit for
bit. ``--baseline`` is a ``sweep3d.cu`` with the floor-operand C entry
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

import torch

from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.eikonal import cuda_transport
from mceik_tpu_torch.eikonal.adjoint_sweep import (batch_weights,
                                                   transport_solve)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.cuda_build import (BUILD_DIR, NvccKernel,
                                                launch_config)
from mceik_tpu_torch.eikonal.cuda_sweep import SOURCE, Sweep3dKernel
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, source_scalars)
from mceik_tpu_torch.forward.predict import interp_tables, predict_events
from mceik_tpu_torch.io.config_io import load_config
from mceik_tpu_torch.model.params import box_from_raw
from mceik_tpu_torch.model.posterior import _gaussian_loglik, build_posterior

REPO = Path(__file__).resolve().parents[2]
CELLS = {"c2": ("c2_checkerboard3d.json", 16),
         "c3": ("c3_joint_events.json", 8),
         "c5": ("c5_pod_nuts.json", 4)}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--cells", default="c2,c3,c5")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default="")
    ap.add_argument("--axes", action="store_true")
    ap.add_argument("--transport", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_timing: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.transport:
        return _transport_main(args, dev)
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
            return k(T0, s, scal, grid.spacing, e.n_inner, done,
                     seed_radius=e.seed_radius)

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
