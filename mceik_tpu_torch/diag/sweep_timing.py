"""Time the 3-D sweep kernel K1 on the card, per cycle and per axis, beside
an earlier version of its source.

    python -m mceik_tpu_torch.diag.sweep_timing [--baseline OLD.cu]
        [--variants A.cu,B.cu] [--cells c2,c3,c5] [--reps 10] [--axes]

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

Prints the card's ``nvidia-smi`` line, then one JSON line per cell. Needs
a CUDA device; builds into ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.eikonal.cuda_build import (BUILD_DIR, NvccKernel,
                                                launch_config)
from mceik_tpu_torch.eikonal.cuda_sweep import SOURCE, Sweep3dKernel
from mceik_tpu_torch.eikonal.solve import (seed_floor, seed_source,
                                           source_scalars)
from mceik_tpu_torch.io.config_io import load_config
from mceik_tpu_torch.model.posterior import build_posterior

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


def _axis_variant(source: Path, ax: int, tag: str) -> Path:
    """A copy of ``source`` whose cycle marches axis ``ax`` alone."""
    text = source.read_text()
    if AXIS_LOOP not in text:
        raise RuntimeError(f"{source}: no axis loop {AXIS_LOOP!r}")
    out = BUILD_DIR.parent / "variants" / f"sweep3d_{tag}_ax{ax}.cu"
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
    s = post.slowness_of(post.sample_prior(gen, n_chains)).unsqueeze(1)
    s = s.expand((n_chains, srcs.shape[0]) + grid.shape)
    s = s.reshape((-1,) + grid.shape).contiguous()
    srcs = srcs.repeat(n_chains, 1)
    return cfg, grid, s, srcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--cells", default="c2,c3,c5")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default="")
    ap.add_argument("--axes", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_timing: torch sees no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
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
    kernels = ([new] + ([old] if old else []) + list(axes.values())
               + list(variants.values()))
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    print(json.dumps({"build_s": {str(k.source.name): k.build_seconds
                                  for k in kernels}}))
    for line in new.build_log.splitlines():
        if "registers" in line or "spill" in line or "properties" in line:
            print(f"ptxas: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(11)
    for cell in args.cells.split(","):
        cfg, grid, s, srcs = _batch(cell, dev, gen)
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
            turns = [_ms(run_new, args.reps), _ms(run_old, args.reps),
                     _ms(run_old, args.reps), _ms(run_new, args.reps)]
            row["ms_turns_new_old_old_new"] = turns
            row["ms_new"] = (turns[0] + turns[3]) / 2
            row["ms_baseline"] = (turns[1] + turns[2]) / 2
            del floor
        else:
            row["ms_new"] = _ms(run_new, args.reps)
        for key, k in variants.items():
            row[f"equal_{key}"] = bool(torch.equal(out_new, run_new(k)))
            turns = [_ms(run_new, args.reps), _ms(lambda k=k: run_new(k),
                                                  args.reps)]
            turns += [_ms(lambda k=k: run_new(k), args.reps),
                      _ms(run_new, args.reps)]
            row[f"ms_turns_new_{key}_{key}_new"] = turns
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
