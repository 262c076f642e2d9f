"""Time the main paths' batched ``value_and_grad`` on the card with the two
backwards of the slowness upsampling: the separable transpose that
``mceik_tpu_torch/model/params.py`` takes (``_Upsample``) and
``F.interpolate``'s own (atomic adds on CUDA), in turns A B B A on one
posterior and one set of chains per config.

    python -m mceik_tpu_torch.diag.upsample_ab [--reps 3]

The configs at their chain counts on the card: c2 MALA (16 chains, 64^3
from 12^3), c1 under MALA (4 chains, 65^2 from 16^2), c3 (8 chains,
48x48x32 from 10x10x8) and c5 (4 chains of 24 stations, 128^3 from 16^3).
Prints one JSON line per config: each backward's median ms per
``value_and_grad`` and the largest difference of their gradients relative
to the largest gradient. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
import torch.nn.functional as F

from mceik_tpu_torch.api import prepare_device
from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.io.config_io import apply_overrides, load_config
from mceik_tpu_torch.model import params as P
from mceik_tpu_torch.model.posterior import build_posterior, value_and_grad
from mceik_tpu_torch.samplers.am_full import _ravel

CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "configs")

CASES = [("c2_mala.json", 16, []),
         ("c1_crosswell.json", 4, ["sampler.algorithm=mala"]),
         ("c3_joint_events.json", 8, []),
         ("c5_pod_nuts.json", 4, ["sampler.n_chains=4"])]


class _Interpolate:
    """``F.interpolate`` with autograd's own backward."""

    @staticmethod
    def apply(x, size):
        return F.interpolate(x.unsqueeze(1), size=size,
                             mode=P._MODES[len(size)],
                             align_corners=False).squeeze(1)


VARIANTS = {"separable": P._Upsample, "interpolate": _Interpolate}


def _time(vag, params, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vag(params)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mceik_tpu_torch.diag.upsample_ab")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("upsample_ab: torch sees no CUDA device")
    dev = prepare_device("cuda")
    try:
        for name, n_chains, over in CASES:
            cfg = apply_overrides(
                load_config(os.path.join(CONFIGS, name)), over)
            grid = cfg.grid.build()
            data, _ = make_dataset(grid, cfg.data, cfg.model, device=dev)
            post = build_posterior(cfg.model, data, grid, cfg.eikonal,
                                   differentiable=True)
            params = post.init_params(torch.Generator(device=dev).manual_seed(
                cfg.sampler.seed), n_chains)
            vag = value_and_grad(post.logpost)
            ms = {v: [] for v in VARIANTS}
            grads = {}
            for v in VARIANTS:          # one untimed call each
                P._Upsample = VARIANTS[v]
                grads[v] = _ravel(vag(params)[1], batch_dims=1)
            for v in ("separable", "interpolate", "interpolate", "separable"):
                P._Upsample = VARIANTS[v]
                ms[v] += _time(vag, params, args.reps)
            a, b = grads["separable"], grads["interpolate"]
            print(json.dumps({
                "config": name, "n_chains": n_chains,
                "grid": list(grid.shape),
                "ms_separable": statistics.median(ms["separable"]),
                "ms_interpolate": statistics.median(ms["interpolate"]),
                "ms_all": ms,
                "grad_max_diff_rel": float((a - b).abs().max()
                                           / b.abs().max())}), flush=True)
            del post, params, data, vag, grads
            torch.cuda.empty_cache()
    finally:
        P._Upsample = VARIANTS["separable"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
