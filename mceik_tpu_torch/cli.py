"""Command-line entry point.

Usage:
    python -m mceik_tpu_torch run configs/c2_checkerboard3d.json [section.key=value ...] [--device cuda|cpu]
    python -m mceik_tpu_torch run configs/c4_smc.json [...]   (SMC: samplers.smc.run_smc_config)
    python -m mceik_tpu_torch print-config configs/c2_checkerboard3d.json
"""

from __future__ import annotations

import argparse
import json
import sys

from mceik_tpu_torch.io.config_io import apply_overrides, config_to_dict, load_config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mceik_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a sampling workload from a config")
    runp.add_argument("config", help="path to JSON config")
    runp.add_argument("overrides", nargs="*",
                      help="dotted overrides, e.g. sampler.n_samples=2000")
    runp.add_argument("--device", default="cuda",
                      help="torch device: cuda (default; fails without a "
                           "card) or cpu")

    pc = sub.add_parser("print-config", help="print the resolved config")
    pc.add_argument("config")
    pc.add_argument("overrides", nargs="*")

    args = p.parse_args(argv)
    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    if args.cmd == "print-config":
        json.dump(config_to_dict(cfg), sys.stdout, indent=2)
        print()
        return 0

    if cfg.sampler.algorithm == "smc":
        from mceik_tpu_torch.samplers.smc import run_smc_config
        run_smc_config(cfg, device=args.device)
    else:
        from mceik_tpu_torch.api import run
        run(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
