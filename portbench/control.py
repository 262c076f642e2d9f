"""The control of a cell's checks, and the readings its limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed, in one process, a run of the cell as ``run.py`` makes it
(``cell.run_cell``), with a window of ``--seconds`` at the cell's own load;
then the cell's numbers twice, both against the plain reference in fp32 at
the window's last states: for the program (its readings, of which the
largest over a dozen seeds is a limit's lower end), and for the control,
the same reference computed with TF32 matrix products (its upsample's) put
in the program's place (whose smallest reading is the upper end). Prints
one JSON line per seed. Needs a CUDA device; the benchmark's runs never run
it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from benchlib import cell  # noqa: E402


def readings(name: str, seed: int, seconds: float, device="cuda", adjust=None):
    """One run of the cell (``cell.run_cell`` with its control);
    ``{"program": {...}, "control": {...}}``: each number, reduced."""
    out = cell.run_cell(name, seed, seconds, False, time.perf_counter(),
                        device=device, adjust=adjust, control=True)
    return {"seed": seed, "work": out["window"]["work"],
            "seconds": out["window"]["seconds"],
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": {k: v["value"] for k, v in out["control"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: torch sees no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(args.workload, seed, args.seconds)
        out["wall_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
