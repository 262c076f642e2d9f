"""The benchmark of the PyTorch and CUDA port (``mceik_tpu_torch``), one run
of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (it exits with code 2 and prints no result otherwise; it never
falls back to the CPU). The cell, its configuration and its metrics are
found by name (``benchlib/layout.py``). The run makes the cell's inputs from
``--seed``, sets the program up and warms it up (``setup_s``, from the
start of this process, less the plain reference's making of the inputs),
measures ``--seconds`` of the program's work, and then checks what the
window's last states hold against the plain reference
(``portbench/reference/``), each number beside its limit.

With ``--trace 0`` the result's metrics are the cell's end-to-end ones;
with ``--trace 1`` the window runs under ``torch.profiler`` and they are
its per-layer ones, with the device's busy and window seconds and the
breakdown. The last lines of standard error are the checks; the last line
of standard output is the result, one JSON object. A run that finds JAX or
the JAX package loaded once the window has closed exits with code 3 and
prints no result.

Build caches: the port builds its kernels into ``build/kernels/`` of the
checkout; ``TORCH_EXTENSIONS_DIR``, ``TRITON_CACHE_DIR`` and
``CUDA_CACHE_PATH`` are set to fixed directories under
``build/portbench/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
sys.path[:0] = [HERE, CHECKOUT]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}

import torch  # noqa: E402

from benchlib import cell, layout  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(CHECKOUT, "build", "portbench", sub)
    chips = layout.cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {args.workload} needs {chips} CUDA "
              f"device(s), torch sees {n}", file=sys.stderr)
        return 2
    # The system under test: a checkout without it fails here.
    importlib.import_module("mceik_tpu_torch")
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START, device="cuda")
    found = sorted(set(out["forbidden"]) | set(cell.forbidden_modules()))
    if found:
        print(f"portbench: modules loaded that the port may not use: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    win = out["window"]
    print(f"portbench: {args.workload} seed {args.seed}: set-up "
          f"{out['setup_s']} s {out['phases']}, {win['work']} in "
          f"{win['seconds']} s", file=sys.stderr)
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
