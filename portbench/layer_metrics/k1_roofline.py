"""``k1_roofline``: K1's share of its roofline in the traced window (percent).

K1 is ``csrc/sweep3d.cu`` (kernel ``sweep3d_cycle_kernel``): one launch is
one sweep cycle of every field of a 3-D batch whose done flag is clear. Its
device time is the profiler's, summed over the kernel names below. Its work
is the window's 3-D sweep solves counted by ``work.py``: the field-cycles
are K1's launches (the program's ``cuda_sweep.SWEEP3D.launches``) times the
fields of a solve (chains x sources), and the field solves the window's
``forward_fields``.

The field-cycles are the weak point: a launch sweeps only the fields not yet
converged, and no counter of the program says how many those were, so a
launch counts every field of the batch and the share reads high by the
batch's mean cycles over its most. A K1 that solves in one launch would
leave the launches counting solves, not cycles: the share then reads low.
Per-field cycle counters in the program would cure both.
"""

from pathlib import Path

from benchlib import layout, roofline

UNIT = "%"
KERNELS = (r"sweep3d_cycle_kernel",)
COUNTERS = {"k1_launches":
            "mceik_tpu_torch.eikonal.cuda_sweep:SWEEP3D.launches"}
work = layout.load_module(Path(__file__).with_name("work.py"),
                          "portbench_metric_work")


def read(ctx):
    launches = roofline.delta(ctx, "k1_launches")
    sh = ctx["shapes"]
    if not launches or len(sh["grid"]) != 3:
        return None
    nodes, ndim = work.nodes_of(sh), 3
    solves = ctx["work"].get("forward_fields", 0)
    ops = nodes * (launches * sh["fields_per_solve"]
                   * work.sweep_cycle_ops(ndim, sh["n_inner"])
                   + solves * work.sweep_solve_ops(ndim))
    return roofline.share(ops, solves * work.sweep_bytes(ndim, nodes),
                          roofline.family_seconds(ctx["kernels"], KERNELS))
