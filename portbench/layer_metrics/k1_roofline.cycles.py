"""``k1_roofline.cycles``: K1's share of its roofline in the traced window
(percent), its field-cycles counted by the kernel.

K1 is ``csrc/sweep3d.cu`` (kernel ``sweep3d_cycle_kernel``): one launch is
one sweep cycle of every field of a 3-D batch whose done flag is clear. Its
device time is the profiler's, summed over the kernel names below. Its work
is the window's 3-D sweep solves counted by ``work.py``: the field-cycles
are those the kernel counts itself, one per field not done per launch (the
program's ``cuda_sweep.SWEEP3D.field_cycles()``, read before and after the
window: a sync each, outside it), the field solves the window's
``forward_fields``. So the share is exact where ``k1_roofline``, which
charges every field of the batch for every launch, reads high, and it
stays exact when a launch runs more than one cycle.
"""

from pathlib import Path

from benchlib import layout, roofline

UNIT = "%"
KERNELS = (r"sweep3d_cycle_kernel",)
COUNTERS = {"k1_field_cycles":
            "mceik_tpu_torch.eikonal.cuda_sweep:SWEEP3D.field_cycles()"}
work = layout.load_module(Path(__file__).with_name("work.py"),
                          "portbench_metric_work")


def read(ctx):
    cycles = roofline.delta(ctx, "k1_field_cycles")
    sh = ctx["shapes"]
    if not cycles or len(sh["grid"]) != 3:
        return None
    nodes, ndim = work.nodes_of(sh), 3
    solves = ctx["work"].get("forward_fields", 0)
    ops = nodes * (cycles * work.sweep_cycle_ops(ndim, sh["n_inner"])
                   + solves * work.sweep_solve_ops(ndim))
    return roofline.share(ops, solves * work.sweep_bytes(ndim, nodes),
                          roofline.family_seconds(ctx["kernels"], KERNELS))
