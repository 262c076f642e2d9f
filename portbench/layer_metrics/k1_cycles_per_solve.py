"""``k1_cycles_per_solve``: the sweep cycles K1 ran per field solve in the
traced window: its field-cycles (one per field not done per launch, counted
by the kernel, the program's ``cuda_sweep.SWEEP3D.field_cycles()``) over the
window's ``forward_fields``. The solve's convergence, whatever the launches
that run it."""

from benchlib import roofline

UNIT = "cycles"
COUNTERS = {"k1_field_cycles":
            "mceik_tpu_torch.eikonal.cuda_sweep:SWEEP3D.field_cycles()"}


def read(ctx):
    cycles = roofline.delta(ctx, "k1_field_cycles")
    solves = ctx["work"].get("forward_fields", 0)
    if not cycles or not solves:
        return None
    return cycles / solves
