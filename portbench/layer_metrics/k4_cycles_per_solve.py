"""``k4_cycles_per_solve``: the transport cycles K4 ran per field solve in
the traced window: its field-cycles (one per field not done per launch,
counted by the kernel, the program's
``cuda_transport.TRANSPORT3D.field_cycles()``) over the window's
``transport_fields``."""

from benchlib import roofline

UNIT = "cycles"
COUNTERS = {"k4_field_cycles":
            "mceik_tpu_torch.eikonal.cuda_transport:"
            "TRANSPORT3D.field_cycles()"}


def read(ctx):
    cycles = roofline.delta(ctx, "k4_field_cycles")
    solves = ctx["work"].get("transport_fields", 0)
    if not cycles or not solves:
        return None
    return cycles / solves
