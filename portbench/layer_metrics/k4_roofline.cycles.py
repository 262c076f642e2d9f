"""``k4_roofline.cycles``: K4's share of its roofline in the traced window
(percent), its field-cycles counted by the kernel.

K4 is the first entry of ``csrc/transport3d.cu`` (kernel
``transport3d_cycle_kernel``, planes up to 4096 nodes): one launch is one
adjoint transport cycle of every field of a 3-D batch whose done flag is
clear. K5, the same template for larger planes, shares the kernel's name;
the cells that report this metric run 64^3 fields, which K4 takes. Device
time: the profiler's, summed over the names below. Work: the window's
transport solves counted by ``work.py``; the field-cycles are those the
kernel counts itself, one per field not done per launch (the program's
``cuda_transport.TRANSPORT3D.field_cycles()``, read before and after the
window), field solves the window's ``transport_fields``. The weights and
the VJP around the transport are torch work, not K4's.
"""

from pathlib import Path

from benchlib import layout, roofline

UNIT = "%"
KERNELS = (r"transport3d_cycle_kernel",)
COUNTERS = {"k4_field_cycles":
            "mceik_tpu_torch.eikonal.cuda_transport:"
            "TRANSPORT3D.field_cycles()"}
work = layout.load_module(Path(__file__).with_name("work.py"),
                          "portbench_metric_work")


def read(ctx):
    cycles = roofline.delta(ctx, "k4_field_cycles")
    sh = ctx["shapes"]
    if not cycles or len(sh["grid"]) != 3:
        return None
    nodes, ndim = work.nodes_of(sh), 3
    solves = ctx["work"].get("transport_fields", 0)
    ops = nodes * (cycles * work.transport_cycle_ops(ndim, sh["n_inner"])
                   + solves * work.transport_solve_ops(ndim))
    return roofline.share(ops, solves * work.transport_bytes(ndim, nodes),
                          roofline.family_seconds(ctx["kernels"], KERNELS))
