"""``k3_roofline``: K3's share of its roofline in the traced window (percent).

K3 is ``csrc/sweep2d.cu``: the whole solve of every field of a 2-D batch in
one launch, a warp per field (``sweep2d_kernel``) or, for batches of no more
fields than SMs, a CTA per field (``sweep2d_block_kernel``). Device time: the
profiler's, summed over both names. Work: the window's 2-D sweep solves
counted by ``work.py``; the field-cycles are exact, counted by the kernel
itself over every field (the program's ``cuda_sweep2d.SWEEP2D.field_cycles()``,
read before and after the window: a sync each, outside it), the field solves
the window's ``forward_fields``.
"""

from pathlib import Path

from benchlib import layout, roofline

UNIT = "%"
KERNELS = (r"sweep2d_kernel", r"sweep2d_block_kernel")
COUNTERS = {"k3_field_cycles":
            "mceik_tpu_torch.eikonal.cuda_sweep2d:SWEEP2D.field_cycles()"}
work = layout.load_module(Path(__file__).with_name("work.py"),
                          "portbench_metric_work")


def read(ctx):
    cycles = roofline.delta(ctx, "k3_field_cycles")
    sh = ctx["shapes"]
    if not cycles or len(sh["grid"]) != 2:
        return None
    nodes, ndim = work.nodes_of(sh), 2
    solves = ctx["work"].get("forward_fields", 0)
    ops = nodes * (cycles * work.sweep_cycle_ops(ndim, sh["n_inner"])
                   + solves * work.sweep_solve_ops(ndim))
    return roofline.share(ops, solves * work.sweep_bytes(ndim, nodes),
                          roofline.family_seconds(ctx["kernels"], KERNELS))
