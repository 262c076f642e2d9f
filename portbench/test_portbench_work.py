"""The roofline work functions against counts made by hand at the cells'
shapes, and the readers' arithmetic on a made-up window."""

import pytest

from benchlib import layout, roofline

work = layout.layer_metric("work")


def test_counts_per_node():
    # Sweep, 3-D: 6 marches x (1 + 2 x 35) + 3 = 429; 2-D: 4 x (1 + 2 x 16)
    # + 3 = 135. Per solve: 5 constants + 16 for the seed in 3-D, 4 + 12
    # in 2-D. Transport, 3-D: 6 x (4 + 2 x 8) + 3 = 123, per solve 9.
    assert work.sweep_cycle_ops(3, 2) == 429
    assert work.sweep_cycle_ops(2, 2) == 135
    assert work.sweep_solve_ops(3) == 21
    assert work.sweep_solve_ops(2) == 16
    assert work.transport_cycle_ops(3, 2) == 123
    assert work.transport_solve_ops(3) == 9
    assert work.sweep_bytes(3, 64 ** 3) == 8 * 64 ** 3 + 16
    assert work.transport_bytes(3, 64 ** 3) == 20 * 64 ** 3


def _ctx(grid, counters, kernels, work_, fields):
    return {"window_s": 2.0, "busy_s": 1.5, "kernels": kernels,
            "counters_before": {k: 0.0 for k in counters},
            "counters_after": counters, "work": work_,
            "shapes": {"grid": grid, "n_inner": 2,
                       "fields_per_solve": fields}}


def test_k1_at_c2():
    # 10 cycles of 128 fields of 64^3 (1,280 field-cycles), 2 solves of 128
    # fields, 1 s on K1: 262144 x (1280 x 429 + 256 x 21) operations over
    # 67 TFLOP/s.
    ctx = _ctx([64, 64, 64], {"k1_field_cycles": 10.0 * 128},
               {"void sweep3d_cycle_kernel<4, true>(float*)": 1.0,
                "other": 5.0}, {"forward_fields": 256}, 128)
    ops = 262144 * (10 * 128 * 429 + 256 * 21)
    want = 100 * ops / 67e12
    assert layout.layer_metric("k1_roofline.cycles").read(ctx) \
        == pytest.approx(want)


def test_k4_at_c2():
    ctx = _ctx([64, 64, 64], {"k4_field_cycles": 13.0 * 128},
               {"void transport3d_cycle_kernel<4, true, false>()": 0.5},
               {"transport_fields": 128}, 128)
    ops = 262144 * (13 * 128 * 123 + 128 * 9)
    want = 100 * ops / 67e12 / 0.5
    assert layout.layer_metric("k4_roofline.cycles").read(ctx) \
        == pytest.approx(want)


def test_k3_at_c4():
    # 80,000 fields of 48^2, 720,000 field-cycles, one solve: 2304 x
    # (720,000 x 135 + 80,000 x 16) operations; both K3 routes count.
    ctx = _ctx([48, 48], {"k3_field_cycles": 720000.0},
               {"void sweep2d_kernel<2, true>()": 0.03,
                "void sweep2d_block_kernel<2>()": 0.01},
               {"forward_fields": 80000}, 80000)
    ops = 2304 * (720000 * 135 + 80000 * 16)
    want = 100 * ops / 67e12 / 0.04
    assert layout.layer_metric("k3_roofline").read(ctx) == pytest.approx(want)


def test_nothing_to_read_gives_nothing():
    ctx = _ctx([64, 64, 64], {"k1_field_cycles": 0.0}, {}, {}, 128)
    assert layout.layer_metric("k1_roofline.cycles").read(ctx) is None
    ctx["counters_after"] = {}
    assert layout.layer_metric("k4_roofline.cycles").read(ctx) is None
    ctx = _ctx([48, 48], {"k3_field_cycles": 5.0}, {}, {}, 80000)
    assert layout.layer_metric("k3_roofline").read(ctx) is None
    assert roofline.share(1.0, 1.0, 0.0) is None


@pytest.mark.parametrize("name", ["idle_share.mcmc", "idle_share.smc"])
def test_idle_share(name):
    ctx = _ctx([8, 8], {}, {}, {}, 1)
    assert layout.layer_metric(name).read(ctx) == pytest.approx(25.0)


def test_bytes_bound_when_operations_are_few():
    assert roofline.share(0.0, 3.35e12, 2.0) == pytest.approx(50.0)
