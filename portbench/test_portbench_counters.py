"""The readers of the program's own counters (the kernels' field-cycles and
the host-sync count) on a made-up window: the formula each states, and
nothing where the counter did not move or the program has none."""

import pytest

from benchlib import layout

C2 = [64, 64, 64]


def _ctx(grid, counters, kernels, work_, fields, before=None):
    before = {k: 0.0 for k in counters} if before is None else before
    return {"window_s": 2.0, "busy_s": 1.5, "kernels": kernels,
            "counters_before": before, "counters_after": counters,
            "work": work_,
            "shapes": {"grid": grid, "n_inner": 2,
                       "fields_per_solve": fields}}


def _read(name, ctx):
    return layout.layer_metric(name).read(ctx)


def test_k1_roofline_cycles_at_c2():
    # 1,500 field-cycles of 64^3 and 128 field solves, 1 s on K1:
    # 262144 x (1500 x 429 + 128 x 21) operations over 67 TFLOP/s.
    ctx = _ctx(C2, {"k1_field_cycles": 1500.0},
               {"void sweep3d_cycle_kernel<4, true>(float*)": 1.0,
                "other": 5.0}, {"forward_fields": 128}, 128)
    want = 100 * 262144 * (1500 * 429 + 128 * 21) / 67e12
    assert _read("k1_roofline.cycles", ctx) == pytest.approx(want)


def test_k4_roofline_cycles_at_c2():
    ctx = _ctx(C2, {"k4_field_cycles": 1200.0},
               {"void transport3d_cycle_kernel<4, true, false>()": 0.5},
               {"transport_fields": 128}, 128)
    want = 100 * 262144 * (1200 * 123 + 128 * 9) / 67e12 / 0.5
    assert _read("k4_roofline.cycles", ctx) == pytest.approx(want)


@pytest.mark.parametrize("name,counter,work_key", [
    ("k1_cycles_per_solve", "k1_field_cycles", "forward_fields"),
    ("k4_cycles_per_solve", "k4_field_cycles", "transport_fields")])
def test_cycles_per_solve(name, counter, work_key):
    # 10 steps of 128 fields: 1,280 field solves in 15,360 field-cycles.
    ctx = _ctx(C2, {counter: 15360.0}, {}, {work_key: 1280}, 128,
               before={counter: 100.0})
    assert _read(name, ctx) == pytest.approx((15360 - 100) / 1280)


@pytest.mark.parametrize("name,fields", [("host_syncs_per_solve.mcmc", 128),
                                         ("host_syncs_per_solve.smc", 80000)])
def test_host_syncs_per_solve(name, fields):
    # 7 batched solves (the window's forward fields over a solve's fields)
    # and 133 syncs.
    ctx = _ctx([48, 48], {"host_syncs": 1133.0}, {},
               {"forward_fields": 7 * fields}, fields,
               before={"host_syncs": 1000.0})
    assert _read(name, ctx) == pytest.approx(133 / 7)


@pytest.mark.parametrize("name,counter", [
    ("k1_roofline.cycles", "k1_field_cycles"),
    ("k4_roofline.cycles", "k4_field_cycles"),
    ("k1_cycles_per_solve", "k1_field_cycles"),
    ("k4_cycles_per_solve", "k4_field_cycles"),
    ("host_syncs_per_solve.mcmc", "host_syncs"),
    ("host_syncs_per_solve.smc", "host_syncs")])
def test_nothing_to_read_gives_nothing(name, counter):
    """A counter that did not move, a program without the counter (its
    reading is None on both sides), and, for a count per solve, a window
    without solves each give nothing, and raise nothing."""
    kernels = {"void sweep3d_cycle_kernel<4, true>(float*)": 1.0,
               "void transport3d_cycle_kernel<4, true, false>()": 1.0}
    work_ = {"forward_fields": 128, "transport_fields": 128}
    assert _read(name, _ctx(C2, {counter: 0.0}, kernels, work_, 128)) is None
    assert _read(name, _ctx(C2, {counter: None}, kernels, work_, 128,
                            before={counter: None})) is None
    assert _read(name, _ctx(C2, {}, kernels, work_, 128)) is None
    if "roofline" not in name:
        ctx = _ctx(C2, {counter: 50.0}, kernels, {}, 128)
        assert _read(name, ctx) is None


def test_counters_name_the_program():
    """Each reader names its counter in the program where the program keeps
    it, and readers of one counter name it alike."""
    from benchlib import cell

    specs = {}
    for name in ("k1_roofline.cycles", "k4_roofline.cycles",
                 "k1_cycles_per_solve", "k4_cycles_per_solve",
                 "host_syncs_per_solve.mcmc", "host_syncs_per_solve.smc"):
        for key, spec in layout.layer_metric(name).COUNTERS.items():
            assert specs.setdefault(key, spec) == spec
            assert cell.counter(spec) is not None
