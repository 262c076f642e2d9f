"""The port's golden harness (``mceik_tpu_torch/diag/golden.py``) against
the JAX package's (``mceik_tpu/diag/golden.py``) and the committed goldens
(tests/golden/), on the CPU.

Tier 1: the committed problem data (``diag/golden_data/*.pt``) equal the
reference's ``make_dataset`` draw bit for bit; the port's ``PROBLEMS``
equal JAX's and every artifact's spec; the port's posterior of each
problem matches JAX's ``_build(name).logpost`` at the golden mean (and
``x_map``) at rtol 2e-5; a cut check run returns the reference's keys and
shapes; a drifted spec is refused; ``make_golden`` writes the committed
schema; the check command applies the reference's bars.

Slow: the z-test of tests/test_golden.py for all four problems by the
port's harness on the CPU, at the reference's check budgets and bars (8
chains with the golden's pinned proposal; c1_small and c2_small by
full-covariance AM, c3_joint_small and c2_mid by Laplace-preconditioned
MALA), through the plain route of the specs.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.diag import golden as jgolden
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.samplers.am_full import _unravel_fn as j_unravel_fn

from mceik_tpu_torch.diag import golden
from mceik_tpu_torch.samplers.am_full import _unravel_fn

NAMES = sorted(golden.PROBLEMS)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tuples(d):
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}


@pytest.mark.parametrize("name", NAMES)
def test_committed_data_equal_jax_make_dataset(name):
    """What ``tools/torch_golden_data.py`` wrote is the reference's draw:
    every array of the dataset and of the truth equal bit for bit."""
    spec = golden.PROBLEMS[name]
    jdata, jtruth = j_make_dataset(
        JGrid(tuple(spec["grid"]["shape"]), tuple(spec["grid"]["spacing"])),
        JDataCfg(**_tuples(spec["data"])), JModelCfg(**_tuples(spec["model"])))
    data, truth = golden.load_data(name)
    fields = (("src_xyz", "rec_xyz") if spec["model"]["mode"] == "tomo"
              else ("sta_xyz",)) + ("t_obs", "mask")
    for f in fields:
        ref = getattr(jdata, f)
        if ref is None:
            assert getattr(data, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(data, f).numpy(),
                                      np.asarray(ref), err_msg=f)
    assert set(truth) == set(jtruth)
    for k in jtruth:
        np.testing.assert_array_equal(truth[k].numpy(), np.asarray(jtruth[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_problems_equal_jax_and_artifacts(name):
    assert golden.PROBLEMS[name] == jgolden.PROBLEMS[name]
    assert golden.load_golden(name)["spec"] == golden.PROBLEMS[name]
    assert golden.load_golden(name) == jgolden.load_golden(name)
    assert set(golden.PROBLEMS) == set(jgolden.PROBLEMS)
    assert golden.CHECK_BUDGET[name][0] == {"c1_small": 31, "c2_small": 32,
                                            "c3_joint_small": 33,
                                            "c2_mid": 34}[name]


@pytest.mark.parametrize("name", NAMES)
def test_posterior_matches_jax_at_golden_points(name):
    """The port's posterior of the problem (its committed data, the spec's
    plain route) against JAX's ``_build(name).logpost`` at the golden mean
    and, for the MALA problems, the stored MAP: rtol 2e-5, the reference's
    own CPU-vs-TPU agreement (XLA contracts FMAs, ROADMAP Queue 3)."""
    art = golden.load_golden(name)
    points = [np.asarray(art["mean"], np.float32)]
    if "x_map" in art["proposal"]:
        points.append(np.asarray(art["proposal"]["x_map"], np.float32))
    jpost = jgolden._build(name)
    j_unravel = j_unravel_fn(jpost.init_params(jax.random.PRNGKey(0)))
    jlp = jax.jit(jpost.logpost)
    ref = np.asarray([float(jlp(j_unravel(jax.numpy.asarray(x))))
                      for x in points])
    post = golden._build(name, "cpu")
    unravel = _unravel_fn(post.init_params(torch.Generator().manual_seed(0),
                                           1), batch_dims=1)
    lp = post.logpost(unravel(torch.from_numpy(np.stack(points))))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(lp.numpy(), ref, rtol=2e-5)


@pytest.mark.parametrize("name,proposal", [("c1_small", False),
                                           ("c2_mid", True)])
def test_run_problem_cut_budget(name, proposal):
    """A cut run returns the reference's keys and shapes: per-cell mean,
    var, se and ESS over the tracked vector, the acceptance, the final
    proposal (with ``x_map`` on the MALA leg) and the draws' covariance;
    the same seed gives the same run."""
    art = golden.load_golden(name)
    kw = dict(proposal=art["proposal"] if proposal else None, device="cpu")
    stats = golden.run_problem(name, 5, 2, 6, thin=2, **kw)
    d = len(art["mean"])
    assert set(stats) == {"mean", "var", "se", "ess", "accept", "proposal",
                          "post_cov"}
    for k in ("mean", "var", "se", "ess"):
        assert stats[k].shape == (d,), k
        assert np.isfinite(stats[k]).all(), k
    assert stats["post_cov"].shape == (d, d)
    assert 0.0 <= stats["accept"] <= 1.0
    assert set(stats["proposal"]) == set(art["proposal"])
    assert np.asarray(stats["proposal"]["cov"]).shape == (d, d)
    again = golden.run_problem(name, 5, 2, 6, thin=2, **kw)
    np.testing.assert_array_equal(again["mean"], stats["mean"])


def test_z_scores_refuses_a_drifted_spec():
    art = copy.deepcopy(golden.load_golden("c2_small"))
    art["spec"]["eikonal"]["tol"] = 1e-4
    with pytest.raises(AssertionError, match="spec drifted"):
        golden.z_scores("c2_small", art, 32, 1, 2, device="cpu")


@pytest.mark.parametrize("name", ["c2_small", "c2_mid"])
def test_make_golden_writes_the_committed_schema(name, tmp_path, monkeypatch):
    """``make_golden`` with a stubbed ``run_problem`` (AM: three bootstrap
    rounds; MALA: one run) writes an artifact whose keys, spec, counts and
    proposal keys are the committed one's, into ``out_dir``; its default
    directory is ``build/golden/``, not the committed ``tests/golden/``."""
    ref = golden.load_golden(name)
    d = len(ref["mean"])
    calls = []

    def fake(n, seed, n_warmup, n_steps, thin=2, proposal=None, device="cuda",
             use_pallas=None, rng="host"):
        calls.append((seed, n_warmup, n_steps, thin, proposal is None))
        prop = {"cov": np.eye(d), "log_step": -0.5}
        if golden._is_mala(n):
            prop["x_map"] = np.zeros(d)
        return {"mean": np.zeros(d), "var": np.ones(d), "se": np.ones(d),
                "ess": np.full(d, 100.0), "accept": 0.3, "proposal": prop,
                "post_cov": np.eye(d)}

    monkeypatch.setattr(golden, "run_problem", fake)
    path, art = golden.make_golden(name, out_dir=str(tmp_path))
    with open(path) as f:
        written = json.load(f)
    assert written == art
    assert set(written) == set(ref)
    assert set(written["proposal"]) == set(ref["proposal"])
    assert written["spec"] == ref["spec"]
    for k in ("n_steps", "thin", "n_chains"):
        assert written[k] == ref[k], k
    assert len(written["mean"]) == d
    assert len(calls) == (1 if golden._is_mala(name) else 3)
    assert golden.OUT_DIR.endswith("build/golden")
    assert golden.OUT_DIR != golden.GOLDEN_DIR


@pytest.mark.parametrize("z_max,rc", [(1.0, 0), (4.0, 1)])
def test_check_command_applies_the_bars(z_max, rc, monkeypatch, capsys):
    """``python -m mceik_tpu_torch.diag.golden check`` prints a row per
    problem (per seed with ``--seeds``) and exits non-zero when a bar fails
    (here max |z|), with a stubbed check run."""
    d = len(golden.load_golden("c2_small")["mean"])

    def fake(name, art, seed, n_warmup, n_steps, thin=2, device="cuda",
             use_pallas=None, rng="host"):
        assert (n_warmup, n_steps) == golden.CHECK_BUDGET[name][1:]
        assert seed in (golden.CHECK_BUDGET[name][0], 7, 8)
        assert use_pallas == "off"
        assert rng == "host"
        z = np.full(d, 0.5)
        z[0] = z_max
        return z, {"mean": np.zeros(d), "accept": 0.3,
                   "ess": np.full(d, 50.0)}

    monkeypatch.setattr(golden, "z_scores", fake)
    assert golden.main(["check", "c2_small", "--device", "cpu",
                        "--route", "off", "--seeds", "7,8"]) == rc
    assert "golden c2_small (seed 8)" in capsys.readouterr().out
    assert golden.main(["check", "c2_small", "--device", "cpu",
                        "--route", "off"]) == rc
    out = capsys.readouterr().out
    assert ("golden c2_small (seed 32): OK" in out) == (rc == 0)
    assert f"max |z| {z_max:.3f}" in out


def test_host_generator_and_its_draws():
    """A run's generator lives on the host by default (``rng="host"``) and
    on the run's device with ``rng="device"`` (the CPU's here, so the two
    runs are one); any other value is refused. The samplers' and the
    posterior's draws are made on the generator's device and moved to the
    tensors'."""
    from mceik_tpu_torch.samplers.base import MHState, draw_normal_uniform

    dev = torch.device("cpu")
    assert golden._generator(3, dev, "host").device.type == "cpu"
    with pytest.raises(ValueError, match="rng"):
        golden._generator(3, dev, "card")
    a = golden.run_problem("c2_small", 5, 2, 4, device="cpu", rng="host")
    b = golden.run_problem("c2_small", 5, 2, 4, device="cpu", rng="device")
    np.testing.assert_array_equal(a["mean"], b["mean"])
    states = MHState(params={"x": torch.zeros(3, 2, dtype=torch.float64)},
                     logpost=torch.zeros(3))
    normal, uniform = draw_normal_uniform(
        torch.Generator().manual_seed(4), states)
    g = torch.Generator().manual_seed(4)
    np.testing.assert_array_equal(
        normal["x"].numpy(), torch.randn((3, 2), generator=g,
                                         dtype=torch.float64).numpy())
    np.testing.assert_array_equal(uniform.numpy(),
                                  torch.rand(3, generator=g).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_device_parity_on_the_cpu(name):
    """``device_parity`` against the CPU itself: the golden's mean, its MAP
    where it has one and the draws around them, every difference 0 and
    within the bars; the gradient parts only for the MALA problems."""
    r = golden.device_parity(name, "cpu", "off", n_points=3)
    mala = golden._is_mala(name)
    assert r["points"] == 3 + (2 if mala else 1)
    assert r["logpost_rel"] == r["logpost_abs"] == 0.0 and r["ok"]
    assert ("grad_rel_l2" in r) == mala
    if mala:
        assert r["grad_rel_l2"] == 0.0 and r["grad_repeats"]


def test_parity_command_exits_on_the_bars(monkeypatch, capsys):
    """``python -m mceik_tpu_torch.diag.golden parity`` prints one JSON row
    per problem and exits non-zero when a row is over a bar (stubbed)."""
    rows = {"c1_small": {"problem": "c1_small", "logpost_rel": 1e-7,
                         "ok": True},
            "c2_mid": {"problem": "c2_mid", "logpost_rel": 1e-3,
                       "ok": False}}
    monkeypatch.setattr(golden, "device_parity",
                        lambda name, device, route: rows[name])
    assert golden.main(["parity", "c1_small", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == rows["c1_small"]
    assert golden.main(["parity", "c1_small", "c2_mid", "--device",
                        "cpu"]) == 1


def test_profile_reset_zeroes_every_launch_count():
    """``diag.profile.reset`` sets every kernel's launches (and K3's block
    launches) to 0, as the harness does before each check."""
    from mceik_tpu_torch.diag import profile

    ks = profile.kernels()
    saved = {n: (k.launches, getattr(k, "block_launches", None))
             for n, k in ks.items()}
    try:
        for k in ks.values():
            k.launches = 5
            if hasattr(k, "block_launches"):
                k.block_launches = 3
        profile.reset()
        assert all(v == 0 for n, v in profile.counts().items()
                   if not n.endswith("_field_cycles"))
    finally:
        for n, k in ks.items():
            k.launches = saved[n][0]
            if saved[n][1] is not None:
                k.block_launches = saved[n][1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal "
                    "on a machine without a card")
def test_sanity_tool_refuses_without_a_card(capsys):
    """``python -m mceik_tpu_torch.diag.sanity`` measures the card's routes:
    without a card it refuses (exit 2) instead of timing the CPU."""
    from mceik_tpu_torch.diag import sanity
    assert sanity.main() == 2
    assert "needs a CUDA device" in capsys.readouterr().err


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_port_golden_moments(name):
    """tests/test_golden.py's z-test by the port's harness on the CPU:
    the reference's check budget (seed, 300 warmup, 2500 steps or 1200 for
    c2_mid, thin 2), the golden's pinned proposal, and its bars: max |z| <
    3.5, median |z| < 1.5, acceptance > 0.05, median ESS > 20 and, for
    c1_small, recovery correlation > 0.5. About 7 (c1_small), 5 (c2_small),
    46 (c3_joint_small) and 11 (c2_mid) minutes on a few CPU threads."""
    seed, n_warmup, n_steps = golden.CHECK_BUDGET[name]
    z, stats = golden.z_scores(name, golden.load_golden(name), seed,
                               n_warmup, n_steps, device="cpu")
    b = golden.bars(name, z, stats)
    print(f"{name}: {b}")
    assert b["max_z"][1], np.round(z, 2).tolist()
    assert b["median_z"][1], np.round(z, 2).tolist()
    assert b["accept"][1], stats["accept"]
    assert b["median_ess"][1], stats["ess"]
    if "recovery_corr" in b:
        assert b["recovery_corr"][1], b["recovery_corr"]
