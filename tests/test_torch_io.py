"""The PyTorch port's files on the CPU, against the JAX package: the data
loaders read what JAX's loaders wrote (HDF5 datasets with truth and mask,
slowness models, CSV station and arrival tables) into equal arrays with the
same error messages, and the ``.pt`` forms round trip; without ``h5py`` an
``.h5`` path fails loudly. The traveltime-table cache keys its files as
JAX's ``_table_key`` does and solves nothing on a hit. Checkpoints round
trip and refuse a mismatched structure. Resume through ``api.run`` (the
checks of tests/test_checkpoint_resume.py, bit for bit with the
uninterrupted run, MALA's Laplace setup skipped, a precondition mismatch
refused) and SMC resume (bit for bit with the uninterrupted ladder)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.forward.tables_cache import _table_key as j_table_key
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.io import loaders as jload
from mceik_tpu.model.data import EventData as JEventData

from mceik_tpu_torch import api
from mceik_tpu_torch.config import DataCfg, ModelCfg
from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward import predict
from mceik_tpu_torch.forward.tables_cache import (_table_key,
                                                  cached_traveltime_tables)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io import loaders
from mceik_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mceik_tpu_torch.io.config_io import config_from_dict
from mceik_tpu_torch.model.data import EventData, TomoData
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.samplers import smc

JGRID2, GRID2 = JGrid((17, 17), (1.0, 1.0)), Grid((17, 17), (1.0, 1.0))
JGRID3, GRID3 = (JGrid((13, 11, 9), (1.0, 1.0, 1.0)),
                 Grid((13, 11, 9), (1.0, 1.0, 1.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on grids of a few
    hundred nodes: one intra-op thread runs them as fast, and keeps them
    from contending with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_events(n_events=4, n_stations=5, seed=11, mask_at=()):
    d, truth = j_make_dataset(JGRID3, JDataCfg(
        dataset="events3d", n_events=n_events, n_stations=n_stations,
        noise=0.005, seed=seed, checker_cells=(2, 2, 2),
        checker_amplitude=0.08), JModelCfg())
    mask = np.ones((n_events, n_stations), np.float32)
    for ij in mask_at:
        mask[ij] = 0.0
    return JEventData(sta_xyz=d.sta_xyz, t_obs=d.t_obs,
                      mask=jnp.asarray(mask)), truth


# --- loaders -----------------------------------------------------------------

def test_reads_jax_tomo_hdf5_through_file_dataset(tmp_path):
    """A tomo HDF5 file JAX wrote (truth slowness and grid attrs) loads
    through make_dataset's "file" dataset into equal arrays; the stored
    truth of the wrong shape is refused with JAX's message."""
    d, truth = j_make_dataset(JGRID2, JDataCfg(
        dataset="crosswell2d", n_src=4, n_rec=6, noise=0.005,
        checker_cells=(2, 2), checker_amplitude=0.1),
        JModelCfg(mode="tomo", inv_shape=(4, 4)))
    path = str(tmp_path / "obs.h5")
    jload.save_dataset_hdf5(path, d, slowness=truth["slowness"], grid=JGRID2)
    data, tr = make_dataset(GRID2, DataCfg(dataset="file", path=path),
                            ModelCfg(mode="tomo"))
    assert isinstance(data, TomoData) and data.mask is None
    for f in ("src_xyz", "rec_xyz", "t_obs"):
        _eq(getattr(data, f), getattr(d, f))
    _eq(tr["slowness"], truth["slowness"])
    bad = Grid((17, 16), (1.0, 1.0))
    with pytest.raises(ValueError) as got:
        make_dataset(bad, DataCfg(dataset="file", path=path), ModelCfg())
    with pytest.raises(ValueError) as want:
        j_make_dataset(JGrid((17, 16), (1.0, 1.0)),
                       JDataCfg(dataset="file", path=path), JModelCfg())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="requires data.path"):
        make_dataset(GRID2, DataCfg(dataset="file"), ModelCfg())


def test_reads_jax_events_hdf5_with_mask_and_extras(tmp_path):
    """An events HDF5 file with a mask and hypo/t0 extras; a file without
    a kind is refused with JAX's message."""
    d, truth = _jax_events(mask_at=[(0, 2), (2, 4)])
    path = str(tmp_path / "events.h5")
    jload.save_dataset_hdf5(path, d, extra={"hypo": truth["hypo"],
                                            "t0": truth["t0"]})
    data, tr = loaders.load_dataset(path)
    assert isinstance(data, EventData)
    for f in ("sta_xyz", "t_obs", "mask"):
        _eq(getattr(data, f), getattr(d, f))
    assert sorted(tr) == ["hypo", "t0"]
    _eq(tr["hypo"], truth["hypo"])
    import h5py
    with h5py.File(tmp_path / "nokind.h5", "w") as f:
        f.create_dataset("t_obs", data=np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError) as got:
        loaders.load_dataset_hdf5(str(tmp_path / "nokind.h5"))
    with pytest.raises(ValueError) as want:
        jload.load_dataset_hdf5(str(tmp_path / "nokind.h5"))
    assert str(got.value) == str(want.value)


def test_reads_jax_slowness_hdf5_with_the_same_checks(tmp_path):
    _, truth = _jax_events()
    s = np.asarray(truth["slowness"])
    path = str(tmp_path / "model.h5")
    jload.save_slowness_hdf5(path, s, JGRID3)
    _eq(loaders.load_slowness(path, GRID3), s)
    for shape, spacing in (((13, 11, 8), (1.0, 1.0, 1.0)),
                           ((13, 11, 9), (1.0, 1.0, 0.5))):
        with pytest.raises(ValueError) as got:
            loaders.load_slowness(path, Grid(shape, spacing))
        with pytest.raises(ValueError) as want:
            jload.load_slowness_hdf5(path, JGrid(shape, spacing))
        assert str(got.value) == str(want.value)
    # And the other way: JAX reads the port's HDF5.
    loaders.save_slowness(str(tmp_path / "port.h5"), torch.from_numpy(s),
                          GRID3)
    _eq(jload.load_slowness_hdf5(str(tmp_path / "port.h5"), JGRID3), s)


def test_csv_tables_both_ways_with_missing_picks(tmp_path):
    """CSV written by JAX loads into the port's arrays (missing picks ->
    mask 0) and through the "csv" dataset; CSV written by the port loads
    into JAX's."""
    d, _ = _jax_events(seed=11, mask_at=[(1, 0), (3, 4), (0, 2)])
    sp, ap = str(tmp_path / "stations.csv"), str(tmp_path / "arrivals.csv")
    jload.save_events_csv(sp, ap, d)
    got = loaders.load_events_csv(sp, ap)
    want = jload.load_events_csv(sp, ap)
    for f in ("sta_xyz", "t_obs", "mask"):
        _eq(getattr(got, f), getattr(want, f))
    data, truth = make_dataset(GRID3, DataCfg(dataset="csv", stations_path=sp,
                                              arrivals_path=ap), ModelCfg())
    assert truth == {}
    _eq(data.t_obs, want.t_obs)
    sp2, ap2 = str(tmp_path / "s2.csv"), str(tmp_path / "a2.csv")
    loaders.save_events_csv(sp2, ap2, got)
    back = jload.load_events_csv(sp2, ap2)
    for f in ("sta_xyz", "t_obs", "mask"):
        _eq(getattr(back, f), getattr(want, f))
    with pytest.raises(ValueError, match="requires data.stations_path"):
        make_dataset(GRID3, DataCfg(dataset="csv"), ModelCfg())


@pytest.mark.parametrize("case", ["unknown station", "duplicate pick",
                                  "duplicate station", "bad header"])
def test_csv_errors_match_jax(case, tmp_path):
    sp = tmp_path / "stations.csv"
    ap = tmp_path / "arrivals.csv"
    sp.write_text("station,x,y,z\nA,0,0,0\nB,1,0,0\n")
    ap.write_text({"unknown station": "event,station,time\nE1,A,1.0\nE1,C,2.0\n",
                   "duplicate pick": "event,station,time\nE1,A,1.0\nE1,A,2.0\n",
                   "duplicate station": "event,station,time\nE1,A,1.0\n",
                   "bad header": "event,sta,time\nE1,A,1.0\n"}[case])
    if case == "duplicate station":
        sp.write_text("station,x,y,z\nA,0,0,0\nA,1,0,0\n")
    with pytest.raises(ValueError) as got:
        loaders.load_events_csv(str(sp), str(ap))
    with pytest.raises(ValueError) as want:
        jload.load_events_csv(str(sp), str(ap))
    assert str(got.value) == str(want.value)
    assert case.split()[-1] in str(got.value) or case == "bad header"


def test_pt_round_trips(tmp_path):
    """Datasets (tomo with truth slowness and extras; events with a mask)
    and slowness models round trip through .pt bit for bit, written
    atomically (no tmp file left) and read with weights_only."""
    d, truth = _jax_events(mask_at=[(1, 1)])
    ev = EventData(sta_xyz=torch.as_tensor(np.asarray(d.sta_xyz)),
                   t_obs=torch.as_tensor(np.asarray(d.t_obs)),
                   mask=torch.as_tensor(np.asarray(d.mask)))
    s = torch.as_tensor(np.asarray(truth["slowness"]))
    path = str(tmp_path / "sub" / "events.pt")
    loaders.save_dataset(path, ev, slowness=s, grid=GRID3,
                         extra={"hypo": np.asarray(truth["hypo"])})
    back, tr = loaders.load_dataset(path)
    for f in ("sta_xyz", "t_obs", "mask"):
        assert torch.equal(getattr(back, f), getattr(ev, f))
    assert torch.equal(tr["slowness"], s)
    _eq(tr["hypo"], truth["hypo"])
    tomo = TomoData(src_xyz=torch.rand(3, 2), rec_xyz=torch.rand(4, 2),
                    t_obs=torch.rand(3, 4))
    loaders.save_dataset(str(tmp_path / "tomo.pt"), tomo)
    tb, ttr = loaders.load_dataset(str(tmp_path / "tomo.pt"))
    assert isinstance(tb, TomoData) and tb.mask is None and ttr == {}
    assert torch.equal(tb.t_obs, tomo.t_obs)
    loaders.save_slowness(str(tmp_path / "m.pt"), s, GRID3)
    assert torch.equal(loaders.load_slowness(str(tmp_path / "m.pt"), GRID3), s)
    with pytest.raises(ValueError, match="spacing"):
        loaders.load_slowness(str(tmp_path / "m.pt"),
                              Grid((13, 11, 9), (1.0, 2.0, 1.0)))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="unknown file format"):
        loaders.save_slowness(str(tmp_path / "m.npy"), s, GRID3)


def test_h5_without_h5py_fails_loudly(tmp_path, monkeypatch):
    """With h5py hidden, every .h5 path raises an ImportError naming h5py
    and the .pt form, and nothing is written in its place."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    s = torch.ones(GRID3.shape)
    for call in (lambda: loaders.save_slowness(str(tmp_path / "m.h5"), s,
                                               GRID3),
                 lambda: loaders.load_slowness(str(tmp_path / "m.h5")),
                 lambda: loaders.load_dataset(str(tmp_path / "d.hdf5")),
                 lambda: make_dataset(GRID3, DataCfg(
                     dataset="file", path=str(tmp_path / "d.h5")),
                     ModelCfg())):
        with pytest.raises(ImportError, match=r"h5py.*\.pt"):
            call()
    assert os.listdir(tmp_path) == []


# --- the table cache ---------------------------------------------------------

def test_table_cache_key_hits_and_misses(tmp_path, monkeypatch):
    """The key equals JAX's _table_key for the same inputs; the first call
    solves and writes tables_{key}.pt, the second loads the same tensor and
    solves nothing, another slowness writes a second file."""
    _, truth = _jax_events()
    s = torch.as_tensor(np.asarray(truth["slowness"]))
    sta = torch.tensor([[1.0, 2.0, 0.0], [10.0, 8.5, 0.0], [6.0, 5.0, 0.0]])
    kw = dict(tol=1e-4, max_iters=40, n_inner=2, seed_radius=3.0)
    key = _table_key(s, sta, GRID3, EikonalConfig(**kw))
    assert key == j_table_key(np.asarray(s), np.asarray(sta), JGRID3,
                              JEikonalConfig(**kw))
    assert key != _table_key(s, sta, GRID3, EikonalConfig(**dict(kw, tol=1e-3)))
    solves = []
    real = predict.traveltime_tables
    monkeypatch.setattr(predict, "traveltime_tables",
                        lambda *a, **k: solves.append(1) or real(*a, **k))
    cache = str(tmp_path / "cache")
    t1 = cached_traveltime_tables(s, sta, GRID3, EikonalConfig(**kw), cache)
    assert os.listdir(cache) == [f"tables_{key}.pt"] and len(solves) == 1
    t2 = cached_traveltime_tables(s, sta, GRID3, EikonalConfig(**kw), cache)
    assert len(solves) == 1 and torch.equal(t1, t2)
    assert torch.equal(t1, real(s, sta, GRID3, EikonalConfig(**kw)))
    cached_traveltime_tables(s * 1.01, sta, GRID3, EikonalConfig(**kw), cache)
    assert len(solves) == 2 and len(os.listdir(cache)) == 2
    cached_traveltime_tables(s, sta, GRID3, EikonalConfig(**kw))
    assert len(solves) == 3 and len(os.listdir(cache)) == 2


# --- checkpoints -------------------------------------------------------------

@dataclasses.dataclass
class _Box:
    a: torch.Tensor
    b: object = None


def test_checkpoint_round_trip_and_mismatches(tmp_path):
    """Leaves keyed by their path (dataclass field, dict key, tuple index),
    None skipped, meta as JSON, restored on the example's dtype; a missing
    leaf raises KeyError and a shape mismatch ValueError, with the
    reference's messages."""
    gen = torch.Generator().manual_seed(5)
    state = {"states": _Box(a=torch.randn(3, 2), b=(torch.arange(4), None)),
             "hyper": Params(u=torch.randn(2, 2), t0=torch.zeros(())),
             "rng": gen.get_state()}
    path = str(tmp_path / "d" / "ck.pt")
    save_checkpoint(path, state, meta={"step": 7, "final": True})
    stored = torch.load(path, weights_only=True)["state"]
    assert sorted(stored) == ["hyper/t0", "hyper/u", "rng", "states/a",
                              "states/b/0"]
    example = {"states": _Box(a=torch.zeros(3, 2, dtype=torch.float64),
                              b=(torch.zeros(4, dtype=torch.long), None)),
               "hyper": Params(u=torch.zeros(2, 2), t0=torch.ones(())),
               "rng": torch.zeros_like(gen.get_state())}
    back, meta = load_checkpoint(path, example)
    assert meta == {"step": 7, "final": True}
    assert back["states"].a.dtype == torch.float64
    torch.testing.assert_close(back["states"].a.float(), state["states"].a,
                               rtol=0, atol=0)
    assert torch.equal(back["states"].b[0], state["states"].b[0])
    assert back["states"].b[1] is None
    assert torch.equal(back["rng"], state["rng"])
    with pytest.raises(KeyError, match="checkpoint missing leaf 'hyper/hypo_raw'"):
        load_checkpoint(path, {**example, "hyper": Params(
            hypo_raw=torch.zeros(1))})
    with pytest.raises(ValueError,
                       match=r"shape mismatch for 'states/a': checkpoint "
                             r"\(3, 2\) vs example \(2, 3\)"):
        load_checkpoint(path, {**example, "states": _Box(a=torch.zeros(2, 3),
                                                         b=example["states"].b)})


def _cfg(**io_kw):
    """tests/test_checkpoint_resume.py's problem, cut from 17^2 to 9^2 and
    from 500 + 200 steps to 120 + 40 (the port's CPU solve is a host
    loop)."""
    return config_from_dict({
        "grid": {"shape": [9, 9], "spacing": [1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-4, "max_iters": 50,
                    "use_pallas": "off"},
        "model": {"mode": "tomo", "inv_shape": [3, 3],
                  "background_slowness": 1.0, "prior_sigma_u": 0.2,
                  "sigma": 0.01},
        "sampler": {"algorithm": "rwm", "n_chains": 4, "n_warmup": 120,
                    "n_samples": 40, "thin": 2, "step_size": 0.05,
                    "seed": 3},
        "data": {"dataset": "crosswell2d", "n_src": 3, "n_rec": 4,
                 "noise": 0.01, "seed": 7, "checker_cells": [2, 2],
                 "checker_amplitude": 0.1},
        "io": {"log_every": 20, **io_kw},
    })


def _with(cfg, section, **kw):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **kw)})


@pytest.fixture(scope="module")
def rwm_runs(tmp_path_factory):
    """``(full, first, resumed, meta)``: one run of 120 + 80 steps in one
    segment; a run of 120 + 40 in segments of 20 with a checkpoint after
    each; the resume of that checkpoint for 40 more."""
    ckpt = str(tmp_path_factory.mktemp("ck") / "run.pt")
    full = api.run(_with(_cfg(log_every=80), "sampler", n_samples=80), "cpu",
                   verbose=False)
    first = api.run(_cfg(checkpoint_path=ckpt, checkpoint_every=20), "cpu",
                    verbose=False)
    meta = load_checkpoint(ckpt, {})[1]
    resumed = api.run(_cfg(resume=ckpt), "cpu", verbose=False)
    return full, first, resumed, meta


def test_checkpoint_then_resume(rwm_runs, tmp_path, capsys):
    """test_checkpoint_then_resume on the port: the resumed run starts from
    the adapted state (acceptance in band at once) and keeps the adapted
    step; the checkpoint's meta as the reference writes it; the resumed
    run says so and runs no warmup; a missing resume path starts fresh with
    the reference's message."""
    _, s1, s2, meta = rwm_runs
    assert meta == {"step": 40, "algorithm": "rwm", "precondition": "laplace",
                    "final": True}
    for s in (s1, s2):
        assert np.isfinite(s.post_mean["params"].u).all()
        assert 0.05 < s.accept_rate < 0.7, s.accept_rate
    assert abs(api._step_size_of(s2.result.hyper)
               - api._step_size_of(s1.result.hyper)) < 1e-6
    ckpt = str(tmp_path / "short.pt")
    short = dict(n_warmup=4, n_samples=4, thin=1)
    api.run(_with(_cfg(checkpoint_path=ckpt), "sampler", **short), "cpu",
            verbose=False)
    api.run(_with(_cfg(resume=ckpt), "sampler", **short), "cpu", verbose=True)
    out = capsys.readouterr().out
    assert f"resumed from {ckpt}" in out and " warmup=0 " in out
    api.run(_with(_cfg(resume=str(tmp_path / "none.pt")), "sampler", **short),
            "cpu", verbose=True)
    out = capsys.readouterr().out
    assert "does not exist — starting fresh" in out and " warmup=4 " in out


def test_segments_and_checkpoints_change_no_draw(rwm_runs):
    """Segmentation (and the checkpoints between segments) does not change
    the draws: the run of 40 samples in segments of 20 collects the first 20
    thinned draws of the one-segment run, bit for bit, and the same welford
    count per sample."""
    full, first, _, _ = rwm_runs
    np.testing.assert_array_equal(first.samples.u, full.samples.u[:20])
    assert float(first.result.welford.count[0]) == 40.0
    assert float(full.result.welford.count[0]) == 80.0


def test_resumed_run_equals_the_uninterrupted_one(rwm_runs):
    """The generator's state is in the checkpoint, so the resumed run's 40
    samples are the uninterrupted run's last 40, bit for bit (the reference
    re-derives its keys and replays the first run's draws instead)."""
    full, _, rest, _ = rwm_runs
    assert torch.equal(rest.result.states.params.u, full.result.states.params.u)
    assert torch.equal(rest.result.states.logpost, full.result.states.logpost)
    np.testing.assert_array_equal(rest.samples.u, full.samples.u[20:])


def _mala_cfg(**io_kw):
    """tests/test_mala_api.py's small MALA problem, cut to 10^3."""
    return config_from_dict({
        "grid": {"shape": [10, 10, 10], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"tol": 1e-3, "max_iters": 30, "use_pallas": "off"},
        "model": {"mode": "tomo", "inv_shape": [3, 3, 3],
                  "prior_sigma_u": 0.15, "sigma": 0.05},
        "sampler": {"algorithm": "mala", "precondition": "laplace",
                    "n_map_steps": 3, "n_chains": 2, "n_warmup": 2,
                    "n_samples": 4, "thin": 1, "step_size": 0.3, "seed": 3},
        "data": {"dataset": "checkerboard3d_volume", "n_src": 2, "n_rec": 3,
                 "noise": 0.05, "seed": 42, "checker_cells": [2, 2, 2],
                 "checker_amplitude": 0.08},
        "io": {"log_every": 4, **io_kw},
    })


def test_mala_resume_skips_laplace_and_refuses_other_precondition(
        tmp_path, monkeypatch):
    """The pinned covariance is in the checkpointed hyper, so a resumed
    MALA run never calls laplace_preconditioner (patched to raise) and
    keeps the pinned count; a checkpoint of precondition="laplace" resumed
    under "none" is refused with the reference's message."""
    ckpt = str(tmp_path / "mala.pt")
    api.run(_mala_cfg(checkpoint_path=ckpt, checkpoint_every=4), "cpu",
            verbose=False)
    from mceik_tpu_torch.model import laplace as laplace_mod

    def boom(*a, **k):
        raise AssertionError("laplace_preconditioner called on resume")

    monkeypatch.setattr(laplace_mod, "laplace_preconditioner", boom)
    s = api.run(_mala_cfg(resume=ckpt), "cpu", verbose=False)
    assert np.isfinite(s.result.logpost_trace.numpy()).all()
    assert float(s.result.hyper.count) > 1e5
    none = _with(_mala_cfg(resume=ckpt), "sampler", precondition="none")
    with pytest.raises(ValueError, match="precondition='laplace' but this "
                                         "run requests 'none'"):
        api.run(none, "cpu", verbose=False)


# --- SMC ---------------------------------------------------------------------

class _Toy:
    """tests/test_torch_smc.py's conjugate Gaussian target."""

    prior_scales = torch.ones(2)
    obs = torch.tensor([1.0, -0.5])

    def log_prior(self, x):
        return -0.5 * (x * x).sum(1)

    def log_lik(self, x):
        return -0.5 * ((self.obs - x) ** 2).sum(1) / 0.5 ** 2

    def sample_prior(self, gen, n):
        return torch.randn((n, 2), generator=gen)


def test_smc_resume_equals_uninterrupted_ladder(tmp_path):
    """Killed after stage 2 and resumed, the ladder ends where the
    uninterrupted one does, bit for bit: population, betas, ESS, acceptance
    and log Z; a missing resume path starts fresh."""
    kw = dict(n_particles=256, n_mutation_steps=3, ess_threshold=0.8,
              step_size=0.5)
    full = smc.run_smc(_Toy(), torch.Generator().manual_seed(0), **kw)
    assert full.n_stages >= 3
    ck = str(tmp_path / "smc.pt")
    part = smc.run_smc(_Toy(), torch.Generator().manual_seed(0),
                       max_stages=2, checkpoint_path=ck, **kw)
    assert part.n_stages == 2
    rest = smc.run_smc(_Toy(), torch.Generator().manual_seed(99),
                       resume=ck, checkpoint_path=ck, **kw)
    assert rest.n_stages == full.n_stages
    assert torch.equal(rest.state.params, full.state.params)
    assert torch.equal(rest.state.log_lik, full.state.log_lik)
    assert rest.betas == full.betas and rest.ess_history == full.ess_history
    assert rest.accept_history == full.accept_history
    assert rest.log_evidence == full.log_evidence
    assert len(rest.stage_seconds) == rest.n_stages
    meta = load_checkpoint(ck, {})[1]
    assert meta["stage"] == full.n_stages and meta["beta"] == 1.0
    fresh = smc.run_smc(_Toy(), torch.Generator().manual_seed(0),
                        resume=str(tmp_path / "none.pt"), **kw)
    assert fresh.betas == full.betas


def test_smc_config_resume_through_run_smc_config(tmp_path):
    """config 4 cut to 16^2, 32 particles and one mutation step through
    run_smc_config, the CLI's SMC entry: io.checkpoint_path with a 2-stage
    cap, then io.resume to a 3-stage cap, equals one 3-stage run bit for
    bit."""
    from mceik_tpu_torch.io.config_io import apply_overrides, load_config
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    c4 = apply_overrides(load_config(os.path.join(repo, "configs",
                                                  "c4_smc.json")),
                         ["grid.shape=[16,16]", "model.inv_shape=[4,4]",
                          "sampler.n_particles=32",
                          "sampler.n_mutation_steps=1", "model.sigma=0.2"])
    ck = str(tmp_path / "c4.pt")
    full = smc.run_smc_config(c4, "cpu", verbose=False, max_stages=3)
    smc.run_smc_config(_with(c4, "io", checkpoint_path=ck), "cpu",
                       verbose=False, max_stages=2)
    rest = smc.run_smc_config(_with(c4, "io", resume=ck), "cpu",
                              verbose=False, max_stages=3)
    assert rest.n_stages == full.n_stages == 3
    assert torch.equal(rest.state.params.u, full.state.params.u)
    assert rest.betas == full.betas
    assert rest.log_evidence == full.log_evidence
