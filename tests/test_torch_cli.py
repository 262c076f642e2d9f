"""The PyTorch port's host side on the CPU: configs and overrides load to
the same values in both packages, grid coordinates agree, the package
imports without JAX, and the CLI runs a tiny config-2 workload end to end
with ``--device cpu`` (and refuses a missing card loudly)."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.io import config_io as jio

from mceik_tpu_torch import cli
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io import config_io as tio


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
C2 = os.path.join(REPO, "configs", "c2_checkerboard3d.json")
C2_MALA = os.path.join(REPO, "configs", "c2_mala.json")
TINY = ["grid.shape=[12,12,12]", "model.inv_shape=[3,3,3]", "data.n_src=2",
        "data.n_rec=3", "sampler.n_chains=2", "sampler.n_warmup=3",
        "sampler.n_samples=4", "sampler.thin=2", "io.log_every=2"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_like_jax(path):
    """Every configs/*.json, with and without dotted overrides, loads to an
    equal dict in both packages."""
    assert tio.config_to_dict(tio.load_config(path)) == \
        jio.config_to_dict(jio.load_config(path))
    ovs = ["sampler.n_chains=3", "grid.shape=[8,8,8]", "eikonal.use_pallas=off"]
    assert tio.config_to_dict(tio.apply_overrides(tio.load_config(path), ovs)) \
        == jio.config_to_dict(jio.apply_overrides(jio.load_config(path), ovs))
    with pytest.raises(ValueError):
        tio.apply_overrides(tio.load_config(path), ["sampler.no_such_key=1"])


def test_grid_coords_match_jax():
    rng = np.random.default_rng(0)
    kw = dict(shape=(7, 5, 6), spacing=(1.0, 1.2, 0.9), origin=(0.5, -1.0, 2.0))
    jg, g = JGrid(**kw), Grid(**kw)
    pts = rng.uniform(-2, 8, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        g.to_index_coords(torch.from_numpy(pts)).numpy(),
        np.asarray(jg.to_index_coords(jnp.asarray(pts))))
    np.testing.assert_array_equal(g.node_coords(), jg.node_coords())
    assert g.extent == jg.extent


def test_package_imports_without_jax():
    """Importing the port (every module of the slice) leaves jax and the JAX
    package out of sys.modules."""
    code = ("import sys\n"
            "import mceik_tpu_torch.api, mceik_tpu_torch.cli, "
            "mceik_tpu_torch.convert, mceik_tpu_torch.eikonal.cuda_sweep, "
            "mceik_tpu_torch.eikonal.cuda_transport, "
            "mceik_tpu_torch.eikonal.adjoint, "
            "mceik_tpu_torch.eikonal.adjoint_sweep, "
            "mceik_tpu_torch.model.laplace, mceik_tpu_torch.samplers.am_full, "
            "mceik_tpu_torch.samplers.mala, mceik_tpu_torch.samplers.hmc, "
            "mceik_tpu_torch.samplers.nuts, mceik_tpu_torch.samplers.pcn, "
            "mceik_tpu_torch.model.whitened, mceik_tpu_torch.diag.profile, "
            "mceik_tpu_torch.forward.locate, "
            "mceik_tpu_torch.forward.tables_cache, "
            "mceik_tpu_torch.io.loaders, mceik_tpu_torch.io.checkpoint, "
            "mceik_tpu_torch.io.trace, mceik_tpu_torch.dist.mesh, "
            "mceik_tpu_torch.dist.dryrun, mceik_tpu_torch.eikonal.dist_sweep, "
            "mceik_tpu_torch.forward.reshard\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mceik_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_runs_tiny_c2_on_cpu(capsys):
    """A tiny config-2 AM run through the CLI completes: one init record,
    one record per segment, finite logposts, and a summary line."""
    assert cli.main(["run", C2, *TINY, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(x.split("] ", 1)[1]) for x in lines
            if x.startswith("[mceik] ")]
    assert [r["phase"] for r in recs] == ["init", "sample", "sample"]
    assert [r["step"] for r in recs] == [0, 2, 4]
    assert all(np.isfinite(r["logpost_mean"]) for r in recs)
    assert all(0.0 <= r["accept"] <= 1.0 for r in recs[1:])
    assert any(x.startswith("[mceik-tpu-torch] am chains=2") for x in lines)


def _records(lines):
    return [json.loads(x.split("] ", 1)[1]) for x in lines
            if x.startswith("[mceik] ")]


def test_cli_runs_tiny_c2_am_full_on_cpu(capsys):
    """Full-covariance AM through the CLI on the tiny config-2 workload."""
    assert cli.main(["run", C2, *TINY, "sampler.algorithm=am_full",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = _records(lines)
    assert [r["phase"] for r in recs] == ["init", "sample", "sample"]
    assert all(np.isfinite(r["logpost_mean"]) for r in recs)
    assert any(x.startswith("[mceik-tpu-torch] am_full chains=2") for x in lines)


def test_cli_runs_tiny_c2_mala_on_cpu(capsys):
    """configs/c2_mala.json cut to 16^3, a 4^3 basis and 2 chains, through
    the CLI: the Laplace record (MAP trace rising), the init and sample
    records with finite logposts, and a mala summary line. The chains start
    at the MAP plus 0.3x Laplace jitter, so their logposts sit near the
    trace's end."""
    argv = ["run", C2_MALA, "grid.shape=[16,16,16]", "model.inv_shape=[4,4,4]",
            "sampler.n_chains=2", "sampler.n_map_steps=3",
            "sampler.n_warmup=2", "sampler.n_samples=4", "sampler.thin=2",
            "io.log_every=2", "--device", "cpu"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = _records(lines)
    assert [r["phase"] for r in recs] == ["laplace", "init", "sample", "sample"]
    lap = recs[0]
    assert lap["logpost_last"] > lap["logpost_first"]
    assert all(np.isfinite(r[k]) for r in recs[1:]
               for k in ("logpost_mean", "logpost_min", "logpost_max"))
    assert recs[1]["logpost_mean"] > lap["logpost_first"]
    assert all(0.0 <= r["accept"] <= 1.0 for r in recs[2:])
    assert any(x.startswith("[mceik-tpu-torch] mala chains=2") for x in lines)


def test_cli_refuses_missing_card_and_later_slices(tmp_path, monkeypatch):
    """The default device is cuda: with no card the run fails loudly
    instead of falling back to the CPU. ``dist.n_devices=2`` without a
    multi-process launcher warns and runs as one process; ``io.profile_dir``
    writes a ``torch.profiler`` trace of the second segment; locate mode
    over a tomo dataset, which has no stations to locate against, raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["run", C2, *TINY])
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.warns(UserWarning, match="one process"):
        assert cli.main(["run", C2, *TINY, "dist.n_devices=2",
                         "--device", "cpu"]) == 0
    prof = tmp_path / "prof"
    assert cli.main(["run", C2, *TINY, f"io.profile_dir={prof}",
                     "--device", "cpu"]) == 0
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with pytest.raises(TypeError, match="locate mode needs EventData"):
        cli.main(["run", C2, *TINY, "model.mode=locate", "--device", "cpu"])
