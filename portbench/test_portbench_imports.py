"""What the harness loads, checked in a fresh interpreter (a pytest plugin
may have loaded JAX into this one): no module whose top-level name, compared
whole, is ``jax``, ``jaxlib``, ``flax`` or the JAX package ``mceik_tpu``;
and the reference loads nothing of the program either."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)

LOAD_HARNESS = f"""
import json, sys
sys.path[:0] = [{HERE!r}, {CHECKOUT!r}]
import run, control
from benchlib import cell, compare, layout, port, roofline, trace
import reference.tomo
for d in ("mcmc", "smc"):
    layout.driver(d)
for m in layout.benchmark()["per_layer"]:
    layout.layer_metric(m["name"])
import mceik_tpu_torch.api, mceik_tpu_torch.samplers.smc
import mceik_tpu_torch.eikonal.cuda_sweep
import mceik_tpu_torch.eikonal.cuda_transport
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path[:0] = [{HERE!r}]
import reference.tomo, reference.eikonal, reference.mala
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level(LOAD_HARNESS)
    assert "mceik_tpu_torch" in mods and "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mceik_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level(LOAD_REFERENCE)
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mceik_tpu",
                       "mceik_tpu_torch"}


def test_reference_sources_name_no_program():
    for name in os.listdir(os.path.join(HERE, "reference")):
        if name.endswith(".py"):
            with open(os.path.join(HERE, "reference", name)) as f:
                text = f.read()
            assert "mceik_tpu" not in text and "import jax" not in text, name


def test_forbidden_names_compare_whole():
    from benchlib import cell
    before = dict(sys.modules)
    try:
        sys.modules["mceik_tpu_torch_probe"] = sys
        found = cell.forbidden_modules()
        assert "mceik_tpu_torch_probe" not in found
        sys.modules["mceik_tpu.grid"] = sys
        assert "mceik_tpu" in cell.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
