"""Write the golden problems' datasets for the PyTorch port.

    python tools/torch_golden_data.py

The committed goldens (tests/golden/*.json) are moments of posteriors over
the JAX package's synthetic data, whose noise is JAX's draw. The port's
harness (``mceik_tpu_torch/diag/golden.py``) runs where there is no JAX, so
it reads those data from ``mceik_tpu_torch/diag/golden_data/<name>.pt``.
This script makes them on the CPU with the reference's ``make_dataset``
(the call ``mceik_tpu/diag/golden.py``'s ``_build`` makes) and writes them
with the port's ``io.loaders.save_dataset_pt``, the truth slowness (and the
events' hypocentres and origin times) included. Run it again only if the
JAX package's datasets change; tests/test_torch_golden.py holds the files
to ``make_dataset`` bit for bit.
"""

import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mceik_tpu.config import DataCfg, ModelCfg  # noqa: E402
from mceik_tpu.datasets import make_dataset  # noqa: E402
from mceik_tpu.diag.golden import PROBLEMS as J_PROBLEMS  # noqa: E402
from mceik_tpu.grid import Grid as JGrid  # noqa: E402

from mceik_tpu_torch.convert import (event_data_from_jax,  # noqa: E402
                                     tomo_data_from_jax)
from mceik_tpu_torch.diag.golden import (DATA_DIR, PROBLEMS,  # noqa: E402
                                         problem_grid)
from mceik_tpu_torch.io.loaders import save_dataset_pt  # noqa: E402


def _tuples(d):
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()}


def main():
    assert PROBLEMS == J_PROBLEMS, "the port's PROBLEMS differ from JAX's"
    for name, spec in PROBLEMS.items():
        jgrid = JGrid(tuple(spec["grid"]["shape"]),
                      tuple(spec["grid"]["spacing"]))
        jdata, truth = make_dataset(jgrid, DataCfg(**_tuples(spec["data"])),
                                    ModelCfg(**_tuples(spec["model"])))
        if spec["model"]["mode"] == "tomo":
            data, extra = tomo_data_from_jax(jdata), {}
        else:
            data = event_data_from_jax(jdata)
            extra = {k: np.array(truth[k]) for k in ("hypo", "t0")}
        path = DATA_DIR / f"{name}.pt"
        save_dataset_pt(str(path), data, slowness=np.array(truth["slowness"]),
                        grid=problem_grid(name), extra=extra)
        print(f"{name}: {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
