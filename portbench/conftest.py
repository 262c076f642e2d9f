"""The benchmark's own tests (``python -m pytest portbench -q``): the
checkout's root and ``portbench/`` on the path, as ``run.py`` puts them.
Tests that need the card carry the ``cuda`` marker and skip elsewhere,
decided inside the test."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

if os.environ.get("PYTEST_XDIST_WORKER"):
    # One thread a worker: parallel workers' thread pools would contend
    # for the same cores.
    import torch

    torch.set_num_threads(1)
