"""Native (C++) components: the serial fast-sweeping oracle
``native/fsm.cc``, built at first use with g++ and bound with ctypes."""

from mceik_tpu_torch.native.fsm import fsm_solve, have_native  # noqa: F401
