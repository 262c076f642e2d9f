"""``host_syncs_per_solve.mcmc``: the times the host waited for the device's
stream in the traced window, per batched forward solve (one per sampler step).

The syncs are the program's own count (``io.trace.COUNTERS.host_syncs``:
a device value read to the host, a host value copied to the device, a
library call that reads the device by itself), read before and after the
window; the batched solves are the window's ``forward_fields`` over the
fields of a solve.
"""

from benchlib import roofline

UNIT = "syncs"
COUNTERS = {"host_syncs": "mceik_tpu_torch.io.trace:COUNTERS.host_syncs"}


def read(ctx):
    syncs = roofline.delta(ctx, "host_syncs")
    solves = (ctx["work"].get("forward_fields", 0)
              / ctx["shapes"]["fields_per_solve"])
    if not syncs or not solves:
        return None
    return syncs / solves
