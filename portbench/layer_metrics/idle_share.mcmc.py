"""``idle_share.mcmc``: the share of the traced window in which nothing ran on
the device (percent): one minus the union of the device's kernel, copy and
set intervals over the window's length (``benchlib/trace.py``)."""

from benchlib import roofline

UNIT = "%"


def read(ctx):
    return roofline.idle_percent(ctx)
