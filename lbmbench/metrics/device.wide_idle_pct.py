"""``device.wide_idle_pct``: ``device.idle_pct``'s reading (the share of
the benchmark's own traced window in which nothing ran on the device)
in the wide grid's cell, read by that metric's own reader."""

from lbmbench import spec


def read(record):
    return spec.reader("device.idle_pct")(record)
