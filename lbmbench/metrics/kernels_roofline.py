"""``kernels_roofline``: the least time an H100 could take for the traced
scenes' work (:func:`lbmbench.roofline.least_seconds`, counted per scene,
whatever the launches), as a share of the device time of every kernel in
the traced window, in percent."""

from lbmbench.roofline import least_seconds


def read(record):
    trace = record["trace"]
    if trace is None or trace["kernel_s"] <= 0:
        return None
    least = sum(least_seconds(r["nx"], r["ny"], r["iters"])
                for r in record["scenes"])
    return 100 * least / trace["kernel_s"]
