"""``kernels.depth_cols_roofline``: the least time an H100 could take for
the traced scenes' work (:func:`lbmbench.roofline.least_seconds`, counted
per scene, whatever the launches), as a share of the device time of the
depth kernel (``fused_depth_kernel``, whose column mode steps a
transposed scene) in the traced window, in percent. None without a
device trace or where the kernel did not run."""

from lbmbench.roofline import least_seconds

KERNEL = "fused_depth_kernel"


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    seconds = sum(s for name, s in trace["device_ops"] if name == KERNEL)
    if seconds <= 0:
        return None
    least = sum(least_seconds(r["nx"], r["ny"], r["iters"])
                for r in record["scenes"])
    return 100 * least / seconds
