"""``device.idle_pct``: the share of the benchmark's own traced window
in which nothing ran on the device, in percent: 100 x (1 - the union of
the device events cut to the window / the window)."""


def read(record):
    trace = record["trace"]
    if trace is None or trace["device_events"] == 0:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])
