"""``runner.idle_pct``: the share of the traced window in which the device
was idle while the host was in the program's own Python, in percent: the
idle gaps put down to a span of the program (``lbm.*``: its phases and
segment loops; not a CUDA call or an ATen operation inside them) over the
window. The trace's reading keeps only its largest idle entries
(``tracing.TOP``), so this is a lower bound. None without a device
trace, or where the program records no such spans (its scenes' timings
have no ``init.plan``)."""


def read(record):
    trace = record["trace"]
    spans = any("init.plan" in r["timings"] for r in record["scenes"])
    if trace is None or trace["device_events"] == 0 or not spans:
        return None
    idle = sum(s for name, s in trace["idle_gaps"]
               if name.startswith("lbm."))
    return 100 * idle / trace["window_s"]
