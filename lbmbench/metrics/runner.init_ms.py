"""``runner.init_ms``: the runner's init phase (``run_simulation``'s
``timings["init"]``: allocation, upload, planning and the wrappers'
construction, ending in a synchronize), in milliseconds, the mean over
the traced window's scenes."""


def read(record):
    times = [r["timings"]["init"] for r in record["scenes"]
             if "init" in r["timings"]]
    return 1e3 * sum(times) / len(times) if times else None
