"""``runner.collate_ms``: the runner's collate phase (``run_simulation``'s
``timings["collate"]``: the final lattice and av_vels copied to the host
and the Reynolds number), in milliseconds, the mean over the traced
window's scenes."""


def read(record):
    times = [r["timings"]["collate"] for r in record["scenes"]
             if "collate" in r["timings"]]
    return 1e3 * sum(times) / len(times) if times else None
