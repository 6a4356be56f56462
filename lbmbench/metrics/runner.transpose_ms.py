"""``runner.transpose_ms``: the device time of a scene's layout
transpositions (``run_simulation``'s ``timings["transpose.device"]``,
CUDA events around the wide grid's lattice transposed into and out of
its execution layout), in milliseconds, the mean over the traced
window's scenes that record it; None where none does."""


def read(record):
    times = [r["timings"]["transpose.device"] for r in record["scenes"]
             if "transpose.device" in r["timings"]]
    return 1e3 * sum(times) / len(times) if times else None
