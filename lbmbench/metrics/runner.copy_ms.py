"""``runner.copy_ms``: the collate phase's copy of the final lattice to
the host (``run_simulation``'s ``timings["collate.copy"]``, the span
``lbm.collate.copy``), in milliseconds, the mean over the traced window's
scenes; None where the program times no such copy."""


def read(record):
    times = [r["timings"]["collate.copy"] for r in record["scenes"]
             if "collate.copy" in r["timings"]]
    return 1e3 * sum(times) / len(times) if times else None
