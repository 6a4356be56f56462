"""``runner.copy_gbps``: the rate of the collate's copy of the final
lattice to the host, in GB/s: the bytes it copies
(``run_simulation``'s ``timings["collate.copy.bytes"]``) over its time
(``timings["collate.copy"]``), each summed over the traced window's
scenes that record both; None where none does."""


def read(record):
    timings = [r["timings"] for r in record["scenes"]
               if {"collate.copy", "collate.copy.bytes"} <= set(r["timings"])]
    seconds = sum(t["collate.copy"] for t in timings)
    if not timings or seconds <= 0:
        return None
    return sum(t["collate.copy.bytes"] for t in timings) / seconds / 1e9
