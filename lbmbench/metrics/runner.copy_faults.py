"""``runner.copy_faults``: the minor page faults of the program's process
during the collate copy of the final lattice (``run_simulation``'s
``timings["collate.copy.minflt"]``), the mean a scene over the traced
window's scenes; None where the program counts none."""


def read(record):
    faults = [r["timings"]["collate.copy.minflt"] for r in record["scenes"]
              if "collate.copy.minflt" in r["timings"]]
    return sum(faults) / len(faults) if faults else None
