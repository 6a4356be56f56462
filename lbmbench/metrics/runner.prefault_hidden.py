"""``runner.prefault_hidden``: the share of the traced window's scenes,
in per cent, whose collate destination was ready before the device had
finished the scene's queued launches (``run_simulation``'s
``timings["compute.prefault.hidden"]``, 1 or 0 a scene); None where no
scene records it."""


def read(record):
    hidden = [r["timings"]["compute.prefault.hidden"]
              for r in record["scenes"]
              if "compute.prefault.hidden" in r["timings"]]
    return 100 * sum(hidden) / len(hidden) if hidden else None
