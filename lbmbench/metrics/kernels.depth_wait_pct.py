"""``kernels.depth_wait_pct``: of the depth kernel's flowing tiles in the
traced window's scenes (the tiles of a launch's rounds after its first,
``run_simulation``'s ``timings["compute.depth.flow_tiles"]``), the share,
in percent, whose first poll found a neighbouring tile of the round
before still unfinished (``timings["compute.depth.waits"]``): how often
the flow form's rounds wait on each other. None where no scene ran the
flow form."""


def read(record):
    rows = [r["timings"] for r in record["scenes"]
            if "compute.depth.flow_tiles" in r["timings"]]
    tiles = sum(t["compute.depth.flow_tiles"] for t in rows)
    if not tiles:
        return None
    return 100 * sum(t["compute.depth.waits"] for t in rows) / tiles
