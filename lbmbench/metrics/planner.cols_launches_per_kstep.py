"""``planner.cols_launches_per_kstep``: the column-mode kernel launches of
the traced window's scenes (``run_simulation``'s
``timings["compute.launches.cols"]``, the ``_cols`` counts of
``lbm_tpu_torch.ops.fused.LAUNCHES`` over a scene) per 1000 of their
steps: how the planner cut a transposed scene's steps into launches.
None where no scene records them."""


def read(record):
    rows = [r for r in record["scenes"]
            if "compute.launches.cols" in r["timings"]]
    steps = sum(r["iters"] for r in rows)
    if not steps:
        return None
    return sum(r["timings"]["compute.launches.cols"] for r in rows) / (
        steps / 1000)
