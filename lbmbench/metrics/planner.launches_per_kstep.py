"""``planner.launches_per_kstep``: the kernel launches the wrappers count
(``lbm_tpu_torch.ops.fused.LAUNCHES``) over the traced window, per 1000
steps of its scenes: how the planner cut the steps into launches."""


def read(record):
    steps = sum(r["iters"] for r in record["scenes"])
    if record["launches"] is None or not steps:
        return None
    return record["launches"] / (steps / 1000)
