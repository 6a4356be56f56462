"""Obstacle masks: re-exported from the numpy-only :mod:`lbm_tpu.obstacles`
so both packages read, generate and write ``.dat`` masks identically."""

from lbm_tpu.obstacles import (
    generate_obstacles,
    load_obstacles,
    num_non_obstacles_r,
    write_obstacles,
)

__all__ = [
    "generate_obstacles",
    "load_obstacles",
    "num_non_obstacles_r",
    "write_obstacles",
]
