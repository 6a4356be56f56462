"""The comparison that decides ``correct``: what the timed path returned
for a scene against the plain reference's float64 run of the same scene.

Three numbers a scene, each a share, and the worst over the checked
scenes is held to the cell's limit:

- ``cells``: the widest gap of any final distribution, over the widest
  departure of the reference's final lattice from the state at rest;
- ``av_vels``: the widest gap of the trajectory's steps, over its peak;
- ``reynolds``: the gap of the Reynolds number, over the reference's.

A value that is not finite reads ``inf``.
"""

from __future__ import annotations

import math

import numpy as np

from lbmbench.reference import rest_state

NUMBERS = ("cells", "av_vels", "reynolds")


def _share(gap: float, scale: float) -> float:
    value = gap / scale
    return value if math.isfinite(value) else math.inf


def gaps(scene, cells, av_vels, reynolds, ref) -> dict:
    """The three numbers of one scene. ``cells``, ``av_vels``,
    ``reynolds``: what the program returned; ``ref``: the reference's
    ``(cells, av_vels, reynolds)``."""
    ref_cells, ref_av, ref_re = ref
    cells = np.asarray(cells, dtype=np.float64)
    av_vels = np.asarray(av_vels, dtype=np.float64)
    if cells.shape != ref_cells.shape or av_vels.shape != ref_av.shape:
        return dict.fromkeys(NUMBERS, math.inf)
    moved = np.max(np.abs(ref_cells - rest_state(scene.density, scene.ny,
                                                   scene.nx)))
    return {
        "cells": _share(np.max(np.abs(cells - ref_cells)), moved),
        "av_vels": _share(np.max(np.abs(av_vels - ref_av)),
                          np.max(np.abs(ref_av))),
        "reynolds": _share(abs(float(reynolds) - ref_re), abs(ref_re)),
    }


def worst(rows: list[dict]) -> dict:
    """Each number's largest value over ``rows`` (inf where none)."""
    return {k: max((r[k] for r in rows), default=math.inf) for k in NUMBERS}


def verdict(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in NUMBERS)
