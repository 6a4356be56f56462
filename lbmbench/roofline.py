"""The benchmark's frozen yardstick for the kernels' roofline: the work a
scene needs, whatever implements it, and the card's data-sheet peaks.

Operations: 90 a cell and step, counted from the textbook update in the
paired association the port's kernels use (``csrc/lbm_cell.cuh``):
density 8 additions; velocity 10 additions and 2 divisions; ``u^2`` 3;
the equilibrium 36 (9 speeds, 4 each, the opposite speeds sharing their
even part); relaxation 27 (9 speeds, 3 each); ``|u|`` and its sum 4. The
forcing of one row is left out.

Bytes: 73 a cell, once a scene: the lattice in (9 float32), the lattice
out (9 float32) and the mask (1 byte). Anything a program reads or
writes beyond that, in every step or in every launch, is its own cost
and not the scene's work.

The least time of a scene is the larger of its operations over the
float32 peak and its bytes over the memory rate. At the reference scenes
the operations bound it.
"""

from __future__ import annotations

OPS_PER_CELL_STEP = 90
BYTES_PER_CELL_SCENE = (9 + 9) * 4 + 1

# NVIDIA H100 SXM data sheet, at its 700 W power limit: float32 outside
# the tensor cores (a fused multiply-add counted as two operations) and
# HBM3. Not measured here; a card set below 700 W runs slower under load.
PEAK_F32_OPS_PER_S = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def least_seconds(nx: int, ny: int, iters: int) -> float:
    """The least time an H100 could take for one scene's work."""
    cells = nx * ny
    return max(OPS_PER_CELL_STEP * cells * iters / PEAK_F32_OPS_PER_S,
               BYTES_PER_CELL_SCENE * cells / PEAK_HBM_BYTES_PER_S)
