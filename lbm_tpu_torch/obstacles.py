"""Obstacle masks: loading, generation and writing.

The reference reads obstacle files as ``x y 1`` integer triplets
scattered into a row-major mask (``d2q9-bgk.c:626-644``) and ships a
generator of boundary walls plus optional interior verticals
(``generate_obstacles.py:1-21``). The mask is a ``(ny, nx)`` bool array.

The port's own copy of :mod:`lbm_tpu.obstacles`;
``tests/test_torch_scene_layer.py`` holds the two equal. The parser is C
(``csrc_host/lbm_io.c``, :func:`.ops._build.load_host`), with the errors
of its plain version, :func:`load_obstacles_plain`, in the same order.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from lbm_tpu_torch.ops import _build

# lbm_read_obstacles' parse codes, each the plain version's exception.
_PARSE_ERRORS = {
    -1: (ValueError, "expected 3 values per line in obstacle file"),
    -2: (OverflowError, "Python int too large to convert to C long"),
    -3: (ValueError, "expected 3 values per line in obstacle file"),
    -4: (ValueError, "obstacle x-coord out of range"),
    -5: (ValueError, "obstacle y-coord out of range"),
    -6: (ValueError, "obstacle blocked value should be 1"),
}


def load_obstacles(path: str | Path, nx: int, ny: int) -> np.ndarray:
    """Parse an obstacle ``.dat`` file into a (ny, nx) bool mask, with
    the reference's validation: 3 values per triplet, coordinates in
    range, blocked flag == 1 (``d2q9-bgk.c:628-633``). Duplicate entries
    (the shipped files repeat the corners) set the same cell."""
    mask = np.zeros((ny, nx), dtype=np.uint8)
    code = _build.load_host().lbm_read_obstacles(
        os.fsencode(path), nx, ny, mask.ctypes.data)
    if code > 0:
        raise FileNotFoundError(
            f"could not open input obstacles file: {path}") \
            from OSError(code, os.strerror(code), str(path))
    if code < 0:
        exc, text = _PARSE_ERRORS[code]
        raise exc(text)
    return mask.view(bool)


def load_obstacles_plain(path: str | Path, nx: int, ny: int) -> np.ndarray:
    """:func:`load_obstacles` in numpy: the plain version."""
    try:
        tokens = Path(path).read_text().split()
    except OSError as exc:
        raise FileNotFoundError(f"could not open input obstacles file: {path}") from exc
    if not tokens:
        return np.zeros((ny, nx), dtype=bool)
    try:
        flat = np.array([int(t) for t in tokens], dtype=np.int64)
    except ValueError as exc:
        raise ValueError("expected 3 values per line in obstacle file") from exc
    if flat.size % 3:
        # Token-stream triplets, like the reference's fscanf
        # (d2q9-bgk.c:628): newline placement is not significant.
        raise ValueError("expected 3 values per line in obstacle file")
    raw = flat.reshape(-1, 3)
    xx, yy, blocked = raw[:, 0], raw[:, 1], raw[:, 2]
    if np.any((xx < 0) | (xx > nx - 1)):
        raise ValueError("obstacle x-coord out of range")
    if np.any((yy < 0) | (yy > ny - 1)):
        raise ValueError("obstacle y-coord out of range")
    if np.any(blocked != 1):
        raise ValueError("obstacle blocked value should be 1")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[yy, xx] = True
    return mask


def num_non_obstacles_r(mask: np.ndarray, dtype=np.float32):
    """1 / (number of fluid cells), the av_vels normaliser
    (d2q9-bgk.c:642), counted on the mask (unique blocked cells)."""
    d = np.dtype(dtype).type
    fluid = mask.size - int(np.count_nonzero(mask))
    return d(1.0) / d(fluid)


def generate_obstacles(
    nx: int, ny: int, interior_walls: bool = False
) -> np.ndarray:
    """The reference generator's mask: walls along rows 0 and ny-1 and
    columns 0 and nx-1, plus (optionally) full-height interior walls at
    x = nx//4 and x = (nx//4)*2 (``generate_obstacles.py:6-20``)."""
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = True
    mask[ny - 1, :] = True
    mask[:, 0] = True
    mask[:, nx - 1] = True
    if interior_walls:
        mask[:, nx // 4] = True
        mask[:, (nx // 4) * 2] = True
    return mask


def write_obstacles(path: str | Path, mask: np.ndarray) -> None:
    """Write a mask in the reference's ``x y 1`` triplet format."""
    yy, xx = np.nonzero(mask)
    with open(path, "w") as fh:
        for x, y in zip(xx, yy):
            fh.write(f"{x} {y} 1\n")
