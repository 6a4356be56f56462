"""Lattice constants, state initialisation, and state carried across from
the JAX package.

The layout is :mod:`lbm_tpu.state`'s planar SoA: one contiguous
``(9, ny, nx)`` tensor, speed-major, so each speed plane is a row-major
image with x fastest (coalesced along x on a GPU).

``D2Q9`` is redeclared here because ``lbm_tpu.state`` imports
``jax.numpy`` at module level; a test holds the two declarations equal.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.params import Params


class D2Q9:
    """D2Q9 lattice constants (speed numbering as in lbm_tpu.state)::

        6 2 5
         \\|/
        3-0-1
         /|\\
        7 4 8
    """

    Q = 9
    CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
    CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)
    W = np.array(
        [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4, dtype=np.float32
    )
    # Bounce-back mirror: an obstacle cell writes speed k from OPP[k].
    OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)


# Speed permutation under the lattice transpose (the x and y velocity
# components swap): speed k of the transposed lattice stores physical
# speed SIGMA[k] (lbm_tpu/ops/pallas_fused.py:78). A transposed speed
# moves in transposed coordinates as the physical speed of the same
# number moves in physical ones, so streaming and collision keep their
# form; only the forced line turns from a row into a column.
SIGMA = (0, 2, 1, 4, 3, 5, 8, 7, 6)


def transpose_state(cells: torch.Tensor) -> torch.Tensor:
    """Physical (9, ny, nx) <-> transposed (9, nx, ny): swap the spatial
    axes and permute the speeds by :data:`SIGMA`, contiguous. An
    involution; the twin of ``lbm_tpu.ops.pallas_fused.transpose_state``
    (plain data movement there too, outside any kernel)."""
    return torch.stack([cells[SIGMA[k]].T for k in range(D2Q9.Q)]).contiguous()


def _per_speed(params: Params, dtype) -> np.ndarray:
    """The nine equilibrium-at-rest weights times the density, in
    ``dtype``: the weight arithmetic of ``lbm_tpu.state.initial_state_np``
    (density*4/9, density/9, density/36 per speed)."""
    d = np.dtype(dtype).type
    w0 = d(params.density) * d(4.0) / d(9.0)
    w1 = d(params.density) / d(9.0)
    w2 = d(params.density) / d(36.0)
    return np.array([w0, w1, w1, w1, w1, w2, w2, w2, w2], dtype=dtype)


def initial_state(params: Params, device="cpu", dtype=None,
                  transposed: bool = False) -> torch.Tensor:
    """Uniform equilibrium-at-rest distributions (obstacle cells
    included), built on ``device``. ``dtype`` (numpy float type) defaults
    to ``params.dtype``. ``transposed``: built in the transposed layout
    (9, nx, ny), speed k holding physical speed ``SIGMA[k]``'s weight:
    :func:`transpose_state` of the physical rest state, bit for bit,
    without making the physical lattice."""
    dtype = params.dtype if dtype is None else dtype
    per_speed = _per_speed(params, dtype)
    shape = (D2Q9.Q, params.ny, params.nx)
    if transposed:
        per_speed, shape = per_speed[list(SIGMA)], (D2Q9.Q, params.nx,
                                                     params.ny)
    return (
        torch.from_numpy(per_speed).to(device)[:, None, None]
        .expand(shape)
        .contiguous()
    )


def initial_state_np(params: Params, dtype=None) -> np.ndarray:
    """Host-side twin of :func:`initial_state`, the same values as a numpy
    array (resuming a checkpoint under another row padding builds its
    fresh pad rows on the host)."""
    dtype = params.dtype if dtype is None else dtype
    return np.broadcast_to(
        _per_speed(params, dtype)[:, None, None],
        (D2Q9.Q, params.ny, params.nx),
    ).copy()


def from_numpy(cells: np.ndarray, mask: np.ndarray, device="cpu", dtype=None):
    """State carried across: a ``(9, ny, nx)`` lattice from the JAX
    package (or a checkpoint) and its ``(ny, nx)`` bool obstacle mask,
    as the port's contiguous tensors on ``device``. ``dtype`` (numpy
    float type) defaults to the array's own."""
    cells = np.asarray(cells)
    mask = np.asarray(mask, dtype=bool)
    if cells.ndim != 3 or cells.shape[0] != D2Q9.Q:
        raise ValueError(f"expected a (9, ny, nx) lattice, got {cells.shape}")
    if mask.shape != cells.shape[1:]:
        raise ValueError(
            f"mask shape {mask.shape} does not match lattice {cells.shape}"
        )
    dtype = cells.dtype if dtype is None else np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"unsupported working dtype {dtype}")
    # np.array copies: the port steps its buffers in place, and they
    # must never alias the caller's arrays.
    cells_t = torch.from_numpy(np.array(cells, dtype=dtype, order="C"))
    return cells_t.to(device), torch.from_numpy(mask.copy()).to(device)


def to_numpy(cells: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy array (the lattice carried back)."""
    return cells.detach().cpu().numpy()
