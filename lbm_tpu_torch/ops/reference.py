"""Plain PyTorch twin of :mod:`lbm_tpu.ops.reference`.

The semantic reference of the port: guarded forcing of row ny-2, pull
streaming (``torch.roll``), bounce-back, BGK collision and the per-step
|u| reduction, term for term in the same floating-point association as
the JAX functions of the same names. It runs on any device; it is the
CPU path of the kernel wrapper (:mod:`lbm_tpu_torch.ops.fused`) and the
oracle the CUDA kernel is held to on the card.

Constants are built in the working dtype with numpy (float32 or
float64) and enter torch ops as Python floats holding exactly those
values, so every op computes in the working dtype as the JAX code does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lbm_tpu_torch.state import D2Q9

# BGK association modes, shared with the CUDA kernel's ``mode`` argument.
MODE_PAIRED, MODE_REFERENCE, MODE_OMEGA = 0, 1, 2


def _paired_eq_enabled() -> bool:
    """Opposite-speed paired equilibrium, the f32 default;
    ``LBM_PAIRED_EQ=0`` restores the reference's term-by-term order
    (read like lbm_tpu.ops.reference._paired_eq_enabled)."""
    return os.environ.get("LBM_PAIRED_EQ", "1") not in ("0", "", "false")


def _omega_eq_enabled() -> bool:
    """Omega-absorbed relaxation on top of the paired form, opt-in with
    ``LBM_OMEGA_EQ=1`` (lbm_tpu.ops.reference._omega_eq_enabled)."""
    return os.environ.get("LBM_OMEGA_EQ", "0") not in ("0", "", "false")


def association_mode(dtype: torch.dtype) -> int:
    """The BGK association for ``dtype`` under the current environment:
    float64 always takes the reference order (the golden-match
    contract); float32 is paired unless ``LBM_PAIRED_EQ=0``, and
    omega-absorbed when paired and ``LBM_OMEGA_EQ=1``."""
    if dtype != torch.float32 or not _paired_eq_enabled():
        return MODE_REFERENCE
    return MODE_OMEGA if _omega_eq_enabled() else MODE_PAIRED


def _np_type(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _accel_delta(w1, w2, like: torch.Tensor) -> torch.Tensor:
    """Per-speed forcing deltas (+w1/-w1 on speeds 1/3, +w2 on 5 and 8,
    -w2 on 6 and 7) as a (9,) tensor like ``like``."""
    d = _np_type(like.dtype)
    w1, w2 = d(w1), d(w2)
    return torch.from_numpy(
        np.array([0, w1, 0, -w1, 0, w2, -w2, -w2, w2], dtype=d)
    ).to(like.device)


def _accelerated_row(row: torch.Tensor, obs_row: torch.Tensor, w1, w2):
    """Guarded forcing of one (9, nx) row: fluid cells whose speeds 3, 6
    and 7 each stay strictly positive after the subtraction."""
    d = _np_type(row.dtype)
    w1, w2 = float(d(w1)), float(d(w2))
    ok = (
        ~obs_row
        & (row[3] - w1 > 0)
        & (row[6] - w2 > 0)
        & (row[7] - w2 > 0)
    )
    return torch.where(ok[None, :], row + _accel_delta(w1, w2, row)[:, None], row)


def accelerate_flow(cells, obstacles, w1, w2, row: int | None = None):
    """Forcing on one lattice row (default ny-2); returns a new tensor.
    ``cells``: (9, ny, nx); ``obstacles``: (ny, nx) bool."""
    if row is None:
        row = cells.shape[1] - 2
    out = cells.clone()
    out[:, row, :] = _accelerated_row(cells[:, row, :], obstacles[row, :], w1, w2)
    return out


def _bgk_update_planes(s, obstacles, omega):
    """BGK relaxation + bounce-back on the streamed planes ``s`` (a list
    of 9 (ny, nx) tensors), in the association that
    :func:`association_mode` picks. Returns ``(new_planes, |u|)``."""
    dtype = s[0].dtype
    d = _np_type(dtype)
    one, c_sq_r, two_c_sq_r, two_c_sq_sq_r = 1.0, 3.0, 1.5, 4.5
    w0 = d(4) / d(9)
    w_axis = d(1) / d(9)
    w_diag = d(1) / d(36)
    weights = [w0, w_axis, w_axis, w_axis, w_axis,
               w_diag, w_diag, w_diag, w_diag]
    omega = d(omega)

    rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7] + s[8]
    u_x = (s[1] + s[5] + s[8] - (s[3] + s[6] + s[7])) / rho
    u_y = (s[2] + s[5] + s[6] - (s[4] + s[7] + s[8])) / rho
    u_sq = u_x * u_x + u_y * u_y

    mode = association_mode(dtype)
    if mode != MODE_REFERENCE:
        # Paired form: feq_k = E + O, feq_opp(k) = E - O; in omega mode
        # the weights carry omega (products taken in the working dtype).
        scale = omega if mode == MODE_OMEGA else d(1)
        base = one - u_sq * two_c_sq_r
        wrho_a = float(w_axis * scale) * rho
        wrho_d = float(w_diag * scale) * rho
        odd_a = c_sq_r * wrho_a
        odd_d = c_sq_r * wrho_d

        def pair(wrho, oddw, uc):
            even = wrho * (base + (uc * uc) * two_c_sq_sq_r)
            odd = oddw * uc
            return even + odd, even - odd

        feq = [None] * D2Q9.Q
        feq[0] = float(w0 * scale) * rho * base
        feq[1], feq[3] = pair(wrho_a, odd_a, u_x)
        feq[2], feq[4] = pair(wrho_a, odd_a, u_y)
        feq[5], feq[7] = pair(wrho_d, odd_d, u_x + u_y)
        feq[6], feq[8] = pair(wrho_d, odd_d, u_y - u_x)
    else:
        feq = []
        for k in range(D2Q9.Q):
            cx, cy = int(D2Q9.CX[k]), int(D2Q9.CY[k])
            w = float(weights[k])
            if cx == 0 and cy == 0:
                feq.append(w * rho * (one - u_sq * two_c_sq_r))
                continue
            if cx == 0:
                uc = u_y if cy > 0 else -u_y
            elif cy == 0:
                uc = u_x if cx > 0 else -u_x
            else:
                ux_t = u_x if cx > 0 else -u_x
                uy_t = u_y if cy > 0 else -u_y
                uc = ux_t + uy_t
            feq.append(
                w * rho
                * (one + uc * c_sq_r + (uc * uc) * two_c_sq_sq_r
                   - u_sq * two_c_sq_r)
            )

    new_planes = []
    for k in range(D2Q9.Q):
        if mode == MODE_OMEGA:
            relaxed = s[k] * float(d(1) - omega) + feq[k]
        else:
            relaxed = s[k] + float(omega) * (feq[k] - s[k])
        new_planes.append(torch.where(obstacles, s[int(D2Q9.OPP[k])], relaxed))
    return new_planes, torch.sqrt(u_sq)


def _bgk_update(s, obstacles, omega):
    """:func:`_bgk_update_planes` plus tot_u, the sum of |u| over fluid
    cells."""
    new_planes, umag = _bgk_update_planes(s, obstacles, omega)
    tot_u = torch.sum(umag.masked_fill(obstacles, 0.0))
    return torch.stack(new_planes), tot_u


def collide_stream(cells, obstacles, omega):
    """Pull streaming on the periodic lattice (speed k at (j, i) reads
    ((j - cy) mod ny, (i - cx) mod nx)), bounce-back and BGK collision.
    Returns ``(new_cells, tot_u)``, tot_u not yet scaled by 1/fluid."""
    s = [
        torch.roll(cells[k], (int(D2Q9.CY[k]), int(D2Q9.CX[k])), (0, 1))
        for k in range(D2Q9.Q)
    ]
    return _bgk_update(s, obstacles, omega)


def fused_step(cells, obstacles, w1, w2, omega, accel_row: int | None = None):
    """One timestep: forcing on the pre-step state, then the fused
    collide-stream pass. Returns ``(new_cells, tot_u)``."""
    cells = accelerate_flow(cells, obstacles, w1, w2, accel_row)
    return collide_stream(cells, obstacles, omega)
