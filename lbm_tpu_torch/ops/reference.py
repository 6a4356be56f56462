"""Plain PyTorch twin of :mod:`lbm_tpu.ops.reference`.

The semantic reference of the port: guarded forcing of row ny-2 (or, on
the transposed lattice of a wide grid, of column ny-2), pull
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

from lbm_tpu_torch.state import D2Q9, SIGMA

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


def forcing(w1, w2, axis: int = 0):
    """``(deltas, guards)`` of the forced line: the per-speed additive
    deltas and the ``(speed, threshold)`` guards, the twin of
    ``AccelSpec.rows`` / ``AccelSpec.lanes``. ``axis`` 0: the row ny-2 of
    the physical lattice (+w1/-w1 on speeds 1/3, +w2 on 5 and 8, -w2 on 6
    and 7; guards on 3, 6, 7). ``axis`` 1: the column ny-2 of the
    transposed lattice, speeds permuted by SIGMA (+w1/-w1 on 2/4, +w2 on
    5 and 6, -w2 on 7 and 8; guards on 4, 8, 7)."""
    deltas = (0.0, w1, 0.0, -w1, 0.0, w2, -w2, -w2, w2)
    guards = ((3, w1), (6, w2), (7, w2))
    if axis == 1:
        deltas = tuple(deltas[SIGMA[k]] for k in range(D2Q9.Q))
        guards = tuple((SIGMA[g], t) for g, t in guards)
    elif axis != 0:
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    return deltas, guards


def _accelerated_line(line: torch.Tensor, obs_line: torch.Tensor, w1, w2,
                      axis: int = 0):
    """Guarded forcing of one (9, m) line of the forced row (axis 0) or
    column (axis 1): fluid cells whose guarded speeds each stay strictly
    positive after the subtraction."""
    d = _np_type(line.dtype)
    deltas, guards = forcing(d(w1), d(w2), axis)
    ok = ~obs_line
    for g, t in guards:
        ok = ok & (line[g] - float(t) > 0)
    delta = torch.from_numpy(np.array(deltas, dtype=d)).to(line.device)
    return torch.where(ok[None, :], line + delta[:, None], line)


def accelerate_flow(cells, obstacles, w1, w2, row: int | None = None,
                    axis: int = 0):
    """Forcing on one lattice line; returns a new tensor. ``cells``: (9,
    H, W); ``obstacles``: (H, W) bool. ``axis`` 0 forces row ``row``
    (default H-2), axis 1 the column ``row`` (default W-2) of a
    transposed lattice (:func:`forcing`)."""
    if row is None:
        row = cells.shape[1 + axis] - 2
    out = cells.clone()
    if axis == 0:
        out[:, row, :] = _accelerated_line(cells[:, row, :], obstacles[row, :],
                                           w1, w2)
    else:
        out[:, :, row] = _accelerated_line(cells[:, :, row], obstacles[:, row],
                                           w1, w2, 1)
    return out


def accelerate_flow_dynamic(cells, obstacles, w1, w2, local_row: int,
                            active: bool):
    """Forcing on the shard-local row ``local_row``, applied only when
    ``active``: the twin of the JAX function of the same name, where only
    the shard that owns global row ny-2 forces it (the reference's
    rank_accelerate flag, d2q9-bgk.c:242-243,498). The index is clipped
    into the shard as JAX clips it; an inactive call returns ``cells``."""
    if not active:
        return cells
    row = min(max(int(local_row), 0), cells.shape[1] - 1)
    return accelerate_flow(cells, obstacles, w1, w2, row)


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


def _pull_halo(ext, h: int):
    """The nine streamed (h, nx) planes of the rows between the first and
    last of ``ext`` (9, h + 2, nx): speed k at row j pulls ext row
    j + 1 - cy, column i - cx with x periodic."""
    return [
        torch.roll(ext[k, 1 - int(D2Q9.CY[k]):1 - int(D2Q9.CY[k]) + h],
                   int(D2Q9.CX[k]), dims=1)
        for k in range(D2Q9.Q)
    ]


def collide_stream_halo(interior, south, north, obstacles, omega):
    """One step of a shard's rows with explicit y-halos, the twin of the
    JAX function of the same name. ``interior``: (9, H, nx) local rows;
    ``south``/``north``: (9, 1, nx) rows below row 0 and above row H-1
    (the reference's jj=0 and jj=num_rows+1 halo rows,
    d2q9-bgk.c:279-283); x stays periodic. Returns ``(new, tot_u)``."""
    h = interior.shape[1]
    ext = torch.cat([south, interior, north], dim=1)
    return _bgk_update(_pull_halo(ext, h), obstacles, omega)


def halo_multi_step(cells, halo_s, halo_n, mask, hmask_s, hmask_n,
                    row0: int, ny: int, w1, w2, omega, n: int, axis: int = 0):
    """``n`` steps of a shard's (9, h, nx) rows from k-row halos: the
    plain version of the seam modes of the one-step (k = n = 1) and depth
    (k = n = D) kernels, on the inputs those kernels take.

    ``halo_s`` holds the k rows below row 0 (global rows row0-k ..
    row0-1), ``halo_n`` the k rows above row h-1, both raw (pre-step, not
    forced); ``hmask_s``/``hmask_n`` are their (k, nx) obstacle rows.
    ``axis`` 0: rows are forced by the global rule, a row whose global
    index is ``(ny - 2) mod ny`` (``ny`` the global, padded row count) is
    forced before each step, in the halos too. ``axis`` 1 (a shard of the
    transposed lattice, sharded over its rows): the column nx-2 of every
    row, halo rows included, is forced before each step. Each step
    consumes one halo row per side. Returns ``(new_cells, tots)``, tots
    the (n,) per-step sums of fluid |u| over the shard's own rows."""
    k, h = halo_s.shape[1], cells.shape[1]
    if not 1 <= n <= k or halo_n.shape[1] != k:
        raise ValueError(f"{n} steps need halos of at least {n} rows, got "
                         f"{halo_s.shape[1]} and {halo_n.shape[1]}")
    win = torch.cat([halo_s, cells, halo_n], dim=1)
    wmask = torch.cat([hmask_s, mask, hmask_n], dim=0)
    accel = (ny - 2) % ny
    forced = [i for i in range(h + 2 * k) if (row0 - k + i) % ny == accel]
    tots = []
    for s in range(n):
        if axis == 1:
            win = accelerate_flow(win, wmask, w1, w2, axis=1)
        else:
            # The window is rows [s, h + 2k - s) of the first one.
            rows = [i - s for i in forced if s <= i < h + 2 * k - s]
            if rows:
                win = win.clone()
                for r in rows:
                    win[:, r] = _accelerated_line(win[:, r], wmask[r], w1, w2)
        inner = wmask[1:-1]
        planes, umag = _bgk_update_planes(_pull_halo(win, win.shape[1] - 2),
                                          inner, omega)
        # The shard's own rows sit k - s - 1 rows into the new window.
        own = slice(k - s - 1, k - s - 1 + h)
        tots.append(torch.sum(umag[own].masked_fill(inner[own], 0.0)))
        win, wmask = torch.stack(planes), inner
    return win[:, k - n:k - n + h].contiguous(), torch.stack(tots)


def fused_step(cells, obstacles, w1, w2, omega, accel_row: int | None = None,
               axis: int = 0):
    """One timestep: forcing on the pre-step state (the row ny-2, or with
    ``axis`` 1 the column ny-2 of a transposed lattice), then the fused
    collide-stream pass. Returns ``(new_cells, tot_u)``."""
    cells = accelerate_flow(cells, obstacles, w1, w2, accel_row, axis)
    return collide_stream(cells, obstacles, omega)


def multi_step(cells, obstacles, w1, w2, omega, n: int, axis: int = 0):
    """``n`` timesteps: ``n`` calls of :func:`fused_step`. Returns
    ``(cells, tots)`` with ``tots`` the (n,) per-step tot_u, not yet
    scaled by 1/fluid. The plain version of the many-step kernels."""
    if n < 1:
        raise ValueError(f"step count must be positive, got {n}")
    tots = []
    for _ in range(n):
        cells, tot = fused_step(cells, obstacles, w1, w2, omega, axis=axis)
        tots.append(tot)
    return cells, torch.stack(tots)


# The stream-cost probe's three variants of a step (the twin of
# scripts/stream_cost_probe.py::_probe_call's modes).
PROBE_MODES = ("full", "collide", "stream")


def probe_multi_step(cells, obstacles, omega, gsteps: int, mode: str):
    """``gsteps`` (even) variant-steps of the stream-cost probe on a
    periodic lattice with no forcing: ``(cells, tots)``, ``tots`` the
    (gsteps,) per-step totals. The plain version of ``csrc/probe.cu``.

    ``full``: pull streaming, then bounce-back and BGK collision
    (:func:`collide_stream`); total, the sum of |u| over fluid cells.
    ``collide``: the same update of each cell from its own nine speeds,
    no streaming (an obstacle bounces its own speeds); the same total.
    ``stream``: the pulled speeds copied through, no collision, the mask
    unread; total, the sum of speed 0 over all cells. ``collide`` and
    ``stream`` are wrong physics on purpose: they split a step's time
    between its two halves."""
    if mode not in PROBE_MODES:
        raise ValueError(f"unknown probe mode {mode!r}; known: {PROBE_MODES}")
    if gsteps < 2 or gsteps % 2:
        raise ValueError(f"the probe takes an even step count >= 2, "
                         f"got {gsteps}")
    tots = []
    for _ in range(gsteps):
        if mode == "full":
            cells, tot = collide_stream(cells, obstacles, omega)
        elif mode == "collide":
            cells, tot = _bgk_update(list(cells.unbind(0)), obstacles, omega)
        else:
            cells = torch.stack([
                torch.roll(cells[k], (int(D2Q9.CY[k]), int(D2Q9.CX[k])),
                           (0, 1)) for k in range(D2Q9.Q)])
            tot = torch.sum(cells[0])
        tots.append(tot)
    return cells, torch.stack(tots)
