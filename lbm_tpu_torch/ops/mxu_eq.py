"""The BGK equilibrium as a matrix product: the twin of
``lbm_tpu/ops/mxu_eq.py``, and its compiled step on the H100's tensor
cores (``csrc/mxu_eq.cu``).

Expanded over the quadratic feature vector

    phi = [rho, rho ux, rho uy, rho ux^2, rho uy^2, rho ux uy]

the nine equilibria ``feq_k = w_k rho (1 + 3 uc_k + 4.5 uc_k^2 - 1.5 u^2)``
are one (9, 6) x (6, cells) contraction, ``feq = W phi`` with

    W[k] = w_k [1, 3 cx, 3 cy, 4.5 cx^2 - 1.5, 4.5 cy^2 - 1.5, 9 cx cy].

:func:`collide_stream_mxu` is the JAX function's twin in plain PyTorch (its
product a ``torch.matmul`` in full float32, the counterpart of
``Precision.HIGHEST``), :func:`mxu_multi_step` the plain version of the
kernel: ``n`` steps of forcing + :func:`collide_stream_mxu`, the step that
``scripts/mxu_probe.py`` compiles and times.

:class:`MxuStep` is the kernel's wrapper: G steps in one cooperative launch,
the device-memory resident form's rounds of depth tiles
(:func:`.resident.device_rounds`) with a stage body that forms each warp's
equilibria on the tensor cores, in f64 (``csrc/lbm_depth.cuh``'s
``kStageMxu``). A tensor on the CPU runs :func:`mxu_multi_step`; a CUDA
tensor launches the kernel or raises, also when the device refuses the
cooperative launch. No planned path runs it: it is an instrument
(``scripts/mxu_probe_torch.py``), as the JAX function is.

:func:`mxu_device_emulated` is the kernel's schedule in plain PyTorch for
the CPU tests: the rounds of depth tiles, and in each stage the warps'
products as the kernel forms them, through the same scratch slots and
fragment registers (:func:`b_loads`, :func:`d_stores`), the registers
assembled into matrices by the PTX ISA's m16n8k8 layout, the product in
f64 and each equilibrium rounded once to f32. A lane map that puts a
cell's features or equilibria in the wrong place fails there.

Tolerances. The kernel's equilibria are W phi in f64 rounded once to f32
(within :data:`EPS_F64_PRODUCT` times ``|W| |phi|`` of the float64 map's,
:func:`product_bound`); a plain f32 product rounds six times (within
:data:`EPS_F32_PRODUCT`). So the kernel is not bit for bit any plain
version: the tests and ``chip_smoke.py`` hold its cells to
:func:`cells_atol` (those errors summed over the steps) and its per-step
totals to :data:`TOT_RTOL`. The first form, 3xTF32 on the f32 tensor
path, erred by up to 2^-20 |W| |phi| and took the 1024^2 scene outside
its drift budget (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, fused_depth, resident
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LatticeKernel
from lbm_tpu_torch.state import D2Q9

# The bound of the kernel's product against the float64 map's, relative to
# |W| |phi|: W's float32 rounding (2^-24) and the one rounding of the f64
# result to f32 (2^-24; the f64 products and sums are exact to ~2^-50).
EPS_F64_PRODUCT = 2.0 ** -23
# The same of a plain float32 product of six terms (six roundings).
EPS_F32_PRODUCT = 2.0 ** -21
# The largest |W| |phi| of the states the checks run: the scenes' density
# 0.1 moved by up to 10 % (rho <= 0.11) at speeds |u| < 0.2, where speed
# 0's row, 4/9 rho (1 + 1.5 |u|^2), is the largest.
PRODUCT_SCALE = 0.055
# Per-step totals against the plain version's: the repo's trajectory rtol.
TOT_RTOL = 1e-4


def cells_atol(gsteps: int, omega, scale: float = PRODUCT_SCALE) -> float:
    """The kernel's (or its emulation's) cells against its plain
    version's after ``gsteps`` steps from one state: each step's
    equilibria differ by at most (:data:`EPS_F64_PRODUCT` +
    :data:`EPS_F32_PRODUCT`) ``scale``, the relaxation passes on omega
    times that, and the trajectory may double what the steps add."""
    return (2.0 * gsteps * float(omega) * (EPS_F64_PRODUCT + EPS_F32_PRODUCT)
            * scale)


def equilibrium_matrix(dtype=torch.float32) -> torch.Tensor:
    """(9, 6) map from the quadratic feature vector to the nine
    equilibria, built in float64 and then cast (bit-equal to the JAX
    function's)."""
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, dtype=np.float64)
    W = np.zeros((D2Q9.Q, 6), dtype=np.float64)
    for k in range(D2Q9.Q):
        cx, cy = float(D2Q9.CX[k]), float(D2Q9.CY[k])
        W[k] = w[k] * np.array([
            1.0, 3.0 * cx, 3.0 * cy,
            4.5 * cx * cx - 1.5, 4.5 * cy * cy - 1.5, 9.0 * cx * cy,
        ])
    return torch.from_numpy(W).to(dtype)


def check_f32_matmul() -> None:
    """Raise unless float32 matrix products run in full float32: the
    counterpart of ``Precision.HIGHEST``. TF32 keeps about three decimal
    digits; a product that quietly took it would be another function."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "collide_stream_mxu needs float32 products in full float32: "
            "torch.backends.cuda.matmul.allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32} and the float32 matmul "
            f"precision is {torch.get_float32_matmul_precision()!r} "
            "(want False and 'highest')")


def _features(s):
    """rho, u_sq and phi (6, ...) of the pulled planes ``s``, each in the
    JAX function's order."""
    rho = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7] + s[8]
    u_x = (s[1] + s[5] + s[8] - (s[3] + s[6] + s[7])) / rho
    u_y = (s[2] + s[5] + s[6] - (s[4] + s[7] + s[8])) / rho
    u_sq = u_x * u_x + u_y * u_y
    rux, ruy = rho * u_x, rho * u_y
    phi = torch.stack([rho, rux, ruy, rux * u_x, ruy * u_y, rux * u_y])
    return u_sq, phi


def _relax(s, feq, obstacles, omega):
    """relaxed = s + omega (feq - s), bounce-back on obstacles."""
    om = float(ref_ops._np_type(s[0].dtype)(omega))
    return torch.stack([
        torch.where(obstacles, s[int(D2Q9.OPP[k])], s[k] + om * (feq[k] - s[k]))
        for k in range(D2Q9.Q)])


def collide_stream_mxu(cells, obstacles, omega):
    """Twin of :func:`.reference.collide_stream` with the equilibrium as a
    matrix product (the JAX function of the same name, step for step).
    Returns ``(new_cells, tot_u)``; raises where float32 products would
    not run in full float32 (:func:`check_f32_matmul`)."""
    check_f32_matmul()
    s = [torch.roll(cells[k], (int(D2Q9.CY[k]), int(D2Q9.CX[k])), (0, 1))
         for k in range(D2Q9.Q)]
    u_sq, phi = _features(s)
    ny, nx = cells.shape[1:]
    W = equilibrium_matrix(cells.dtype).to(cells.device)
    feq = torch.matmul(W, phi.reshape(6, ny * nx)).reshape(D2Q9.Q, ny, nx)
    tot_u = torch.sum(torch.sqrt(u_sq).masked_fill(obstacles, 0.0))
    return _relax(s, feq, obstacles, omega), tot_u


def mxu_step(cells, obstacles, w1, w2, omega):
    """One step as ``scripts/mxu_probe.py`` builds it: forcing of row ny-2
    (:func:`.reference.accelerate_flow`), then :func:`collide_stream_mxu`."""
    cells = ref_ops.accelerate_flow(cells, obstacles, w1, w2)
    return collide_stream_mxu(cells, obstacles, omega)


def mxu_multi_step(cells, obstacles, w1, w2, omega, n: int):
    """``n`` calls of :func:`mxu_step`: ``(cells, tots)``, tots the (n,)
    per-step tot_u. The kernel's plain version."""
    if n < 1:
        raise ValueError(f"step count must be positive, got {n}")
    tots = []
    for _ in range(n):
        cells, tot = mxu_step(cells, obstacles, w1, w2, omega)
        tots.append(tot)
    return cells, torch.stack(tots)


# ---------------------------------------------------------------------------
# The products as the kernel forms them.
# ---------------------------------------------------------------------------

# The PTX ISA's fragment layout of mma.m16n8k8 with .f64 operands (the
# hardware's): the (row, column) each lane's register holds, lane = 4 g + t.
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3
PTX_A = np.array([(_G, _T), (_G + 8, _T), (_G, _T + 4), (_G + 8, _T + 4)])
PTX_B = np.array([(_T, _G), (_T + 4, _G)])
PTX_D = np.array([(_G, 2 * _T), (_G, 2 * _T + 1), (_G + 8, 2 * _T),
                  (_G + 8, 2 * _T + 1)])


def a_fragments() -> np.ndarray:
    """The kernel's A registers, (4, 32) float64: register i of lane l
    at [i, l], W (float32, exact in f64) padded to 16 x 8."""
    pad = np.zeros((16, 8), dtype=np.float64)
    pad[:D2Q9.Q, :6] = equilibrium_matrix(torch.float32).numpy()
    return np.stack([pad[PTX_A[i, 0], PTX_A[i, 1]] for i in range(4)])


# The kernel's own maps (csrc/lbm_depth.cuh): where a warp's scratch keeps
# each plane of each of its P cells, and which slot each lane loads into
# each B register and stores each D register to.

def mxu_slot(p, c, P: int):
    """Plane p of cell c (2 lane + i) in a warp's scratch of P cells."""
    return p * P + ((c + 8 * p) & (P - 1))


def owner_slots(planes: int, P: int) -> np.ndarray:
    """(planes, P): the slot of each plane of each of the warp's cells,
    where its owner stores phi and loads feq."""
    return mxu_slot(np.arange(planes)[:, None], np.arange(P)[None, :], P)


def b_loads(P: int) -> np.ndarray:
    """(P // 8, 32, 2): the slot each lane loads into b0 and b1 for each
    of the warp's products, -1 for a zero (features 6 and 7)."""
    T = np.arange(P // 8)[:, None]
    c = 8 * T + _G
    b0 = mxu_slot(_T, c, P)
    b1 = np.where(_T < 2, mxu_slot(_T + 4, c, P), -1)
    return np.stack([b0, b1], axis=-1)


def d_stores(P: int) -> np.ndarray:
    """(P // 8, 32, 4): the slot each lane stores d0..d3 to for each of
    the warp's products, -1 for a dropped register (W's padding rows)."""
    T = np.arange(P // 8)[:, None]
    e = 8 * T + 2 * _T
    top = np.broadcast_to(_G == 0, e.shape)
    return np.stack([
        np.broadcast_to(mxu_slot(_G, e, P), e.shape),
        np.broadcast_to(mxu_slot(_G, e + 1, P), e.shape),
        np.where(top, mxu_slot(8, e, P), -1),
        np.where(top, mxu_slot(8, e + 1, P), -1)], axis=-1)


def _matrix(regs: torch.Tensor, layout: np.ndarray, shape) -> torch.Tensor:
    """The matrices whose fragments are ``regs`` (..., registers, 32) by
    ``layout``: (..., *shape)."""
    out = regs.new_zeros(regs.shape[:-2] + tuple(shape))
    for i in range(layout.shape[0]):
        out[..., layout[i, 0], layout[i, 1]] = regs[..., i, :]
    return out


def warp_products(phi: torch.Tensor, P: int) -> torch.Tensor:
    """The equilibria that warps with P cells each form: ``phi`` (warps,
    6, P) float32 in, feq (warps, 9, P) out, through the kernel's scratch
    (NaN where nothing was stored), its B and D maps, the hardware's
    fragment layout and one f64 product, each result rounded once to
    float32."""
    n = phi.shape[0]
    sc = torch.full((n, 9 * P), float("nan"), dtype=torch.float32)
    sc[:, torch.from_numpy(owner_slots(6, P).ravel())] = phi.reshape(n, 6 * P)
    a = _matrix(torch.from_numpy(a_fragments()), PTX_A, (16, 8))
    loads = torch.from_numpy(b_loads(P))
    b = torch.where(loads >= 0, sc[:, loads.clamp(min=0)], 0.0)
    bm = _matrix(b.transpose(-1, -2), PTX_B, (8, 8))   # (n, tiles, 8, 8)
    d = (a @ bm.double()).float()
    regs = torch.stack([d[..., PTX_D[i, 0], PTX_D[i, 1]] for i in range(4)],
                       dim=-1)                          # (n, tiles, 32, 4)
    stores = torch.from_numpy(d_stores(P))
    kept = stores >= 0
    sc[:, stores[kept]] = regs[:, kept]
    return sc[:, torch.from_numpy(owner_slots(9, P).ravel())].reshape(n, 9, P)


def product_bound(phi: torch.Tensor) -> torch.Tensor:
    """The bound of :func:`warp_products`' error against the float64
    map's W phi: :data:`EPS_F64_PRODUCT` |W| |phi|, (9, ...) for ``phi``
    (6, ...)."""
    w = equilibrium_matrix(torch.float64).abs()
    flat = phi.double().abs().reshape(6, -1)
    return (EPS_F64_PRODUCT * (w @ flat)).reshape((9,) + tuple(phi.shape[1:]))


def _window_order(depth: int) -> torch.Tensor:
    """The window positions (row-major) of the depth tile's cells in the
    order of the kernel's threads, two cells a thread: cell 2 tid + i sits
    at window row r of the thread's quad row, column 2 (tid mod 20) + i
    (``csrc/lbm_depth.cuh``: the tile's rows first, then the south halo
    rows, then the north ones)."""
    ty, _ = fused_depth.TILES[4]
    width = fused_depth.TILES[4][1] + 2 * fused_depth.HALO_X[4]
    h = ty + 2 * depth
    qrow = np.arange(h)
    r = np.where(qrow < ty, qrow + depth,
                 np.where(qrow < ty + depth, qrow - ty, qrow))
    pos = r[:, None] * width + np.arange(width)[None, :]
    return torch.from_numpy(pos.ravel())


def _window_products(phi: torch.Tensor) -> torch.Tensor:
    """feq (9, H, W) of a depth tile's window from its phi (6, H, W), each
    warp's cells through :func:`warp_products`."""
    _, h, width = phi.shape
    depth = (h - fused_depth.TILES[4][0]) // 2
    order = _window_order(depth)
    cells = phi.reshape(6, -1)[:, order]
    full, rest = divmod(cells.shape[1], 64)
    parts = [warp_products(cells[:, :64 * full].reshape(6, full, 64)
                           .transpose(0, 1), 64)
             .transpose(0, 1).reshape(9, -1)]
    if rest:
        parts.append(warp_products(cells[None, :, 64 * full:], rest)[0])
    feq = torch.empty(9, h * width, dtype=phi.dtype)
    feq[:, order] = torch.cat(parts, dim=1)
    return feq.reshape(9, h, width)


def _bgk_products(s, obstacles, omega):
    """The stage body's update of a window's pulled interior planes
    (:func:`.fused_depth.fused_depth_emulated`'s ``bgk``): phi on the CUDA
    cores, feq from the warps' products (the window's outer ring, which no
    thread updates, NaN), the relaxation and bounce-back."""
    u_sq, phi = _features(s)
    h, w = u_sq.shape
    win = torch.full((6, h + 2, w + 2), float("nan"), dtype=phi.dtype)
    win[:, 1:-1, 1:-1] = phi
    feq = _window_products(win)[:, 1:-1, 1:-1]
    return list(_relax(s, feq, obstacles, omega).unbind(0)), torch.sqrt(u_sq)


def mxu_device_emulated(cells, obstacles, w1, w2, omega, gsteps: int):
    """The kernel's schedule in plain PyTorch: the rounds of
    :func:`.resident.device_rounds` on the depth kernel's tile, forcing as
    the device form forces, each stage's equilibria by
    :func:`warp_products`, each step's tots summed by tile in tile order.
    Returns ``(new_cells, tots)``."""
    return resident._rounds_emulated(cells, obstacles, w1, w2, omega,
                                     resident.device_rounds(gsteps), 0,
                                     bgk=_bgk_products)


class MxuStep(LatticeKernel):
    """The kernel bound to one mask: ``run(a, b, out, t, scale)`` runs
    ``gsteps`` steps from ``a`` (row ny-2 forced, row mode only) and
    returns ``(cells, spare)``: ``(a, b)`` for an even ``gsteps``, ``(b,
    a)`` for an odd one, as the resident kernel's wrapper. On a CUDA mask
    the launch geometry (``blocks``: as many as can be co-resident, at
    most one a tile; ``rounds``) is fixed at construction and the
    (gsteps, tiles) partials and the two tile tickets are allocated once."""

    def __init__(self, mask: torch.Tensor, w1, w2, omega, gsteps: int):
        if gsteps < 1:
            raise ValueError(f"gsteps must be positive, got {gsteps}")
        super().__init__(mask, w1, w2, omega)
        self.gsteps = self.steps_per_call = int(gsteps)
        if self.on_cpu:
            return
        lib, (ny, nx) = self._lib, mask.shape
        blocks = lib.lbm_mxu_blocks(ny, nx, self._index)
        if blocks < 0:
            _build.check(lib, -blocks, "mxu launch geometry")
        self.blocks = blocks
        self.rounds = resident.device_rounds(self.gsteps)
        self._partials = torch.empty(
            self.gsteps * lib.lbm_depth_num_partials(4, ny, nx),
            dtype=torch.float32, device=self.device)
        # The tile tickets of even and odd rounds, zero between launches.
        self._tickets = torch.zeros(2, dtype=torch.int32, device=self.device)
        self._a_frags = np.ascontiguousarray(a_fragments())

    def run(self, a, b, out, t: int = 0, scale=1.0):
        self._check_call(a, b, out, t)
        g = self.gsteps
        result = (a, b) if g % 2 == 0 else (b, a)
        if self.on_cpu:
            new, tots = mxu_multi_step(a, self.mask, self.w1, self.w2,
                                       self.omega, g)
            result[0].copy_(new)
            out[t:t + g] = tots * self._scale(scale)
            return result
        lib, ny, nx = self._lib, self.shape[1], self.shape[2]
        rounds = self.rounds
        self._launch(
            "mxu", f"mxu G={g} cooperative launch", lib.lbm_mxu_resident,
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), self._tickets.data_ptr(),
            out.data_ptr() + 4 * t, ny, nx, self.accel, self.w1, self.w2,
            self.omega, g, rounds.count(4), rounds.count(2), rounds.count(1),
            self._scale(scale), self._a_frags.ctypes.data, self.blocks,
            self._index, self._stream())
        return result


def mxu_resident(cells, obstacles, w1, w2, omega, gsteps: int):
    """``gsteps`` steps: ``(new_cells, tots)``, tots the (gsteps,) per-step
    tot_u. Launches the kernel on a CUDA tensor (on copies: the kernel
    overwrites both of its buffers); runs :func:`mxu_multi_step` on a CPU
    tensor."""
    kernel = MxuStep(obstacles, w1, w2, omega, gsteps)
    a, b = cells.clone(), torch.empty_like(cells)
    tots = torch.empty(gsteps, dtype=torch.float32, device=cells.device)
    new, _ = kernel.run(a, b, tots)
    return new, tots
