"""The fused-step kernel's wrapper: one timestep of the lattice in one
CUDA launch (``csrc/fused_step.cu``, the port of
``lbm_tpu/ops/pallas_fused.py::_kernel``), plus a one-block launch that
sums the per-block tot_u partials on the device.

A tensor on the CPU runs the plain version, :mod:`.reference`; that is
the only case the plain version stands in for the kernel. A CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.state import D2Q9

# Launch counts, one per kernel; incremented only where a kernel launches.
LAUNCHES = {"step": 0, "reduce": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class FusedStep:
    """The step kernel bound to one obstacle mask and scene constants.

    ``step(src, dst, out, t, scale)`` writes one timestep of ``src``
    into ``dst`` and ``scale * tot_u`` into ``out[t]``: the runner's
    ping-pong buffers and its on-device av_vels. The association mode
    (``LBM_PAIRED_EQ`` / ``LBM_OMEGA_EQ``) is read at construction, as
    the JAX package reads it when it traces a run. On a CUDA mask this
    builds the kernel library on first use and allocates the tot_u
    partials once; the kernel itself allocates nothing.
    """

    def __init__(self, mask: torch.Tensor, w1, w2, omega):
        if mask.dtype != torch.bool or mask.dim() != 2:
            raise ValueError(
                f"mask must be a 2-D bool tensor, got {mask.dtype} "
                f"{tuple(mask.shape)}"
            )
        self.mask = mask
        self.shape = (D2Q9.Q, *mask.shape)
        self.w1, self.w2, self.omega = (
            np.float32(w1), np.float32(w2), np.float32(omega)
        )
        self.mode = ref_ops.association_mode(torch.float32)
        self.device = mask.device
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"no fused-step kernel for device {self.device}")
        ny, nx = mask.shape
        self._lib = _build.load()
        if ny > self._lib.lbm_max_rows():
            raise ValueError(
                f"{ny} rows exceed the kernel's limit of "
                f"{self._lib.lbm_max_rows()}"
            )
        self._mask_u8 = mask.to(torch.uint8).contiguous()
        self._partials = torch.empty(
            self._lib.lbm_num_partials(ny, nx), dtype=torch.float32,
            device=self.device,
        )
        self._index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()

    def _check(self, t: torch.Tensor, name: str, shape) -> None:
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}, mask on {self.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def step(self, src, dst, out, t: int = 0, scale=1.0) -> None:
        self._check(src, "src", self.shape)
        self._check(dst, "dst", self.shape)
        self._check(out, "out", out.shape)
        if out.dim() != 1 or not 0 <= t < out.shape[0]:
            raise ValueError(f"out[{t}] is not an element of a 1-D tensor "
                             f"of {out.shape[0] if out.dim() else 0}")
        if src.data_ptr() == dst.data_ptr():
            raise ValueError("src and dst must be distinct buffers")
        if self.device.type == "cpu":
            new, tot = ref_ops.fused_step(
                src, self.mask, self.w1, self.w2, self.omega
            )
            dst.copy_(new)
            out[t] = tot * float(np.float32(scale))
            return
        lib, ny, nx = self._lib, self.shape[1], self.shape[2]
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _build.check(lib, lib.lbm_fused_step(
            src.data_ptr(), dst.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), ny, nx, (ny - 2) % ny,
            self.w1, self.w2, self.omega, self.mode, self._index, stream,
        ), "fused step launch")
        LAUNCHES["step"] += 1
        _build.check(lib, lib.lbm_reduce_tot(
            self._partials.data_ptr(), self._partials.numel(),
            np.float32(scale), out.data_ptr() + 4 * t, self._index, stream,
        ), "tot_u reduce launch")
        LAUNCHES["reduce"] += 1


def fused_step(cells, obstacles, w1, w2, omega):
    """One timestep: ``(new_cells, tot_u)`` for a float32 (9, ny, nx)
    lattice and its (ny, nx) bool mask. Launches the kernel on a CUDA
    tensor; runs :func:`fused_step_plain` on a CPU tensor."""
    stepper = FusedStep(obstacles, w1, w2, omega)
    new = torch.empty_like(cells)
    tot = torch.empty(1, dtype=torch.float32, device=cells.device)
    stepper.step(cells, new, tot)
    return new, tot[0]


def fused_step_plain(cells, obstacles, w1, w2, omega):
    """The kernel's plain version: :func:`.reference.fused_step` with
    the wrapper's signature."""
    return ref_ops.fused_step(cells, obstacles, w1, w2, omega)
