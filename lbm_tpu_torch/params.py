"""Scene parameter loading: the ``.params`` file contract.

The reference's 7-field parameter file (``d2q9-bgk.c:522-528``), one
value per line:

    nx ny maxIters reynolds_dim density accel omega

The port's own copy of :mod:`lbm_tpu.params` (numpy only), so the two
packages parse ``.params`` files identically without the port importing
the JAX package; ``tests/test_torch_scene_layer.py`` holds them equal.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class Params:
    """Simulation parameters (the reference's ``t_param``,
    d2q9-bgk.c:66-87). Decomposition facts live in
    :mod:`lbm_tpu_torch.parallel.decomp`."""

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: np.float32
    accel: np.float32
    omega: np.float32
    # Working precision: float32 matches the reference artifact; float64
    # matches the golden data's original double-precision code.
    dtype: type = np.float32

    def __post_init__(self) -> None:
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"grid dims must be positive, got {self.nx}x{self.ny}")
        if self.max_iters <= 0:
            raise ValueError(f"maxIters must be positive, got {self.max_iters}")
        d = np.dtype(self.dtype).type
        object.__setattr__(self, "dtype", d)
        # Normalise float fields to the working precision.
        object.__setattr__(self, "density", d(self.density))
        object.__setattr__(self, "accel", d(self.accel))
        object.__setattr__(self, "omega", d(self.omega))

    @property
    def viscosity(self):
        """Kinematic viscosity: (1/6)(2/omega - 1) (d2q9-bgk.c:676)."""
        d = self.dtype
        return d(1.0) / d(6.0) * (d(2.0) / self.omega - d(1.0))

    @property
    def accel_w1(self):
        """Axis-speed forcing weight density*accel/9 (d2q9-bgk.c:237)."""
        return self.dtype(self.density * self.accel / self.dtype(9.0))

    @property
    def accel_w2(self):
        """Diagonal-speed forcing weight density*accel/36 (d2q9-bgk.c:238)."""
        return self.dtype(self.density * self.accel / self.dtype(36.0))


def ensure_dtype_computable(params: Params) -> None:
    """Refuse a working precision the port cannot compute in. PyTorch
    computes float32 and float64 on every device, so, unlike the JAX
    package (which needs x64 enabled first), only other types fail."""
    if params.dtype not in (np.float32, np.float64):
        raise ValueError(
            f"params.dtype is {np.dtype(params.dtype).name}; the port "
            "computes in float32 or float64"
        )


def load_params(path: str | Path, dtype: type = np.float32) -> Params:
    """Parse a 7-line ``.params`` scene file (d2q9-bgk.c:522-528)."""
    path = Path(path)
    fields = ("nx", "ny", "maxIters", "reynolds_dim", "density", "accel", "omega")
    try:
        lines = path.read_text().split()
    except OSError as exc:
        raise FileNotFoundError(f"could not open input parameter file: {path}") from exc
    if len(lines) < len(fields):
        missing = fields[len(lines)]
        raise ValueError(f"could not read param file: {missing}")
    vals = lines[: len(fields)]
    try:
        return Params(
            nx=int(vals[0]),
            ny=int(vals[1]),
            max_iters=int(vals[2]),
            reynolds_dim=int(vals[3]),
            density=np.dtype(dtype).type(vals[4]),
            accel=np.dtype(dtype).type(vals[5]),
            omega=np.dtype(dtype).type(vals[6]),
            dtype=dtype,
        )
    except ValueError as exc:
        raise ValueError(f"could not parse param file {path}: {exc}") from exc
