"""The device mesh and the row decomposition, the twin of
:mod:`lbm_tpu.parallel.decomp`.

The reference balances ``ny`` rows over ranks with the first ``ny % size``
ranks taking one extra row (allocate_rows, d2q9-bgk.c:483-503). Here, as
in the JAX package, shards are equal: ``ny % n_shards == 0``, reached by
padding where needed (:func:`.halo.plan_padding_mode`).

A :class:`Mesh` is a tuple of torch devices. It may repeat a device: P
shards on one card, each with its own buffers and stream, exchanging
seams as they would across cards. That is the counterpart of the JAX
package's virtual CPU devices (``provision_virtual_cpu``), and the tests
build ``[torch.device("cpu")] * n`` meshes with it.
"""

from __future__ import annotations

import dataclasses

import torch

AXIS = "y"  # the single mesh axis name, rows of the lattice


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices of the shards, in shard order."""

    devices: tuple
    axis: str = AXIS

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mesh devices mix types: {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def visible_devices(device_type: str = "cuda") -> list:
    """The devices a mesh may take without an explicit list: every
    visible CUDA device, or the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: the
    visible CUDA devices). ``devices=[torch.device("cuda:0")] * 4`` gives
    four shards on one card."""
    if devices is None:
        devices = visible_devices("cuda")
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    return Mesh(tuple(devices[:n_devices]))


def largest_divisor_leq(ny: int, n: int) -> int:
    """Largest d <= n with ny % d == 0 (the device-count fallback)."""
    for d in range(min(n, ny), 0, -1):
        if ny % d == 0:
            return d
    return 1


@dataclasses.dataclass(frozen=True)
class RowDecomposition:
    """Static decomposition facts for an ny-row lattice over n shards
    (the reference's index_start/index_stop/num_rows,
    d2q9-bgk.c:493-500)."""

    ny: int
    n_shards: int

    def __post_init__(self):
        if self.ny % self.n_shards != 0:
            raise ValueError(
                f"ny={self.ny} not divisible by {self.n_shards} shards; "
                f"use largest_divisor_leq(ny, n) to pick a usable count"
            )

    @property
    def local_ny(self) -> int:
        return self.ny // self.n_shards

    def row0(self, shard: int) -> int:
        """Global index of the shard's first row."""
        return shard * self.local_ny

    @property
    def accel_row(self) -> int:
        """Global index of the forced row (ny-2, d2q9-bgk.c:240)."""
        return self.ny - 2

    def local_accel_row(self, shard: int) -> int:
        """Shard-local index of the forced row; outside [0, local_ny) on
        the shards that do not own it (d2q9-bgk.c:498)."""
        return self.accel_row - self.row0(shard)
