"""The ring kernel's planner and wrapper: G steps per launch on every
shard, the seam rows exchanged every step inside the kernel
(``csrc/ring.cu``, the port of
``lbm_tpu/parallel/resident_ring.py::_kernel_ring``, in row mode and in
the column mode of ``TransposedRingShardImpl``: the shards of a wide
grid's transposed lattice, the column ny-2 forced in every shard).

One cooperative launch per card hosts every shard on that card. The
shards' halo slots and flags are plain device memory, peer pointers for a
neighbour on another card, so P shards on one card run the protocol of P
cards. As in the JAX package the ring is an opt-in
(``LBM_SHARD_RESIDENT=1``), with G from the port's preferences
(:data:`.ops.plan.G_PREF`) or the ``LBM_RESIDENT_STEPS`` pin (even).

On CPU tensors the wrapper runs the plain version: G steps of the halo
exchange and :func:`.ops.reference.halo_multi_step`, the same update the
kernel makes. On CUDA tensors it launches or raises, also when the
device refuses the cooperative launch.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, plan
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LAUNCHES
from lbm_tpu_torch.state import D2Q9

_THREADS, _BX, _BY = 256, 32, 8  # csrc/ring.cu's block


def ring_prefs(local_rows: int, lanes: int) -> tuple[int, ...] | None:
    """G preferences when the ring applies to shards of ``local_rows``
    rows, else None: ``LBM_SHARD_RESIDENT=1`` and at least two rows a
    shard (a row 0 and a row h-1). The TPU's VMEM sizing rules do not
    apply: the shards stay in device memory."""
    if os.environ.get("LBM_SHARD_RESIDENT") != "1" or local_rows < 2:
        return None
    pin = plan._pinned_steps()
    return (pin,) if pin else plan.G_PREF


def ring_gsteps(local_rows: int, lanes: int, n_iters: int) -> int | None:
    """The first preferred G that divides ``n_iters``, or None."""
    prefs = ring_prefs(local_rows, lanes)
    if not prefs or not n_iters:
        return None
    return next((g for g in prefs if n_iters % g == 0), None)


class _RingShardC(ctypes.Structure):
    """csrc/ring.cu's RingShard."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "a", "b", "mask", "halo_s", "halo_n", "hmask_s", "hmask_n",
        "north_halo_s", "south_halo_n", "sync", "north_sync", "south_sync",
        "partials", "tots")] + [("row0", ctypes.c_longlong)]


class RingShardImpl:
    """The ring over every shard of a :class:`.halo.ShardSet`:
    ``run(t)`` advances each shard ``gsteps`` steps and writes each
    step's tot_u into ``shard.tots[t:t + gsteps]``. ``gsteps`` is even,
    so each shard's result is back in its ``cells`` buffer. The forcing
    axis is the shard set's (1: column mode)."""

    kernel = "ring"

    def __init__(self, ss, gsteps: int):
        if gsteps < 2 or gsteps % 2:
            raise ValueError(f"the ring takes an even G >= 2, got {gsteps}")
        if ss.h < 2:
            raise ValueError(f"the ring needs 2 rows a shard, got {ss.h}")
        self.ss, self.gsteps = ss, int(gsteps)
        self.steps_per_call = self.gsteps
        p = ss.params
        self.w1, self.w2, self.omega = (np.float32(p.accel_w1),
                                        np.float32(p.accel_w2),
                                        np.float32(p.omega))
        self.mode = ref_ops.association_mode(torch.float32)
        self.axis = ss.axis
        self.hmasks = [ss.halo_masks(r, 1) for r in range(len(ss.shards))]
        self._step = 0  # steps run so far: the flags' tags go on from it
        nx = ss.nx
        if ss.device_type == "cpu":
            self.halos = [(torch.empty(D2Q9.Q, 1, nx, dtype=sh.cells.dtype),
                           torch.empty(D2Q9.Q, 1, nx, dtype=sh.cells.dtype))
                          for sh in ss.shards]
            return
        self._lib = lib = _build.load()
        self._groups = {}
        for sh in ss.shards:
            self._groups.setdefault(sh.device, []).append(sh.index)
        index = {d: d.index if d.index is not None else torch.cuda.current_device()
                 for d in self._groups}
        self._index = index
        for d in index:
            for other in index:
                if other != d:
                    _build.check(lib, lib.lbm_enable_peer_access(
                        index[d], index[other]), "peer access")
        tiles = max((nx + _BX - 1) // _BX * ((ss.h - 2 + _BY - 1) // _BY),
                    2 * ((nx + _THREADS - 1) // _THREADS))
        self._bps = {}
        for d, idxs in self._groups.items():
            blocks = lib.lbm_ring_blocks(self.axis, index[d])
            if blocks < 0:
                _build.check(lib, -blocks, "ring launch geometry")
            if blocks < len(idxs):
                raise ValueError(f"{len(idxs)} shards on {d} exceed the "
                                 f"{blocks} co-resident blocks of the ring")
            bps = max(1, min(blocks // len(idxs), tiles))
            if self.axis:
                # Coprime with the tile columns, so the forced column's
                # tiles spread over every block (csrc/resident.cu).
                while bps > 1 and math.gcd(bps, (nx + _BX - 1) // _BX) != 1:
                    bps -= 1
            self._bps[d] = bps
        self._bufs = []
        for sh in ss.shards:
            dev = sh.device
            self._bufs.append({
                "halo_s": torch.zeros(2, D2Q9.Q, nx, device=dev),
                "halo_n": torch.zeros(2, D2Q9.Q, nx, device=dev),
                "hmask": [m.to(torch.uint8).contiguous()
                          for m in self.hmasks[sh.index]],
                "mask": sh.mask.to(torch.uint8).contiguous(),
                "sync": torch.zeros(7, dtype=torch.int32, device=dev),
                "partials": torch.empty(self.gsteps * self._bps[dev],
                                        device=dev),
            })
        self._structs = {}

    def _struct(self, dev, idxs):
        """The device array of RingShard for the shards on ``dev``, built
        for their current buffers (and kept while those stay)."""
        shards, bufs, n = self.ss.shards, self._bufs, len(self.ss.shards)
        key = (dev, tuple((shards[i].cells.data_ptr(),
                           shards[i].spare.data_ptr()) for i in idxs))
        if key not in self._structs:
            arr = (_RingShardC * len(idxs))()
            for slot, i in enumerate(idxs):
                sh, b = shards[i], bufs[i]
                north, south = bufs[(i + 1) % n], bufs[(i - 1) % n]
                arr[slot] = _RingShardC(
                    sh.cells.data_ptr(), sh.spare.data_ptr(),
                    b["mask"].data_ptr(), b["halo_s"].data_ptr(),
                    b["halo_n"].data_ptr(), b["hmask"][0].data_ptr(),
                    b["hmask"][1].data_ptr(), north["halo_s"].data_ptr(),
                    south["halo_n"].data_ptr(), b["sync"].data_ptr(),
                    north["sync"].data_ptr(), south["sync"].data_ptr(),
                    b["partials"].data_ptr(), sh.tots.data_ptr(), sh.row0)
            raw = torch.frombuffer(bytearray(bytes(arr)), dtype=torch.uint8)
            self._structs[key] = raw.to(dev)
        return self._structs[key]

    def run(self, t: int) -> None:
        ss, g = self.ss, self.gsteps
        if ss.device_type == "cpu":
            self._run_plain(t)
            return
        lib = self._lib
        for dev, idxs in self._groups.items():
            lead = ss.shards[idxs[0]]
            with ss.on(lead):
                for i in idxs[1:]:
                    lead.stream.wait_event(ss.record(ss.shards[i]))
                struct = self._struct(dev, idxs)
                _build.check(lib, lib.lbm_ring(
                    struct.data_ptr(), len(idxs), self._bps[dev], ss.h,
                    ss.nx, ss.ny, self.w1, self.w2, self.omega, self.mode,
                    self.axis, g, self._step, t, self._index[dev],
                    lead.stream.cuda_stream,
                ), f"ring G={g} cooperative launch")
                LAUNCHES["ring_cols" if self.axis else "ring"] += 1
                done = ss.record(lead)
            for i in idxs[1:]:
                ss.shards[i].stream.wait_event(done)
        self._step += g

    def _run_plain(self, t: int) -> None:
        ss = self.ss
        for s in range(self.gsteps):
            ss.exchange(self.halos, 1)
            for sh, (hs, hn), (ms, mn) in zip(ss.shards, self.halos,
                                              self.hmasks):
                new, tots = ref_ops.halo_multi_step(
                    sh.cells, hs, hn, sh.mask, ms, mn, sh.row0, ss.ny,
                    self.w1, self.w2, self.omega, 1, self.axis)
                sh.spare.copy_(new)
                sh.cells, sh.spare = sh.spare, sh.cells
                sh.tots[t + s] = tots[0]
        self._step += self.gsteps
