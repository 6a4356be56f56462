"""The ring kernel's planner and wrappers: G steps per launch on every
shard, the shards' seam rows exchanged inside the kernel, the port of
``lbm_tpu/parallel/resident_ring.py::_kernel_ring`` in row mode and in the
column mode of ``TransposedRingShardImpl`` (the shards of a wide grid's
transposed lattice, the column ny-2 forced in every shard). Two forms of
the one TPU kernel, chosen by the shard's size (:func:`ring_form`):

- on chip (``csrc/ring_onchip.cu``, :class:`RingOnchipImpl`), the TPU
  design: each shard's rows split into strips, one block an SM holding
  its strip in shared memory for all G steps, in two buffers
  (``"onchip"``) or in one updated in place (``"inplace"``, the JAX
  kernel's in-place mode, ``LBM_RESIDENT_INPLACE``); seam rows go through
  the ring's slots as the strips' rows do (the single-device on-chip
  form's strip step, ``csrc/lbm_onchip.cuh``);
- in device memory (``csrc/ring.cu``, :class:`RingShardImpl`,
  ``"device"``): rounds of D steps between exchanges of D-row halos, its
  blocks running the depth kernel's tiles (``csrc/lbm_depth.cuh``), for
  shards whose strips do not fit.

One cooperative launch per card hosts every shard on that card; the
shards' halo slots (on chip: halo values that carry their step's tag; in
device memory: slots and flags) are plain device memory, peer pointers
for a neighbour on another card, so P shards on one card run the protocol of
P cards. As in the JAX package the ring is an opt-in
(``LBM_SHARD_RESIDENT=1``), with G from the port's preferences
(:data:`.ops.plan.G_PREF`) or the ``LBM_RESIDENT_STEPS`` pin (even, in
both forms and modes), and the device form's D the first of
:data:`.ops.plan.AUTO_DEPTHS` that divides G and fits the shard's rows
(:func:`ring_depth`).

On CPU tensors either wrapper runs the plain version: G steps of the halo
exchange and :func:`.ops.reference.halo_multi_step`, the same update the
kernels make. On CUDA tensors it launches or raises, also when the device
refuses the cooperative launch or the strips' shared memory: a form never
gives way to another. :func:`ring_emulated` (the device form's rounds)
and :func:`ring_onchip_emulated` (the on-chip form's strips, in both
modes) are the kernels' schedules in plain PyTorch, for the tests.
"""

from __future__ import annotations

import collections
import ctypes
import math
import os

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, fused_depth, plan, resident
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LAUNCHES
from lbm_tpu_torch.state import D2Q9

def ring_prefs(local_rows: int, lanes: int) -> tuple[int, ...] | None:
    """G preferences when the ring applies to shards of ``local_rows``
    rows, else None: ``LBM_SHARD_RESIDENT=1`` and at least two rows a
    shard (a row 0 and a row h-1). The TPU's VMEM sizing rules do not
    apply: the shards stay in device memory."""
    if os.environ.get("LBM_SHARD_RESIDENT") != "1" or local_rows < 2:
        return None
    pin = plan._pinned_steps(even=True)
    return (pin,) if pin else plan.G_PREF


def ring_blocks(local_rows: int, shards_on_card: int, sms: int) -> int:
    """Strips a shard of the on-chip ring: the card's SMs split evenly
    among the shards it hosts, at most one a row
    (:func:`.ops.plan.onchip_blocks`)."""
    return plan.onchip_blocks(local_rows, 0, max(1, sms // shards_on_card))


def ring_form(local_rows: int, lanes: int, shards_on_card: int, sms: int,
              smem_per_block: int) -> str:
    """The ring's form for shards of ``local_rows`` x ``lanes`` cells,
    ``shards_on_card`` of them on each card of ``sms`` SMs and
    ``smem_per_block`` bytes of shared memory a block: "onchip" (the
    on-chip ring in two buffers), "inplace" (in one) or "device" (the
    device-memory ring).

    The single-device planner's rule and pins (:func:`.ops.plan.
    planned_form`) over the card's share of SMs a shard, so that its
    strips are :func:`ring_blocks`'; a pinned mode whose strips do not fit
    raises here, before anything runs.

    The on-chip forms are planned wherever their strips fit because they
    were faster than the device ring by more than 2 % at every shape
    measured (over 4 shards on an NVIDIA H100 80GB HBM3 at 700 W,
    ``chip_smoke.py``'s shard_timing, PERF.md): 0.54-0.69x it in two
    buffers at 256x256, 512x512, 640x512 and the x-plan of 1024x384,
    0.71-0.78x in one buffer at 768x768 and the x-plan of 1024x512."""
    share = max(1, sms // shards_on_card)
    form = plan.planned_form(local_rows, lanes, (share, smem_per_block))
    buffers = {"onchip": 2, "inplace": 1}.get(form)
    if buffers and not plan.onchip_fits(local_rows, lanes, share,
                                        smem_per_block, buffers):
        blocks = ring_blocks(local_rows, shards_on_card, sms)
        need = plan.onchip_smem_bytes(local_rows, lanes, blocks, buffers)
        mode = "single-buffer" if buffers == 1 else "two-buffer"
        raise ValueError(
            f"the on-chip ring's {mode} mode (pinned) needs {need} B of "
            f"shared memory a block for shards of {local_rows}x{lanes} over "
            f"{blocks} strips; the card gives {smem_per_block}")
    return form


def planned_ring_form(local_rows: int, lanes: int, mesh) -> str | None:
    """:func:`ring_form` for the shards of ``mesh`` with its cards'
    limits (the card that hosts the most shards), or None off the card."""
    if mesh.device_type != "cuda":
        return None
    device, hosted = collections.Counter(mesh.devices).most_common(1)[0]
    sms, smem = resident.device_limits(device)
    return ring_form(local_rows, lanes, hosted, sms, smem)


def ring_gsteps(local_rows: int, lanes: int, n_iters: int) -> int | None:
    """The first preferred G that divides ``n_iters``, or None."""
    prefs = ring_prefs(local_rows, lanes)
    if not prefs or not n_iters:
        return None
    return next((g for g in prefs if n_iters % g == 0), None)


def ring_depth(gsteps: int, local_rows: int) -> int:
    """The ring's D for calls of ``gsteps`` steps on shards of
    ``local_rows`` rows: the first of :data:`.ops.plan.AUTO_DEPTHS` that
    divides ``gsteps`` and is at most ``local_rows`` (an even G on shards
    of two rows or more always finds D = 2)."""
    d = next((d for d in plan.AUTO_DEPTHS
              if gsteps % d == 0 and d <= local_rows), None)
    if d is None:
        raise ValueError(f"no depth of {plan.AUTO_DEPTHS} divides G={gsteps} "
                         f"and fits {local_rows} rows a shard")
    return d


def inner_tiles(h: int, nx: int, depth: int) -> tuple[int, int]:
    """``(first, end)``: the tiles of an ``h``-row shard whose depth-D
    windows lie inside it, tile rows 1 .. (h - D) // TY - 1 (the kernel's
    n_inner, tiles numbered row by row as the depth kernel numbers
    them). The first tile row and the rows past these are the edge
    tiles."""
    ty, tx = fused_depth.TILES[depth]
    tiles_x = -(-nx // tx)
    return tiles_x, tiles_x * (1 + max(0, (h - depth) // ty - 1))


class _RingShardC(ctypes.Structure):
    """csrc/ring.cu's RingShard."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "a", "b", "mask", "halo_s", "halo_n", "hmask_s", "hmask_n",
        "north_halo_s", "south_halo_n", "sync", "north_sync", "south_sync",
        "partials", "tots")] + [("row0", ctypes.c_longlong)]


class _Ring:
    """What both forms share: the even G, the forcing constants, the
    steps run so far (the step tags go on from them), the plain version
    on CPU tensors and, on the card, the shards grouped by card with peer
    access between the cards."""

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
        self._step = 0  # steps run so far: the tags go on from it
        if ss.device_type == "cpu":
            from lbm_tpu_torch.parallel.halo import halo_sources

            n = len(ss.shards)
            self.hmasks = [ss.halo_masks(r, 1) for r in range(n)]
            self.sources = halo_sources(ss, 1)
            self.halos = ss.halo_buffers(self.sources, 1)
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
        n = len(ss.shards)
        self._cross = any(ss.shards[(i + s) % n].device != sh.device
                          for i, sh in enumerate(ss.shards) for s in (-1, 1))

    def _on_card(self, dev):
        """Work on the stream that ``dev``'s launches run on. Scratch
        allocated there goes back to the allocator, when its wrapper is
        freed, only behind those launches: a launch still spinning on its
        flags or halo words keeps them whether or not its wrapper
        lives."""
        return self.ss.on(self.ss.shards[self._groups[dev][0]])

    def _launch_all(self, launch) -> None:
        """``launch(dev, idxs, stream)`` for each card's shards, on the
        stream of its first shard, after every shard of that card's last
        work and before its next."""
        ss = self.ss
        for dev, idxs in self._groups.items():
            lead = ss.shards[idxs[0]]
            with ss.on(lead):
                for i in idxs[1:]:
                    lead.stream.wait_event(ss.record(ss.shards[i]))
                launch(dev, idxs, lead.stream.cuda_stream)
                done = ss.record(lead)
            for i in idxs[1:]:
                ss.shards[i].stream.wait_event(done)

    def _run_plain(self, t: int) -> None:
        ss = self.ss
        for s in range(self.gsteps):
            views = ss.halo_views(self.sources, self.halos, 1)
            ss.exchange(self.sources, self.halos, 1)
            for sh, (hs, hn), (ms, mn) in zip(ss.shards, views, self.hmasks):
                new, tots = ref_ops.halo_multi_step(
                    sh.cells, hs, hn, sh.mask, ms, mn, sh.row0, ss.ny,
                    self.w1, self.w2, self.omega, 1, self.axis)
                sh.spare.copy_(new)
                sh.cells, sh.spare = sh.spare, sh.cells
                sh.tots[t + s] = tots[0]
        self._step += self.gsteps


class RingShardImpl(_Ring):
    """The device-memory ring over every shard of a :class:`.halo.ShardSet`
    (``csrc/ring.cu``): ``run(t)`` advances each shard ``gsteps`` steps
    and writes each step's tot_u into ``shard.tots[t:t + gsteps]``; each
    shard's result is in its ``cells`` buffer. The forcing axis is the
    shard set's (1: column mode), its D :func:`ring_depth`'s. ``blocks``:
    blocks a shard (default: as many as can be co-resident, split among a
    card's shards); a launch of more than fit raises."""

    form = "device"

    def __init__(self, ss, gsteps: int, blocks: int | None = None):
        super().__init__(ss, gsteps)
        depth = ring_depth(gsteps, ss.h)
        self.depth = depth
        if ss.device_type == "cpu":
            return
        lib, nx = self._lib, ss.nx
        tiles = lib.lbm_depth_num_partials(depth, ss.h, nx)
        self._bps = {}
        for d, idxs in self._groups.items():
            if blocks is not None:
                self._bps[d] = int(blocks)
                continue
            fit = lib.lbm_ring_blocks(depth, self.axis, self._index[d])
            if fit < 0:
                _build.check(lib, -fit, "ring launch geometry")
            if fit < len(idxs):
                raise ValueError(f"{len(idxs)} shards on {d} exceed the "
                                 f"{fit} co-resident blocks of the ring")
            bps = max(1, min(fit // len(idxs), tiles))
            if self.axis:
                # Coprime with the tile columns, so the forced column's
                # tiles spread over every block (csrc/resident.cu).
                tiles_x = -(-nx // fused_depth.TILES[depth][1])
                while bps > 1 and math.gcd(bps, tiles_x) != 1:
                    bps -= 1
            self._bps[d] = bps
        self._bufs = []
        slots = (2, D2Q9.Q, depth, nx)
        for sh in ss.shards:
            dev = sh.device
            with self._on_card(dev):
                self._bufs.append({
                    "halo_s": torch.zeros(slots, device=dev),
                    "halo_n": torch.zeros(slots, device=dev),
                    "hmask": [m.to(torch.uint8).contiguous()
                              for m in ss.halo_masks(sh.index, depth)],
                    "mask": sh.mask.to(torch.uint8).contiguous(),
                    "sync": torch.zeros(7, dtype=torch.int32, device=dev),
                    "partials": torch.empty(self.gsteps * tiles, device=dev),
                })
        self._structs = {}

    def _struct(self, dev, idxs):
        """``(array, vec)``: the device array of RingShard for the shards
        on ``dev``, built for their current buffers (and kept while those
        stay), and whether every buffer takes 16-byte vectors."""
        shards, bufs, n = self.ss.shards, self._bufs, len(self.ss.shards)
        key = (dev, tuple((shards[i].cells.data_ptr(),
                           shards[i].spare.data_ptr()) for i in idxs))
        if key not in self._structs:
            arr = (_RingShardC * len(idxs))()
            ptrs = []
            for slot, i in enumerate(idxs):
                sh, b = shards[i], bufs[i]
                north, south = bufs[(i + 1) % n], bufs[(i - 1) % n]
                ptrs += [sh.cells.data_ptr(), sh.spare.data_ptr(),
                         b["halo_s"].data_ptr(), b["halo_n"].data_ptr(),
                         b["mask"].data_ptr(), b["hmask"][0].data_ptr(),
                         b["hmask"][1].data_ptr()]
                arr[slot] = _RingShardC(
                    sh.cells.data_ptr(), sh.spare.data_ptr(),
                    b["mask"].data_ptr(), b["halo_s"].data_ptr(),
                    b["halo_n"].data_ptr(), b["hmask"][0].data_ptr(),
                    b["hmask"][1].data_ptr(), north["halo_s"].data_ptr(),
                    south["halo_n"].data_ptr(), b["sync"].data_ptr(),
                    north["sync"].data_ptr(), south["sync"].data_ptr(),
                    b["partials"].data_ptr(), sh.tots.data_ptr(), sh.row0)
            vec = self.ss.nx % 4 == 0 and all(p % 16 == 0 for p in ptrs)
            raw = torch.frombuffer(bytearray(bytes(arr)), dtype=torch.uint8)
            self._structs[key] = (raw.to(dev), vec)
        return self._structs[key]

    def run(self, t: int) -> None:
        ss, g, d = self.ss, self.gsteps, self.depth
        if ss.device_type == "cpu":
            self._run_plain(t)
            return
        lib = self._lib

        def launch(dev, idxs, stream):
            struct, vec = self._struct(dev, idxs)
            _build.check(lib, lib.lbm_ring(
                struct.data_ptr(), len(idxs), self._bps[dev], ss.h, ss.nx,
                ss.ny, self.w1, self.w2, self.omega, self.mode, self.axis,
                d, g, self._step // d, t, int(vec), int(self._cross),
                self._index[dev], stream,
            ), f"ring G={g} D={d} cooperative launch")
            LAUNCHES["ring_cols" if self.axis else "ring"] += 1

        self._launch_all(launch)
        if (g // d) % 2:
            # An odd number of rounds ends in each shard's other buffer.
            for sh in ss.shards:
                sh.cells, sh.spare = sh.spare, sh.cells
        self._step += g


class _RingStripShardC(ctypes.Structure):
    """csrc/ring_onchip.cu's RingStripShard."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cells", "mask", "halo", "partials", "ticket", "tots",
        "north_slots", "south_slots")] + [
        ("row0", ctypes.c_longlong)]


class RingOnchipImpl(_Ring):
    """The on-chip ring over every shard of a :class:`.halo.ShardSet`
    (``csrc/ring_onchip.cu``): ``run(t)`` advances each shard ``gsteps``
    steps, its strips in shared memory for the whole call, in place in
    its ``cells`` buffer, and writes each step's tot_u into
    ``shard.tots[t:t + gsteps]``. ``form``: "onchip" (two buffers) or
    "inplace" (one). On a card the geometry (:func:`ring_blocks` strips a
    shard) is fixed and the scratch (each strip's slots, each
    shard's partials and ticket) allocated at construction; a mode whose
    strips do not fit the card's shared memory, or more blocks than can be
    co-resident, raises there."""

    def __init__(self, ss, gsteps: int, form: str):
        if form not in ("onchip", "inplace"):
            raise ValueError(f"the on-chip ring's forms are 'onchip' and "
                             f"'inplace', got {form!r}")
        super().__init__(ss, gsteps)
        self.form = form
        self.buffers = 1 if form == "inplace" else 2
        if ss.device_type == "cpu":
            return
        lib, h, nx = self._lib, ss.h, ss.nx
        mode = "single-buffer" if self.buffers == 1 else "two-buffer"
        bps = {}
        for d, idxs in self._groups.items():
            sms, smem = resident.device_limits(d)
            b = ring_blocks(h, len(idxs), sms)
            need = plan.onchip_smem_bytes(h, nx, b, self.buffers)
            if lib.lbm_onchip_smem_bytes(h, nx, b, self.buffers) != need:
                raise RuntimeError("ops/plan.py and csrc/lbm_onchip.cuh "
                                   "size a strip differently")
            if need > smem:
                raise ValueError(
                    f"the on-chip ring's {mode} mode needs {need} B of "
                    f"shared memory a block for shards of {h}x{nx} over {b} "
                    f"strips; the card gives {smem}")
            _build.check(lib, lib.lbm_ring_onchip_prepare(
                self.axis, self.mode, self.buffers, int(self._cross), need,
                len(idxs) * b, self._index[d],
            ), f"on-chip ring ({mode}) cooperative launch of "
               f"{len(idxs) * b} blocks")
            bps[d] = b
        self._bps = bps
        bufs = {}
        for dev, idxs in self._groups.items():
            with self._on_card(dev):
                for i in idxs:
                    b = bps[dev]
                    bufs[i] = {
                        "bps": b,
                        # (bps, 2, 2, 3, nx) halo words: a value's bits
                        # and its step's tag.
                        "halo": torch.zeros(b * 2 * 2 * 3 * nx,
                                            dtype=torch.int64, device=dev),
                        # The ticket as an int32 word the kernel reads as
                        # unsigned.
                        "ticket": torch.zeros(1, dtype=torch.int32,
                                              device=dev),
                        "partials": torch.empty(self.gsteps * b, device=dev),
                        "mask": ss.shards[i].mask.to(torch.uint8).contiguous(),
                    }
        self._bufs = [bufs[i] for i in range(len(ss.shards))]
        self._structs = {}

    def _struct(self, dev, idxs):
        """The device array of RingStripShard for the shards on ``dev``,
        built for their current ``cells`` (and kept while those stay)."""
        shards, bufs, n = self.ss.shards, self._bufs, len(self.ss.shards)
        key = (dev, tuple(shards[i].cells.data_ptr() for i in idxs))
        if key not in self._structs:
            pair = 2 * 3 * self.ss.nx * 8  # bytes of a strip's (dir) slots
            arr = (_RingStripShardC * len(idxs))()
            for slot, i in enumerate(idxs):
                sh, b = shards[i], bufs[i]
                north, south = bufs[(i + 1) % n], bufs[(i - 1) % n]
                last = south["bps"] - 1
                arr[slot] = _RingStripShardC(
                    sh.cells.data_ptr(), b["mask"].data_ptr(),
                    b["halo"].data_ptr(), b["partials"].data_ptr(),
                    b["ticket"].data_ptr(), sh.tots.data_ptr(),
                    north["halo"].data_ptr(),
                    south["halo"].data_ptr() + (last * 2 + 1) * pair,
                    sh.row0)
            raw = torch.frombuffer(bytearray(bytes(arr)), dtype=torch.uint8)
            self._structs[key] = raw.to(dev)
        return self._structs[key]

    def run(self, t: int) -> None:
        ss, g = self.ss, self.gsteps
        if ss.device_type == "cpu":
            self._run_plain(t)
            return
        lib = self._lib
        key = "ring_onchip_inplace" if self.buffers == 1 else "ring_onchip"

        def launch(dev, idxs, stream):
            _build.check(lib, lib.lbm_ring_onchip(
                self._struct(dev, idxs).data_ptr(), len(idxs),
                self._bps[dev], ss.h, ss.nx, ss.ny, self.w1, self.w2,
                self.omega, self.mode, self.axis, self.buffers, g,
                self._step, t, int(self._cross), self._index[dev], stream,
            ), f"on-chip ring G={g} cooperative launch")
            LAUNCHES[key + ("_cols" if self.axis else "")] += 1

        self._launch_all(launch)
        self._step += g


def make_ring(ss, gsteps: int, form: str | None = None):
    """The ring of ``form`` (:func:`ring_form`; None or "device": the
    device-memory ring) over the shard set ``ss``."""
    if form in ("onchip", "inplace"):
        return RingOnchipImpl(ss, gsteps, form)
    return RingShardImpl(ss, gsteps)


# --------------------------------------------------------------------------
# The kernel's round schedule in plain PyTorch.
# --------------------------------------------------------------------------


def _receive_slot(rnd: int) -> int:
    """The slot a shard's edge tiles read in round ``rnd``: the one its
    neighbours filled in that round."""
    return rnd % 2


def _window_forced(ys, cols, row0: int, ny: int, nx: int, h: int,
                   axis: int):
    """The window cells on the forced line, window rows ``ys`` (shard
    rows, negative or past ``h - 1`` in the halos) and columns ``cols``:
    row mode, the rows whose global index ``(row0 + y) mod ny`` is ny - 2,
    halo rows included; column mode, column nx - 2 of every row."""
    if axis:
        line = (cols == (nx - 2) % nx)[None, :]
    else:
        line = ((row0 + ys) % ny == (ny - 2) % ny)[:, None]
    return line.expand(len(ys), len(cols))


def ring_emulated(ss, gsteps: int, depth: int, t: int = 0) -> None:
    """``gsteps`` steps of every shard of the CPU shard set ``ss`` by the
    kernel's schedule, in rounds of ``depth`` steps, the results into each
    shard's ``cells`` and the per-step tot_u into ``shard.tots[t:...]``.

    Round k: every shard's pre-round top ``depth`` rows (nine speeds,
    raw) go to its north neighbour's south slot k mod 2 and its bottom
    rows to its south neighbour's north slot. Before they land, each
    shard runs its interior tiles (:func:`inner_tiles`) with that slot
    NaN, so a window that reached the halo would show; then the rows
    land and it runs its edge tiles. A tile is the depth kernel's
    (:func:`.ops.fused_depth.fused_depth_emulated`): its window of the
    shard's rows and the slots (rows past the north slot repeat its last
    row), ``depth`` stages with NaN outside each stage's valid region,
    the forced line forced at every stage by the receiver
    (:func:`_window_forced`, halo rows included). tot_u: each (step,
    tile) partial as a fixed-shape sum, the tiles in tile order. Cells are
    bit-identical to the plain shard steps; tots differ from theirs by
    summation order."""
    p, n, h, nx, ny = ss.params, len(ss.shards), ss.h, ss.nx, ss.ny
    if gsteps % depth or depth not in fused_depth.TILES or depth > h:
        raise ValueError(f"depth {depth} does not divide G={gsteps} or fit "
                         f"{h} rows a shard")
    dt = ss.shards[0].cells.dtype
    np_type = ref_ops._np_type(dt)
    deltas, guards = ref_ops.forcing(np_type(p.accel_w1),
                                     np_type(p.accel_w2), ss.axis)
    ty, tx = fused_depth.TILES[depth]
    hx = fused_depth.HALO_X[depth]
    tiles_x, n_tiles = -(-nx // tx), -(-nx // tx) * -(-h // ty)
    first, end = inner_tiles(h, nx, depth)
    hmasks = [ss.halo_masks(r, depth) for r in range(n)]
    nan = torch.full((D2Q9.Q, depth, nx), float("nan"), dtype=dt)
    # slots[r][0 south / 1 north][slot]
    slots = [[[nan, nan], [nan, nan]] for _ in range(n)]
    own = (slice(depth, depth + ty), slice(hx, hx + tx))

    def tile_steps(r, tile, slot, new, parts):
        sh = ss.shards[r]
        by, bx = divmod(tile, tiles_x)
        hy, wx = min(ty, h - by * ty), min(tx, nx - bx * tx)
        ys = torch.arange(by * ty - depth, (by + 1) * ty + depth)
        cols = torch.arange(bx * tx - hx, (bx + 1) * tx + hx) % nx
        ext = torch.cat([slots[r][0][slot], sh.cells, slots[r][1][slot]], 1)
        emask = torch.cat([hmasks[r][0], sh.mask, hmasks[r][1]], 0)
        at = torch.clamp(ys + depth, max=h + 2 * depth - 1)
        win, wmask = ext[:, at][:, :, cols], emask[at][:, cols]
        forced = _window_forced(ys, cols, sh.row0, ny, nx, h, ss.axis)
        counted = torch.zeros((ty, tx), dtype=torch.bool)
        counted[:hy, :wx] = ~wmask[own][:hy, :wx]
        for s in range(depth):
            inner, umag, _, _ = fused_depth._stage(win, wmask, forced, deltas,
                                                   guards, p.omega)
            win = torch.full_like(win, float("nan"))
            win[:, 1:-1, 1:-1] = inner
            u = torch.zeros(wmask.shape, dtype=dt)
            u[1:-1, 1:-1] = umag
            parts[s][tile] = torch.where(counted, u[own],
                                         torch.zeros((), dtype=dt)).sum()
        new[:, by * ty:by * ty + hy, bx * tx:bx * tx + wx] = \
            win[:, own[0], own[1]][:, :hy, :wx]

    for k in range(gsteps // depth):
        slot = k % 2
        sent = [(sh.cells[:, h - depth:].clone(), sh.cells[:, :depth].clone())
                for sh in ss.shards]
        news = [torch.empty_like(sh.cells) for sh in ss.shards]
        parts = [[[None] * n_tiles for _ in range(depth)] for _ in range(n)]
        for r in range(n):
            slots[r][0][slot] = slots[r][1][slot] = nan
            for tile in range(first, end):
                tile_steps(r, tile, slot, news[r], parts[r])
        for r in range(n):
            top, bottom = sent[r]
            slots[(r + 1) % n][0][slot] = top
            slots[(r - 1) % n][1][slot] = bottom
        for r in range(n):
            for tile in [*range(first), *range(end, n_tiles)]:
                tile_steps(r, tile, _receive_slot(k), news[r], parts[r])
        for r, sh in enumerate(ss.shards):
            sh.cells = news[r]
            for s in range(depth):
                tot = torch.zeros((), dtype=dt)
                for v in parts[r][s]:
                    tot = tot + v
                sh.tots[t + k * depth + s] = tot


# --------------------------------------------------------------------------
# The on-chip ring's strips in plain PyTorch.
# --------------------------------------------------------------------------


def ring_onchip_emulated(ss, gsteps: int, buffers: int, blocks: int,
                         wave: int = resident.THREADS, t: int = 0) -> None:
    """``gsteps`` steps of every shard of the CPU shard set ``ss`` by the
    on-chip ring's schedule, the results into each shard's ``cells`` and
    the per-step tot_u into ``shard.tots[t:...]``.

    Each shard's rows split into ``blocks`` strips (:func:`.ops.resident.
    strips`); the strips of all shards, shard by shard, form one ring, the
    top strip of a shard sending north into the north shard's strip 0 and
    its strip 0 south into the south shard's top strip: the strip step of
    :func:`.ops.resident.onchip_schedule` (each step's rows sent before
    it, in two buffers from the update of the step before; interior rows
    and edge rows from the slot of the step; in ``buffers`` 1 the line forced
    in place first and the strip updated in place in waves of ``wave``
    cells through :func:`.ops.resident._inplace_strip_step`), forced by
    global row (column mode: column nx-2 of every shard). tot_u: each
    shard's strip partials summed in strip order. Cells are bit-identical
    to the plain shard steps; tots differ from theirs by summation
    order."""
    n, h = len(ss.shards), ss.h
    if gsteps < 2 or gsteps % 2 or not 1 <= blocks <= h:
        raise ValueError(f"the on-chip ring takes an even G >= 2 and 1 to "
                         f"{h} strips a shard, got G={gsteps}, {blocks}")
    p = ss.params
    local = resident.strips(h, blocks)
    parts = [(r * h + r0, rows) for r in range(n) for r0, rows in local]
    cells = torch.cat([sh.cells for sh in ss.shards], 1)
    mask = torch.cat([sh.mask for sh in ss.shards], 0)
    new, partials = resident.onchip_schedule(
        cells, mask, p.accel_w1, p.accel_w2, p.omega, gsteps, parts, ss.axis,
        buffers, wave)
    for r, sh in enumerate(ss.shards):
        sh.cells = new[:, r * h:(r + 1) * h].clone()
        sh.tots[t:t + gsteps] = resident.sum_in_order(
            partials[:, r * blocks:(r + 1) * blocks])
