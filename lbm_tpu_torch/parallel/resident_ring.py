"""The ring kernel's planner and wrapper: G steps per launch on every
shard, in rounds of D steps between exchanges of D-row halos inside the
kernel (``csrc/ring.cu``, the port of
``lbm_tpu/parallel/resident_ring.py::_kernel_ring``, in row mode and in
the column mode of ``TransposedRingShardImpl``: the shards of a wide
grid's transposed lattice, the column ny-2 forced in every shard).

One cooperative launch per card hosts every shard on that card. Its
blocks run the depth kernel's tiles (``csrc/lbm_depth.cuh``) D steps at a
time; the shards' halo slots and flags are plain device memory, peer
pointers for a neighbour on another card, so P shards on one card run the
protocol of P cards. As in the JAX package the ring is an opt-in
(``LBM_SHARD_RESIDENT=1``), with G from the port's preferences
(:data:`.ops.plan.G_PREF`) or the ``LBM_RESIDENT_STEPS`` pin (even), and D
the first of :data:`.ops.plan.AUTO_DEPTHS` that divides G and fits the
shard's rows (:func:`ring_depth`).

On CPU tensors the wrapper runs the plain version: G steps of the halo
exchange and :func:`.ops.reference.halo_multi_step`, the same update the
kernel makes. On CUDA tensors it launches or raises, also when the
device refuses the cooperative launch. :func:`ring_emulated` is the
kernel's round schedule in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from lbm_tpu_torch.ops import _build, fused_depth, plan
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


class RingShardImpl:
    """The ring over every shard of a :class:`.halo.ShardSet`:
    ``run(t)`` advances each shard ``gsteps`` steps and writes each
    step's tot_u into ``shard.tots[t:t + gsteps]``; each shard's result
    is in its ``cells`` buffer. The forcing axis is the shard set's (1:
    column mode), its D :func:`ring_depth`'s. ``blocks``: blocks a shard
    (default: as many as can be co-resident, split among a card's
    shards); a launch of more than fit raises."""

    kernel = "ring"

    def __init__(self, ss, gsteps: int, blocks: int | None = None):
        if gsteps < 2 or gsteps % 2:
            raise ValueError(f"the ring takes an even G >= 2, got {gsteps}")
        if ss.h < 2:
            raise ValueError(f"the ring needs 2 rows a shard, got {ss.h}")
        depth = ring_depth(gsteps, ss.h)
        self.ss, self.gsteps, self.depth = ss, int(gsteps), depth
        self.steps_per_call = self.gsteps
        p = ss.params
        self.w1, self.w2, self.omega = (np.float32(p.accel_w1),
                                        np.float32(p.accel_w2),
                                        np.float32(p.omega))
        self.mode = ref_ops.association_mode(torch.float32)
        self.axis = ss.axis
        self._step = 0  # steps run so far: the rounds' tags go on from it
        nx, n = ss.nx, len(ss.shards)
        if ss.device_type == "cpu":
            from lbm_tpu_torch.parallel.halo import halo_sources

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
        self._cross = any(ss.shards[(i + s) % n].device != sh.device
                          for i, sh in enumerate(ss.shards) for s in (-1, 1))
        tiles = lib.lbm_depth_num_partials(depth, ss.h, nx)
        self._bps = {}
        for d, idxs in self._groups.items():
            if blocks is not None:
                self._bps[d] = int(blocks)
                continue
            fit = lib.lbm_ring_blocks(depth, self.axis, index[d])
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
        for sh in ss.shards:
            dev = sh.device
            slots = (2, D2Q9.Q, depth, nx)
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
        for dev, idxs in self._groups.items():
            lead = ss.shards[idxs[0]]
            with ss.on(lead):
                for i in idxs[1:]:
                    lead.stream.wait_event(ss.record(ss.shards[i]))
                struct, vec = self._struct(dev, idxs)
                _build.check(lib, lib.lbm_ring(
                    struct.data_ptr(), len(idxs), self._bps[dev], ss.h, ss.nx,
                    ss.ny, self.w1, self.w2, self.omega, self.mode, self.axis,
                    d, g, self._step // d, t, int(vec), int(self._cross),
                    self._index[dev], lead.stream.cuda_stream,
                ), f"ring G={g} D={d} cooperative launch")
                LAUNCHES["ring_cols" if self.axis else "ring"] += 1
                done = ss.record(lead)
            for i in idxs[1:]:
                ss.shards[i].stream.wait_event(done)
        if (g // d) % 2:
            # An odd number of rounds ends in each shard's other buffer.
            for sh in ss.shards:
                sh.cells, sh.spare = sh.spare, sh.cells
        self._step += g

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
