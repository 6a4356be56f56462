"""The sharded path, the twin of :mod:`lbm_tpu.parallel.halo`: the
padding and mesh planners, the halo exchange, the per-shard step
implementations and the sharded simulation.

Two plans, as in the JAX package (:func:`plan_sharding`): the row plan
shards the physical lattice's rows (y); the x-plan, for a wide grid on the
``cuda`` kernel (:func:`.ops.plan.transposed_layout`, nx dividing the
mesh), shards the rows of the transposed lattice, which are physical x:
each shard holds a block of physical columns, transposed, and its kernels
run in column mode (the twin of ``_TransposedPallasShardImpl`` and
``TransposedRingShardImpl``). Everything below the plan (the exchange,
the seam kernels, the ring) works on the rows of the lattice it is given.

One controller drives every shard, as ``jax.shard_map`` does (not MPI).
Each shard owns its rows on its device: two lattice buffers, its mask
rows, the static mask rows of its halos, per-step tot_u, and on a GPU its
own CUDA stream. Per call of a seam kernel:

1. every shard's stream waits on an event recorded on each neighbour's
   after its last launch (the twin of ``exchange_halos`` /
   ``_halo_seams``): the south neighbour's top k rows and the north
   neighbour's bottom k rows are its halos, with periodic wrap over the
   shard ring (:func:`halo_sources`). The one-step kernel reads its
   one-row halos in place in the neighbours' lattices, on one card or
   between peers; the depth kernel's k-row halos, and any halo from a
   card without peer access, are copied into the receiver's buffers (a
   peer copy across cards, a device-to-device copy on one);
2. each shard's kernel steps its rows from its halos, forcing by global
   row index; there is no device-wide synchronize per step.

After the run the per-shard tot_u are summed over the shards in a fixed
order (the twin of the one ``psum`` and of the reference's single
``MPI_Reduce``) and scaled by 1 / fluid cells; the cells are gathered on
the first shard's device (the ``device_get`` collate).

Wall-less non-divisor runs pad the lattice with ``p`` obstacle rows inside
shard 0 (the 'wrap' modes): shard 0 sends its row ``p`` north instead of
row 0, and its pad row ``p - 1`` takes the south halo's speeds every step
(the plain shard step copies them in; the seam kernel reads them there),
so the wrap closes over the real lattice, bit-exact.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.obstacles import num_non_obstacles_r
from lbm_tpu_torch.ops import _build, fused, fused_depth, plan
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import resident_ring
from lbm_tpu_torch.parallel.decomp import (
    Mesh, RowDecomposition, largest_divisor_leq, make_mesh, visible_devices,
)
from lbm_tpu_torch.state import D2Q9, transpose_state


# --------------------------------------------------------------------------
# Planners: pure Python over Params, the mask and the mesh size.
# --------------------------------------------------------------------------


def _resolve_kernel(kernel: str, params: Params, mesh: Mesh) -> str:
    """``auto`` is ``cuda`` for float32 on CUDA devices, ``reference``
    otherwise: one rule for every planner, so they never disagree."""
    from lbm_tpu_torch.runner import KERNELS

    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "auto":
        f32_cuda = mesh.device_type == "cuda" and params.dtype == np.float32
        return "cuda" if f32_cuda else "reference"
    return kernel


def resolve_shard_kernel(params: Params, mesh: Mesh, kernel: str) -> str:
    """Resolve ``auto`` and refuse a float64 ``cuda`` request (the
    kernels are float32-only). The TPU's per-shard 8-row alignment rule
    is a Mosaic constraint and has no counterpart here."""
    kernel = _resolve_kernel(kernel, params, mesh)
    if kernel == "cuda" and params.dtype != np.float32:
        raise ValueError("the cuda kernel is float32-only; use "
                         "kernel='reference' with float64")
    return kernel


def _x_plan(params: Params, n: int, kernel: str) -> bool:
    """The wide-grid x-sharding gate, shared by :func:`plan_sharding` and
    :func:`plan_row_padding` (the twin of ``_wide_transposed_plan``): the
    resolved ``cuda`` kernel, the single-device layout rule
    (:func:`.ops.plan.transposed_layout`, so a sharded run and the
    unsharded ``auto`` run use the same layout) and nx dividing the mesh.
    JAX's per-shard 8-row alignment is a Mosaic rule and has no
    counterpart."""
    return (kernel == "cuda" and plan.transposed_layout(params.ny, params.nx)
            and params.nx % n == 0)


def plan_row_padding(params: Params, obstacles, mesh: Mesh,
                     kernel: str) -> int:
    """Rows of all-obstacle padding that make ny divide the mesh: the
    equal-shard answer to the reference's uneven ``allocate_rows``
    (d2q9-bgk.c:483-492). Exact behind full bounce-back wall rows at both
    y boundaries: rows behind a wall never feed the interior. The pad
    goes below row 0, so the forced row stays ny-2. Raises when padding
    is needed but a boundary row has fluid cells; 0 when ny divides or
    the wide-grid x-plan shards the columns."""
    n = mesh.size
    ny = params.ny
    if _x_plan(params, n, _resolve_kernel(kernel, params, mesh)):
        return 0
    ny_pad = -(-ny // n) * n
    if ny_pad == ny:
        return 0
    obs = np.asarray(obstacles, dtype=bool)
    if not (obs[0, :].all() and obs[-1, :].all()):
        raise ValueError(
            f"ny={ny} does not divide over {n} devices and the obstacle "
            "mask has no full wall rows at both y boundaries, so "
            "obstacle-row padding would change the physics; use a "
            "divisor device count"
        )
    return ny_pad - ny


def _wrap_fits(ny: int, n: int, unit: int):
    """Smallest wrap pad to a multiple of ``unit`` rows that fits inside
    shard 0 (pad <= local_ny - 1), or None."""
    pad = -(-ny // unit) * unit - ny
    local = (ny + pad) // n
    return pad if 1 <= pad <= local - 1 else None


def plan_padding_mode(params: Params, obstacles, mesh: Mesh, kernel: str):
    """``('none'|'wall'|'wrap'|'wrap_ref', pad)``, as the JAX package
    plans it off the TPU: 'none' when ny divides the mesh or the x-plan
    shards a wide grid's columns; 'wall' behind
    full wall rows (:func:`plan_row_padding`); for a wall-less mask the
    wrap discipline on the seam kernel ('wrap', kernel ``cuda``) or on
    the plain shard step ('wrap_ref'). Raises when even the wrap pad does
    not fit inside shard 0 (:func:`resolve_mesh` then takes a divisor)."""
    n = mesh.size
    k = _resolve_kernel(kernel, params, mesh)
    try:
        pad = plan_row_padding(params, obstacles, mesh, kernel)
        return ("wall", pad) if pad else ("none", 0)
    except ValueError:
        pad = _wrap_fits(params.ny, n, n)
        if pad is None:
            raise
        return ("wrap" if k == "cuda" else "wrap_ref"), pad


def resolve_mesh(params: Params, obstacles, n_devices: int, kernel: str,
                 devices=None):
    """The CLI's device policy: clamp ``n_devices`` to ``devices``
    (default: the visible CUDA devices), keep every device through
    padding where :func:`plan_padding_mode` can, else demote to the
    largest divisor of ny. Returns ``(mesh_or_None, notes)`` with the
    JAX package's notes, word for word."""
    if devices is None:
        devices = visible_devices("cuda")
    notes = []
    visible = len(devices)
    usable = min(n_devices, visible)
    if usable != n_devices:
        notes.append(f"note: using {usable} devices ({visible} visible)")
    if usable <= 1:
        return None, notes
    mesh = make_mesh(usable, devices=devices)
    try:
        # The seam kernel takes any wrap pad that fits inside shard 0, so
        # the JAX package's note on a demotion to the portable wrap has
        # no case here.
        plan_padding_mode(params, obstacles, mesh, kernel)
    except ValueError:
        fallback = largest_divisor_leq(params.ny, usable)
        notes.append(
            f"note: using {fallback} devices (ny={params.ny} over "
            f"{usable} leaves no headroom for wrap padding; "
            "divisor fallback)"
        )
        mesh = make_mesh(fallback, devices=devices) if fallback > 1 else None
    return mesh, notes


def pad_scene(params: Params, obstacles, pad: int):
    """``pad`` all-obstacle rows below row 0 (the forced row stays at the
    new ny-2)."""
    obs = np.pad(np.asarray(obstacles, dtype=bool), ((pad, 0), (0, 0)),
                 constant_values=True)
    return dataclasses.replace(params, ny=params.ny + pad), obs


def plan_sharding(params: Params, mesh: Mesh, kernel: str):
    """``(transposed, decomp)``, the twin of the JAX function: the row
    plan (physical y over the mesh), or for a wide grid on the ``cuda``
    kernel the x-plan (:func:`_x_plan`): the transposed lattice's rows,
    physical x, over the mesh."""
    n = mesh.size
    if _x_plan(params, n, _resolve_kernel(kernel, params, mesh)):
        return True, RowDecomposition(ny=params.nx, n_shards=n)
    return False, RowDecomposition(ny=params.ny, n_shards=n)


def shard_segments(params: Params, decomp: RowDecomposition, kernel: str,
                   iters: int, wrap_pad: int = 0, transposed: bool = False,
                   mesh: Mesh | None = None) -> list[plan.Segment]:
    """The run as segments, the twin of ``_shard_segments``: the ring at
    the first preferred G (``LBM_SHARD_RESIDENT=1``), else the depth
    kernel at a preferred D that every shard can hold (D <= local rows),
    else the one-step kernel, all in seam mode, planned as the
    single-device planner plans (:func:`.ops.plan.plan_segments`) on the
    shard's rows and lanes (``transposed``: the x-plan's, lanes = ny).
    The wrap discipline runs the one-step kernel only (its pad-row
    refresh lands between steps); ``reference`` runs the plain shard
    step. The single-device resident kernel never runs under a mesh.
    With a ``mesh`` of cards the ring's segments carry its form
    (:func:`.resident_ring.planned_ring_form`: on chip in two buffers or
    one, or in device memory; a pinned mode that does not fit raises
    here)."""
    if kernel == "reference":
        return [plan.Segment("reference", 1, iters)]
    if wrap_pad:
        return [plan.Segment("step", 1, iters)]
    h, lanes = decomp.local_ny, params.ny if transposed else params.nx
    depths = [d for d in plan.depth_preference(h, lanes) if d <= h]
    prefs = resident_ring.ring_prefs(h, lanes)
    form = resident_ring.planned_ring_form(h, lanes, mesh) \
        if prefs and mesh is not None else None
    return plan.plan_segments(iters, prefs, depths, many="ring", form=form)


def _check_wrap_kernel(wrap_pad: int, kernel: str,
                       transposed: bool = False) -> None:
    """Wrap padding's contract, the twin of the JAX function: the wrap
    discipline lives in the row plan's impls (the plain shard step and
    the one-step seam kernel); the x-plan shards columns and cannot carry
    row padding (:func:`plan_padding_mode` never plans the two
    together)."""
    if wrap_pad and kernel not in ("reference", "cuda"):
        raise ValueError("wrap_pad (wall-less non-divisor padding) requires "
                         f"the 'reference' or 'cuda' kernel, got {kernel!r}")
    if wrap_pad and transposed:
        raise ValueError("wrap_pad requires the row plan; the transposed "
                         "x-sharded plan cannot carry row padding")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What a sharded run will do: the padded scene, the resolved kernel,
    the pad and its mode, the plan (``transposed``: the x-plan) and its
    decomposition, and the per-shard segments."""

    params: Params
    obstacles: np.ndarray
    kernel: str
    mode: str
    pad: int
    wrap_pad: int
    transposed: bool
    decomp: RowDecomposition
    segments: list


def plan_run(params: Params, obstacles, mesh: Mesh, kernel: str,
             iters: int) -> ShardPlan:
    """The padding plan (the twin of ``lbm_tpu.runner.run_simulation``'s
    mesh branch) and the segments, from one owner for the runner and the
    CLI's plan line."""
    kernel = resolve_shard_kernel(params, mesh, kernel)
    mode, pad = plan_padding_mode(params, obstacles, mesh, kernel)
    obstacles = np.asarray(obstacles, dtype=bool)
    if pad:
        params, obstacles = pad_scene(params, obstacles, pad)
    wrap_pad = pad if mode in ("wrap", "wrap_ref") else 0
    if mode == "wrap_ref":
        kernel = "reference"
    transposed, decomp = plan_sharding(params, mesh, kernel)
    _check_wrap_kernel(wrap_pad, kernel, transposed)
    segs = shard_segments(params, decomp, kernel, iters, wrap_pad, transposed,
                          mesh)
    return ShardPlan(params, obstacles, kernel, mode, pad, wrap_pad,
                     transposed, decomp, segs)


def describe_mesh(mesh: Mesh) -> str:
    """``cuda:0 x4`` for four shards on one card; runs of equal devices
    are grouped."""
    runs = []
    for d in mesh.devices:
        if runs and runs[-1][0] == d:
            runs[-1][1] += 1
        else:
            runs.append([d, 1])
    return ", ".join(f"{d} x{n}" if n > 1 else str(d) for d, n in runs)


def describe(sp: ShardPlan, mesh: Mesh) -> str:
    """The plan line's tail: shards (of physical columns under the
    x-plan), pad and per-shard segments."""
    pad = f", {sp.mode} pad {sp.pad}" if sp.pad else ""
    lines = "columns" if sp.transposed else "rows"
    return (f"{mesh.size} shards of {sp.decomp.local_ny} {lines} "
            f"({describe_mesh(mesh)}){pad}: "
            f"{plan.describe(sp.segments)} per shard")


# --------------------------------------------------------------------------
# Shards and the halo exchange.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloSource:
    """Where one of a shard's k-row halos comes from: rows ``row`` ..
    ``row + k - 1`` of shard ``shard``'s lattice, read in place from its
    ``cells`` (``in_place``; plane stride ``plane`` = h * nx, the
    sender's) or copied into the receiver's (9, k, nx) halo buffer
    (``plane`` = k * nx)."""

    shard: int
    row: int
    plane: int
    in_place: bool


def reachable(recv: torch.device, send: torch.device) -> bool:
    """Whether a kernel on ``recv`` may read ``send``'s memory: the same
    device, or two CUDA devices with peer access."""
    return recv == send or (recv.type == send.type == "cuda"
                            and torch.cuda.can_device_access_peer(recv, send))


def halo_sources(ss: "ShardSet", k: int, wrap_pad: int = 0,
                 reach=reachable) -> list[tuple[HaloSource, HaloSource]]:
    """The halo plan, ``(south, north)`` for every shard: the south
    neighbour's top k rows and the north neighbour's bottom k rows (row
    ``wrap_pad`` instead of row 0 from shard 0 when wrap-padded), with
    periodic wrap over the shard ring. One-row halos (the one-step seam
    kernel, whose loads take a plane stride) are read in place wherever
    ``reach(receiver, sender)`` holds; deeper halos (the depth kernel's
    window loads take a packed (9, k, nx) buffer) and halos from an
    unreachable sender are copied. Decided from the devices alone, never
    by trying."""
    shards, n, h = ss.shards, len(ss.shards), ss.h
    plan = []
    for r, sh in enumerate(shards):
        north_row = wrap_pad if wrap_pad and (r + 1) % n == 0 else 0
        pair = []
        for nb, row in ((shards[(r - 1) % n], h - k),
                        (shards[(r + 1) % n], north_row)):
            here = k == 1 and reach(sh.device, nb.device)
            pair.append(HaloSource(nb.index, row, (h if here else k) * ss.nx,
                                   here))
        plan.append(tuple(pair))
    return plan


@dataclasses.dataclass
class Shard:
    """One shard's state on its device: the ping-pong lattice buffers
    (the result is in ``cells``), its mask rows, per-step tot_u (not yet
    scaled), its stream and an event recorded on it."""

    index: int
    device: torch.device
    row0: int
    mask: torch.Tensor
    cells: torch.Tensor
    spare: torch.Tensor
    tots: torch.Tensor
    stream: object = None
    event: object = None


class ShardSet:
    """The shards of one run: the physical ``cells`` (9, ny, nx) and
    ``mask`` (ny, nx) split into ``mesh.size`` row blocks, each copied to
    its device. ``axis`` 1 (the x-plan): split into blocks of physical
    columns instead, each transposed (the lattice's rows are then
    physical x), for the kernels' column mode. ``ny``, ``nx``, ``h`` and
    ``mask_np`` describe the lattice the shards step: the transposed one
    under ``axis`` 1."""

    def __init__(self, params: Params, cells: torch.Tensor, mask, mesh: Mesh,
                 iters: int, axis: int = 0):
        rows, lanes = (params.nx, params.ny) if axis else (params.ny, params.nx)
        decomp = RowDecomposition(ny=rows, n_shards=mesh.size)
        self.params, self.mesh, self.decomp = params, mesh, decomp
        self.axis = axis
        self.h, self.nx, self.ny = decomp.local_ny, lanes, rows
        self.device_type = mesh.device_type
        mask = np.asarray(mask, dtype=bool)
        self.mask_np = mask.T.copy() if axis else mask
        if tuple(cells.shape) != (D2Q9.Q, params.ny, params.nx):
            raise ValueError(f"cells have shape {tuple(cells.shape)}, "
                             f"expected {(D2Q9.Q, params.ny, params.nx)}")
        self.shards = []
        for r, dev in enumerate(mesh.devices):
            r0 = decomp.row0(r)
            if axis:
                c = transpose_state(cells[:, :, r0:r0 + self.h]).to(dev)
            else:
                c = cells[:, r0:r0 + self.h].to(dev, copy=True).contiguous()
            cuda = dev.type == "cuda"
            self.shards.append(Shard(
                index=r, device=dev, row0=r0,
                mask=torch.from_numpy(self.mask_np[r0:r0 + self.h].copy()).to(dev),
                cells=c, spare=torch.empty_like(c),
                tots=torch.zeros(iters, dtype=c.dtype, device=dev),
                stream=torch.cuda.Stream(dev) if cuda else None,
                event=torch.cuda.Event() if cuda else None,
            ))
        self.synchronize()

    def on(self, sh: Shard):
        """Work on ``sh``'s stream (nothing to switch on the CPU)."""
        if sh.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(sh.stream)

    def record(self, sh: Shard):
        """``sh``'s event, recorded on its stream now (None on the CPU)."""
        if sh.event is not None:
            sh.event.record(sh.stream)
        return sh.event

    def synchronize(self) -> None:
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def halo_masks(self, r: int, k: int, wrap_pad: int = 0):
        """Static (k, nx) obstacle rows of shard ``r``'s south and north
        halos, from the rows the exchange sends it."""
        south = [(self.shards[r].row0 - k + i) % self.ny for i in range(k)]
        north = [(self.shards[r].row0 + self.h + i) % self.ny for i in range(k)]
        if wrap_pad and r == len(self.shards) - 1:
            north = [wrap_pad + i for i in range(k)]
        dev = self.shards[r].device
        return (torch.from_numpy(self.mask_np[south]).to(dev),
                torch.from_numpy(self.mask_np[north]).to(dev))

    def halo_buffers(self, sources, k: int):
        """Each shard's (south, north) (9, k, nx) buffers for the halos
        ``sources`` (:func:`halo_sources`) copies; None where a halo is
        read in place."""
        return [tuple(None if src.in_place else torch.empty(
                    (D2Q9.Q, k, self.nx), dtype=sh.cells.dtype,
                    device=sh.device) for src in pair)
                for sh, pair in zip(self.shards, sources)]

    def exchange(self, sources, halos, k: int) -> None:
        """Order each shard's next launch after its neighbours' last ones
        and copy the halos ``sources`` copies into ``halos``. Each
        receiver's stream waits on an event recorded on each sender's
        stream now. That covers both hazards of a halo read in place: the
        receiver reads the sender's new rows, and the sender's next
        launch, which writes the buffer read here, waits in its turn for
        the receiver's launch."""
        shards = self.shards
        events = [self.record(sh) for sh in shards]
        for sh, pair, bufs in zip(shards, sources, halos):
            if sh.stream is not None:
                for src in pair:
                    sh.stream.wait_event(events[src.shard])
            copied = [(shards[src.shard], src.row, buf)
                      for src, buf in zip(pair, bufs) if not src.in_place]
            if copied:
                with self.on(sh):
                    for send, row, buf in copied:
                        self._copy(buf, send.cells[:, row:row + k], sh, send)

    def halo_views(self, sources, halos, k: int):
        """Each shard's (south, north) halos as its kernel reads them:
        (9, k, nx) views into the senders' current cells, or the buffers.
        Take them before any shard of the call swaps its buffers."""
        return [tuple(self.shards[src.shard].cells[:, src.row:src.row + k]
                      if src.in_place else buf
                      for src, buf in zip(pair, bufs))
                for pair, bufs in zip(sources, halos)]

    @staticmethod
    def _copy(dst, src, recv: Shard, send: Shard) -> None:
        if recv.device == send.device:
            dst.copy_(src, non_blocking=True)
            return
        # A peer copy syncs with the current streams of both devices:
        # make those the two shards' streams.
        with torch.cuda.stream(send.stream):
            dst.copy_(src, non_blocking=True)

    def gather(self) -> torch.Tensor:
        """The physical (9, ny, nx) lattice on the first shard's device
        (the x-plan's column blocks transposed back)."""
        dev0 = self.shards[0].device
        if self.axis:
            return torch.cat([transpose_state(sh.cells).to(dev0)
                              for sh in self.shards], dim=2)
        return torch.cat([sh.cells.to(dev0) for sh in self.shards], dim=1)

    def av_vels(self, inv_fluid, t0: int = 0, t1=None) -> torch.Tensor:
        """Per-step tot_u of steps ``t0`` to ``t1`` (default: all) summed
        over the shards in shard order, then scaled by ``inv_fluid``: the
        same bits for a step whatever slice asks for it."""
        dev0 = self.shards[0].device
        acc = self.shards[0].tots[t0:t1]
        for sh in self.shards[1:]:
            acc = acc + sh.tots[t0:t1].to(dev0)
        return acc * float(inv_fluid)


# --------------------------------------------------------------------------
# Per-shard step implementations: ``run(t)`` advances every shard by
# ``steps_per_call`` steps and writes tot_u into ``shard.tots[t:...]``.
# --------------------------------------------------------------------------


class ReferenceShardImpl:
    """The plain shard step, the twin of ``_ReferenceShardImpl``: the
    owner of row ny-2 forces it (under the x-plan every shard forces its
    column ny-2), the forced boundary rows are exchanged, shard 0
    refreshes its pad row under the wrap discipline, and
    :func:`.ops.reference.collide_stream_halo` steps each shard. Runs in
    float32 and float64, on any device; it is also the plain version of
    every seam kernel (D of its steps for depth D, G for the ring), in
    both of their forcing modes."""

    kernel = "reference"
    steps_per_call = 1

    def __init__(self, ss: ShardSet, wrap_pad: int = 0):
        _check_wrap_kernel(wrap_pad, self.kernel, bool(ss.axis))
        if wrap_pad and not (len(ss.shards) > 1 and 1 <= wrap_pad <= ss.h - 1):
            raise ValueError(
                f"wrap_pad={wrap_pad} must fit inside shard 0 "
                f"(local_ny={ss.h}, {len(ss.shards)} shards)")
        self.ss, self.wrap_pad = ss, wrap_pad

    def run(self, t: int) -> None:
        ss, w = self.ss, self.wrap_pad
        p, n, h = ss.params, len(ss.shards), ss.h
        forced = []
        for sh in ss.shards:
            if ss.axis:
                forced.append(ref_ops.accelerate_flow(
                    sh.cells, sh.mask, p.accel_w1, p.accel_w2, axis=1))
                continue
            lr = ss.decomp.local_accel_row(sh.index)
            forced.append(ref_ops.accelerate_flow_dynamic(
                sh.cells, sh.mask, p.accel_w1, p.accel_w2, lr, 0 <= lr < h))
        tops = [c[:, h - 1:] for c in forced]
        bots = [c[:, :1] for c in forced]
        if w:
            bots[0] = forced[0][:, w:w + 1]
        new = []
        for r, sh in enumerate(ss.shards):
            south = tops[(r - 1) % n].to(sh.device)
            north = bots[(r + 1) % n].to(sh.device)
            c = forced[r]
            if w and r == 0:
                c = c.clone()
                c[:, w - 1:w] = south
            cells, tot = ref_ops.collide_stream_halo(c, south, north,
                                                     sh.mask, p.omega)
            sh.tots[t] = tot
            new.append(cells)
        for sh, cells in zip(ss.shards, new):
            sh.cells = cells


class SeamShardImpl:
    """A seam kernel on every shard, the twin of ``_PallasShardImpl``
    (``depth`` 1: the one-step kernel, else the depth kernel with
    ``depth``-row halos), under the x-plan of
    ``_TransposedPallasShardImpl`` (the kernels in column mode) and, with
    ``wrap_pad``, of ``_WrapPallasShardImpl`` (one-step only: shard 0's
    kernel reads its pad row ``wrap_pad - 1`` from its south halo). Each
    call orders the shards after their neighbours and copies the halos
    the plan copies (:func:`halo_sources`, ``reach`` as there), then
    launches one kernel per shard on its stream. On one card the
    one-step kernel's halos are read in place, so a call is one launch a
    shard and nothing else."""

    def __init__(self, ss: ShardSet, depth: int = 1, wrap_pad: int = 0,
                 reach=reachable):
        _check_wrap_kernel(wrap_pad, "cuda", bool(ss.axis))
        if wrap_pad and (depth != 1 or not (
                len(ss.shards) > 1 and 1 <= wrap_pad <= ss.h - 1)):
            raise ValueError(
                f"wrap_pad={wrap_pad} needs the one-step kernel and must fit "
                f"inside shard 0 (local_ny={ss.h}, {len(ss.shards)} shards)")
        if depth > ss.h:
            raise ValueError(f"depth {depth} exceeds the {ss.h} rows a shard")
        self.ss, self.k, self.wrap_pad = ss, depth, wrap_pad
        self.kernel = "step" if depth == 1 else "depth"
        self.steps_per_call = depth
        self.sources = halo_sources(ss, depth, wrap_pad, reach)
        self.halos = ss.halo_buffers(self.sources, depth)
        p = ss.params
        self.kernels = []
        for sh in ss.shards:
            ms, mn = ss.halo_masks(sh.index, depth, wrap_pad)
            args = (sh.mask, ms, mn, p.accel_w1, p.accel_w2, p.omega,
                    sh.row0, ss.ny)
            wrap_row = wrap_pad - 1 if wrap_pad and sh.index == 0 else -1
            self.kernels.append(
                fused.SeamStep(*args, axis=ss.axis, wrap_row=wrap_row)
                if depth == 1
                else fused_depth.FusedDepthSeam(*args, depth, axis=ss.axis))
        self._launchers = {}
        if ss.device_type == "cuda":
            lib = _build.load()
            for sh, pair in zip(ss.shards, self.sources):
                for src in pair:
                    send = ss.shards[src.shard].device
                    if src.in_place and send != sh.device:
                        _build.check(lib, lib.lbm_enable_peer_access(
                            _index(sh.device), _index(send)), "peer access")

    def run(self, t: int) -> None:
        ss, k = self.ss, self.k
        if k == 1 and ss.device_type == "cuda":
            # The shards' buffers alternate, so two sets of launches serve
            # every step; the launchers hold their pointers.
            key = tuple((sh.cells.data_ptr(), sh.spare.data_ptr())
                        for sh in ss.shards)
            launch = self._launchers.get(key)
            if launch is None:
                views = ss.halo_views(self.sources, self.halos, k)
                launch = self._launchers[key] = [
                    kern.launcher(sh.cells, sh.spare, hs, hn, sh.tots)
                    for sh, kern, (hs, hn) in zip(ss.shards, self.kernels,
                                                  views)]
            ss.exchange(self.sources, self.halos, k)
            for sh, go in zip(ss.shards, launch):
                go(t, sh.stream.cuda_stream)
                sh.cells, sh.spare = sh.spare, sh.cells
            return
        views = ss.halo_views(self.sources, self.halos, k)
        ss.exchange(self.sources, self.halos, k)
        for sh, kern, (hs, hn) in zip(ss.shards, self.kernels, views):
            with ss.on(sh):
                sh.cells, sh.spare = kern.run(sh.cells, sh.spare, hs, hn,
                                              sh.tots, t)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def make_impl(seg: plan.Segment, ss: ShardSet, wrap_pad: int = 0):
    """The step implementation of one planned segment."""
    if seg.kernel == "reference":
        return ReferenceShardImpl(ss, wrap_pad)
    if seg.kernel == "ring":
        return resident_ring.make_ring(ss, seg.steps_per_call, seg.form)
    return SeamShardImpl(ss, seg.steps_per_call, wrap_pad)


class ShardedSimulation:
    """One sharded run, the twin of ``make_sharded_simulate`` and, in its
    chunk form, of ``make_sharded_chunk``: the shards, the planned
    segments' implementations (all built once), and ``run()`` walking the
    segments over every shard. ``kernel`` is the resolved ``reference``
    or ``cuda``; ``cuda`` on CPU tensors runs each wrapper's plain version
    (the tests' way to drive the planned path without a card).
    ``transposed``: the plan (None: :func:`plan_sharding`'s; False builds
    the row plan of a wide grid).

    The chunk form, as the single-device runner's: ``cells`` is the
    gathered physical lattice (padded as this run pads it) scattered into
    the shards, fresh or from a checkpoint; ``sizes`` are the chunk
    lengths the run will take (default: ``iters`` in one go), each
    planned on its own (:func:`shard_segments`) with implementations of
    the same granularity shared; :meth:`run_chunk` runs ``n`` steps from
    step ``t0``, every shard writing its tot_u at the step's own index,
    so the fixed-order sum of :meth:`result` gives the same bits chunked
    or not. A resumed run's trajectory before ``start_step`` is ``av0``'s
    (the per-shard sums of those steps are not in a checkpoint)."""

    def __init__(self, params: Params, cells: torch.Tensor, mask, mesh: Mesh,
                 kernel: str, iters: int, wrap_pad: int = 0, transposed=None,
                 sizes=None, av0=None, start_step: int = 0):
        if transposed is None:
            transposed = plan_sharding(params, mesh, kernel)[0]
        _check_wrap_kernel(wrap_pad, kernel, transposed)
        self.ss = ShardSet(params, cells, mask, mesh, iters, int(transposed))
        self.params, self.kernel, self.iters = params, kernel, iters
        self.wrap_pad, self.transposed = wrap_pad, transposed
        self.inv_fluid = num_non_obstacles_r(self.ss.mask_np,
                                             dtype=params.dtype)
        self._av0, self._start = av0, start_step
        self._made, self._plans = {}, {}
        if sizes is None:
            self.segments = self._segments(iters)
            self._impls = self._plan(iters)
        else:
            for n in sizes:
                self._plan(n)

    def _segments(self, n: int):
        return shard_segments(self.params, self.ss.decomp, self.kernel, n,
                              self.wrap_pad, self.transposed, self.ss.mesh)

    def _plan(self, n: int):
        """The implementations of an ``n``-step chunk, ``[(impl, steps),
        ...]``."""
        if n not in self._plans:
            parts = []
            for seg in self._segments(n):
                key = (seg.kernel, seg.steps_per_call, seg.form)
                if key not in self._made:
                    self._made[key] = make_impl(seg, self.ss, self.wrap_pad)
                parts.append((self._made[key], seg.steps))
            self._plans[n] = parts
        return self._plans[n]

    def run_chunk(self, t0: int, n: int) -> None:
        """``n`` steps from step ``t0`` on every shard; returns without
        waiting for the devices."""
        t = t0
        for impl, steps in self._plan(n):
            for _ in range(steps // impl.steps_per_call):
                impl.run(t)
                t += impl.steps_per_call

    def synchronize(self) -> None:
        self.ss.synchronize()

    def run(self) -> None:
        self.run_chunk(0, self.iters)
        self.ss.synchronize()

    def _with_prefix(self, av: torch.Tensor, t0: int) -> torch.Tensor:
        """``av`` (steps from ``t0`` on) with a resumed run's steps
        before its start taken from the checkpoint's trajectory."""
        if self._av0 is not None and t0 < self._start:
            prefix = torch.from_numpy(np.asarray(self._av0)[t0:self._start])
            av[:self._start - t0] = prefix[:av.shape[0]].to(av)
        return av

    def result(self):
        """``(cells, av_vels)`` on the first shard's device: the gathered
        (9, ny, nx) lattice (padded, as stepped) and the trajectory.
        Waits for every shard."""
        self.ss.synchronize()
        return (self.ss.gather(),
                self._with_prefix(self.ss.av_vels(self.inv_fluid), 0))

    def av_value(self, t: int) -> float:
        """``av_vels[t]`` on the host (waits for every shard)."""
        self.ss.synchronize()
        return float(self._with_prefix(
            self.ss.av_vels(self.inv_fluid, t, t + 1), t)[0])

    def total_density(self, pad_rows: int = 0) -> float:
        """The summed distributions of the gathered lattice without its
        first ``pad_rows`` rows (waits for every shard)."""
        from lbm_tpu_torch.observables import total_density

        self.ss.synchronize()
        return float(total_density(self.ss.gather()[:, pad_rows:]))
