"""The port's sharding planners against the JAX package's, case by case:
padding modes and pads, meshes and their notes, padded scenes and the
per-shard segments. JAX meshes are the 8 virtual CPU devices that
tests/conftest.py provisions; the port's are ``[cpu] * n``. Every JAX
planner gets ``backend="cpu"`` (or runs on the CPU backend), so no other
backend is probed. The port's ``cuda`` kernel is the JAX package's
``pallas``. Grids keep nx < 2 ny, the row plan; the x-plan of wide grids
is held to the JAX package's in tests/test_torch_wide_sharded.py."""

import numpy as np
import pytest
import torch

from lbm_tpu.params import Params as JParams
from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.parallel import resident_ring as jring
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp, halo, resident_ring

CPU = torch.device("cpu")
JAX_KERNEL = {"cuda": "pallas", "reference": "reference", "auto": "auto"}
PLAN_ENV = ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_RESIDENT_INPLACE", "LBM_RESIDENT")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)


def _params(ny, nx=12, iters=20):
    kw = dict(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=0.1,
              accel=0.005, omega=1.85)
    return Params(**kw), JParams(**kw)


def _mask(ny, nx, walls):
    return generate_obstacles(nx, ny) if walls else np.zeros((ny, nx), bool)


def _meshes(n):
    return (decomp.make_mesh(n, devices=[CPU] * n),
            jdecomp.make_mesh(n, devices=jax_cpu_devices()))


def jax_cpu_devices():
    import jax

    return jax.devices("cpu")


def _outcome(fn):
    """``("ok", value)`` or ``("error", message)``."""
    try:
        return "ok", fn()
    except ValueError as exc:
        return "error", str(exc)


GRID = [(ny, n, walls) for ny in (8, 9, 16, 30, 66, 100, 130, 1022, 1024)
        for n in (1, 2, 3, 4, 6, 8) for walls in (True, False)]


@pytest.mark.parametrize("kernel", ["cuda", "reference", "auto"])
def test_padding_plans_match(kernel):
    for ny, n, walls in GRID:
        tp, jp = _params(ny)
        mask = _mask(ny, tp.nx, walls)
        tmesh, jmesh = _meshes(n)
        where = f"ny={ny} n={n} walls={walls} kernel={kernel}"
        got = _outcome(lambda: halo.plan_padding_mode(tp, mask, tmesh, kernel))
        want = _outcome(lambda: jhalo.plan_padding_mode(
            jp, mask, jmesh, JAX_KERNEL[kernel], backend="cpu"))
        assert got == want, where
        got = _outcome(lambda: halo.plan_row_padding(tp, mask, tmesh, kernel))
        want = _outcome(lambda: jhalo.plan_row_padding(
            jp, mask, jmesh, JAX_KERNEL[kernel], backend="cpu"))
        assert got == want, where
        if got[0] == "ok" and want[1]:
            p2, m2 = halo.pad_scene(tp, mask, want[1])
            jp2, jm2 = jhalo.pad_scene(jp, mask, want[1])
            assert p2.ny == jp2.ny and np.array_equal(m2, jm2), where


@pytest.mark.parametrize("kernel", ["cuda", "reference"])
def test_resolve_mesh_matches(kernel):
    for ny in (8, 9, 16, 30, 66, 130, 1024):
        for walls in (True, False):
            tp, jp = _params(ny)
            mask = _mask(ny, tp.nx, walls)
            for n in (1, 2, 3, 5, 8, 9, 12):
                where = f"ny={ny} walls={walls} n={n}"
                tmesh, tnotes = halo.resolve_mesh(tp, mask, n, kernel,
                                                  devices=[CPU] * 8)
                jmesh, jnotes = jhalo.resolve_mesh(jp, mask, n,
                                                   JAX_KERNEL[kernel],
                                                   backend="cpu")
                assert tnotes == jnotes, where
                assert (tmesh.size if tmesh else None) == \
                    (jmesh.shape["y"] if jmesh else None), where


def test_resolve_mesh_clamps_to_the_visible_devices():
    tp, _ = _params(1024)
    mesh, notes = halo.resolve_mesh(tp, _mask(1024, 12, True), 4, "auto",
                                    devices=[CPU])
    assert mesh is None
    assert notes == ["note: using 1 devices (1 visible)"]
    mesh, notes = halo.resolve_mesh(tp, _mask(1024, 12, True), 4, "auto",
                                    devices=[torch.device("cuda", 0)] * 4)
    assert mesh.size == 4 and notes == []


def _jax_segments(impls):
    out = []
    for impl, steps in impls:
        if isinstance(impl, jring.RingShardImpl):
            key = ("ring", impl.gsteps)
        elif isinstance(impl, jhalo._WrapPallasShardImpl):
            key = ("step", 1)
        elif isinstance(impl, jhalo._PallasShardImpl):
            key = ("depth", impl.fused) if impl.fused > 1 else ("step", 1)
        else:
            key = ("reference", 1)
        out.append([key, steps])
    return _merged(out)


def _merged(parts):
    """Adjacent segments of one kernel at one size as one: the JAX
    package splits a run into aliased pairs and a remainder at the same
    depth, which the port (no pairing) runs as one segment."""
    out = []
    for key, steps in parts:
        if out and out[-1][0] == key:
            out[-1][1] += steps
        else:
            out.append([key, steps])
    return [(k, s) for k, s in out]


SEGMENT_CASES = {
    # name: (ny, nx, walls, n, kernel, iters, env)
    "depth-4": (64, 32, True, 8, "cuda", 20, {"LBM_PALLAS_DEPTH": "4"}),
    "depth-2-tail": (64, 32, True, 8, "cuda", 21, {"LBM_PALLAS_DEPTH": "2"}),
    "depth-8": (128, 32, True, 8, "cuda", 16, {"LBM_PALLAS_DEPTH": "8"}),
    "step-only": (64, 32, True, 4, "cuda", 7, {"LBM_PALLAS_DEPTH": "1"}),
    "ring": (16, 16, True, 8, "cuda", 20, {"LBM_SHARD_RESIDENT": "1"}),
    "ring-tail": (64, 32, True, 8, "cuda", 23,
                  {"LBM_SHARD_RESIDENT": "1", "LBM_RESIDENT_STEPS": "4",
                   "LBM_PALLAS_DEPTH": "1"}),
    "ring-padded": (66, 32, True, 8, "cuda", 20, {"LBM_SHARD_RESIDENT": "1"}),
    "wrap": (66, 32, False, 8, "cuda", 20, {}),
    "reference": (64, 32, True, 8, "reference", 20, {}),
    "wrap-reference": (66, 32, False, 8, "reference", 20, {}),
}


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_shard_segments_match(name, monkeypatch):
    ny, nx, walls, n, kernel, iters, env = SEGMENT_CASES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tp, jp = _params(ny, nx, iters)
    mask = _mask(ny, nx, walls)
    tmesh, jmesh = _meshes(n)
    sp = halo.plan_run(tp, mask, tmesh, kernel, iters)
    mode, pad = jhalo.plan_padding_mode(jp, mask, jmesh, JAX_KERNEL[kernel],
                                        backend="cpu")
    jk = "reference" if mode == "wrap_ref" else JAX_KERNEL[kernel]
    if pad:
        jp, _ = jhalo.pad_scene(jp, mask, pad)
    transposed, jd, _, _ = jhalo.plan_sharding(jp, jmesh, jk, backend="cpu")
    assert not transposed
    wrap = pad if mode in ("wrap", "wrap_ref") else 0
    want = _jax_segments(jhalo._shard_segments(jp, jd, jk, iters, False,
                                               wrap_pad=wrap))
    got = _merged([[(s.kernel, s.steps_per_call), s.steps]
                   for s in sp.segments])
    assert got == want
    assert (sp.mode, sp.pad, sp.wrap_pad, sp.decomp.local_ny) == \
        (mode, pad, wrap, jd.local_ny)
    assert sum(s.steps for s in sp.segments) == iters


def test_depth_needs_every_shard_to_hold_d_rows(monkeypatch):
    """16 rows over 8 shards: 2 rows a shard, so D=2 at most."""
    tp, _ = _params(16, 16, 20)
    sp = halo.plan_run(tp, _mask(16, 16, True),
                       decomp.make_mesh(8, devices=[CPU] * 8), "cuda", 20)
    assert [(s.kernel, s.steps_per_call) for s in sp.segments] == [("depth", 2)]
    monkeypatch.setenv("LBM_PALLAS_DEPTH", "8")
    sp = halo.plan_run(tp, _mask(16, 16, True),
                       decomp.make_mesh(8, devices=[CPU] * 8), "cuda", 21)
    assert [(s.kernel, s.steps_per_call, s.steps) for s in sp.segments] == \
        [("depth", 2, 20), ("step", 1, 1)]


def test_ring_gating(monkeypatch):
    assert resident_ring.ring_prefs(128, 1024) is None
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "0")
    assert resident_ring.ring_prefs(128, 1024) is None
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    assert resident_ring.ring_prefs(128, 1024) == plan.G_PREF
    assert resident_ring.ring_gsteps(128, 1024, 20000) == 100
    assert resident_ring.ring_gsteps(128, 1024, 23) is None
    assert resident_ring.ring_prefs(1, 1024) is None
    # No VMEM ceiling on the card: the JAX package's largest shards fit.
    assert resident_ring.ring_prefs(4096, 1024) == plan.G_PREF
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    assert resident_ring.ring_prefs(128, 1024) == (4,)
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "5")
    with pytest.raises(ValueError, match="even"):
        resident_ring.ring_prefs(128, 1024)


def test_mesh_and_decomposition():
    mesh = decomp.make_mesh(4, devices=[torch.device("cuda:0")] * 4)
    assert mesh.size == 4 and mesh.shape == {"y": 4}
    assert halo.describe_mesh(mesh) == "cuda:0 x4"
    with pytest.raises(ValueError, match="available"):
        decomp.make_mesh(3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="mix"):
        decomp.Mesh((CPU, torch.device("cuda:0")))
    d, jd = decomp.RowDecomposition(128, 8), jdecomp.RowDecomposition(128, 8)
    assert (d.local_ny, d.accel_row) == (jd.local_ny, jd.accel_row)
    assert [d.row0(r) for r in range(8)] == [16 * r for r in range(8)]
    assert [d.local_accel_row(r) for r in range(8)] == \
        [126 - 16 * r for r in range(8)]
    for ny, n in [(128, 6), (100, 8), (7, 3)]:
        assert decomp.largest_divisor_leq(ny, n) == \
            jdecomp.largest_divisor_leq(ny, n)
    with pytest.raises(ValueError, match="not divisible"):
        decomp.RowDecomposition(10, 4)
