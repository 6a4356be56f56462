"""Checkpoint/resume, chunking, preemption and debug of the port: the
twins of tests/test_checkpoint.py's cases, on scenes written into
``tmp_path``, and the cross-package cases (a checkpoint written by either
package resumes in the other).

The port promises more than the JAX tests check: every kernel is
bit-identical to the plain version, so a chunked, a resumed and a
single-shot run of a scene under the same kernel and mesh give the same
bits, cells and av_vels (``assert_array_equal`` below). The planned
``cuda`` path runs here on CPU tensors, each wrapper taking its plain
version (the ``cuda_on_cpu`` fixture lifts the entry point's refusal), so
the chunk planning, the ping-pong buffers and the transposed layout are
the ones the card runs.

Against ``lbm_tpu``: cells at rtol 2e-5 / atol 5e-8 and av_vels at rtol
1e-4 in float32 (XLA's jit moves the JAX f32 trajectory by ulps, ROADMAP
section 3), float64 at 1e-12.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu import runner as jrunner
from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.params import Params as JParams
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp
from lbm_tpu_torch.runner import (
    load_checkpoint,
    run_simulation,
    save_checkpoint,
)
from lbm_tpu_torch.state import initial_state_np

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RTOL, ATOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4
PLAN_ENV = ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_RESIDENT", "LBM_RESIDENT_INPLACE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def cuda_on_cpu(monkeypatch):
    """Let ``run_simulation(kernel="cuda")`` step CPU tensors: the planned
    kernel path with each wrapper's plain version."""
    monkeypatch.setattr(trunner, "_resolve_kernel", lambda k, p, d: k)
    monkeypatch.setattr(trunner, "_check_mesh", lambda mesh, kernel: None)


def small_params(**kw):
    defaults = dict(nx=32, ny=16, max_iters=30, reynolds_dim=10,
                    density=0.1, accel=0.005, omega=1.85)
    defaults.update(kw)
    return Params(**defaults)


def _jparams(p):
    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters,
                   reynolds_dim=p.reynolds_dim, density=p.density,
                   accel=p.accel, omega=p.omega, dtype=p.dtype)


def _mesh(n):
    return decomp.make_mesh(n, devices=[CPU] * n)


def run(p, obstacles, kernel="reference", **kw):
    return run_simulation(p, obstacles, kernel=kernel, device="cpu", **kw)


def _same(a, b):
    np.testing.assert_array_equal(a.cells, b.cells)
    np.testing.assert_array_equal(a.av_vels, b.av_vels)


def _preempt_after(monkeypatch, n_saves=1):
    """Make the port's ``save_checkpoint`` deliver SIGTERM to this process
    after its ``n_saves``-th save; returns the list of saved steps."""
    real_save, saves = trunner.save_checkpoint, []

    def save_and_preempt(path, step, cells, av):
        real_save(path, step, cells, av)
        saves.append(step)
        if len(saves) == n_saves:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(trunner, "save_checkpoint", save_and_preempt)
    return saves


def test_checkpoint_roundtrip(tmp_path):
    f = tmp_path / "ck.npz"
    cells = np.random.default_rng(0).random((9, 4, 8)).astype(np.float32)
    av = np.arange(5, dtype=np.float32)
    save_checkpoint(f, 5, cells, av)
    step, c, a = load_checkpoint(f)
    assert step == 5 and trunner.checkpoint_step(f) == 5
    np.testing.assert_array_equal(c, cells)
    np.testing.assert_array_equal(a, av)
    # The file format is the JAX package's: each reads the other's.
    jstep, jc, ja = jrunner.load_checkpoint(f)
    assert jstep == 5
    np.testing.assert_array_equal(jc, cells)
    jrunner.save_checkpoint(f, 7, cells, av)
    assert load_checkpoint(f)[0] == 7


def test_chunked_equals_single_shot(tmp_path):
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run(p, obstacles)
    ck = run(p, obstacles, checkpoint_every=7,
             checkpoint_file=tmp_path / "ck.npz")
    _same(base, ck)
    assert ck.completed_steps == p.max_iters and not ck.preempted
    # The final checkpoint holds the completed run.
    step, cells, av = load_checkpoint(tmp_path / "ck.npz")
    assert step == p.max_iters
    np.testing.assert_array_equal(cells, ck.cells)
    np.testing.assert_array_equal(av, ck.av_vels)


def test_resume_continues_trajectory(tmp_path):
    p = small_params(max_iters=30)
    obstacles = generate_obstacles(p.nx, p.ny)
    full = run(p, obstacles)
    half = run(p, obstacles, n_iters=15, checkpoint_every=15,
               checkpoint_file=tmp_path / "ck.npz")
    resumed = run(p, obstacles, resume_from=tmp_path / "ck.npz")
    _same(full, resumed)
    np.testing.assert_array_equal(full.av_vels[:15], half.av_vels)
    assert half.completed_steps == 15 and resumed.completed_steps == 30


# Chunked = checkpointed-and-resumed = single shot, bit for bit, under the
# planned kernel path: (nx, ny, iters, stride, env, transposed).
KERNEL_CASES = {
    # 7-step chunks plan depth D=4 + D=2 + one step each: an odd number
    # of launches a chunk, so the ping-pong pair swaps at every boundary.
    "depth-odd-stride": (32, 16, 30, 7, {"LBM_RESIDENT": "0"}, None),
    "depth-stride-below-D": (32, 16, 11, 3, {"LBM_RESIDENT": "0",
                                              "LBM_PALLAS_DEPTH": "8"}, None),
    "resident-stride-below-G": (32, 16, 30, 7, {"LBM_RESIDENT": "1",
                                                 "LBM_RESIDENT_STEPS": "16"},
                                None),
    "resident-odd-G-tail": (32, 16, 25, 10, {}, None),
    "one-step": (32, 16, 9, 4, {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "1"},
                 None),
    "transposed": (64, 16, 21, 8, {"LBM_RESIDENT": "0"}, True),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernel_path_chunked_and_resumed_equal_single_shot(
        name, tmp_path, monkeypatch, cuda_on_cpu):
    nx, ny, iters, stride, env, transposed = KERNEL_CASES[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if transposed:
        # The layout rule keeps grids this small physical: patch JAX's
        # rule in, as tests/test_torch_wide_sharded.py does.
        monkeypatch.setattr(plan, "transposed_layout",
                            lambda ny, nx: nx >= 2 * ny and nx % 8 == 0)
    p = small_params(nx=nx, ny=ny, max_iters=iters)
    rng = np.random.default_rng(3)
    obstacles = generate_obstacles(nx, ny) | (rng.random((ny, nx)) < 0.05)
    obstacles[ny - 2, 3] = False
    assert trunner.plan_layout(p, "cuda") == bool(transposed)
    base = run(p, obstacles, "cuda")
    plain = run(p, obstacles, "reference")

    def cells_equal_plain(cells, want):
        # The transposed lattice sums its (permuted) speeds in another
        # order, so it agrees with the physical one within the repo's
        # bounds; the physical layout agrees bit for bit.
        if transposed:
            np.testing.assert_allclose(cells, want, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(cells, want)

    cells_equal_plain(base.cells, plain.cells)
    np.testing.assert_allclose(base.av_vels, plain.av_vels, rtol=TRAJ_RTOL)

    _same(base, run(p, obstacles, "cuda", chunk_iters=stride))
    f = tmp_path / "ck.npz"
    _same(base, run(p, obstacles, "cuda", checkpoint_every=stride,
                    checkpoint_file=f))
    part = run(p, obstacles, "cuda", n_iters=stride + 1,
               checkpoint_every=stride + 1, checkpoint_file=f)
    assert part.completed_steps == stride + 1
    # The checkpoint is physical, also of a transposed run.
    assert load_checkpoint(f)[1].shape == (9, ny, nx)
    _same(base, run(p, obstacles, "cuda", resume_from=f))
    # ...and resumes in chunks, and under the plain version (cells only:
    # the kernels' tot_u sums have their own order).
    _same(base, run(p, obstacles, "cuda", resume_from=f, chunk_iters=stride))
    cells_equal_plain(run(p, obstacles, "reference", resume_from=f).cells,
                      plain.cells)


def test_chunk_plans_shrink_below_the_preferred_granularity(monkeypatch):
    """A chunk shorter than the planned G or D plans smaller kernels; it
    never fails, and the kernels of one granularity are built once."""
    p = small_params(max_iters=30)
    mask = torch.from_numpy(generate_obstacles(p.nx, p.ny))
    from lbm_tpu_torch.state import initial_state

    sim = trunner._Simulation(p, initial_state(p), mask, "cuda", 30,
                              sizes=[7, 2, 1])
    kinds = {n: [(type(i).__name__, i.steps_per_call, s.steps)
                 for i, s in sim._plans[n]] for n in (7, 2, 1)}
    assert kinds[7] == [("FusedDepth", 4, 4), ("FusedDepth", 2, 2),
                        ("FusedStep", 1, 1)]
    assert kinds[2] == [("FusedDepth", 2, 2)]
    assert kinds[1] == [("FusedStep", 1, 1)]
    assert sim._plans[7][1][0] is sim._plans[2][0][0]
    assert trunner.chunk_sizes(0, 30, 7) == [7, 2]
    assert trunner.chunk_sizes(14, 30, 8) == [8]
    assert trunner.chunk_sizes(5, 30, None) == [25]
    assert trunner.chunk_sizes(30, 30, 7) == []


def _debug_lines(out, key):
    return [ln for ln in out.splitlines() if ln.startswith(key)]


def test_debug_mode_prints_reference_block(capsys):
    p = small_params(max_iters=3)
    obstacles = generate_obstacles(p.nx, p.ny)
    res = run(p, obstacles, debug=True)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 9
    for t in range(3):
        assert out[3 * t] == "==timestep: %d==" % t
        assert out[3 * t + 1] == "av velocity: %.12E" % res.av_vels[t]
        assert out[3 * t + 2].startswith("tot density: ")
    _same(run(p, obstacles), res)
    # The JAX package prints the same block for the same scene.
    jrunner.run_simulation(_jparams(p), obstacles, kernel="reference",
                           debug=True)
    jout = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in jout] == [ln.split(":")[0] for ln in out]
    for a, b in zip(out, jout):
        if not a.startswith("=="):
            assert np.isclose(float(a.split()[-1]), float(b.split()[-1]),
                              rtol=TRAJ_RTOL)


def test_sharded_resume_matches_full(tmp_path):
    p = small_params(ny=32, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    mesh = _mesh(4)
    full = run(p, obstacles, mesh=mesh)
    f = tmp_path / "ck_shard.npz"
    run(p, obstacles, mesh=mesh, n_iters=12, checkpoint_every=12,
        checkpoint_file=f)
    _same(full, run(p, obstacles, mesh=mesh, resume_from=f))
    np.testing.assert_array_equal(full.cells, run(p, obstacles).cells)


def test_debug_resume_continues_labels(tmp_path, capsys):
    p = small_params(max_iters=6)
    obstacles = generate_obstacles(p.nx, p.ny)
    run(p, obstacles, n_iters=3, checkpoint_every=3,
        checkpoint_file=tmp_path / "ck.npz")
    res = run(p, obstacles, debug=True, resume_from=tmp_path / "ck.npz")
    out = capsys.readouterr().out
    assert "==timestep: 3==" in out and "==timestep: 0==" not in out
    _same(run(p, obstacles), res)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_debug_with_mesh_matches_unsharded(kernel, capsys, cuda_on_cpu):
    p = small_params(max_iters=4)
    obstacles = generate_obstacles(p.nx, p.ny)
    res = run(p, obstacles, kernel, debug=True, mesh=_mesh(4))
    out = capsys.readouterr().out
    assert "==timestep: 0==" in out and "==timestep: 3==" in out
    base = run(p, obstacles, kernel, debug=True)
    base_out = capsys.readouterr().out
    np.testing.assert_array_equal(base.cells, res.cells)
    np.testing.assert_allclose(base.av_vels, res.av_vels, rtol=1e-5)
    # The sharded debug values are the sharded non-debug run's.
    np.testing.assert_array_equal(
        res.av_vels, run(p, obstacles, kernel, mesh=_mesh(4),
                         chunk_iters=1).av_vels)
    assert [ln for ln in _debug_lines(out, "av velocity")] == \
        ["av velocity: %.12E" % v for v in res.av_vels]
    dens, base_dens = (_debug_lines(o, "tot density") for o in (out, base_out))
    assert len(dens) == len(base_dens) == 4
    for a, b in zip(dens, base_dens):
        assert np.isclose(float(a.split()[-1]), float(b.split()[-1]), rtol=1e-6)


def test_debug_with_mesh_nondivisor_padding(capsys):
    """The pad rows are excluded from the printed density, so both debug
    lines match an unsharded debug run of the same scene."""
    p = small_params(ny=46, max_iters=3)
    obstacles = generate_obstacles(p.nx, p.ny)
    res = run(p, obstacles, debug=True, mesh=_mesh(3))
    out = capsys.readouterr().out
    base = run(p, obstacles, debug=True)
    base_out = capsys.readouterr().out
    assert res.cells.shape == base.cells.shape
    np.testing.assert_array_equal(base.cells, res.cells)
    np.testing.assert_allclose(base.av_vels, res.av_vels, rtol=1e-5)
    dens, base_dens = ([float(ln.split()[-1])
                        for ln in _debug_lines(o, "tot density")]
                       for o in (out, base_out))
    assert len(dens) == len(base_dens) == 3
    np.testing.assert_allclose(dens, base_dens, rtol=1e-6)


def test_ring_preemption_padding_checkpoint(tmp_path, monkeypatch,
                                            cuda_on_cpu):
    """Checkpoint x padding x ring: ny=60 over 8 shards pads to 64 behind
    the walls, each 8-step chunk runs the ring at G=4, SIGTERM lands at
    the first chunk boundary, and the resumed run equals the
    uninterrupted ones."""
    from lbm_tpu_torch.parallel import halo, resident_ring

    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    mesh = _mesh(8)
    p = small_params(ny=60, nx=32, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    sp = halo.plan_run(p, obstacles, mesh, "cuda", 8)
    assert (sp.mode, sp.pad) == ("wall", 4)
    assert plan.describe(sp.segments) == "ring G=4 x2"

    base = run(p, obstacles)
    full = run(p, obstacles, "cuda", mesh=mesh)
    f = tmp_path / "ck.npz"
    _preempt_after(monkeypatch)
    res = run(p, obstacles, "cuda", mesh=mesh, checkpoint_every=8,
              checkpoint_file=f)
    monkeypatch.undo()
    assert res.preempted and res.completed_steps == 8
    assert not res.av_vels[8:].any() and res.av_vels[:8].all()
    # The flushed checkpoint holds the PADDED lattice of the writer.
    assert load_checkpoint(f)[1].shape == (9, 64, p.nx)

    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    monkeypatch.setattr(trunner, "_resolve_kernel", lambda k, p, d: k)
    monkeypatch.setattr(trunner, "_check_mesh", lambda mesh, kernel: None)
    sim_cls = halo.ShardedSimulation
    made = []
    monkeypatch.setattr(halo, "ShardedSimulation",
                        lambda *a, **k: made.append(sim_cls(*a, **k)) or made[-1])
    resumed = run(p, obstacles, "cuda", mesh=mesh, resume_from=f)
    assert isinstance(made[0]._plans[16][0][0], resident_ring.RingShardImpl)
    assert not resumed.preempted and resumed.completed_steps == 24
    _same(full, resumed)
    np.testing.assert_array_equal(base.cells, resumed.cells)
    np.testing.assert_allclose(base.av_vels, resumed.av_vels, rtol=1e-5)


VALIDATION = {
    "every-without-file": (dict(checkpoint_every=4), "checkpoint_file"),
    "nonpositive-every": (dict(checkpoint_every=0, checkpoint_file="x.npz"),
                          "checkpoint_every must be"),
    "nonpositive-chunk": (dict(chunk_iters=0), "chunk_iters must be"),
    "chunk-and-every": (dict(chunk_iters=5, checkpoint_every=5,
                             checkpoint_file="x.npz"), "mutually exclusive"),
    "zero-iters": (dict(n_iters=0), "must be positive"),
    "negative-iters": (dict(n_iters=-5), "must be positive"),
}


@pytest.mark.parametrize("name", list(VALIDATION))
def test_validation_messages_equal_the_jax_package(name):
    """The six misconfigurations raise the JAX package's messages, word
    for word."""
    kwargs, match = VALIDATION[name]
    p = small_params(ny=16, nx=32, max_iters=8)
    obstacles = generate_obstacles(p.nx, p.ny)
    with pytest.raises(ValueError, match=match) as got:
        run(p, obstacles, **kwargs)
    with pytest.raises(ValueError) as want:
        jrunner.run_simulation(_jparams(p), obstacles, kernel="reference",
                               **kwargs)
    assert str(got.value) == str(want.value)


def test_resume_past_requested_iters_rejected(tmp_path):
    p = small_params(max_iters=20)
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "ck.npz"
    run(p, obstacles, checkpoint_every=20, checkpoint_file=f)
    assert load_checkpoint(f)[0] == 20
    with pytest.raises(ValueError, match="cannot resume") as got:
        run(p, obstacles, n_iters=10, resume_from=f)
    with pytest.raises(ValueError) as want:
        jrunner.run_simulation(_jparams(p), obstacles, kernel="reference",
                               n_iters=10, resume_from=f)
    assert str(got.value) == str(want.value)
    # Resuming at exactly the end is legal (nothing left to run).
    done = run(p, obstacles, resume_from=f)
    assert len(done.av_vels) == 20 and done.completed_steps == 20
    _same(done, run(p, obstacles))


def test_resume_rejects_mismatched_scene(tmp_path):
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "ck.npz"
    for shape in ((9, p.ny, p.nx * 2), (9, p.ny - 4, p.nx), (8, p.ny, p.nx)):
        save_checkpoint(f, 5, np.zeros(shape, np.float32),
                        np.zeros(5, np.float32))
        with pytest.raises(ValueError, match="does not match") as got:
            run(p, obstacles, resume_from=f)
        with pytest.raises(ValueError) as want:
            jrunner.run_simulation(_jparams(p), obstacles, kernel="reference",
                                   resume_from=f)
        assert str(got.value) == str(want.value)


def test_resume_across_shard_counts_reconciles_padding(tmp_path):
    """A 3-shard run pads ny=46 to 48 and checkpoints the 48-row lattice;
    it resumes on 2 shards (no padding), and an unpadded checkpoint on 3:
    pad rows sit behind the scene's walls, so fresh equilibrium rows in
    their place are exact."""
    p = small_params(ny=46, nx=64, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run(p, obstacles)

    f = tmp_path / "ck3.npz"
    run(p, obstacles, mesh=_mesh(3), n_iters=12, checkpoint_every=12,
        checkpoint_file=f)
    assert load_checkpoint(f)[1].shape == (9, 48, 64)
    for mesh in (_mesh(2), None):
        got = run(p, obstacles, mesh=mesh, resume_from=f)
        np.testing.assert_array_equal(base.cells, got.cells)
        np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=1e-5)

    f2 = tmp_path / "ck1.npz"
    run(p, obstacles, n_iters=12, checkpoint_every=12, checkpoint_file=f2)
    assert load_checkpoint(f2)[1].shape == (9, 46, 64)
    got = run(p, obstacles, mesh=_mesh(3), resume_from=f2)
    np.testing.assert_array_equal(base.cells, got.cells)
    np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=1e-5)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_wrap_pad_checkpoint_resume(kernel, tmp_path, cuda_on_cpu):
    """Checkpoint/resume under the wrap discipline (wall-less,
    non-divisor): the checkpoint stores the padded lattice, the resume
    substitutes fresh pad rows, and the wrap rewrites the one consumed pad
    row from the wrap halo before any real row reads it."""
    p = small_params(ny=46, nx=32, max_iters=18)
    rng = np.random.default_rng(9)
    no_walls = rng.random((p.ny, p.nx)) < 0.08
    no_walls[p.ny - 2, 3] = False
    base = run(p, no_walls)
    f = tmp_path / "ckwrap.npz"
    half = run(p, no_walls, kernel, mesh=_mesh(3), n_iters=9,
               checkpoint_every=9, checkpoint_file=f)
    assert load_checkpoint(f)[1].shape == (9, 48, 32)  # padded writer
    got = run(p, no_walls, kernel, mesh=_mesh(3), resume_from=f)
    np.testing.assert_array_equal(base.cells, got.cells)
    np.testing.assert_allclose(base.av_vels, got.av_vels, rtol=2e-5)
    np.testing.assert_array_equal(got.av_vels[:9], half.av_vels)
    _same(got, run(p, no_walls, kernel, mesh=_mesh(3)))
    # ...and unsharded, the pad stripped.
    np.testing.assert_array_equal(
        base.cells, run(p, no_walls, resume_from=f).cells)


def test_corrupt_checkpoint_is_a_clean_error(tmp_path):
    p = small_params(max_iters=8)
    obstacles = generate_obstacles(p.nx, p.ny)
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not a zip archive at all")
    missing_keys = tmp_path / "missing.npz"
    np.savez(missing_keys, step=4)  # no cells/av_vels arrays
    for bad in (garbage, missing_keys):
        with pytest.raises(ValueError, match="invalid checkpoint"):
            run(p, obstacles, resume_from=bad)
    with pytest.raises(ValueError, match="invalid checkpoint"):
        trunner.checkpoint_step(garbage)
    with pytest.raises(OSError):
        run(p, obstacles, resume_from=tmp_path / "absent.npz")


def test_truncated_av_prefix_is_a_clean_error(tmp_path):
    p = small_params(max_iters=20)
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "short.npz"
    save_checkpoint(f, 10, initial_state_np(p), np.zeros((6,), np.float32))
    with pytest.raises(ValueError, match="av_vels prefix") as got:
        run(p, obstacles, resume_from=f)
    with pytest.raises(ValueError) as want:
        jrunner.run_simulation(_jparams(p), obstacles, kernel="reference",
                               resume_from=f)
    assert str(got.value) == str(want.value)


def test_graceful_preemption_chunked(tmp_path, monkeypatch):
    p = small_params(max_iters=40)
    obstacles = generate_obstacles(p.nx, p.ny)
    full = run(p, obstacles)
    f = tmp_path / "ck.npz"
    saves = _preempt_after(monkeypatch, n_saves=2)  # 2 of 5 chunks done
    res = run(p, obstacles, checkpoint_every=8, checkpoint_file=f)
    monkeypatch.undo()

    assert res.preempted and res.completed_steps == 16 and saves == [8, 16]
    # A preempted run returns zeros past its completed steps.
    np.testing.assert_array_equal(res.av_vels[:16], full.av_vels[:16])
    assert not res.av_vels[16:].any()
    # The guard restored the default handler on the way out.
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    step, _, av_prefix = load_checkpoint(f)
    assert step == 16
    np.testing.assert_array_equal(full.av_vels[:16], av_prefix[:16])

    resumed = run(p, obstacles, resume_from=f)
    assert not resumed.preempted and resumed.completed_steps == 40
    _same(full, resumed)


def test_graceful_preemption_sharded(tmp_path, monkeypatch):
    p = small_params(ny=32, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    full = run(p, obstacles, mesh=_mesh(4))
    f = tmp_path / "ck.npz"
    _preempt_after(monkeypatch)
    res = run(p, obstacles, mesh=_mesh(4), checkpoint_every=8,
              checkpoint_file=f)
    monkeypatch.undo()
    assert res.preempted and res.completed_steps == 8
    assert load_checkpoint(f)[0] == 8
    _same(full, run(p, obstacles, mesh=_mesh(4), resume_from=f))


def test_graceful_preemption_debug_path(tmp_path, monkeypatch, capsys):
    """The per-step debug loop flushes a checkpoint on the signal and
    stops; nothing runs after it."""
    p = small_params(max_iters=12)
    obstacles = generate_obstacles(p.nx, p.ny)
    f = tmp_path / "ck.npz"
    _preempt_after(monkeypatch)
    res = run(p, obstacles, debug=True, checkpoint_every=3, checkpoint_file=f)
    monkeypatch.undo()
    assert res.preempted and res.completed_steps == 3
    assert load_checkpoint(f)[0] == 3
    assert not res.av_vels[3:].any()
    assert "==timestep: 3==" not in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_guard_is_inert_without_checkpointing():
    """No periodic checkpointing, no boundary to stop at: the guard
    installs nothing."""
    before = signal.getsignal(signal.SIGTERM)
    with trunner._PreemptionGuard(enabled=False) as guard:
        assert signal.getsignal(signal.SIGTERM) == before
    assert not guard.requested
    with trunner._PreemptionGuard(enabled=True) as guard:
        assert signal.getsignal(signal.SIGTERM) == guard._handle
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
        # A second signal would be deadly again.
        assert signal.getsignal(signal.SIGTERM) == before
    assert signal.getsignal(signal.SIGTERM) == before


@pytest.fixture
def scene(tmp_path):
    params = tmp_path / "scene.params"
    params.write_text("64\n32\n40\n10\n0.1\n0.005\n1.85\n")
    obs = tmp_path / "obstacles.dat"
    write_obstacles(obs, generate_obstacles(64, 32))
    return tmp_path, str(params), str(obs)


def test_cli_preemption_exit_code(scene, monkeypatch, capsys):
    """A preempted CLI run exits 75 (EX_TEMPFAIL), points at the resume
    command on stderr, and writes no partial output files; the resumed
    run's files equal the uninterrupted run's byte for byte."""
    d, params, obs = scene
    ck = d / "ck.npz"
    av_f, fs_f = d / "av.dat", d / "fs.dat"
    outputs = ["--av-vels-file", str(av_f), "--final-state-file", str(fs_f)]
    _preempt_after(monkeypatch)
    rc = tcli.main([params, obs, "--device", "cpu", "--checkpoint-every", "8",
                    "--checkpoint-file", str(ck), *outputs])
    monkeypatch.undo()
    assert rc == 75
    captured = capsys.readouterr()
    assert "preempted at step 8/40" in captured.err
    assert f"--resume {ck}" in captured.err
    assert "==done==" not in captured.out
    assert ck.exists() and not av_f.exists() and not fs_f.exists()

    assert tcli.main([params, obs, "--device", "cpu", "--resume", str(ck),
                      *outputs]) == 0
    assert tcli.main([params, obs, "--device", "cpu", "--av-vels-file",
                      str(d / "av1.dat"), "--final-state-file",
                      str(d / "fs1.dat")]) == 0
    assert av_f.read_bytes() == (d / "av1.dat").read_bytes()
    assert fs_f.read_bytes() == (d / "fs1.dat").read_bytes()


def test_cli_sigterm_in_a_subprocess(scene):
    """The real thing: SIGTERM to a running ``python -m lbm_tpu_torch``
    once its first checkpoint exists."""
    d, params, obs = scene
    ck = d / "ck.npz"
    proc = subprocess.Popen(
        [sys.executable, "-m", "lbm_tpu_torch", params, obs, "--device", "cpu",
         "--iters", "200000", "--checkpoint-every", "50", "--checkpoint-file",
         str(ck), "--av-vels-file", str(d / "av.dat"), "--final-state-file",
         str(d / "fs.dat")],
        cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(d),
             "OMP_NUM_THREADS": "2"})
    try:
        import time

        t0 = time.monotonic()
        while not ck.exists() and proc.poll() is None \
                and time.monotonic() - t0 < 120:
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, err[-2000:]
    step = load_checkpoint(ck)[0]
    assert 0 < step < 200000 and step % 50 == 0
    assert f"preempted at step {step}/200000" in err
    assert "==done==" not in out and not (d / "av.dat").exists()


def test_cli_checkpoint_file_without_every_warns(scene, capsys):
    d, params, obs = scene
    ck = d / "ck.npz"
    rc = tcli.main([params, obs, "--device", "cpu", "--iters", "20",
                    "--checkpoint-file", str(ck), "--av-vels-file",
                    str(d / "av.dat"), "--final-state-file", str(d / "fs.dat")])
    assert rc == 0
    assert "saves nothing" in capsys.readouterr().err
    assert not ck.exists()


def test_cli_default_checkpoint_file_and_plan_line(scene, capsys, monkeypatch):
    """--checkpoint-every alone writes lbm_checkpoint.npz in the working
    directory; --debug and --chunk-iters parse; the JAX CLI's
    --compilation-cache is there too (the kernels' build directory)."""
    d, params, obs = scene
    monkeypatch.chdir(d)
    outputs = ["--av-vels-file", str(d / "av.dat"), "--final-state-file",
               str(d / "fs.dat")]
    assert tcli.main([params, obs, "--device", "cpu", "--iters", "10",
                      "--checkpoint-every", "5", *outputs]) == 0
    assert load_checkpoint(d / "lbm_checkpoint.npz")[0] == 10
    assert tcli.main([params, obs, "--device", "cpu", "--iters", "10",
                      "--chunk-iters", "4", "--resume", "lbm_checkpoint.npz",
                      *outputs]) == 0
    capsys.readouterr()
    assert tcli.main([params, obs, "--device", "cpu", "--iters", "2",
                      "--debug", *outputs]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "==timestep: 0=="
    opts = {a.dest for a in tcli.build_parser()._actions}
    assert {"debug", "checkpoint_every", "checkpoint_file", "resume",
            "chunk_iters", "trace", "compilation_cache"} <= opts


def test_chunk_iters_equals_single_shot():
    """Full chunks and a shorter tail (30 = 7+7+7+7+2), no checkpoint
    I/O."""
    p = small_params()
    obstacles = generate_obstacles(p.nx, p.ny)
    ch = run(p, obstacles, chunk_iters=7)
    _same(run(p, obstacles), ch)
    assert ch.completed_steps == p.max_iters and not ch.preempted


@pytest.mark.parametrize("kernel,env", [
    ("reference", {}), ("cuda", {}), ("cuda", {"LBM_SHARD_RESIDENT": "1",
                                               "LBM_RESIDENT_STEPS": "4"}),
    ("cuda", {"LBM_PALLAS_DEPTH": "1"})],
    ids=["reference", "seam-depth", "ring", "seam-step"])
def test_chunk_iters_sharded_equals_single_shot(kernel, env, monkeypatch,
                                                cuda_on_cpu):
    """The fixed-order av_vels sum gives the same bits chunked or not,
    under each sharded plan (7-step chunks: a main segment and a tail in
    every chunk)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = small_params(ny=32)
    obstacles = generate_obstacles(p.nx, p.ny)
    base = run(p, obstacles)
    full = run(p, obstacles, kernel, mesh=_mesh(4))
    ch = run(p, obstacles, kernel, chunk_iters=7, mesh=_mesh(4))
    _same(full, ch)
    np.testing.assert_array_equal(base.cells, ch.cells)
    np.testing.assert_allclose(base.av_vels, ch.av_vels, rtol=1e-5)


def test_x_plan_checkpoint_resume(tmp_path, monkeypatch, cuda_on_cpu):
    """A wide grid over 4 shards (the x-plan: shards of physical columns,
    transposed): the checkpoint is the physical lattice, and resumes over
    the x-plan, unsharded (transposed) and under the plain version."""
    from lbm_tpu_torch.parallel import halo

    monkeypatch.setattr(plan, "transposed_layout",
                        lambda ny, nx: nx >= 2 * ny and nx % 8 == 0)
    p = small_params(nx=64, ny=16, max_iters=22)
    obstacles = generate_obstacles(p.nx, p.ny)
    mesh = _mesh(4)
    assert halo.plan_run(p, obstacles, mesh, "cuda", 22).transposed
    plain = run(p, obstacles)
    base = run(p, obstacles, "cuda")  # unsharded, transposed
    full = run(p, obstacles, "cuda", mesh=mesh)
    np.testing.assert_array_equal(base.cells, full.cells)
    np.testing.assert_allclose(full.cells, plain.cells, rtol=RTOL, atol=ATOL)
    f = tmp_path / "ck.npz"
    run(p, obstacles, "cuda", mesh=mesh, n_iters=9, checkpoint_every=9,
        checkpoint_file=f)
    assert load_checkpoint(f)[1].shape == (9, 16, 64)
    _same(full, run(p, obstacles, "cuda", mesh=mesh, resume_from=f))
    _same(full, run(p, obstacles, "cuda", mesh=mesh, chunk_iters=5))
    np.testing.assert_array_equal(
        base.cells, run(p, obstacles, "cuda", resume_from=f).cells)
    # The physical layout sums the speeds in another order.
    np.testing.assert_allclose(
        run(p, obstacles, "reference", resume_from=f).cells, plain.cells,
        rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# Across the packages: a checkpoint written by one resumes in the other,
# and both ends are held to lbm_tpu's uninterrupted run.
# --------------------------------------------------------------------------


def _jax_run(p, obstacles, **kw):
    return jrunner.run_simulation(_jparams(p), obstacles, kernel="reference",
                                  **kw)


def _close_to_jax(got, want, rtol=RTOL, atol=ATOL, traj=TRAJ_RTOL):
    np.testing.assert_allclose(got.cells, want.cells, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=traj)


@pytest.mark.parametrize("writer", ["lbm_tpu", "lbm_tpu_torch"])
def test_cross_package_resume_single_device(writer, tmp_path):
    p = small_params(nx=32, ny=24, max_iters=40)
    rng = np.random.default_rng(4)
    obstacles = generate_obstacles(p.nx, p.ny) | (rng.random((24, 32)) < 0.05)
    want = _jax_run(p, obstacles)
    f = tmp_path / "ck.npz"
    if writer == "lbm_tpu":
        _jax_run(p, obstacles, n_iters=16, checkpoint_every=16,
                 checkpoint_file=f)
        got = run(p, obstacles, resume_from=f)
    else:
        run(p, obstacles, n_iters=16, checkpoint_every=16, checkpoint_file=f)
        got = _jax_run(p, obstacles, resume_from=f)
    assert load_checkpoint(f)[0] == 16
    _close_to_jax(got, want)
    assert got.completed_steps == 40 and not got.preempted


@pytest.mark.parametrize("writer", ["lbm_tpu", "lbm_tpu_torch"])
def test_cross_package_resume_wall_padded_mesh(writer, tmp_path):
    """ny=46 over 3 shards pads to 48 in both packages: the padded
    checkpoint of one resumes under the other's mesh, and unsharded."""
    p = small_params(nx=32, ny=46, max_iters=24)
    obstacles = generate_obstacles(p.nx, p.ny)
    want = _jax_run(p, obstacles)
    f = tmp_path / "ck.npz"
    if writer == "lbm_tpu":
        _jax_run(p, obstacles, mesh=jdecomp.make_mesh(3), n_iters=12,
                 checkpoint_every=12, checkpoint_file=f)
        resumed = [run(p, obstacles, mesh=_mesh(3), resume_from=f),
                   run(p, obstacles, resume_from=f)]
    else:
        run(p, obstacles, mesh=_mesh(3), n_iters=12, checkpoint_every=12,
            checkpoint_file=f)
        resumed = [_jax_run(p, obstacles, mesh=jdecomp.make_mesh(3),
                            resume_from=f),
                   _jax_run(p, obstacles, resume_from=f)]
    assert load_checkpoint(f)[1].shape == (9, 48, 32)
    for got in resumed:
        assert got.cells.shape == (9, 46, 32)
        _close_to_jax(got, want)


_F64_SCRIPT = """
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from lbm_tpu.params import Params
from lbm_tpu.runner import run_simulation
mode, ck, out = sys.argv[1:4]
z = np.load(sys.argv[4])
p = Params(nx=int(z["nx"]), ny=int(z["ny"]), max_iters=24, reynolds_dim=10,
           density=0.1, accel=0.005, omega=1.85, dtype=np.float64)
if mode == "write":
    run_simulation(p, z["mask"], kernel="reference", n_iters=12,
                   checkpoint_every=12, checkpoint_file=ck)
    r = run_simulation(p, z["mask"], kernel="reference")
else:
    r = run_simulation(p, z["mask"], kernel="reference", resume_from=ck)
np.savez(out, cells=r.cells, av_vels=r.av_vels)
"""


def test_cross_package_resume_float64(tmp_path):
    """float64 (the JAX package needs x64 from process start, so it runs
    in a subprocess): both directions within 1e-12 of its uninterrupted
    run."""
    p = small_params(nx=32, ny=24, max_iters=24, dtype=np.float64)
    obstacles = generate_obstacles(p.nx, p.ny)
    inp = tmp_path / "in.npz"
    np.savez(inp, mask=obstacles, nx=p.nx, ny=p.ny)
    env = {"PYTHONPATH": str(REPO), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}

    def jax(mode, ck, out):
        res = subprocess.run(
            [sys.executable, "-c", _F64_SCRIPT, mode, str(ck), str(out),
             str(inp)], capture_output=True, text=True, cwd=REPO, timeout=300,
            env=env)
        assert res.returncode == 0, res.stderr[-2000:]
        return np.load(out)

    want = jax("write", tmp_path / "ck_jax.npz", tmp_path / "full.npz")
    got = run(p, obstacles, resume_from=tmp_path / "ck_jax.npz")
    assert got.cells.dtype == np.float64
    np.testing.assert_allclose(got.cells, want["cells"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.av_vels, want["av_vels"], rtol=1e-12)

    run(p, obstacles, n_iters=12, checkpoint_every=12,
        checkpoint_file=tmp_path / "ck_torch.npz")
    back = jax("resume", tmp_path / "ck_torch.npz", tmp_path / "back.npz")
    np.testing.assert_allclose(back["cells"], want["cells"], rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(back["av_vels"], want["av_vels"], rtol=1e-12)
