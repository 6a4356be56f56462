"""The kernel's module, lbm_tpu_torch.ops.fused, on the CPU: CPU tensors
run the wrapper's plain version, held here against the JAX package's
``_kernel`` in interpret mode, run the way tests/test_pallas.py runs it.
The CUDA kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles, num_non_obstacles_r
from lbm_tpu.ops.pallas_fused import (
    collide_stream_pallas,
    make_carry_step,
    make_fused_step,
)
from lbm_tpu.params import Params
from lbm_tpu.runner import make_simulate
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.ops import _build, fused

torch.set_num_threads(2)

RTOL, ATOL, TOT_RTOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4, 1e-4


def _params(ny, nx, **kw):
    base = dict(nx=nx, ny=ny, max_iters=8, reynolds_dim=10,
                density=0.1, accel=0.005, omega=1.85)
    base.update(kw)
    return Params(**base)


def _state(p, seed):
    rng = np.random.default_rng(seed)
    cells = rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(np.float32)
    # Fail the forcing guard on part of row ny-2.
    cells[7, p.ny - 2, rng.random(p.nx) < 0.3] = np.float32(p.accel_w2)
    return cells


def test_step_matches_pallas_make_fused_step():
    p = _params(32, 128)
    cells, mask = _state(p, 0), generate_obstacles(p.nx, p.ny)
    want, want_tot = make_fused_step(p)(jnp.asarray(cells), jnp.asarray(mask))
    got, got_tot = fused.fused_step(
        torch.from_numpy(cells), torch.from_numpy(mask),
        p.accel_w1, p.accel_w2, p.omega,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.isclose(float(got_tot), float(want_tot), rtol=TOT_RTOL)


def test_multiblock_matches_collide_stream_pallas():
    """128x256 spans several of the TPU kernel's row blocks. With zero
    forcing weights the fused step is the bare collide-stream pass."""
    p = _params(128, 256)
    cells, mask = _state(p, 2), generate_obstacles(p.nx, p.ny)
    cj = jnp.asarray(cells)
    want, want_tot = collide_stream_pallas(
        cj, cj[:, -1:, :], cj[:, :1, :], jnp.asarray(mask), p.omega
    )
    got, got_tot = fused.fused_step(
        torch.from_numpy(cells), torch.from_numpy(mask), 0.0, 0.0, p.omega
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.isclose(float(got_tot), float(want_tot), rtol=TOT_RTOL)


def test_stepper_trajectory_matches_pallas_carry_step(monkeypatch):
    """8 steps of the JAX main path pinned to ``_kernel`` (depth 1, no
    resident kernel: CarryStep) against the port's stepper."""
    monkeypatch.setenv("LBM_PALLAS_DEPTH", "1")
    monkeypatch.setenv("LBM_RESIDENT", "0")
    p = _params(128, 128)
    impl = make_carry_step(p, n_iters=8)
    assert impl.fused == 1 and type(impl).__name__ == "CarryStep"
    mask = generate_obstacles(p.nx, p.ny)
    inv = num_non_obstacles_r(mask)
    cj, aj = make_simulate(p, kernel="pallas", n_iters=8)(
        jnp.asarray(initial_state_np(p)), jnp.asarray(mask), inv)

    stepper = fused.FusedStep(torch.from_numpy(mask), p.accel_w1,
                              p.accel_w2, p.omega)
    a = torch.from_numpy(initial_state_np(p))
    b = torch.empty_like(a)
    av = torch.empty(8)
    for t in range(8):
        stepper.step(a, b, av, t, inv)
        a, b = b, a
    np.testing.assert_allclose(a.numpy(), np.asarray(cj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av.numpy(), np.asarray(aj), rtol=TRAJ_RTOL)


def test_cpu_wrapper_is_the_plain_version():
    p = _params(24, 100)
    cells = torch.from_numpy(_state(p, 4))
    mask = torch.from_numpy(generate_obstacles(p.nx, p.ny))
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    before = dict(fused.LAUNCHES)
    got, got_tot = fused.fused_step(cells, *args)
    want, want_tot = fused.fused_step_plain(cells, *args)
    assert torch.equal(got, want) and float(got_tot) == float(want_tot)
    assert fused.LAUNCHES == before, "no kernel launches on the CPU"


def test_stepper_rejects_what_the_kernel_does_not_take():
    mask = torch.from_numpy(generate_obstacles(16, 8))
    st = fused.FusedStep(mask, 1e-5, 1e-6, 1.85)
    good = torch.ones(9, 8, 16)
    av = torch.empty(4)
    bad = [
        (good.double(), torch.empty(9, 8, 16), av, 0),
        (torch.ones(9, 8, 15), torch.empty(9, 8, 16), av, 0),
        (torch.ones(9, 16, 8).transpose(1, 2), torch.empty(9, 8, 16), av, 0),
        (good, good, av, 0),
        (good, torch.empty(9, 8, 16), av, 4),
    ]
    for src, dst, out, t in bad:
        with pytest.raises(ValueError):
            st.step(src, dst, out, t)
    with pytest.raises(ValueError):
        fused.FusedStep(mask.to(torch.uint8), 1e-5, 1e-6, 1.85)


def test_cuda_kernel_on_cpu_device_raises():
    p = _params(16, 32)
    mask = generate_obstacles(p.nx, p.ny)
    with pytest.raises(ValueError, match="CUDA device"):
        trunner._resolve_kernel("cuda", p, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA device"):
        trunner.run_simulation(p, mask, kernel="cuda", device="cpu")
    assert trunner._resolve_kernel("auto", p, torch.device("cpu")) == "reference"


def test_nvcc_command_targets_sm90a_and_lists_every_source(tmp_path):
    """One ``nvcc -c`` per source, all for sm_90a without fast math,
    then one link of every object into the hashed library."""
    compiles = _build.compile_commands(tmp_path)
    srcs = sorted(Path(_build.CSRC).glob("*.cu"))
    assert srcs and [Path(c[-1]) for c in compiles] == srcs
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert "--use_fast_math" not in cmd
    link = _build.link_command(tmp_path)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    objs = [c[c.index("-o") + 1] for c in compiles]
    assert [c for c in link if c.endswith(".o")] == objs
    out = Path(link[link.index("-o") + 1])
    assert out.parent == Path(_build.PACKAGE_DIR).parent / "build" / "lbm_tpu_torch"
    assert out.name.endswith(".so") and out == _build.library_path()
    # The shared headers are part of the library's hash.
    assert [h.name for h in _build.headers()] == ["lbm_cell.cuh",
                                                  "lbm_depth.cuh",
                                                  "lbm_onchip.cuh",
                                                  "lbm_reduce.cuh",
                                                  "lbm_rounds.cuh",
                                                  "lbm_seam.cuh"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ptxas_table_reads_kernels_and_called_functions():
    """The build line's register table: an entry function with its
    registers and spills, and a device function that is a call of its
    own (the ring's tile) with its spills alone."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__x_7_"
        "ring_cu_d511ring_kernelILi4ELb0EEEvNS_4RingE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN39_GLOBAL__N__x_7_ring_cu"
        "_d511ring_kernelILi4ELb0EEEvNS_4RingE",
        "    112 bytes stack frame, 140 bytes spill stores, 152 bytes spill "
        "loads",
        "ptxas info    : Used 48 registers, used 1 barriers, 1616 bytes smem",
        "ptxas info    : Function properties for _ZN37_INTERNAL_x_7_ring_cu"
        "_d539_GLOBAL__N__x9ring_tileILi4ELb0ELi0EEEvRK4ArgsPfiS5_m",
        "    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Compiling entry function '_Z16reduce_tot_kernel"
        "PKfifPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z16reduce_tot_kernelPKfifPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 22 registers, used 1 barriers",
    ])
    assert _chip_smoke().ptxas_table(log) == {
        "ring_kernel<4,0>": "48 registers, 140 / 152 B spilled",
        "ring_tile<4,0,0>": "12 / 12 B spilled",
        "reduce_tot_kernel": "22 registers"}


def test_chip_smoke_grid_names_are_nx_by_ny():
    """chip_smoke.py names grids NXxNY as the repository does: the
    131072x128 stress scene is 131072 columns by 128 rows, as
    tests/test_pallas.py builds it and lbm_tpu lays it out (a wide grid,
    which its planner transposes)."""
    from lbm_tpu.ops.pallas_fused import _transposed_layout

    smoke = _chip_smoke()
    assert smoke.grid("131072x128") == (131072, 128)
    stress = _params(128, 131072)
    assert (stress.nx, stress.ny) == smoke.grid("131072x128")
    assert _transposed_layout(stress.ny, stress.nx)
    assert not _transposed_layout(*reversed(smoke.grid("128x131072")))
    names = [name for name, _ in smoke.KERNEL_CASES]
    assert "131072x128" in names and "16384x1024" in names
    for name in names + [smoke.SCENE, smoke.STRESS]:
        nx, ny = smoke.grid(name)
        p = smoke.scene_params(name)
        assert (p.nx, p.ny) == (nx, ny)
        if nx * ny <= 1 << 20:
            assert generate_obstacles(nx, ny).shape == (ny, nx)
