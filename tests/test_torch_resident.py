"""The resident kernel's module, lbm_tpu_torch.ops.resident, on the CPU:
the plain version (``multi_step``) and the wrapper on CPU tensors against
the JAX package's ``_kernel_resident`` in interpret mode
(``ResidentStep``), run as tests/test_resident.py runs it, with one row
block and with several. The CUDA kernel itself is compared with the
plain version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: cells rtol 2e-5 / atol 5e-8 and tot rtol 1e-4, the repo's
kernel-vs-reference bounds (tests/test_pallas.py:204-207).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.ops.pallas_resident import ResidentStep
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state, initial_state_np
from lbm_tpu_torch.ops import fused, resident
from lbm_tpu_torch.ops import reference as ref_ops

torch.set_num_threads(2)

RTOL, ATOL, TOT_RTOL = 2e-5, 5e-8, 1e-4


def _params(ny, nx, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _jax_resident(p, gsteps):
    """One ``ResidentStep`` call of ``gsteps`` steps from rest."""
    obstacles = jnp.asarray(generate_obstacles(p.nx, p.ny))
    impl = ResidentStep(p, gsteps)
    prepared = impl.prepare(obstacles)
    carry, tots = impl.step(impl.init(initial_state(p), prepared), prepared)
    return np.asarray(impl.final(carry)), np.asarray(tots)


def _port(p, gsteps):
    """multi_step and the wrapper on CPU tensors, from rest."""
    mask = torch.from_numpy(generate_obstacles(p.nx, p.ny))
    c0 = torch.from_numpy(initial_state_np(p))
    args = (mask, p.accel_w1, p.accel_w2, p.omega, gsteps)
    plain = ref_ops.multi_step(c0, *args)
    wrapped = resident.resident(c0, *args)
    return plain, wrapped


def _assert_matches(got, tots, want, want_tots):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), want_tots, rtol=TOT_RTOL)


def test_matches_resident_step_single_block():
    p = _params(32, 128, 8)
    want, want_tots = _jax_resident(p, 8)
    (c, t), (cw, tw) = _port(p, 8)
    _assert_matches(c, t, want, want_tots)
    _assert_matches(cw, tw, want, want_tots)


def test_matches_resident_step_multiblock(monkeypatch):
    """Several of the TPU kernel's row blocks per step (by=8), as
    tests/test_resident.py forces them."""
    monkeypatch.setattr(pf, "_SLOT_BYTES", 8 * 9 * 64 * 4)
    p = _params(32, 64, 6)
    assert pf._pick_block_rows(p.ny, p.nx) == 8
    want, want_tots = _jax_resident(p, 6)
    (c, t), (cw, tw) = _port(p, 6)
    _assert_matches(c, t, want, want_tots)
    _assert_matches(cw, tw, want, want_tots)


@pytest.mark.parametrize("gsteps", [1, 4, 5])
def test_cpu_wrapper_keeps_the_kernels_buffer_parity(gsteps):
    """The result is in the first buffer after an even G and in the
    second after an odd one, as on the card; out[t:t+G] gets the scaled
    tots; nothing launches."""
    p = _params(24, 40, gsteps)
    rng = np.random.default_rng(gsteps)
    a = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 24, 40)).astype(np.float32))
    a0 = a.clone()
    b = torch.empty_like(a)
    mask = torch.from_numpy(generate_obstacles(40, 24))
    kernel = resident.Resident(mask, p.accel_w1, p.accel_w2, p.omega, gsteps)
    assert kernel.steps_per_call == gsteps
    av = torch.full((gsteps + 4,), -1.0)
    before = dict(fused.LAUNCHES)
    new, spare = kernel.run(a, b, av, 2, 0.25)
    assert (new, spare) == ((a, b) if gsteps % 2 == 0 else (b, a))
    want, want_tots = ref_ops.multi_step(a0, mask, p.accel_w1, p.accel_w2,
                                         p.omega, gsteps)
    assert torch.equal(new, want)
    assert torch.equal(av[2:2 + gsteps], want_tots * 0.25)
    assert (av[:2] == -1).all() and (av[2 + gsteps:] == -1).all()
    assert fused.LAUNCHES == before, "no kernel launches on the CPU"


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mask = torch.from_numpy(generate_obstacles(16, 8))
    with pytest.raises(ValueError, match="positive"):
        resident.Resident(mask, 1e-5, 1e-6, 1.85, 0)
    kernel = resident.Resident(mask, 1e-5, 1e-6, 1.85, 4)
    a, b = torch.ones(9, 8, 16), torch.empty(9, 8, 16)
    with pytest.raises(ValueError, match="slice"):
        kernel.run(a, b, torch.empty(6), 3)  # out[3:7] of 6
    with pytest.raises(ValueError, match="shape"):
        kernel.run(torch.ones(9, 8, 15), b, torch.empty(6), 0)
    with pytest.raises(ValueError):
        resident.Resident(mask.to(torch.uint8), 1e-5, 1e-6, 1.85, 4)


def test_multi_step_is_n_fused_steps():
    p = _params(16, 24, 3)
    rng = np.random.default_rng(9)
    c0 = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 16, 24)).astype(np.float32))
    mask = torch.from_numpy(rng.random((16, 24)) < 0.1)
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    got, tots = ref_ops.multi_step(c0, *args, 3)
    c = c0
    for n in range(3):
        c, tot = ref_ops.fused_step(c, *args)
        assert float(tots[n]) == float(tot)
    assert torch.equal(got, c)
    with pytest.raises(ValueError, match="positive"):
        ref_ops.multi_step(c0, *args, 0)
