"""The tensor-core equilibrium's module of the port against the JAX
package's ``lbm_tpu/ops/mxu_eq.py``, and the kernel's schedule against its
plain version.

The same inputs, made from a seed with numpy, go through the JAX function
and its twin: ``equilibrium_matrix`` bit for bit; ``collide_stream_mxu`` at
rtol 5e-5 / atol 1e-7 (the bound of ``tests/test_pallas.py``'s own mxu
test: another f32 association of one step), also against the port's
``collide_stream`` in the reference order; ``mxu_multi_step`` over 200 steps
against a loop of JAX's ``accelerate_flow`` + ``collide_stream_mxu`` (the
body of ``scripts/mxu_probe.py``'s step) at the repo's trajectory rtol 1e-4.

The kernel's schedule (``mxu_device_emulated``: the device form's rounds of
depth tiles, each warp's products through the kernel's scratch slots and
fragment registers, one f64 product rounded to float32) against
``mxu_multi_step``: cells within ``mxu_eq.cells_atol`` (the kernel's
product bound, pinned here against a float64 product, and the plain f32
product's, summed over the steps), totals at rtol 1e-4; two swapped lanes
in either fragment map fail it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import mxu_eq as jmxu
from lbm_tpu.ops import reference as jref
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import fused, mxu_eq
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params

torch.set_num_threads(2)

RTOL, ATOL = 5e-5, 1e-7
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 5e-8
OMEGA = 1.85


def _case(name):
    """A seeded state near equilibrium (stable over many steps) or, for
    "uniform", each value in [0.01, 0.2] (held for one step), its mask, and
    the forcing of the scenes' params (accel 0.01) with the guard failing
    on part of the forced row."""
    ny, nx, kind, state = {
        "walls-48x64": (48, 64, "walls", "near"),
        "odd-13x24": (13, 24, "random", "near"),
        "interior-40x72": (40, 72, "interior", "near"),
        "uniform-24x40": (24, 40, "walls", "uniform"),
    }[name]
    rng = np.random.default_rng(len(name) + ny)
    p = Params(nx=nx, ny=ny, max_iters=200, reynolds_dim=10, density=0.1,
               accel=0.01, omega=OMEGA)
    if state == "uniform":
        cells = rng.uniform(0.01, 0.2, (9, ny, nx)).astype(np.float32)
    else:
        w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, np.float32) * 0.1
        cells = (w[:, None, None]
                 * (1 + 0.2 * (rng.random((9, ny, nx)) - 0.5))).astype(np.float32)
    cells[6, ny - 2, rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    if kind == "random":
        mask = rng.random((ny, nx)) < 0.15
    else:
        mask = generate_obstacles(nx, ny)
        if kind == "interior":
            mask[12:20, 30:33] = True
            mask |= rng.random((ny, nx)) < 0.04
    return p, cells, mask


STEP_CASES = ["walls-48x64", "odd-13x24", "uniform-24x40"]
RUN_CASES = ["walls-48x64", "odd-13x24", "interior-40x72"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_equilibrium_matrix_is_the_jax_one_bit_for_bit(dtype):
    np_type = np.float32 if dtype == torch.float32 else np.float64
    got = mxu_eq.equilibrium_matrix(dtype).numpy()
    want = jmxu.equilibrium_matrix(np_type)
    assert got.dtype == want.dtype and got.shape == (9, 6)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("case", STEP_CASES)
def test_collide_stream_mxu_matches_the_jax_function(case):
    p, cells, mask = _case(case)
    want, want_tot = jmxu.collide_stream_mxu(jnp.asarray(cells),
                                             jnp.asarray(mask), p.omega)
    got, tot = mxu_eq.collide_stream_mxu(torch.from_numpy(cells),
                                         torch.from_numpy(mask), p.omega)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert np.isclose(float(tot), float(want_tot), rtol=1e-4)


@pytest.mark.parametrize("case", STEP_CASES)
def test_collide_stream_mxu_matches_the_reference_order(case, monkeypatch):
    """The product is the reference equilibrium, reassociated: one step
    against the port's collide_stream under LBM_PAIRED_EQ=0."""
    monkeypatch.setenv("LBM_PAIRED_EQ", "0")
    p, cells, mask = _case(case)
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    want, want_tot = ref_ops.collide_stream(c, m, p.omega)
    got, tot = mxu_eq.collide_stream_mxu(c, m, p.omega)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert np.isclose(float(tot), float(want_tot), rtol=1e-4)


def test_mxu_multi_step_matches_the_jax_probe_step():
    """200 steps of the kernel's plain version against a loop of the body
    of scripts/mxu_probe.py's step."""
    p, cells, mask = _case("walls-48x64")
    c, m = jnp.asarray(cells), jnp.asarray(mask)
    want_tots = []
    for _ in range(200):
        c = jref.accelerate_flow(c, m, p.accel_w1, p.accel_w2)
        c, tot = jmxu.collide_stream_mxu(c, m, p.omega)
        want_tots.append(float(tot))
    got, tots = mxu_eq.mxu_multi_step(torch.from_numpy(cells),
                                      torch.from_numpy(mask), p.accel_w1,
                                      p.accel_w2, p.omega, 200)
    np.testing.assert_allclose(got.numpy(), np.asarray(c), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL)
    np.testing.assert_allclose(tots.numpy(), want_tots, rtol=TRAJ_RTOL)


def _phi(rng, shape):
    """Feature vectors of plausible cells: rho in [0.05, 0.2], |u| up to
    0.2 in each direction."""
    rho = rng.uniform(0.05, 0.2, shape)
    ux, uy = rng.uniform(-0.2, 0.2, shape), rng.uniform(-0.2, 0.2, shape)
    return np.stack([rho, rho * ux, rho * uy, rho * ux * ux, rho * uy * uy,
                     rho * ux * uy], axis=-2).astype(np.float32)


@pytest.mark.parametrize("P", [64, 32, 16])
def test_the_products_keep_their_bound(P):
    """The warps' products: W phi (W in float32) in f64, rounded once to
    float32, bit for bit; within EPS_F64_PRODUCT |W| |phi| of the float64
    map's W phi everywhere, as a plain float32 product is within
    EPS_F32_PRODUCT."""
    rng = np.random.default_rng(P)
    phi = torch.from_numpy(_phi(rng, (5, P)))          # (5 warps, 6, P)
    got = mxu_eq.warp_products(phi, P)
    w32 = mxu_eq.equilibrium_matrix(torch.float32)
    assert torch.equal(got, torch.einsum("kf,nfc->nkc", w32.double(),
                                         phi.double()).float())
    exact = torch.einsum("kf,nfc->nkc", mxu_eq.equilibrium_matrix(
        torch.float64), phi.double())
    bound = torch.stack([mxu_eq.product_bound(x) for x in phi])
    assert float(((got.double() - exact).abs() / bound).max()) <= 1.0
    plain = torch.einsum("kf,nfc->nkc", w32, phi).double()
    eps = mxu_eq.EPS_F32_PRODUCT / mxu_eq.EPS_F64_PRODUCT
    assert float(((plain - exact).abs() / bound).max()) <= eps


def test_a_fragments_hold_w():
    """The A registers, put back by the PTX layout: W (float32) in f64,
    zero outside it."""
    a = mxu_eq._matrix(torch.from_numpy(mxu_eq.a_fragments()), mxu_eq.PTX_A,
                       (16, 8))
    assert a.dtype == torch.float64
    assert torch.equal(a[:9, :6], mxu_eq.equilibrium_matrix().double())
    assert not a[9:].any() and not a[:, 6:].any()


@pytest.mark.parametrize("P", [64, 32, 16])
def test_the_scratch_maps_cover_each_slot_once(P):
    """Each plane of each cell has its own slot; every phi slot is loaded
    into exactly one lane's register across the warp's products, and
    every feq slot is stored by exactly one."""
    owners = mxu_eq.owner_slots(9, P)
    assert sorted(owners.ravel()) == list(range(9 * P))
    loads = mxu_eq.b_loads(P)
    loaded = loads[loads >= 0]
    assert sorted(loaded) == sorted(owners[:6].ravel())
    stores = mxu_eq.d_stores(P)
    stored = stores[stores >= 0]
    assert sorted(stored) == sorted(owners.ravel())


@pytest.mark.parametrize("gsteps", [3, 6])
@pytest.mark.parametrize("case", RUN_CASES)
def test_device_schedule_matches_the_plain_version(case, gsteps):
    """The kernel's rounds (G=3: three of one step, the depth-1 window
    whose last warp holds 16 cells; G=6: 4 + 2, the depth-2 window's last
    warp 32) with the warps' products: cells within cells_atol, totals at
    rtol 1e-4."""
    p, cells, mask = _case(case)
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    want, want_tots = mxu_eq.mxu_multi_step(c, m, p.accel_w1, p.accel_w2,
                                            p.omega, gsteps)
    got, tots = mxu_eq.mxu_device_emulated(c, m, p.accel_w1, p.accel_w2,
                                           p.omega, gsteps)
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= mxu_eq.cells_atol(gsteps, p.omega), err
    np.testing.assert_allclose(tots.numpy(), want_tots.numpy(),
                               rtol=mxu_eq.TOT_RTOL)


@pytest.mark.parametrize("table", ["b_loads", "d_stores"])
def test_swapped_lanes_fail_the_emulation(table, monkeypatch):
    """Two lanes' entries of a fragment map swapped: the emulation puts
    some cell's features or equilibria in another's place, and its cells
    land far outside the bound."""
    p, cells, mask = _case("walls-48x64")
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    real = getattr(mxu_eq, table)

    def swapped(P):
        t = real(P).copy()
        t[:, [5, 9]] = t[:, [9, 5]]
        return t

    monkeypatch.setattr(mxu_eq, table, swapped)
    want, _ = mxu_eq.mxu_multi_step(c, m, p.accel_w1, p.accel_w2, p.omega, 4)
    got, _ = mxu_eq.mxu_device_emulated(c, m, p.accel_w1, p.accel_w2,
                                        p.omega, 4)
    err = float((got - want).abs().nan_to_num(1.0).max())
    assert err > 100 * mxu_eq.cells_atol(4, p.omega), err


@pytest.mark.parametrize("gsteps", [4, 5])
def test_the_wrapper_on_a_cpu_tensor_runs_the_plain_version(gsteps):
    """MxuStep.run on the CPU: mxu_multi_step's cells in the buffer the
    contract names (the first after an even G, the second after an odd
    one), its tots scaled into out[t:t + G], no launch counted."""
    p, cells, mask = _case("walls-48x64")
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    kernel = mxu_eq.MxuStep(m, p.accel_w1, p.accel_w2, p.omega, gsteps)
    a, b = c.clone(), torch.zeros_like(c)
    out = torch.zeros(gsteps + 2)
    before = dict(fused.LAUNCHES)
    cells_out, spare = kernel.run(a, b, out, 1, 0.5)
    want, want_tots = mxu_eq.mxu_multi_step(c, m, p.accel_w1, p.accel_w2,
                                            p.omega, gsteps)
    assert (cells_out is a) == (gsteps % 2 == 0) and spare is not cells_out
    assert torch.equal(cells_out, want)
    assert torch.equal(out[1:1 + gsteps], want_tots * 0.5)
    assert out[0] == 0 and out[-1] == 0
    assert fused.LAUNCHES == before
    with pytest.raises(ValueError):
        mxu_eq.MxuStep(m, p.accel_w1, p.accel_w2, p.omega, 0)


def test_the_product_refuses_tf32(monkeypatch):
    """The counterpart of Precision.HIGHEST: with TF32 allowed, or a
    float32 matmul precision below "highest", the step raises instead of
    running another function."""
    p, cells, mask = _case("walls-48x64")
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full float32"):
        mxu_eq.collide_stream_mxu(c, m, p.omega)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            mxu_eq.mxu_multi_step(c, m, p.accel_w1, p.accel_w2, p.omega, 1)
    finally:
        torch.set_float32_matmul_precision(before)
    mxu_eq.collide_stream_mxu(c, m, p.omega)
