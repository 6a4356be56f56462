"""The port's C host module (``lbm_tpu_torch/csrc_host/lbm_io.c``): its
``final_state.dat`` and ``av_vels.dat`` bytes against the port's plain
numpy writers and against ``lbm_tpu.io``'s Python writers, its obstacle
parser's masks and error texts against the plain parser's, and the build
that raises instead of giving way to the numpy writers."""

import numpy as np
import pytest

from lbm_tpu import io as jio
from lbm_tpu import obstacles as jobs
from lbm_tpu.params import Params as JParams
from lbm_tpu_torch import io as tio
from lbm_tpu_torch import obstacles as tobs
from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.params import Params


def _params(nx, ny, dtype=np.float32):
    return Params(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85, dtype=dtype)


def _jparams(p):
    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters,
                   reynolds_dim=p.reynolds_dim, density=p.density,
                   accel=p.accel, omega=p.omega, dtype=p.dtype)


def _three_writers(tmp_path, p, cells, mask):
    """The bytes of the C writer, the plain writer and lbm_tpu's."""
    paths = [tmp_path / n for n in ("c.dat", "plain.dat", "jax.dat")]
    tio.write_final_state(paths[0], p, cells, mask)
    tio.write_final_state_plain(paths[1], p, cells, mask)
    jio.write_final_state(paths[2], _jparams(p), cells, mask)
    return [path.read_bytes() for path in paths]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (128, 64)])
def test_final_state_bytes_equal_both_python_writers(tmp_path, shape, dtype):
    nx, ny = shape
    rng = np.random.default_rng(nx * ny)
    p = _params(nx, ny, dtype)
    cells = rng.uniform(0.001, 0.2, (9, ny, nx)).astype(dtype)
    mask = rng.random((ny, nx)) < 0.2
    got, plain, jax = _three_writers(tmp_path, p, cells, mask)
    assert got == plain == jax
    assert got.count(b"\n") == nx * ny


def test_final_state_of_a_transposed_lattice(tmp_path):
    """Fields that are not C-contiguous (a lattice transposed back, as
    the runner returns a wide grid's) are written in (jj, ii) order."""
    rng = np.random.default_rng(2)
    p = _params(24, 10)
    cells = rng.uniform(0.01, 0.2, (9, 24, 10)).astype(np.float32)
    cells = cells.transpose(0, 2, 1)
    mask = np.asfortranarray(rng.random((10, 24)) < 0.3)
    assert not cells.flags.c_contiguous and not mask.flags.c_contiguous
    got, plain, jax = _three_writers(tmp_path, p, cells, mask)
    assert got == plain == jax


def test_final_state_nan_from_an_empty_fluid_cell(tmp_path):
    """0/0 on x86 is a NaN with the sign bit set: glibc's printf prints
    -NAN, Python prints NAN."""
    p = _params(6, 4)
    cells = np.full((9, 4, 6), 0.01, np.float32)
    cells[:, 2, 3] = 0.0
    mask = np.zeros((4, 6), bool)
    u_x = tio.final_state_fields(p, cells, mask)[0]
    assert np.isnan(u_x[2, 3])
    got, plain, jax = _three_writers(tmp_path, p, cells, mask)
    assert got == plain == jax
    assert b" NAN NAN NAN " in got and b"-NAN" not in got


SPECIALS = [0.0, -0.0, 1e30, -1e30, np.inf, -np.inf, np.nan, -np.nan,
            1e-45, -3e-42, 1.17e-38, 2.2250738585072014e-308, 5e-324,
            0.1, 1 / 3, 9.9999999999995, 9.99999999999949, 12345678901235.0,
            12345678901225.0, 1e13, 1e25, 1e26, 1e300, 2.5e-7, 0.5]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_final_state_special_values(tmp_path, monkeypatch, dtype):
    """-0.0, subnormals, 1e30, infinities, NaNs of either sign, exact
    ties at the 13th digit, through all three writers."""
    with np.errstate(over="ignore"):
        vals = np.array(SPECIALS, dtype=np.float64).astype(dtype)
    n = len(vals)
    fields = [np.roll(vals, k).reshape(1, n) for k in range(4)]
    for mod in (tio, jio):
        monkeypatch.setattr(mod, "final_state_fields",
                            lambda *a, **k: tuple(fields))
    p = _params(n, 1, dtype)
    mask = np.zeros((1, n), bool)
    got, plain, jax = _three_writers(tmp_path, p, np.zeros((9, 1, n), dtype),
                                     mask)
    assert got == plain == jax
    assert b"-0.000000000000E+00" in got and b"-INF" in got


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_av_vels_random_bit_patterns(tmp_path, dtype):
    """Every finite magnitude a float can hold, as random bit patterns."""
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2**63, 4000, dtype=np.int64)
    if dtype == np.float32:
        vals = (bits >> 32).astype(np.uint32).view(np.float32)
    else:
        vals = bits.view(np.float64)
    tio.write_av_vels(tmp_path / "c.dat", vals)
    tio.write_av_vels_plain(tmp_path / "plain.dat", vals)
    assert (tmp_path / "c.dat").read_bytes() == \
        (tmp_path / "plain.dat").read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_printf_only_build_writes_the_same_bytes(tmp_path, dtype):
    """The A/B variant that scripts/writer_ab_torch.py times (glibc's
    printf for every field) against the port's formatter, on random bit
    patterns and the special values; it is a library of its own hash."""
    printf_only = ("-DLBM_IO_PRINTF_ONLY",)
    assert _build.host_library_path(printf_only) != _build.host_library_path()
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2**63, 4000, dtype=np.int64)
    if dtype == np.float32:
        vals = (bits >> 32).astype(np.uint32).view(np.float32)
    else:
        vals = bits.view(np.float64)
    with np.errstate(over="ignore"):
        special = np.array(SPECIALS, dtype=np.float64).astype(dtype)
    vals = np.ascontiguousarray(np.concatenate([vals, special]))
    out = []
    for defines in ((), printf_only):
        path = tmp_path / f"{len(defines)}.dat"
        tio._host_call(path, _build.load_host(defines).lbm_write_av_vels,
                       vals.size, vals.ctypes.data,
                       int(dtype == np.float64))
        out.append(path.read_bytes())
    assert out[0] == out[1]
    tio.write_av_vels_plain(tmp_path / "plain.dat", vals)
    assert out[0] == (tmp_path / "plain.dat").read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [0, 1, 17])
def test_av_vels_bytes_equal(tmp_path, n, dtype):
    rng = np.random.default_rng(n)
    av = (rng.uniform(0, 1e-3, n) * 10.0 ** rng.integers(-6, 3, n)).astype(dtype)
    tio.write_av_vels(tmp_path / "c.dat", av)
    tio.write_av_vels_plain(tmp_path / "plain.dat", av)
    jio.write_av_vels(tmp_path / "jax.dat", av)
    got = (tmp_path / "c.dat").read_bytes()
    assert got == (tmp_path / "plain.dat").read_bytes()
    assert got == (tmp_path / "jax.dat").read_bytes()
    assert got.count(b"\n") == n


def test_writer_reports_an_unwritable_path(tmp_path):
    p = _params(4, 3)
    cells = np.full((9, 3, 4), 0.01, np.float32)
    with pytest.raises(FileNotFoundError):
        tio.write_final_state(tmp_path / "no" / "fs.dat", p, cells,
                              np.zeros((3, 4), bool))
    with pytest.raises(IsADirectoryError):
        tio.write_av_vels(tmp_path, np.zeros(3, np.float32))


GOOD_OBSTACLES = {
    "lines": "0 0 1\n3 1 1\n0 0 1\n",
    "one line": "0 0 1 3 1 1 5 2 1",
    "signs and underscores": "+1 0 1\n0_0 1 1\n 0\t2\r\n1\n",
    "empty": "",
    "whitespace only": " \n\t\n",
}


@pytest.mark.parametrize("name", list(GOOD_OBSTACLES))
def test_load_obstacles_masks_equal(tmp_path, name):
    path = tmp_path / "obs.dat"
    path.write_text(GOOD_OBSTACLES[name])
    got = tobs.load_obstacles(path, 8, 4)
    assert got.dtype == bool and got.shape == (4, 8)
    np.testing.assert_array_equal(got, tobs.load_obstacles_plain(path, 8, 4))
    np.testing.assert_array_equal(got, jobs.load_obstacles(path, 8, 4))


def test_load_obstacles_large_mask(tmp_path):
    rng = np.random.default_rng(4)
    mask = tobs.generate_obstacles(300, 200) | (rng.random((200, 300)) < 0.3)
    tobs.write_obstacles(tmp_path / "obs.dat", mask)
    np.testing.assert_array_equal(
        tobs.load_obstacles(tmp_path / "obs.dat", 300, 200), mask)


BAD_OBSTACLES = {
    "two values": "1 2\n",
    "x out of range": "8 0 1\n",
    "negative x": "-1 0 1\n",
    "y out of range": "0 4 1\n",
    "blocked 2": "1 1 2\n",
    "a word": "1 1 one\n",
    "a float": "1 1 1.0\n",
    "trailing underscore": "1_ 1 1\n",
    "double underscore": "1__0 1 1\n",
    "sign only": "+ 1 1\n",
    # The plain parser checks every x, then every y, then every flag.
    "y before x": "0 9 1\n9 0 1\n",
    "flag before y": "0 0 7\n0 9 1\n",
    "word after range": "9 9 9\n1 x 1\n",
    "beyond int64": "99999999999999999999 0 1\n",
    "count before range": "9 9 1 0\n",
}


@pytest.mark.parametrize("name", list(BAD_OBSTACLES))
def test_load_obstacles_errors_equal(tmp_path, name):
    path = tmp_path / "obs.dat"
    path.write_text(BAD_OBSTACLES[name])
    with pytest.raises((ValueError, OverflowError)) as want:
        tobs.load_obstacles_plain(path, 8, 4)
    with pytest.raises(type(want.value)) as got:
        tobs.load_obstacles(path, 8, 4)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_load_obstacles_missing_file(tmp_path):
    path = tmp_path / "none.dat"
    with pytest.raises(FileNotFoundError) as want:
        tobs.load_obstacles_plain(path, 8, 4)
    with pytest.raises(FileNotFoundError) as got:
        tobs.load_obstacles(path, 8, 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cc", ["no-such-compiler-lbm", "false"])
def test_a_failed_build_raises(tmp_path, monkeypatch, cc):
    """No compiler, or one that fails: the writers raise with the
    compiler's message and never fall back to the numpy writers."""
    monkeypatch.setenv("CC", cc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=cc):
        _build.build_host()
    out = tmp_path / "av.dat"
    with pytest.raises(RuntimeError, match=cc):
        tio.write_av_vels(out, np.zeros(3, np.float32))
    assert not out.exists()
    with pytest.raises(RuntimeError, match=cc):
        tobs.load_obstacles(out, 4, 4)


def test_the_library_is_keyed_by_source_and_compiler(monkeypatch):
    monkeypatch.delenv("CC", raising=False)
    path = _build.host_library_path()
    assert _build.host_compiler() == "cc"
    assert path.parent == _build.BUILD_DIR and path.name.startswith("liblbm_io-")
    monkeypatch.setenv("CC", "gcc")
    assert _build.host_library_path() != path
