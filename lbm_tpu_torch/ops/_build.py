"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``lbm_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface, on first use, into
``build/lbm_tpu_torch/`` beside the package (a directory ``.gitignore``
lists; :func:`set_build_dir`, the CLI's ``--compilation-cache``, names
another): one ``nvcc -c`` per source, all started together, then one link.
The library is named by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds it; it is loaded
with ``ctypes``. Nothing here runs at
import time: a CPU-only machine imports this module and never builds.

The host compiler builds the port's one C file for the CPU,
``csrc_host/lbm_io.c`` (the ``.dat`` writers and the obstacle parser),
the same way: on first use, into the same directory, named by a hash of
the source, the compiler and its flags (:func:`build_host`,
:func:`load_host`). It builds on any machine with a C compiler, the CPU
test machine included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "lbm_tpu_torch"

# sm_90a (Hopper with its architecture-specific features); no
# --use_fast_math, so division and sqrt stay IEEE. -fmad=false: no
# multiply-add contraction, so each kernel rounds every operation as
# written, in the order of the plain PyTorch version. With contraction
# on, ptxas fused a different set of multiply-adds in each kernel (and
# after a refactor of one), so kernels sharing lbm_cell.cuh disagreed in
# the last bit. -Xptxas -v reports registers/spills in the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# Explicit signatures: without them ctypes truncates pointers to 32 bits
# and passes floats as ints.
_SIGNATURES = {
    "lbm_fused_step": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int,
         _c_float, _c_float, _c_float, _c_int, _c_int, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_reduce_tot": (
        [_c_void_p, _c_int, _c_float, _c_void_p, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_num_partials": ([_c_int, _c_int], _c_int),
    "lbm_max_rows": ([], _c_int),
    "lbm_fused_depth": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int,
         _c_float, _c_float, _c_float, _c_int, _c_int, _c_int, _c_float,
         _c_void_p, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_depth_num_partials": ([_c_int, _c_int, _c_int], _c_int),
    "lbm_depth_block_slots": ([_c_int, _c_int], _c_int),
    "lbm_fused_depth_flow": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int,
         _c_int, _c_int, _c_float, _c_float, _c_float, _c_int, _c_int,
         _c_float, _c_void_p, _c_int, ctypes.c_uint, _c_int, _c_int, _c_int,
         _c_void_p],
        _c_int,
    ),
    "lbm_depth_max_rows": ([_c_int], _c_int),
    "lbm_resident": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_int, _c_int, _c_int, _c_float, _c_float, _c_float, _c_int,
         _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_int, _c_int,
         _c_void_p],
        _c_int,
    ),
    "lbm_resident_shift": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_void_p, _c_int, _c_int, _c_int, _c_float, _c_float, _c_float,
         _c_int, _c_int, _c_float, _c_int, _c_int, _c_int, _c_int,
         _c_void_p],
        _c_int,
    ),
    "lbm_shift_owners": ([_c_int, _c_int, _c_int], _c_int),
    "lbm_shift_smem_bytes": ([_c_int, _c_int, _c_int], ctypes.c_longlong),
    "lbm_shift_edge_floats": ([_c_int, _c_int, _c_int], ctypes.c_longlong),
    "lbm_resident_blocks": ([_c_int, _c_int, _c_int, _c_int, _c_int],
                            _c_int),
    "lbm_sm_count": ([_c_int], _c_int),
    "lbm_smem_optin": ([_c_int], _c_int),
    "lbm_onchip_smem_bytes": (
        [_c_int, _c_int, _c_int, _c_int], ctypes.c_longlong),
    "lbm_onchip_prepare": (
        [_c_int, _c_int, _c_int, ctypes.c_longlong, _c_int, _c_int], _c_int),
    "lbm_resident_onchip": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_void_p, _c_int, _c_int, _c_int, _c_float, _c_float,
         _c_float, _c_int, _c_int, _c_float, ctypes.c_uint, _c_int, _c_int,
         _c_int, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_fused_step_seam": ([_c_void_p, _c_int, _c_int, _c_void_p], _c_int),
    "lbm_seam_num_partials": ([_c_int, _c_int, _c_int], _c_int),
    "lbm_seam_max_rows": ([_c_int], _c_int),
    "lbm_fused_depth_seam": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_void_p, _c_int, _c_void_p, _c_int, _c_int, _c_int, _c_int,
         _c_float, _c_float, _c_float, _c_int, _c_int, _c_int, _c_float,
         _c_void_p, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_ring_blocks": ([_c_int, _c_int, _c_int], _c_int),
    "lbm_enable_peer_access": ([_c_int, _c_int], _c_int),
    "lbm_ring": (
        [_c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float,
         _c_float, _c_float, _c_int, _c_int, _c_int, _c_int, ctypes.c_uint,
         _c_int, _c_int, _c_int, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_ring_onchip_prepare": (
        [_c_int, _c_int, _c_int, _c_int, ctypes.c_longlong, _c_int, _c_int],
        _c_int),
    "lbm_ring_onchip": (
        [_c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float,
         _c_float, _c_float, _c_int, _c_int, _c_int, _c_int, ctypes.c_uint,
         _c_int, _c_int, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_probe": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_int, _c_int, _c_float, _c_int, _c_int, _c_int, _c_int, _c_int,
         _c_int, _c_int, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_probe_blocks": ([_c_int, _c_int, _c_int, _c_int], _c_int),
    "lbm_mxu_blocks": ([_c_int, _c_int, _c_int], _c_int),
    "lbm_mxu_resident": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_int, _c_int, _c_int, _c_float, _c_float, _c_float, _c_int,
         _c_int, _c_int, _c_int, _c_float, _c_void_p, _c_int, _c_int,
         _c_void_p],
        _c_int,
    ),
    "lbm_error_string": ([_c_int], ctypes.c_char_p),
}

_c_char_p = ctypes.c_char_p
_HOST_SIGNATURES = {
    "lbm_write_final_state": (
        [_c_char_p, _c_int, _c_int, _c_void_p, _c_void_p, _c_void_p,
         _c_void_p, _c_void_p, _c_int],
        _c_int,
    ),
    "lbm_write_av_vels": (
        [_c_char_p, ctypes.c_longlong, _c_void_p, _c_int], _c_int),
    "lbm_read_obstacles": ([_c_char_p, _c_int, _c_int, _c_void_p], _c_int),
}
HOST_CSRC = PACKAGE_DIR / "csrc_host"
# -O2 and no -ffast-math: the writers' formatting is exact integer
# arithmetic, and the compiler may not reassociate it.
HOST_CFLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_host_libs: dict = {}


def set_build_dir(path) -> Path:
    """Build and reuse the kernels' and the host module's libraries in the
    directory ``path`` from now on (each still named by its sources'
    hash). Raises if ``path`` is not a directory this process can write."""
    global BUILD_DIR
    d = Path(path).resolve()
    if not d.is_dir():
        raise FileNotFoundError(f"compilation cache {path}: no such directory")
    if not os.access(d, os.W_OK | os.X_OK):
        raise PermissionError(f"compilation cache {path}: not writable")
    BUILD_DIR = d
    return d


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblbm_kernels-{h.hexdigest()[:16]}.so"


def compile_commands(obj_dir: Path) -> list[list[str]]:
    """One ``nvcc -c`` per source, its object in ``obj_dir``."""
    return [[nvcc_path(), *NVCC_FLAGS, "-c", "-o",
             str(obj_dir / f"{src.stem}.o"), str(src)] for src in sources()]


def link_command(obj_dir: Path, out: Path | None = None) -> list[str]:
    out = library_path() if out is None else out
    return [nvcc_path(), *NVCC_FLAGS, "-shared", "-o", str(out),
            *(str(obj_dir / f"{src.stem}.o") for src in sources())]


def build() -> tuple[Path, float]:
    """Compile the library unless this source hash is already built.
    Returns ``(path, seconds spent compiling)``; raises on failure."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under private names and rename: concurrent builds never
    # load a half-written library.
    obj_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    try:
        procs = [(cmd, _start(cmd)) for cmd in compile_commands(obj_dir)]
        results = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
        if all(rc == 0 for _, _, rc in results):
            cmd = link_command(obj_dir, tmp)
            p = _start(cmd)
            results.append((cmd, p.communicate()[0], p.returncode))
        out.with_suffix(".log").write_text(
            "".join(f"$ {' '.join(cmd)}\n{text}" for cmd, text, _ in results)
        )
        for cmd, text, rc in results:
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed (exit {rc}) on {cmd[-1]} "
                                   f"building {out.name}:\n{text[-4000:]}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return out, time.perf_counter() - t0


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load() -> ctypes.CDLL:
    """The built kernel library, built on first use, with its C
    signatures declared."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def host_sources() -> list[Path]:
    return sorted(HOST_CSRC.glob("*.c"))


def host_compiler() -> str:
    """The host C compiler: ``$CC``, else ``cc``."""
    return os.environ.get("CC") or "cc"


def host_library_path(defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for src in host_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((host_compiler(), *HOST_CFLAGS, *defines)).encode())
    return BUILD_DIR / f"liblbm_io-{h.hexdigest()[:16]}.so"


def build_host(defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc_host/*.c`` with the host compiler and ``defines``
    (``-D`` flags; the port uses none, ``scripts/writer_ab_torch.py``
    builds an A/B variant) unless this hash is built; raises with the
    compiler's message on failure."""
    out = host_library_path(defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [host_compiler(), *HOST_CFLAGS, *defines, "-o", str(tmp),
           *(str(src) for src in host_sources())]
    try:
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(f"host compiler {cmd[0]!r} could not run "
                           f"building {out.name}: {exc}") from exc
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed (exit {p.returncode}) building "
                           f"{out.name}:\n{p.stdout[-4000:]}")
    os.replace(tmp, out)
    return out


def load_host(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built host library, built on first use, with its C
    signatures declared."""
    path = build_host(defines)
    lib = _host_libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _HOST_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _host_libs[path] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if code != 0:
        msg = lib.lbm_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
