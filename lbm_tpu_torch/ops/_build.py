"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``lbm_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface, on first use, into
``build/lbm_tpu_torch/`` beside the package (a directory ``.gitignore``
lists). The library is named by a hash of the sources and the flags, so
an edit rebuilds it; it is loaded with ``ctypes``. Nothing here runs at
import time: a CPU-only machine imports this module and never builds.
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
# --use_fast_math, so division and sqrt stay IEEE; nvcc's default FMA
# contraction stays on. -Xptxas -v reports registers/spills in the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c_int, _c_float, _c_void_p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# Explicit signatures: without them ctypes truncates pointers to 32 bits
# and passes floats as ints.
_SIGNATURES = {
    "lbm_fused_step": (
        [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int,
         _c_float, _c_float, _c_float, _c_int, _c_int, _c_void_p],
        _c_int,
    ),
    "lbm_reduce_tot": (
        [_c_void_p, _c_int, _c_float, _c_void_p, _c_int, _c_void_p], _c_int
    ),
    "lbm_num_partials": ([_c_int, _c_int], _c_int),
    "lbm_max_rows": ([], _c_int),
    "lbm_error_string": ([_c_int], ctypes.c_char_p),
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblbm_kernels-{h.hexdigest()[:16]}.so"


def nvcc_command(out: Path | None = None) -> list[str]:
    out = library_path() if out is None else out
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            *(str(s) for s in sources())]


def build() -> tuple[Path, float]:
    """Compile the library unless this source hash is already built.
    Returns ``(path, seconds spent compiling)``; raises on failure."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name and rename: concurrent builds never
    # load a half-written library.
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    res = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}) building {out.name}:\n"
            + (res.stderr or res.stdout)[-4000:]
        )
    os.replace(tmp, out)
    return out, seconds


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


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if code != 0:
        msg = lib.lbm_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
