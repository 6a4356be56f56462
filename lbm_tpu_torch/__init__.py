"""lbm_tpu_torch — the PyTorch/CUDA port of ``lbm_tpu``.

The same D2Q9 BGK lattice-Boltzmann solver, scene files and output
formats as :mod:`lbm_tpu`, run with PyTorch on a CUDA device. The
per-step update (guarded forcing of row ny-2, pull streaming,
bounce-back, BGK collision and the |u| reduction) is one hand-written
CUDA kernel (``csrc/fused_step.cu``) on a GPU, and plain PyTorch ops
(:mod:`lbm_tpu_torch.ops.reference`) on the CPU.

The package imports ``torch`` and never ``jax``. The numpy-only scene
layer (params, obstacles, .dat I/O) is re-exported from ``lbm_tpu`` so
the byte formats cannot drift between the two packages.
"""

__version__ = "0.1.0"

# Lazy re-exports (PEP 562), the lbm_tpu idiom: importing the package
# pulls in neither torch nor the solver until a name is used.
_EXPORTS = {
    "Params": "lbm_tpu_torch.params",
    "load_params": "lbm_tpu_torch.params",
    "load_obstacles": "lbm_tpu_torch.obstacles",
    "initial_state": "lbm_tpu_torch.state",
    "D2Q9": "lbm_tpu_torch.state",
    "SimulationResult": "lbm_tpu_torch.runner",
    "run_simulation": "lbm_tpu_torch.runner",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))


__all__ = [
    "Params",
    "load_params",
    "load_obstacles",
    "initial_state",
    "D2Q9",
    "SimulationResult",
    "run_simulation",
    "__version__",
]
