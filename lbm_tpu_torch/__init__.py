"""lbm_tpu_torch — the PyTorch/CUDA port of ``lbm_tpu``.

The same D2Q9 BGK lattice-Boltzmann solver, scene files and output
formats as :mod:`lbm_tpu`, run with PyTorch on a CUDA device. The
update (guarded forcing of row ny-2, pull streaming, bounce-back, BGK
collision and the |u| reduction) runs in hand-written CUDA kernels on a
GPU (``csrc/``: one step, D steps or G steps per launch, chosen by
:mod:`lbm_tpu_torch.ops.plan`), and as plain PyTorch ops
(:mod:`lbm_tpu_torch.ops.reference`) on the CPU. With a mesh
(``run_simulation(..., mesh=)``, the CLI's ``--devices``) the rows are
sharded over a list of devices, which may repeat one card
(:mod:`lbm_tpu_torch.parallel`: the seam modes of the one-step and depth
kernels, and the ring kernel).

The package imports ``torch``, never ``jax`` and nothing of ``lbm_tpu``:
the numpy-only scene layer (params, obstacles, .dat I/O, the checker) is
the port's own copy, held byte-identical to ``lbm_tpu``'s by the tests.
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
    "Mesh": "lbm_tpu_torch.parallel.decomp",
    "make_mesh": "lbm_tpu_torch.parallel.decomp",
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
    "Mesh",
    "make_mesh",
    "__version__",
]
