"""The benchmark's plain reference: the coursework's D2Q9 BGK solver
(``d2q9-bgk.c`` of georgeherbert/lattice-boltzmann) written again in plain
PyTorch, independent of the program under test.

It imports numpy and torch only: nothing of ``jax``, ``lbm_tpu`` or
``lbm_tpu_torch``. It takes a scene's published parameters and its mask
and works the whole scene out again from rest:

- the equilibrium at rest, ``density * w_k`` in every cell (obstacles
  included);
- each step: the guarded forcing of row ``ny - 2`` (a fluid cell whose
  speeds 3, 6 and 7 stay strictly positive after the subtraction gains
  ``w1 = density * accel / 9`` on speed 1, ``w2 = w1 / 4`` on speeds 5
  and 8, and loses them on 3, 6 and 7); pull streaming on the periodic
  lattice; bounce-back in obstacle cells and BGK relaxation towards the
  second-order equilibrium in fluid cells; ``av_vels[t]``, the mean
  ``|u|`` of the streamed state over fluid cells;
- the Reynolds number of the final state, its mean fluid ``|u|`` times
  ``reynolds_dim`` over the viscosity ``(2 / omega - 1) / 6``.

Several scenes of one grid and step count run together as a batch, each
with its own mask and parameters. The step is written in the textbook
order, with none of the program's association; the check runs it in
float64. Its control computes each step in float32 and rounds the state
to bfloat16 after it, as a program that kept its lattice in bfloat16
would. On a card the steps are replayed from
CUDA graphs of up to :data:`GRAPH_STEPS` steps, each captured from these
same operations, so that the launches of a small lattice do not set its
time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Q = 9
CX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
CY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
# Speeds the forcing raises and lowers (d2q9-bgk.c's accelerate_flow).
FORCE = (0.0, 1.0, 0.0, -1.0, 0.0, 0.25, -0.25, -0.25, 0.25)

GRAPH_STEPS = 100


def rest_state(density: float, ny: int, nx: int) -> np.ndarray:
    """The (9, ny, nx) equilibrium at rest in float64."""
    w = np.asarray(W, dtype=np.float64) * density
    return np.broadcast_to(w[:, None, None], (Q, ny, nx))


def viscosity(omega: float) -> float:
    return (2.0 / omega - 1.0) / 6.0


class _Batch:
    """The constant tensors of ``B`` scenes of one grid on a device."""

    def __init__(self, scenes, dtype, device):
        self.B = len(scenes)
        self.ny, self.nx = scenes[0].ny, scenes[0].nx
        n = self.ny * self.nx
        opt = dict(dtype=dtype, device=device)
        col = lambda vals: torch.tensor(vals, **opt).view(self.B, 1, 1)
        masks = torch.from_numpy(np.stack([s.mask for s in scenes])).to(device)
        self.obstacle = masks.view(self.B, 1, n)
        self.fluid = (~masks).view(self.B, n).to(dtype)
        self.fluid_row = ~masks[:, self.ny - 2, :]
        self.n_fluid = self.fluid.sum(1)
        w1 = [s.density * s.accel / 9.0 for s in scenes]
        self.w1 = torch.tensor(w1, **opt).view(self.B, 1)
        self.w2 = self.w1 / 4.0
        self.force = col(w1) * torch.tensor(FORCE, **opt).view(1, Q, 1)
        self.omega = col([s.omega for s in scenes])
        self.cx = torch.tensor(CX, **opt).view(1, Q, 1)
        self.cy = torch.tensor(CY, **opt).view(1, Q, 1)
        self.w = torch.tensor(W, **opt).view(1, Q, 1)
        self.three = torch.tensor(3.0, **opt)
        self.four_half = torch.tensor(4.5, **opt)
        self.opp = torch.tensor(OPP, device=device)
        # Pull streaming as one gather: speed k at (j, i) reads
        # ((j - cy) mod ny, (i - cx) mod nx) of its own plane.
        j = torch.arange(self.ny, device=device).view(self.ny, 1)
        i = torch.arange(self.nx, device=device).view(1, self.nx)
        self.pull = torch.cat([
            (k * n + ((j - CY[k]) % self.ny) * self.nx
             + (i - CX[k]) % self.nx).reshape(-1) for k in range(Q)])

    def initial(self, scenes, dtype, device) -> torch.Tensor:
        rest = [rest_state(s.density, self.ny, self.nx) for s in scenes]
        return torch.from_numpy(np.stack(rest)).to(device=device, dtype=dtype)


def velocity(f: torch.Tensor):
    """``(rho, u_x, u_y)`` of a (B, 9, n) state."""
    rho = f.sum(1)
    ux = (f[:, 1] + f[:, 5] + f[:, 8] - (f[:, 3] + f[:, 6] + f[:, 7])) / rho
    uy = (f[:, 2] + f[:, 5] + f[:, 6] - (f[:, 4] + f[:, 7] + f[:, 8])) / rho
    return rho, ux, uy


def step(f: torch.Tensor, b: _Batch) -> torch.Tensor:
    """One timestep of the (B, 9, ny, nx) state ``f``, in place. Returns
    the (B,) sums of fluid ``|u|`` of the streamed state."""
    row = f[:, :, b.ny - 2, :]
    ok = (b.fluid_row & (row[:, 3] - b.w1 > 0) & (row[:, 6] - b.w2 > 0)
          & (row[:, 7] - b.w2 > 0))
    row += ok.unsqueeze(1).to(f.dtype) * b.force
    s = torch.index_select(f.view(b.B, -1), 1, b.pull).view(b.B, Q, -1)
    rho, ux, uy = velocity(s)
    usq = ux * ux + uy * uy
    # c_k . u for every speed, then the equilibrium
    # w_k rho (1 + 3 cu + 4.5 cu^2 - 1.5 u^2), its polynomial in cu in
    # Horner's form: fewer passes over the nine planes, the same sum.
    cu = torch.addcmul(b.cx * ux.unsqueeze(1), b.cy, uy.unsqueeze(1))
    poly = torch.addcmul((1.0 - 1.5 * usq).unsqueeze(1), cu,
                         torch.addcmul(b.three, cu, b.four_half))
    feq = poly.mul_(b.w).mul_(rho.unsqueeze(1))
    # Relaxation s + omega (feq - s) in fluid cells, bounce-back in
    # obstacles, written into the state.
    torch.where(b.obstacle, torch.index_select(s, 1, b.opp),
                torch.lerp(s, feq, b.omega), out=f.view(b.B, Q, -1))
    return (torch.sqrt(usq) * b.fluid).sum(1)


def _steps(f, b, av, t0, n, store=None):
    for t in range(t0, t0 + n):
        av[:, t] = step(f, b) / b.n_fluid
        if store is not None:
            f.copy_(f.to(store))


def _run_graphed(f, b, av, iters, store):
    """``iters`` steps replayed from one CUDA graph of ``k`` steps, ``k``
    the largest divisor of ``iters`` up to :data:`GRAPH_STEPS`; each
    replay's ``av_vels`` copied out after it."""
    k = math.gcd(iters, GRAPH_STEPS)
    slot = torch.empty(b.B, k, dtype=f.dtype, device=f.device)
    side = torch.cuda.Stream(f.device)
    side.wait_stream(torch.cuda.current_stream(f.device))
    with torch.cuda.stream(side):
        _steps(f.clone(), b, slot, 0, 1, store)  # first use outside the capture
    torch.cuda.current_stream(f.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _steps(f, b, slot, 0, k, store)
    for t in range(0, iters, k):
        graph.replay()
        av[:, t:t + k].copy_(slot)


def run(scenes, dtype=torch.float64, device="cpu", store=None):
    """Every scene of ``scenes`` (one grid and step count) from rest:
    a list of ``(cells, av_vels, reynolds)``, the (9, ny, nx) final state
    and the (iters,) trajectory as float64 numpy arrays, computed in
    ``dtype`` on ``device``. ``store``: a type the state is rounded to
    after every step (the control's bfloat16)."""
    device = torch.device(device)
    if len({(s.nx, s.ny, s.iters) for s in scenes}) != 1:
        raise ValueError("a reference batch holds scenes of one grid and "
                         "one step count")
    iters = scenes[0].iters
    b = _Batch(scenes, dtype, device)
    f = b.initial(scenes, dtype, device)
    av = torch.empty(b.B, iters, dtype=dtype, device=device)
    with torch.no_grad():
        if device.type == "cuda":
            _run_graphed(f, b, av, iters, store)
        else:
            _steps(f, b, av, 0, iters, store)
        _, ux, uy = velocity(f.view(b.B, Q, -1))
        speed = (torch.sqrt(ux * ux + uy * uy) * b.fluid).sum(1) / b.n_fluid
    out = []
    for n, s in enumerate(scenes):
        re = float(speed[n]) * s.reynolds_dim / viscosity(s.omega)
        out.append((f[n].double().cpu().numpy(), av[n].double().cpu().numpy(),
                    re))
    return out
