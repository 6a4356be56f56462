"""Observables over a global lattice state, the twins of
:mod:`lbm_tpu.observables`: per-cell density and velocity, mean |u| over
fluid cells, the Reynolds number and the total density."""

from __future__ import annotations

import torch

from lbm_tpu_torch.params import Params


def macroscopic(cells: torch.Tensor):
    """``(rho, u_x, u_y)``, each (ny, nx), from a (9, ny, nx) state."""
    rho = torch.sum(cells, dim=0)
    u_x = (cells[1] + cells[5] + cells[8] - (cells[3] + cells[6] + cells[7])) / rho
    u_y = (cells[2] + cells[5] + cells[6] - (cells[4] + cells[7] + cells[8])) / rho
    return rho, u_x, u_y


def av_velocity(cells: torch.Tensor, obstacles: torch.Tensor) -> torch.Tensor:
    """Mean |u| over fluid cells."""
    _, u_x, u_y = macroscopic(cells)
    speed = torch.sqrt(u_x * u_x + u_y * u_y)
    fluid = ~obstacles.to(torch.bool)
    tot_u = torch.sum(speed.masked_fill(~fluid, 0.0))
    # An integer count, as the reference's int tot_cells: a float sum
    # of ones rounds past 2^24 fluid cells.
    tot_cells = torch.sum(fluid, dtype=torch.int64).to(cells.dtype)
    return tot_u / tot_cells


def calc_reynolds(params: Params, cells, obstacles) -> torch.Tensor:
    """av_velocity * reynolds_dim / viscosity, in the working dtype."""
    d = params.dtype
    return (
        av_velocity(cells, obstacles)
        * float(d(params.reynolds_dim))
        / float(params.viscosity)
    )


def total_density(cells: torch.Tensor) -> torch.Tensor:
    """Sum of all distributions, conserved by every step."""
    return torch.sum(cells)
