"""The traffic generator: a cell's scenes, drawn from ``--seed``.

A configuration file gives a deployment's published parameters and its
mask recipe; the generator makes whole published scenes from it, which
differ only in their seeded interior obstacles. The one traffic mix,
``scene``, is these scenes back to back.

Configuration keys read here: ``params`` (``nx``, ``ny``, ``max_iters``,
``reynolds_dim``, ``density``, ``accel``, ``omega``, as in a ``.params``
file) and ``mask``: ``walls`` (the reference generator's boundary walls)
and ``interior``, a list of rectangles, each ``{"x": [lo, hi], "y": [lo,
hi], "w": [lo, hi], "h": [lo, hi]}`` in cells, its lower-left corner and
size each drawn uniformly from the closed range; a rectangle that
reaches past the grid is cut at its edge.

A run makes :data:`POOL` distinct scenes before its window; the window
takes them in turn and starts again at the first. Scene ``i`` of seed
``s`` is drawn from its own generator, seeded with ``(s, i)``, so it
does not depend on how many scenes a run makes. Every value is rounded
to float32 as a ``.params`` file is read.
"""

from __future__ import annotations

import dataclasses

import numpy as np

POOL = 64


@dataclasses.dataclass(frozen=True)
class Scene:
    index: int
    nx: int
    ny: int
    iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float
    mask: np.ndarray  # (ny, nx) bool, True where blocked


def seed_entropy(seed: int) -> int:
    """A non-negative word for numpy's seed sequence from any integer."""
    return int(seed) % 2**64


def walls(nx: int, ny: int) -> np.ndarray:
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = mask[ny - 1, :] = True
    mask[:, 0] = mask[:, nx - 1] = True
    return mask


def _draw_int(rng, bounds) -> int:
    lo, hi = bounds
    return int(rng.integers(lo, hi, endpoint=True))


def make_mask(recipe: dict, nx: int, ny: int, rng) -> np.ndarray:
    mask = walls(nx, ny) if recipe.get("walls", False) else \
        np.zeros((ny, nx), dtype=bool)
    for rect in recipe.get("interior", []):
        x, y = _draw_int(rng, rect["x"]), _draw_int(rng, rect["y"])
        w, h = _draw_int(rng, rect["w"]), _draw_int(rng, rect["h"])
        mask[max(y, 0):min(y + h, ny), max(x, 0):min(x + w, nx)] = True
    return mask


def make_scene(config: dict, seed: int, index: int) -> Scene:
    p = config["params"]
    rng = np.random.default_rng([seed_entropy(seed), index])
    mask = make_mask(config["mask"], p["nx"], p["ny"], rng)
    return Scene(index=index, nx=p["nx"], ny=p["ny"], iters=p["max_iters"],
                 reynolds_dim=p["reynolds_dim"], mask=mask,
                 **{k: float(np.float32(p[k]))
                    for k in ("density", "accel", "omega")})


def make_pool(config: dict, seed: int) -> list[Scene]:
    return [make_scene(config, seed, i) for i in range(POOL)]
