"""The 10k-body pile (BASELINE.json:8, config 2): mixed convex bodies
falling into a container and settling, the workload of the metric
BASELINE.json:2 names first, and its compound variant. The scenes of
``starframe_tpu/scenes/pile.py`` ``pile`` and ``pile_compound``, built from
the same numpy draws, so both packages hold the same arrays."""

from __future__ import annotations

import numpy as np

from ..config import SolverConfig
from ..shapes import Shape
from ..state import WorldBuilder
from .base import Scene


def pile(n_bodies: int = 10_000, body_half: float = 0.5,
         friction: float = 0.5, seed: int = 0, substeps: int = 10,
         container_half_width: float = None, sleep: bool = True,
         device="cuda") -> Scene:
    """Boxes, hexagons and circles packed in a grid above a floor between
    two walls, falling into a pile several bodies deep. Sleep is on by
    default (``sleep_velocity = 0.1``, ``sleep_frames = 30``: settled bodies
    freeze, and the tile engine's rollouts compact them into skipped
    tiles); ``sleep=False`` keeps every body live (``sleep_velocity =
    0``)."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))

    cols = int(np.ceil(np.sqrt(n_bodies * 4)))
    rows = int(np.ceil(n_bodies / cols))
    spacing = body_half * 2.2
    if container_half_width is None:
        container_half_width = cols * spacing / 2 + 2.0

    # container: floor + two walls
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(container_half_width + 2.0, 0.5),
                   friction=friction)
    wl = b.add_static(pos=(-container_half_width, rows * spacing))
    b.add_collider(wl, Shape.box(0.5, rows * spacing + 4.0), friction=friction)
    wr = b.add_static(pos=(container_half_width, rows * spacing))
    b.add_collider(wr, Shape.box(0.5, rows * spacing + 4.0), friction=friction)

    x0 = -(cols - 1) * spacing / 2
    count = 0
    for row in range(rows):
        for col in range(cols):
            if count >= n_bodies:
                break
            x = x0 + col * spacing + rng.uniform(-0.05, 0.05) * body_half
            y = body_half * 1.5 + row * spacing
            body = b.add_body(pos=(x, y), angle=float(rng.uniform(0, np.pi)))
            kind = rng.integers(0, 3)
            if kind == 0:
                b.add_collider(body, Shape.circle(body_half * 0.9),
                               friction=friction)
            elif kind == 1:
                b.add_collider(body, Shape.box(body_half, body_half * 0.8),
                               friction=friction)
            else:
                b.add_collider(body, Shape.hexagon(body_half),
                               friction=friction)
            count += 1

    world, cap = b.build(device=device)
    # the tile engine keeps K = 8 frames of slot tables (16 slots a row: a
    # settled dense pile peaks at 9-12 true candidates) and re-sorts every
    # 8 frames or when the staleness guard fires
    cfg = SolverConfig(dt=1 / 60, substeps=substeps, broadphase="grid",
                       grid_cell_capacity=b.suggest_grid_cell_capacity(),
                       frames_per_broadphase=8, slot_capacity=16,
                       sleep_velocity=0.1 if sleep else 0.0, sleep_frames=30)
    return Scene("pile", world, cap, cfg)


def pile_compound(n_bodies: int = 10_000, body_half: float = 0.5,
                  friction: float = 0.5, seed: int = 0, substeps: int = 10,
                  device="cuda") -> Scene:
    """The pile with every dynamic body a compound of two colliders:
    dumbbells (two offset circles) and L-shapes (two offset boxes), on a
    sparser lattice (bench.py's ``pile_compound``: BASELINE.json config
    4's compound shapes at the pile's 10k scale). 2 n colliders ride the
    tile engine's collider rows with owner reductions. Sleep on, as
    ``pile``'s default; 24 table slots a row (the JAX package measured 16
    overflowing on the settled compound pile)."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))

    # compounds are ~2 half-widths wide: a sparser spacing than pile()'s,
    # and the column count scaled to keep its ~4:1 lattice
    spacing = body_half * 3.4
    cols = int(np.ceil(np.sqrt(n_bodies * 4 * 3.4 / 2.2)))
    rows = int(np.ceil(n_bodies / cols))
    container_half_width = cols * spacing / 2 + 2.0

    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(container_half_width + 2.0, 0.5),
                   friction=friction)
    wl = b.add_static(pos=(-container_half_width, rows * spacing))
    b.add_collider(wl, Shape.box(0.5, rows * spacing + 4.0), friction=friction)
    wr = b.add_static(pos=(container_half_width, rows * spacing))
    b.add_collider(wr, Shape.box(0.5, rows * spacing + 4.0), friction=friction)

    x0 = -(cols - 1) * spacing / 2
    r = body_half * 0.55
    count = 0
    for row in range(rows):
        for col in range(cols):
            if count >= n_bodies:
                break
            x = x0 + col * spacing + rng.uniform(-0.05, 0.05) * body_half
            y = body_half * 1.5 + row * spacing
            body = b.add_body(pos=(x, y), angle=float(rng.uniform(0, np.pi)))
            if rng.integers(0, 2) == 0:  # dumbbell: two offset circles
                b.add_collider(body, Shape.circle(r), friction=friction,
                               offset=(-body_half * 0.6, 0.0))
                b.add_collider(body, Shape.circle(r), friction=friction,
                               offset=(body_half * 0.6, 0.0))
            else:  # L-shape: two offset boxes
                b.add_collider(body, Shape.box(body_half, body_half * 0.35),
                               friction=friction,
                               offset=(0.0, -body_half * 0.5))
                b.add_collider(body,
                               Shape.box(body_half * 0.35, body_half * 0.6),
                               friction=friction,
                               offset=(-body_half * 0.65, body_half * 0.45))
            count += 1

    world, cap = b.build(device=device)
    cfg = SolverConfig(dt=1 / 60, substeps=substeps, broadphase="grid",
                       grid_cell_capacity=b.suggest_grid_cell_capacity(),
                       frames_per_broadphase=8, slot_capacity=24,
                       sleep_velocity=0.1, sleep_frames=30)
    return Scene("pile_compound", world, cap, cfg)
