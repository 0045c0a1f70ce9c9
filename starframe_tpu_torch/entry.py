"""Entry point: one batched step on the flagship workload, on the card.

The port's counterpart of ``__graft_entry__.py``'s ``entry()``. The
multi-device dry run waits for the port's multi-device work (ROADMAP.md
A5).
"""

from __future__ import annotations


def entry(device="cuda"):
    """``(fn, (worlds,))``: ``fn(worlds)`` is one ``batched_step`` over
    ``batched_worlds(n_worlds=32, n_bodies=32, substeps=4)`` (independent
    physics worlds, BASELINE.json:11), built on ``device``."""
    from .parallel import batched_step
    from .scenes import batched_worlds

    scene = batched_worlds(n_worlds=32, n_bodies=32, substeps=4,
                           device=device)
    cfg, max_pairs = scene.config, scene.capacity.max_pairs

    def fn(worlds):
        return batched_step(worlds, cfg, max_pairs)

    return fn, (scene.world,)
