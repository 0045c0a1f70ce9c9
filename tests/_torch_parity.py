"""Helpers shared by the ``test_torch_*`` parity tests: carrying a world
between the JAX package and the PyTorch port as numpy arrays, and the small
scenes both are held to."""

import jax
import numpy as np


def jax_to_numpy(world) -> dict:
    """A JAX world as ``{"bodies/pos": ndarray, ...}`` (the snapshot keys)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(world)
    return {"/".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in flat}


def numpy_to_jax(arrays: dict, like):
    """The inverse of :func:`jax_to_numpy`, shaped like ``like``."""
    import jax.numpy as jnp

    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    leaves = [jnp.asarray(arrays["/".join(p.name for p in path)])
              for path, _ in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def build_pile(builder_cls, shape_cls, n=128, seed=0, sensor_idx=None,
               layered=False):
    """One static ground + ``n - 1`` mixed dynamic bodies (the scene of
    tests/test_frame2.py), described through either package's builder.
    ``layered=True`` puts every third body on layer 1, colliding only with
    layer 1, to exercise the layer/mask rules."""
    rng = np.random.default_rng(seed)
    b = builder_cls(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, shape_cls.box(40.0, 0.5), friction=0.5)
    cols = int(np.ceil(np.sqrt((n - 1) * 2)))
    for i in range(n - 1):
        row, col = divmod(i, cols)
        pos = (-(cols - 1) * 0.55 + col * 1.1 + rng.uniform(-0.05, 0.05),
               0.7 + row * 1.1)
        is_sensor = sensor_idx is not None and i == sensor_idx
        body = b.add_body(pos=pos, vel=rng.normal(scale=0.3, size=2),
                          ang_vel=float(rng.normal(scale=0.2)),
                          mass=1.0 if is_sensor else None,
                          inertia=0.1 if is_sensor else None)
        shape = (shape_cls.circle(0.45) if i % 2 == 0
                 else shape_cls.box(0.4, 0.35))
        kw = {}
        if layered and i % 3 == 0:
            kw = dict(layer=1, mask=0b10)
        b.add_collider(body, shape, friction=0.5, restitution=0.2,
                       sensor=is_sensor, **kw)
    return b
