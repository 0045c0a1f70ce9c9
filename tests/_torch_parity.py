"""Helpers shared by the ``test_torch_*`` parity tests: carrying a world
between the JAX package and the PyTorch port as numpy arrays, and the small
scenes both are held to."""

import jax
import numpy as np
import torch

# One intra-op thread per test process: the suite runs several pytest
# workers on a few cores, and the twins' OpenMP threads would otherwise
# oversubscribe them (six workers at eight threads each ran a port test
# ~4x slower than at one thread each).
torch.set_num_threads(1)


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


def build(builder, *args, **kw):
    """``builder.build(*args, **kw)``, on the CPU when ``builder`` is the
    port's (which builds on the card unless told otherwise; the JAX
    builder takes no device)."""
    from starframe_tpu_torch.state import WorldBuilder

    if isinstance(builder, WorldBuilder):
        kw["device"] = "cpu"
    return builder.build(*args, **kw)


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


def build_jointed(builder_cls, shape_cls, n=128, seed=11):
    """Ground + mixed bodies with joints of every type (the scene of
    tests/test_frame2.py:233-284): a particle chain on distance joints, a
    pinned pendulum, a weld pair, a pinned angle-limited pair and a pinned
    motor pair, filled with circles to ``n`` bodies. Returns the builder
    and its capacity."""
    b = builder_cls(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, shape_cls.box(60.0, 0.5), friction=0.5)
    anchor = b.add_static(pos=(0.0, 14.0))
    b.add_collider(anchor, shape_cls.circle(0.1), mask=0)
    chain = []
    for k in range(6):
        p = b.add_body(pos=(0.3 * k, 13.0 - 0.6 * k), mass=0.5,
                       inertia=np.inf)
        b.add_collider(p, shape_cls.circle(0.1), mask=0)
        chain.append(p)
    b.distance_joint(anchor, chain[0], rest=1.0)
    for a_, b_ in zip(chain, chain[1:]):
        b.distance_joint(a_, b_, rest=0.7)
    pl_ = b.add_body(pos=(6.0, 12.0))
    b.add_collider(pl_, shape_cls.box(0.8, 0.2))
    b.pin_joint(anchor, pl_, world_point=(6.0, 13.0))
    w1 = b.add_body(pos=(-6.0, 5.0))
    b.add_collider(w1, shape_cls.box(0.5, 0.5))
    w2 = b.add_body(pos=(-6.0, 6.1))
    b.add_collider(w2, shape_cls.box(0.5, 0.5))
    b.weld_joint(w1, w2, world_point=(-6.0, 5.55))
    r1 = b.add_body(pos=(9.0, 8.0))
    b.add_collider(r1, shape_cls.box(0.6, 0.2))
    r2 = b.add_body(pos=(10.3, 8.0))
    b.add_collider(r2, shape_cls.box(0.6, 0.2))
    b.pin_joint(r1, r2, world_point=(9.65, 8.0))
    b.angle_limit(r1, r2, -0.4, 0.4)
    m1 = b.add_body(pos=(-10.0, 4.0))
    b.add_collider(m1, shape_cls.circle(0.5))
    m2 = b.add_body(pos=(-10.0, 4.0))
    b.add_collider(m2, shape_cls.box(1.2, 0.1), mask=0)
    b.pin_joint(m1, m2, world_point=(-10.0, 4.0))
    b.angular_motor(m1, m2, speed=2.0, max_torque=50.0)
    i = 0
    while len(b._bodies) < n:
        body = b.add_body(pos=(14.0 + (i % 8) * 1.1, 0.7 + (i // 8) * 1.1))
        b.add_collider(body, shape_cls.circle(0.45), friction=0.5)
        i += 1
    return b, dict(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=len(b._joints), max_verts=4)


def build_tiled(builder_cls, shape_cls, n=1024, seed=5):
    """Ground + two walls + ``n - 3`` mixed bodies spread in x over
    ``n / 256`` tiles of the tile engine (the scene of
    tests/test_tiles.py), described through either package's builder.
    Returns the builder and its capacity's fields."""
    rng = np.random.default_rng(seed)
    b = builder_cls(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, shape_cls.box(400.0, 0.5), friction=0.5)
    wl = b.add_static(pos=(-390.0, 10.0))
    b.add_collider(wl, shape_cls.box(0.5, 12.0), friction=0.5)
    wr = b.add_static(pos=(390.0, 10.0))
    b.add_collider(wr, shape_cls.box(0.5, 12.0), friction=0.5)
    n_dyn = n - 3
    cols = n_dyn // 4
    for i in range(n_dyn):
        row, col = divmod(i, cols)
        x = -(cols - 1) * 0.75 + col * 1.5 + rng.uniform(-0.1, 0.1)
        y = 0.7 + row * 1.2
        body = b.add_body(pos=(x, y), vel=rng.normal(scale=0.2, size=2),
                          ang_vel=float(rng.normal(scale=0.1)))
        kind = i % 3
        if kind == 0:
            b.add_collider(body, shape_cls.circle(0.45), friction=0.5,
                           restitution=0.1)
        elif kind == 1:
            b.add_collider(body, shape_cls.box(0.4, 0.35), friction=0.5)
        else:
            b.add_collider(body, shape_cls.hexagon(0.42), friction=0.5)
    return b, dict(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=0, max_verts=6)


STATE_KEYS = ("px", "py", "an", "vx", "vy", "om")


def build_compound(builder_cls, shape_cls, n_dyn=515, seed=7,
                   l_shaped_every=3):
    """Ground + walls + ``n_dyn`` two-collider bodies (dumbbells and
    L-shapes) spread in x: the compound scene of tests/test_tiled_compound.py
    (``_compound_scene``), described through either package's builder.
    Returns the builder and its capacity's fields."""
    rng = np.random.default_rng(seed)
    b = builder_cls(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, shape_cls.box(400.0, 0.5), friction=0.5)
    wl = b.add_static(pos=(-390.0, 10.0))
    b.add_collider(wl, shape_cls.box(0.5, 12.0), friction=0.5)
    wr = b.add_static(pos=(390.0, 10.0))
    b.add_collider(wr, shape_cls.box(0.5, 12.0), friction=0.5)
    cols = max(n_dyn // 4, 1)
    for i in range(n_dyn):
        row, col = divmod(i, cols)
        x = -(cols - 1) * 1.1 + col * 2.2 + rng.uniform(-0.1, 0.1)
        y = 0.8 + row * 1.6
        body = b.add_body(pos=(x, y), vel=rng.normal(scale=0.2, size=2),
                          ang_vel=float(rng.normal(scale=0.1)))
        if i % l_shaped_every == 0:  # L-shape: two offset boxes
            b.add_collider(body, shape_cls.box(0.55, 0.18), friction=0.5,
                           offset=(0.0, -0.3))
            b.add_collider(body, shape_cls.box(0.18, 0.3), friction=0.5,
                           offset=(-0.37, 0.18))
        else:  # dumbbell: two offset circles
            b.add_collider(body, shape_cls.circle(0.28), friction=0.5,
                           restitution=0.1, offset=(-0.3, 0.0))
            b.add_collider(body, shape_cls.circle(0.28), friction=0.5,
                           restitution=0.1, offset=(0.3, 0.0))
    m = 3 + 2 * n_dyn
    return b, dict(max_bodies=n_dyn + 3, max_colliders=m, max_pairs=12 * m,
                   max_joints=0, max_verts=6)


def jax_tile_manifold(state, kc, large, pidx, act, tile_live, *, Cs, V,
                      margin, dt, sleep_velocity, event_ids=None,
                      n_colliders=0):
    """``starframe_tpu/pallas/tiles.py``'s manifold kernel as
    ``run_tiled_frame`` calls it, in interpret mode, on a JAX tile layout
    (``[Nt, 1, T]`` rows, ``tile_live [Nt, 1, T]``). Returns its outputs
    ``(cc, c2, pidx_c, src, nact, wake, pen, npts)``, and ``keyc`` with
    ``event_ids = (cid [Nt, 1, T], l_cid [1, L])`` (f32, as the rollout
    passes them)."""
    import functools

    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from starframe_tpu.pallas import tiles as jpt

    Nt, C, T = pidx.shape[0], pidx.shape[1], jpt.T

    def wrows(x):
        return [x, x, x]

    args = (sum([wrows(state[k]) for k in STATE_KEYS], [])
            + wrows(kc["vlx"]) + wrows(kc["vly"])
            + sum([wrows(kc[k]) for k in ("rad", "nv", "fric", "rst", "sen",
                                          "invm", "invi")], [])
            + [kc["sen"]]
            + [large[k] for k in ("px", "py", "an", "vlx", "vly", "rad",
                                  "nv", "fric", "rst", "sen")]
            + [pidx, act, tile_live])
    with_keys = event_ids is not None
    if with_keys:
        args = args + wrows(event_ids[0]) + [event_ids[1]]
    kernel = functools.partial(
        jpt._manifold_kernel, C=C, Cs=Cs, V=V, margin=margin, dt=dt,
        n_tiles=Nt, sleep_velocity=sleep_velocity, with_keys=with_keys,
        n_colliders=n_colliders)
    f32, i32 = jnp.float32, jnp.int32
    out_specs = (jpt._own3(Cs * jpt.KC), jpt._own3(Cs * jpt.K2),
                 jpt._own3(Cs), jpt._own3(Cs), jpt._own3(2),
                 jpt._own_spec(), jpt._own_spec(), jpt._own_spec())
    out_shape = (jax.ShapeDtypeStruct((Nt, Cs * jpt.KC, T), f32),
                 jax.ShapeDtypeStruct((Nt, Cs * jpt.K2, T), f32),
                 jax.ShapeDtypeStruct((Nt, Cs, T), i32),
                 jax.ShapeDtypeStruct((Nt, Cs, T), i32),
                 jax.ShapeDtypeStruct((Nt, 2, T), i32),
                 jax.ShapeDtypeStruct((Nt, 1, T), f32),
                 jax.ShapeDtypeStruct((Nt, 1, T), f32),
                 jax.ShapeDtypeStruct((Nt, 1, T), f32))
    if with_keys:
        out_specs += (jpt._own3(Cs),)
        out_shape += (jax.ShapeDtypeStruct((Nt, Cs, T), i32),)
    return pl.pallas_call(
        kernel, grid=(Nt,),
        in_specs=jpt._manifold_specs(Nt, C, V, with_keys=with_keys),
        out_specs=out_specs, out_shape=out_shape, interpret=True)(*args)


def jax_tile_apply(state, corr, kc, large, pidx_c, cc, c2, lam, tile_live,
                   *, h, relaxation, max_dpos, rest_threshold, lin_damp,
                   ang_damp, compound):
    """``pallas/tiles.py``'s apply kernel as ``run_tiled_frame``'s substep
    calls it, in interpret mode, on a JAX tile layout: ``corr`` the four
    ``[Nt, 1, T]`` correction rows, ``lam [Nt, 2 Cs, T]``. Returns its six
    state rows, and ``accv [Nt, 4, T]`` with ``compound``."""
    import functools

    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from starframe_tpu.pallas import tiles as jpt

    Nt, Cs, T = pidx_c.shape[0], pidx_c.shape[1], jpt.T
    f32 = jnp.float32

    def w3s():
        return list(jpt._window_specs(Nt))

    def wrows(x):
        return [x, x, x]

    specs = (sum([w3s() for _ in range(10)], []) + [jpt._own_spec()] * 4
             + [jpt._bcast((1, jpt.L))] * 3
             + [jpt._own3(Cs), jpt._own3(Cs * jpt.KC), jpt._own3(Cs * jpt.K2),
                jpt._own3(2 * Cs), jpt._bcast((1, 2)), jpt._own_spec()])
    args = (sum([wrows(state[k]) for k in STATE_KEYS], [])
            + sum([wrows(x) for x in corr], [])
            + [kc[k] for k in ("invm", "invi", "dynb", "kin")]
            + [large[k] for k in ("px", "py", "an")]
            + [pidx_c, cc, c2, lam, jnp.asarray([[0.0, -9.81]], f32),
               tile_live])
    kernel = functools.partial(
        jpt._apply_kernel, C=Cs, h=h, relaxation=relaxation,
        max_dpos=max_dpos, rest_threshold=rest_threshold, lin_damp=lin_damp,
        ang_damp=ang_damp, n_tiles=Nt, compound=compound)
    out_specs = [jpt._own_spec()] * 6 + ([jpt._own3(4)] if compound else [])
    out_shape = ([jax.ShapeDtypeStruct((Nt, 1, T), f32)] * 6
                 + ([jax.ShapeDtypeStruct((Nt, 4, T), f32)] if compound
                    else []))
    return pl.pallas_call(
        kernel, grid=(Nt,), in_specs=specs, out_specs=tuple(out_specs),
        out_shape=tuple(out_shape), interpret=True)(*args)


def compound_resting(frames=20):
    """The compound scene of tests/test_tiled_compound.py ``frames`` frames
    into a port rollout (its ``_cfg`` at 2 substeps, K = 2; it starts in
    the air): ``(JAX world, port world, JAX config)``, the same arrays."""
    import dataclasses

    import starframe_tpu_torch as st
    from starframe_tpu_torch import io as tio
    from test_tiled_compound import _cfg, _compound_scene

    jw, _ = _compound_scene()
    tb, cap = build_compound(st.WorldBuilder, st.Shape)
    tw, _ = tb.build(st.Capacity(**cap), device="cpu")
    cfg = _cfg(substeps=2, frames_per_broadphase=2)
    tw, _ = st.tiled_rollout(tw, st.SolverConfig(**dataclasses.asdict(cfg)),
                             frames)
    return numpy_to_jax(tio.world_to_numpy(tw), jw), tw, cfg


def events_pile(frames=20):
    """``pile(n_bodies=1021, sleep=False)`` (4 tiles) ``frames`` frames into
    a port rollout at 2 substeps and K = 4: ``(JAX world, port world, port
    config)``, the same arrays."""
    import dataclasses

    import starframe_tpu as sf
    import starframe_tpu_torch as st
    from starframe_tpu_torch import io as tio

    jw = sf.scenes.pile(n_bodies=1021, sleep=False).world
    sc = st.scenes.pile(n_bodies=1021, sleep=False, device="cpu")
    cfg = dataclasses.replace(sc.config, substeps=2, frames_per_broadphase=4)
    tw, _ = st.tiled_rollout(sc.world, cfg, frames)
    return numpy_to_jax(tio.world_to_numpy(tw), jw), tw, cfg


def sol_to_jax(sol, pidx_c):
    """The JAX manifold kernel's ``cc [Nt, KC * Cs, T]`` and ``c2 [Nt, K2 *
    Cs, T]`` of the port's solve tables and compacted partners (the
    inverse of :func:`sol_from_jax`)."""
    import jax.numpy as jnp

    from starframe_tpu.pallas import tiles as jpt

    sol = np.asarray(sol)
    Nt, _, Cs, T = sol.shape
    cc = np.concatenate([np.asarray(pidx_c, np.float32)[:, None]]
                        + [sol[:, k - 1:k] for k in range(1, jpt.KC)], 1)
    c2 = sol[:, jpt.KC - 1:]
    return (jnp.asarray(cc.reshape(Nt, jpt.KC * Cs, T)),
            jnp.asarray(c2.reshape(Nt, jpt.K2 * Cs, T)))


def sol_from_jax(cc, c2, Cs):
    """The port's solve tables ``[Nt, SOL_FIELDS, Cs, T]`` of the JAX
    manifold kernel's ``cc [Nt, KC * Cs, T]`` and ``c2 [Nt, K2 * Cs, T]``
    (``cc``'s first plane, the partner index, is ``pidx_c``)."""
    from starframe_tpu.pallas import tiles as jpt

    cc, c2 = np.asarray(cc), np.asarray(c2)
    return np.stack([cc[:, k * Cs:(k + 1) * Cs] for k in range(1, jpt.KC)]
                    + [c2[:, q * Cs:(q + 1) * Cs] for q in range(jpt.K2)], 1)
