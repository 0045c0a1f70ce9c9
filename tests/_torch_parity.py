"""Helpers shared by the ``test_torch_*`` parity tests: carrying a world
between the JAX package and the PyTorch port as numpy arrays, and the small
scenes both are held to. JAX is imported where it is used, so the scene
builders also serve the card-only tests, whose machine has no JAX."""

import numpy as np
import torch

# One intra-op thread per test process: the suite runs several pytest
# workers on a few cores, and the twins' OpenMP threads would otherwise
# oversubscribe them (six workers at eight threads each ran a port test
# ~4x slower than at one thread each).
torch.set_num_threads(1)


def jax_to_numpy(world) -> dict:
    """A JAX world as ``{"bodies/pos": ndarray, ...}`` (the snapshot keys)."""
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(world)
    return {"/".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in flat}


def numpy_to_jax(arrays: dict, like):
    """The inverse of :func:`jax_to_numpy`, shaped like ``like``."""
    import jax
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


def slot_edge_arrays(arrays: dict, seed=9, squeeze=0.2) -> dict:
    """Edit a world batch's snapshot (numpy arrays, ``io`` keys) for the
    slot kernels' edge cases: every fifth collider on layer 31 and hitting
    only layer 31 (mask bit 31, a negative int32); collider 7 inactive in
    world 1 only; even worlds squeezed to half their spacing and jostled
    (positions into contact, fast velocities, so rows fill every tier), odd
    worlds squeezed toward their centre to ``squeeze`` of their spacing
    (rows hold more than 32 touching partners). Returns an edited copy."""
    from starframe_tpu_torch.state import COL_ACTIVE

    arrays = {k: np.array(v) for k, v in arrays.items()}
    rng = np.random.default_rng(seed)
    top = np.arange(arrays["colliders/layer"].shape[1]) % 5 == 2
    arrays["colliders/layer"][:, top] = 31
    arrays["colliders/mask"][:, top] = np.int32(-2 ** 31)
    if arrays["colliders/flags"].shape[0] > 1:
        arrays["colliders/flags"][1, 7] &= ~COL_ACTIVE
    pos, vel = arrays["bodies/pos"], arrays["bodies/vel"]
    for w in range(pos.shape[0]):
        dyn = arrays["bodies/inv_mass"][w] > 0
        c = pos[w, dyn].mean(axis=0)
        if w % 2 == 0:
            pos[w, dyn] = c + 0.5 * (pos[w, dyn] - c) + rng.normal(
                scale=0.25, size=pos[w, dyn].shape).astype(np.float32)
            vel[w, dyn] += rng.normal(scale=60.0, size=vel[w, dyn].shape
                                      ).astype(np.float32)
        else:
            pos[w, dyn] = c + squeeze * (pos[w, dyn] - c)
    return arrays


def shuffle_colliders(arrays: dict, seed=4, n=None) -> dict:
    """The same batch with its first ``n`` (default all) collider rows in a
    random order (one permutation for every world): a spatially incoherent
    index order."""
    m = arrays["colliders/layer"].shape[1]
    n = m if n is None else n
    perm = np.concatenate([np.random.default_rng(seed).permutation(n),
                           np.arange(n, m)])
    return {k: (np.ascontiguousarray(v[:, perm])
                if k.startswith("colliders/") else v)
            for k, v in arrays.items()}


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

    import jax
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

    import jax
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


def build_ring(builder_cls, shape_cls, gap, comoving=(0.0, 0.0), n_ring=12,
               R=1.5, r=0.25, n=128):
    """tests/test_solve_compaction.py's ``_ring_scene`` at ``n`` bodies: one
    central circle with ``n_ring`` small circles at surface gap ``gap``, the
    whole formation moving rigidly at ``comoving``, and far-away pads.
    Returns the builder and its capacity's fields."""
    b = builder_cls(gravity=(0.0, 0.0))
    c = b.add_body(pos=(0.0, 0.0), vel=comoving)
    b.add_collider(c, shape_cls.circle(R), friction=0.0, restitution=0.0)
    for i in range(n_ring):
        th = 2 * np.pi * i / n_ring
        d = R + r + gap
        body = b.add_body(pos=(d * np.cos(th), d * np.sin(th)), vel=comoving)
        b.add_collider(body, shape_cls.circle(r), friction=0.0,
                       restitution=0.0)
    for i in range(n - n_ring - 1):
        body = b.add_body(pos=(300.0 + 10.0 * i, 0.0))
        b.add_collider(body, shape_cls.circle(0.3))
    return b, dict(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=0, max_verts=4)


def build_escorted(builder_cls, shape_cls, escorts, speed=1000.0):
    """tests/test_ccd.py's ``_bullet_batch`` with ``escorts`` small static
    circles 0.02 m from the bullet, behind and beside it: each slot of
    theirs ranks before the wall's (imminent against speculative), so a
    row solving ``escorts`` slots drops the wall. Returns the builder and
    its capacity's fields."""
    wb = builder_cls()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type="static")
    wb.add_collider(wall, shape_cls.box(0.1, 2.0))
    b = wb.add_body(pos=(-3.0, 0.0), vel=(speed, 0.0), bullet=True)
    wb.add_collider(b, shape_cls.circle(0.05))
    d = 0.05 + 0.02 + 0.05
    for k in range(escorts):
        th = np.pi / 2 + np.pi * k / max(escorts - 1, 1)
        e = wb.add_body(pos=(-3.0 + d * np.cos(th), d * np.sin(th)),
                        body_type="static")
        wb.add_collider(e, shape_cls.circle(0.05))
    for i in range(128 - 2 - escorts):
        pad = wb.add_body(pos=(1000.0 + 10.0 * i, 0.0))
        wb.add_collider(pad, shape_cls.circle(0.3))
    return wb, dict(max_bodies=128, max_colliders=128, max_pairs=512,
                    max_joints=0, max_verts=4)


def build_static_floor(builder_cls, shape_cls, n_dynamic=32, n=256,
                       sensor=False):
    """A floor of static 0.5 m tiles side by side (every body past the
    dynamic ones) under ``n_dynamic`` boxes and circles resting 1 cm above
    it, 0.45 m apart: a world whose rows mostly may not hold a slot (K1's
    row rule), as a walker's terrain. With ``sensor`` the first tile is a
    sensor (a row that may not) and a kinematic body carries a sensor box
    sweeping along the row at 1 m/s (one that may). Returns the builder and
    its capacity's fields (N = M = n)."""
    wb = builder_cls()
    wb.gravity = (0.0, -9.81)
    n_static = n - n_dynamic - (1 if sensor else 0)
    for k in range(n_static):
        t = wb.add_static(pos=(0.5 * (k - n_static / 2), -0.25))
        wb.add_collider(t, shape_cls.box(0.25, 0.25), sensor=sensor and k == 0)
    for k in range(n_dynamic):
        d = wb.add_body(pos=(0.45 * (k - n_dynamic / 2), 0.21))
        wb.add_collider(d, shape_cls.circle(0.2) if k % 2
                        else shape_cls.box(0.2, 0.2))
    if sensor:
        s = wb.add_body(pos=(-0.45 * n_dynamic / 2, 0.2), vel=(1.0, 0.0),
                        body_type="kinematic")
        wb.add_collider(s, shape_cls.box(0.5, 0.3), sensor=True)
    return wb, dict(max_bodies=n, max_colliders=n, max_pairs=4 * n,
                    max_joints=0, max_verts=4)


def walker_batch(n_worlds, seed, device, frames=0):
    """``(cfg, world)``: ``n_worlds`` BipedalWalker-v3 envs of the
    benchmark's walker cell (``portbench/``: its scene, solver and motor
    control, each env's motors set once from ``seed``), ``frames`` frames
    in."""
    import sys
    from pathlib import Path

    from starframe_tpu_torch import parallel

    bench = Path(__file__).resolve().parents[1] / "portbench"
    if str(bench) not in sys.path:
        sys.path.append(str(bench))
    from harness import cells

    cell = cells.resolve("bipedal_walker.random_actions")
    args = dict(cell.config["scene_args"], n_worlds=n_worlds)
    w = cell.control.apply(cell.scene.program(args, seed, device), seed, 0)
    cfg = cells.solver_config(cell.config)
    if frames:
        w = parallel.batched_rollout(w, cfg, 0, frames,
                                     record=lambda _: None)[0]
    return cfg, w


def build_compound128(builder_cls, shape_cls, n=128, seed=3):
    """tests/test_frame2.py's ``_compound_scene``: ``_scene``'s capacity,
    every 4th dynamic body a compound of 3 colliders (an L of boxes and a
    circle cap), through either package's builder. Returns the builder and
    its capacity's fields."""
    rng = np.random.default_rng(seed)
    b = builder_cls(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, shape_cls.box(40.0, 0.5), friction=0.5)
    n_col, n_bod, cols, i = 1, 1, 12, 0
    while True:
        compound = i % 4 == 0
        need = 3 if compound else 1
        if n_col + need > n or n_bod + 1 > n:
            break
        row, col = divmod(i, cols)
        pos = (-(cols - 1) * 0.55 + col * 1.1 + rng.uniform(-0.05, 0.05),
               0.7 + row * 1.1)
        body = b.add_body(pos=pos, vel=rng.normal(scale=0.3, size=2),
                          ang_vel=float(rng.normal(scale=0.2)))
        if compound:
            b.add_collider(body, shape_cls.box(0.3, 0.12), friction=0.5,
                           restitution=0.2)
            b.add_collider(body, shape_cls.box(0.12, 0.3), friction=0.5,
                           restitution=0.2, offset=(0.18, 0.2))
            b.add_collider(body, shape_cls.circle(0.14), friction=0.5,
                           restitution=0.2, offset=(-0.25, 0.0))
        else:
            b.add_collider(body, shape_cls.circle(0.4) if i % 2 else
                           shape_cls.box(0.35, 0.3), friction=0.5,
                           restitution=0.2)
        n_col += need
        n_bod += 1
        i += 1
    return b, dict(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                   max_joints=0, max_verts=4)


def to_jax_tables(tables):
    """The port's slot tables ``(partner, slot_act, count, count_touch,
    count_close)`` as JAX arrays, for ``frame2_step(..., tables=)``."""
    import jax.numpy as jnp

    return tuple(jnp.asarray(t.numpy()) for t in tables)


def frame2_args(w, cfg, tables):
    """One frame of ``w`` without sleep as ``hopper.run_frame2`` takes it,
    built as ``parallel.frame2_step`` builds it: ``(args, inputs)``, the
    frame's body planes with ``tables``' partner and mask, and the call's
    ``Frame2Inputs``."""
    from starframe_tpu_torch import parallel

    planes, _ = parallel.frame2_planes(w, cfg)
    return (*planes, tables[0], tables[1]), parallel.frame2_inputs(w, cfg).k4


def jax_run_frame2(args, inputs, **kw):
    """The JAX package's ``run_frame2`` (Pallas, interpret mode) on the
    port's frame ``args`` and ``inputs`` (:func:`frame2_args`): the same
    tensors in its argument order, the joint axis padded to 128 lanes as
    its ``parallel.py:305-326`` pads it (padded rows inactive, no slot
    points at them), the same parameters; ``kw`` adds to them."""
    import jax.numpy as jnp

    from starframe_tpu.pallas.frame2 import run_frame2

    x = inputs
    tensors = (*args[:6], x.invm, x.invi, x.dyn, x.kin, x.cbody, x.vlx,
               x.vly, x.nverts, x.radius, x.fric, x.rest, x.sensor,
               *args[6:])
    joints = None
    if x.joints is not None:
        J = x.joints["jtype"].shape[1]
        Jp = -(-J // 128) * 128
        joints = {}
        for k, v in x.joints.items():
            v = v.numpy()
            if v.ndim == 2:
                v = np.pad(v, ((0, 0), (0, Jp - J)),
                           constant_values=2 ** 20 if k == "jcolor" else 0)
            joints[k] = jnp.asarray(v)
    params = dict(C=x.C, substeps=x.substeps, iterations=x.iterations,
                  h=x.h, dt=x.dt, margin=x.margin, compliance=x.compliance,
                  relaxation=x.relaxation, max_dpos=x.max_dpos,
                  rest_threshold=x.rest_threshold, lin_damp=x.lin_damp,
                  ang_damp=x.ang_damp, ccd=x.ccd, ccd_slop=x.ccd_slop)
    if joints is not None:
        params.update(JC=x.JC, joint_solver=x.joint_solver,
                      n_colors=x.n_colors, max_dpos_joint=x.max_dpos_joint)
    return run_frame2(
        *[jnp.asarray(t.numpy()) for t in tensors], joints,
        jnp.asarray(x.gravity.numpy()),
        None if x.bullet is None else jnp.asarray(x.bullet.numpy()),
        interpret=True, **params, **kw)


# starframe_tpu/pallas/frame2.py:414 gathers the per-slot normal (2-D,
# [Wb, C * M]) with the per-point helper, whose loop runs over a leading
# point axis: tracing the kernel with 0 < Cs < C raises, so the JAX
# package's batched compaction never runs (ROADMAP.md C). The parity tests
# hold the port against a copy of that module with the one call repaired.
_FRAME2_FAULT = "n_ax=cpk2(cb_.n_ax), n_ay=cpk2(cb_.n_ay),"
_FRAME2_FIX = "n_ax=cpk(cb_.n_ax), n_ay=cpk(cb_.n_ay),"


def repaired_run_frame2():
    """``run_frame2`` of a copy of ``starframe_tpu/pallas/frame2.py`` with
    the compaction's normal gather repaired (the file is not touched)."""
    import importlib.util
    import inspect

    from starframe_tpu.pallas import frame2 as jf2

    src = inspect.getsource(jf2)
    assert src.count(_FRAME2_FAULT) == 1, "the reference changed"
    spec = importlib.util.spec_from_loader(
        "starframe_tpu.pallas._frame2_repaired", loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "starframe_tpu.pallas"
    exec(compile(src.replace(_FRAME2_FAULT, _FRAME2_FIX), jf2.__file__,
                 "exec"), mod.__dict__)
    return mod.run_frame2


class repaired_reference:
    """Context in which ``starframe_tpu.parallel``'s kernel path calls
    :func:`repaired_run_frame2` (it imports ``run_frame2`` at call time);
    the module attribute is restored on exit. ``outputs`` holds each call's
    outputs (``nact`` is the ninth with compaction)."""

    def __enter__(self):
        from starframe_tpu.pallas import frame2 as jf2

        run = repaired_run_frame2()
        self.outputs = []

        def recorded(*args, **kw):
            out = run(*args, **kw)
            self.outputs.append(out)
            return out

        self._saved = jf2.run_frame2
        jf2.run_frame2 = recorded
        return self

    def __exit__(self, *exc):
        from starframe_tpu.pallas import frame2 as jf2

        jf2.run_frame2 = self._saved
        return False
