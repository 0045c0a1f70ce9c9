"""Continuous collision on the batched path: the frame twin's CCD branch
(``hopper/frame2.py``, K4 with ``ccd=True``) against the JAX package's
``parallel.frame2_step(..., interpret=True)`` (Pallas in interpret mode),
and the bullet checks of tests/test_ccd.py on the port.

The scenes are tests/test_ccd.py's ``_bullet_batch`` (a thin wall, a
0.05 m bullet flying at it and far-away padding, 128 bodies, 4 worlds)
described through both builders, and the same batch with a two-collider
bullet. Tolerances: over 3 frames (the bullet hits the wall in the first)
poses and velocities to 1e-4, every counter equal. The behaviour checks
are test_ccd.py's own bounds.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import parallel as jpar  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402
from test_ccd import KCFG, WALL_FACE  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402
from starframe_tpu_torch.state import BODY_BULLET  # noqa: E402

from _torch_parity import build, jax_to_numpy  # noqa: E402

CFG = st.SolverConfig(**dataclasses.asdict(KCFG))
PARITY_FRAMES = 3


def bullet_batch(builder_cls, shape_cls, capacity_cls, speed,
                 restitution=0.0, target="static", n=128, worlds=4,
                 two_colliders=False):
    """tests/test_ccd.py's ``_bullet_batch`` through either package's
    builder; ``two_colliders`` gives the bullet a second circle beside the
    first (M = 256 then, a lane multiple for the JAX kernel)."""
    wb = builder_cls()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type=target)
    wb.add_collider(wall, shape_cls.box(0.1, 2.0), restitution=restitution)
    b = wb.add_body(pos=(-3.0, 0.0), vel=(speed, 0.0), bullet=True)
    if two_colliders:
        for dy in (-0.03, 0.03):
            wb.add_collider(b, shape_cls.circle(0.05), offset=(0.0, dy),
                            restitution=restitution)
    else:
        wb.add_collider(b, shape_cls.circle(0.05), restitution=restitution)
    for i in range(n - 2):
        pad = wb.add_body(pos=(1000.0 + 10.0 * i, 0.0))
        wb.add_collider(pad, shape_cls.circle(0.3))
    cap = capacity_cls(max_bodies=n, max_colliders=256 if two_colliders else n,
                       max_pairs=4 * n, max_joints=0, max_verts=4)
    w, _ = build(wb, cap)
    if builder_cls is JBuilder:
        return jpar.replicate_world(w, worlds)
    return parallel.replicate_world(w, worlds)


def _port(speed, **kw):
    return bullet_batch(st.WorldBuilder, st.Shape, st.Capacity, speed, **kw)


def _run(worlds, cfg, frames):
    for _ in range(frames):
        worlds = parallel.frame2_step(worlds, cfg)[0]
    return worlds


SCENES = {"200": dict(speed=200.0), "1000": dict(speed=1000.0),
          "two_colliders": dict(speed=1000.0, two_colliders=True)}


@pytest.fixture(scope="module")
def jax_reference():
    """Each scene's JAX batch and its ``PARITY_FRAMES`` frames through
    ``frame2_step(interpret=True)``: ``{scene: (start, [(world, counts,
    aux), ...])}``."""
    step = jax.jit(lambda w: jpar.frame2_step(w, KCFG, interpret=True))
    out = {}
    for name, kw in SCENES.items():
        w = bullet_batch(JBuilder, JShape, JCapacity, **kw)
        start, frames = w, []
        for _ in range(PARITY_FRAMES):
            w, _, _, counts, aux = step(w)
            frames.append((w, counts, aux))
        out[name] = (start, frames)
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_frame2_ccd_twin_matches_jax(jax_reference, scene):
    start, frames = jax_reference[scene]
    w = _port(**SCENES[scene])
    a, b = jax_to_numpy(start), tio.world_to_numpy(w)
    for k in a:  # both builders describe the same batch
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    launches = hopper.run_frame2.ccd_launches
    for jw, jcounts, jaux in frames:
        w, _, _, counts, aux = parallel.frame2_step(w, CFG)
        a, b = jax_to_numpy(jw), tio.world_to_numpy(w)
        for k in ("bodies/pos", "bodies/angle", "bodies/vel",
                  "bodies/ang_vel"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        for x, y in zip(jcounts, counts):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        assert {k: int(v) for k, v in jaux.items()} == {
            k: int(v) for k, v in aux.items()}
    assert hopper.run_frame2.ccd_launches == launches  # CPU: the twin
    x = b["bodies/pos"][:, 1, 0]
    # the clamp fired: the bullet has not crossed the wall
    assert (x < 0.0).all(), x
    if scene == "two_colliders":  # conservative: stopped short of the face
        assert (x < WALL_FACE - 0.06).all(), x


@pytest.mark.parametrize("speed", [200.0, 1000.0])
def test_frame2_bullet_never_tunnels(speed):
    x = _run(_port(speed), CFG, 30).bodies.pos[:, 1, 0]
    assert ((WALL_FACE - 0.06 < x) & (x <= WALL_FACE + 0.01)).all(), x


def test_frame2_bullet_restitution_sees_true_approach_speed():
    vx = _run(_port(1000.0, restitution=0.9), CFG, 10).bodies.vel[:, 1, 0]
    assert ((-950.0 < vx) & (vx < -820.0)).all(), vx


def test_frame2_bullet_into_dynamic_target_transfers_momentum():
    w = _run(_port(500.0, target="dynamic"), CFG, 30)
    assert (w.bodies.pos[:, 1, 0] < w.bodies.pos[:, 0, 0]).all()
    assert (w.bodies.vel[:, 0, 0] > 0.1).all()


def test_frame2_ccd_inert_for_unflagged_scenes():
    """No body flagged: every TOI factor is 1 and ``ccd=True`` leaves the
    frames bitwise those of ``ccd=False``."""
    w = _port(2.0)
    b = w.bodies
    w = dataclasses.replace(
        w, bodies=dataclasses.replace(b, flags=b.flags & ~BODY_BULLET))
    on = _run(w, CFG, 20)
    off = _run(w, dataclasses.replace(CFG, ccd=False), 20)
    for field in ("pos", "angle", "vel", "ang_vel"):
        assert torch.equal(getattr(on.bodies, field),
                           getattr(off.bodies, field)), field


def test_frame2_ccd_with_joints_matches_pallas():
    """K4's joint and CCD branches together (``<V, true, true>``): the
    jointed batch of tests/test_torch_frame2_joints.py with every dynamic
    body a bullet thrown down at 40 m/s, so that the clamp fires, one frame
    in; the next frame through the twin and through the JAX
    ``run_frame2(ccd=True, interpret=True)`` on the same inputs;
    ``touched`` equal, the joint tests' bounds, and CCD made a
    difference."""
    from _torch_parity import build_jointed, frame2_args, jax_run_frame2

    b, cap = build_jointed(st.WorldBuilder, st.Shape)
    w = parallel.replicate_world(build(b, st.Capacity(**cap))[0], 2)
    bd = w.bodies
    dyn = bd.inv_mass > 0
    w = dataclasses.replace(w, bodies=dataclasses.replace(
        bd, flags=torch.where(dyn, bd.flags | BODY_BULLET, bd.flags),
        vel=torch.where(dyn[..., None], bd.vel + torch.tensor([0.0, -40.0]),
                        bd.vel)))
    cfg = st.SolverConfig(substeps=4, slot_capacity=8, ccd=True)
    w = parallel.frame2_step(w, cfg)[0]
    args, inputs = frame2_args(w, cfg, parallel.frame2_tables(w, cfg))
    ref = jax_run_frame2(args, inputs)
    got = hopper.run_frame2(*args, inputs)
    assert float(got[6].sum()) > 10, "no touching contacts: vacuous"
    np.testing.assert_array_equal(np.asarray(ref[6]), got[6].numpy())
    tols = (2e-4, 2e-4, 5e-4, 2e-2, 2e-2, 2e-2)
    for field, a, b_, tol in zip(("posx", "posy", "ang", "velx", "vely",
                                  "angvel"), ref[:6], got[:6], tols):
        np.testing.assert_allclose(np.asarray(a), b_.numpy(), rtol=0,
                                   atol=tol, err_msg=field)
    free = hopper.run_frame2(*args, dataclasses.replace(inputs, ccd=False))
    assert float(torch.abs(free[1] - got[1]).max()) > 1e-3, "CCD inert"


def test_frame2_ccd_without_frame_manifolds_is_refused():
    """CCD trusts the frame-start normals: with per-substep manifolds the
    slot kernels do not take the batch (the JAX package's gate)."""
    w = _port(100.0)
    bad = dataclasses.replace(CFG, manifold_refresh="substep")
    assert not parallel.frame2_shapes_ok(w, bad)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        parallel.frame2_step(w, bad)

