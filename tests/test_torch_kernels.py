"""The port's contact math (``starframe_tpu_torch/kernels.py``) against
``starframe_tpu/kernels.py`` on seeded random pairs of circles, capsules,
triangles and boxes: manifolds, the XPBD position projection (both
static-friction reference forms) and the velocity pass, to atol 1e-5."""

import pytest

torch = pytest.importorskip("torch")

from types import SimpleNamespace  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from starframe_tpu import kernels as jk  # noqa: E402
from starframe_tpu.shapes import Shape  # noqa: E402

from starframe_tpu_torch import kernels as tk  # noqa: E402

ATOL = 1e-5
V = 4
P = 768


def _shape_bank():
    return [Shape.circle(0.45), Shape.capsule(0.4, 0.15),
            Shape.polygon([[0.0, 0.0], [0.8, 0.1], [0.3, 0.6]]),
            Shape.box(0.45, 0.45), Shape.box(0.6, 0.2, radius=0.05),
            Shape.box(2.0, 0.5)]


def _random_pairs(seed):
    """Local verts [V, P] (padded with v0), vertex counts and radii for both
    sides, and poses that put most pairs within reach of each other."""
    rng = np.random.default_rng(seed)
    bank = _shape_bank()

    def side(ids):
        vx = np.zeros((V, P), np.float32)
        vy = np.zeros((V, P), np.float32)
        nv = np.zeros(P, np.int32)
        r = np.zeros(P, np.float32)
        for p, k in enumerate(ids):
            v = bank[k].verts
            pad = np.concatenate([v, np.repeat(v[:1], V - len(v), 0)])
            vx[:, p], vy[:, p] = pad[:, 0], pad[:, 1]
            nv[p], r[p] = len(v), bank[k].radius
        return vx, vy, nv, r

    a = side(rng.integers(0, len(bank), P))
    b = side(rng.integers(0, len(bank), P))
    pose = dict(
        pax=rng.uniform(-0.2, 0.2, P), pay=rng.uniform(-0.2, 0.2, P),
        aa=rng.uniform(-np.pi, np.pi, P),
        pbx=rng.uniform(-1.2, 1.2, P), pby=rng.uniform(-1.2, 1.2, P),
        ab=rng.uniform(-np.pi, np.pi, P))
    pose = {k: v.astype(np.float32) for k, v in pose.items()}
    margin = rng.uniform(0.02, 0.3, P).astype(np.float32)
    return a, b, pose, margin, rng


def _world_verts(vx, vy, px, py, ang):
    c, s = np.cos(ang), np.sin(ang)
    return px + c * vx - s * vy, py + s * vx + c * vy


def _both(fn_j, fn_t, *arrays):
    """Run one function of each package on the same numpy inputs."""
    out_j = fn_j(*[jnp.asarray(x) for x in arrays])
    out_t = fn_t(*[torch.as_tensor(x) for x in arrays])
    return out_j, out_t


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_manifold_batch_matches(seed):
    (avx, avy, na, ra), (bvx, bvy, nb, rb), pose, margin, _ = \
        _random_pairs(seed)
    wax, way = _world_verts(avx, avy, pose["pax"], pose["pay"], pose["aa"])
    wbx, wby = _world_verts(bvx, bvy, pose["pbx"], pose["pby"], pose["ab"])
    args = [x.astype(np.float32) if x.dtype.kind == "f" else x
            for x in (wax, way, na, ra, wbx, wby, nb, rb, margin)]
    mj, mt = _both(jk.manifold_batch, tk.manifold_batch, *args)
    assert float(mt.pmask.sum()) > P // 4, "too few contacts: vacuous"
    for name in jk.ManifoldB._fields:
        _close(getattr(mj, name), getattr(mt, name), name)


def _contact_inputs(seed):
    """Frame-constant contact data from the JAX narrowphase on random pairs,
    plus a moved pose (the substep pose) and velocities."""
    (avx, avy, na, ra), (bvx, bvy, nb, rb), pose, margin, rng = \
        _random_pairs(seed)
    pd = SimpleNamespace(
        verts_ax=avx, verts_ay=avy, verts_bx=bvx, verts_by=bvy,
        nverts_a=na, nverts_b=nb, radius_a=ra, radius_b=rb,
        valid=rng.uniform(size=P) < 0.9, sensor=rng.uniform(size=P) < 0.1,
        inv_mass_a=rng.uniform(0.5, 2.0, P), inv_mass_b=np.where(
            rng.uniform(size=P) < 0.3, 0.0, rng.uniform(0.5, 2.0, P)),
        inv_inertia_a=rng.uniform(0.5, 4.0, P),
        inv_inertia_b=rng.uniform(0.0, 4.0, P),
        friction=rng.uniform(0.0, 1.0, P), restitution=rng.uniform(0, 1, P))
    pd = SimpleNamespace(**{
        k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
        for k, v in vars(pd).items()})
    p0 = jk.make_pair_pose(*(jnp.asarray(pose[k]) for k in
                             ("pax", "pay", "aa", "pbx", "pby", "ab")))
    jpd = SimpleNamespace(**{k: jnp.asarray(v) for k, v in vars(pd).items()})
    cb_ = jk.narrowphase_b(jpd, p0, jnp.asarray(margin))
    cb_np = {k: np.array(getattr(cb_, k)) for k in cb_._fields}
    assert cb_np["solve_mask"].sum() > P // 4, "too few contacts: vacuous"
    moved = {k: (v + rng.normal(scale=0.03, size=P)).astype(np.float32)
             for k, v in pose.items()}
    vel = {k: rng.normal(scale=1.0, size=P).astype(np.float32)
           for k in ("vax", "vay", "oa", "vbx", "vby", "ob")}
    vel0 = {k: (v + rng.normal(scale=0.5, size=P)).astype(np.float32)
            for k, v in vel.items()}
    return pd, pose, moved, cb_np, vel, vel0


def _pair_pose(mod, lib, pose):
    c, s = lib.cos, lib.sin
    t = (jnp.asarray if lib is jnp else torch.as_tensor)
    x = {k: t(v) for k, v in pose.items()}
    return mod.PairPose(x["pax"], x["pay"], c(x["aa"]), s(x["aa"]),
                        x["pbx"], x["pby"], c(x["ab"]), s(x["ab"]))


def _ns(d, conv):
    return SimpleNamespace(**{k: conv(v) for k, v in d.items()})


@pytest.mark.parametrize("seed", [3, 4])
def test_solve_and_velocity_contacts_match(seed):
    pd, pose0, pose1, cb_np, vel, vel0 = _contact_inputs(seed)
    h, compliance = 1.0 / 600.0, 1e-4
    jpd = _ns(vars(pd), jnp.asarray)
    tpd = _ns(vars(pd), torch.as_tensor)
    jcb, tcb = _ns(cb_np, jnp.asarray), _ns(cb_np, torch.as_tensor)
    jp0, tp0 = _pair_pose(jk, jnp, pose0), _pair_pose(tk, torch, pose0)
    jp1, tp1 = _pair_pose(jk, jnp, pose1), _pair_pose(tk, torch, pose1)

    # the position projection, with the reference pose and with the
    # carried reference kinematics the frame kernel passes instead
    vj = jk.solve_contacts_b(jp1, jp0, jpd, jcb, h, compliance)
    vt = tk.solve_contacts_b(tp1, tp0, tpd, tcb, h, compliance)
    kin0 = tk._pair_kinematics(tcb, tp0)[6:10]
    vk = tk.solve_contacts_b(tp1, None, tpd, tcb, h, compliance, kin0=kin0)
    for name, a, b, c in zip(("vals_a", "vals_b", "lam"), vj, vt, vk):
        _close(a, b, name)
        assert torch.equal(b, c), name
    assert float((vt[2] > 0).sum()) > 10, "no active constraints: vacuous"

    for k in range(10):
        _close(jk._pair_kinematics(jcb, jp1)[k],
               tk._pair_kinematics(tcb, tp1)[k], f"kinematics {k}")

    pj = jk.PairVel(*(jnp.asarray(vel[k]) for k in jk.PairVel._fields))
    pj0 = jk.PairVel(*(jnp.asarray(vel0[k]) for k in jk.PairVel._fields))
    pt = tk.PairVel(*(torch.as_tensor(vel[k]) for k in tk.PairVel._fields))
    pt0 = tk.PairVel(*(torch.as_tensor(vel0[k]) for k in tk.PairVel._fields))
    lam = np.array(vj[2])
    wj = jk.velocity_contacts_b(jp1, pj, pj0, jpd, jcb, jnp.asarray(lam), h,
                                0.5)
    wt = tk.velocity_contacts_b(tp1, pt, pt0, tpd, tcb, torch.as_tensor(lam),
                                h, 0.5)
    for name, a, b in zip(("vals_a", "vals_b"), wj, wt):
        _close(a, b, name)
