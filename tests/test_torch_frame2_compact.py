"""Per-frame solve-slot compaction on the batched path (``cfg.
batch_solve_capacity``, K4's ``Cs`` form): the frame twin against the JAX
package's ``parallel.frame2_step`` and ``pallas/frame2.py``'s
``run_frame2(..., Cs=, interpret=True)`` on the same inputs (the port's
slot tables handed to both).

Scenes: a batched form of tests/test_solve_compaction.py's ring (12 around
1, C = 16, Cs = 8) with speculative-only, imminent and touching partners;
the jointed scene of tests/test_frame2.py at C = 8, Cs = 2; and
tests/test_ccd.py's bullet batch with small static escorts beside the
bullet, closer than the wall it flies at (C = 8, Cs = 4). ``partner_solve``,
``nact``, ``touched`` and the counters equal; poses and velocities to the
bounds of tests/test_torch_frame2.py (2e-4, 5e-4 in angle, 2e-2).

The reference takes the CCD time of impact over the ``Cs`` solved slots
only (``frame2.py:504``), so a bullet whose wall ranks past ``Cs`` tunnels
through it; the port takes it over all C slots (ROADMAP.md C).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from starframe_tpu import parallel as jpar  # noqa: E402
from starframe_tpu.config import Capacity as JCapacity  # noqa: E402
from starframe_tpu.config import SolverConfig as JConfig  # noqa: E402
from starframe_tpu.shapes import Shape as JShape  # noqa: E402
from starframe_tpu.state import WorldBuilder as JBuilder  # noqa: E402

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import hopper, parallel  # noqa: E402
from starframe_tpu_torch import io as tio  # noqa: E402

from _torch_parity import (  # noqa: E402
    build,
    build_escorted,
    build_jointed,
    build_ring,
    frame2_args,
    jax_to_numpy,
    repaired_reference,
    to_jax_tables,
)

WALL_FACE = -0.15  # tests/test_ccd.py: wall half-width 0.1 + radius 0.05
RING = {"speculative": dict(gap=0.12, comoving=(9.0, 9.0)),
        "imminent": dict(gap=0.02), "touching": dict(gap=0.0)}
RING_CFG = dict(substeps=4, iterations=1, slot_capacity=16,
                batch_solve_capacity=8)
JOINT_CFG = dict(substeps=4, slot_capacity=8, batch_solve_capacity=2)
CCD_CFG = dict(dt=1 / 60, substeps=10, ccd=True, slot_capacity=8,
               batch_solve_capacity=4)


def _pair(builder_fn, worlds=2):
    """The same batch through both builders: ``(JAX worlds, port worlds)``."""
    jb, cap = builder_fn(JBuilder, JShape)
    tb, _ = builder_fn(st.WorldBuilder, st.Shape)
    jw, _ = jb.build(JCapacity(**cap))
    tw, _ = build(tb, st.Capacity(**cap))
    return (jpar.replicate_world(jw, worlds),
            parallel.replicate_world(tw, worlds))


def _scenes():
    out = {f"ring_{k}": (lambda b, s, kw=kw: build_ring(b, s, **kw), RING_CFG)
           for k, kw in RING.items()}
    out["jointed"] = (lambda b, s: build_jointed(b, s), JOINT_CFG)
    # the wall ranks last: kept with Cs - 1 escorts, dropped with Cs
    for n in (CCD_CFG["batch_solve_capacity"] - 1,
              CCD_CFG["batch_solve_capacity"]):
        out[f"ccd_escorts{n}"] = (lambda b, s, n=n: build_escorted(b, s, n),
                                  CCD_CFG)
    return out


SCENES = _scenes()


@pytest.fixture(scope="module")
def reference():
    """Per scene: the port's batch and tables, and the JAX package's frame
    on them, ``frame2_step(interpret=True, tables=)``: its world, touched,
    partner_solve and aux, and its ``run_frame2`` call's ``nact``."""
    out = {}
    with repaired_reference() as ref:
        for name, (make, kw) in SCENES.items():
            jw, tw = _pair(make)
            cfg, jcfg = st.SolverConfig(**kw), JConfig(**kw)
            tables = parallel.frame2_tables(tw, cfg)
            jw2, jt, jp, _, jaux = jpar.frame2_step(
                jw, jcfg, interpret=True, tables=to_jax_tables(tables))
            out[name] = dict(port=tw, cfg=cfg, tables=tables, world=jw2,
                             touched=np.asarray(jt), partner=np.asarray(jp),
                             aux={k: int(v) for k, v in jaux.items()},
                             nact=np.asarray(ref.outputs[-1][8]))
    return out


def _frame(ref):
    return parallel.frame2_step(ref["port"], ref["cfg"], tables=ref["tables"])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compacted_frame_matches_jax(reference, scene):
    """One compacted frame: ``partner_solve``, ``touched`` and the solve
    counters equal to the reference's, poses and velocities within the
    frame kernel's bounds (the wall-dropping CCD scene is the fault below,
    held to the reference only where it does not clamp)."""
    ref = reference[scene]
    w, touched, partner, _, aux = _frame(ref)
    Cs = ref["cfg"].batch_solve_capacity
    assert tuple(touched.shape) == (2, Cs, 128)
    np.testing.assert_array_equal(ref["partner"], partner.numpy())
    np.testing.assert_array_equal(ref["touched"], touched.numpy())
    assert ref["aux"] == {k: int(v) for k, v in aux.items()}
    a, b = jax_to_numpy(ref["world"]), tio.world_to_numpy(w)
    keep = slice(None)
    if scene == "ccd_escorts4":  # the bullet (body 1) differs: the fault
        keep = np.arange(128) != 1
    for k, tol in (("bodies/pos", 2e-4), ("bodies/angle", 5e-4),
                   ("bodies/vel", 2e-2), ("bodies/ang_vel", 2e-2)):
        np.testing.assert_allclose(a[k][:, keep], b[k][:, keep], rtol=0,
                                   atol=tol, err_msg=k)


def test_ring_counts_and_counters(reference):
    """``nact`` equals ``run_frame2``'s; the rings give what they are built
    for: 4 dropped speculative slots a world (soft), 4 dropped imminent or
    touching ones (HARD)."""
    expect = {"speculative": (0, 8), "imminent": (8, 0), "touching": (8, 0)}
    for kind, (hard, soft) in expect.items():
        ref = reference[f"ring_{kind}"]
        args, inputs = frame2_args(ref["port"], ref["cfg"],
                                      ref["tables"])
        out = hopper.run_frame2(*args, inputs)
        assert len(out) == 9
        np.testing.assert_array_equal(ref["nact"], out[8].numpy())
        assert (ref["aux"]["solve_overflow"],
                ref["aux"]["solve_dropped"]) == (hard, soft), kind


def test_ccd_toi_spans_the_whole_table(reference):
    """The pin of ADVICE.md:4 (ROADMAP.md C): a bullet at 1000 m/s with 4
    escorts closer than the wall it flies at, Cs = 4. Its wall slot ranks
    fifth and is dropped from the solve (soft ``solve_dropped``). The
    reference takes the TOI over the 4 solved slots and the bullet tunnels
    through the wall in the first frame; the port takes it over all 8 and
    the bullet stops on the wall's near face. With 3 escorts the wall is
    solved and both stop there (``test_compacted_frame_matches_jax``)."""
    ref = reference["ccd_escorts4"]
    assert ref["aux"]["solve_dropped"] == 2 and ref["aux"]["solve_overflow"] == 0
    jx = np.asarray(ref["world"].bodies.pos)[:, 1, 0]
    assert (jx > 0.15).all(), jx  # the reference: through the wall
    w = _frame(ref)[0]
    # stopped at the face; unsolved this frame, the contact deepens by at
    # most ccd_slop a substep, and the next frame's solve pushes it out
    x = w.bodies.pos[:, 1, 0].numpy()
    slop = ref["cfg"].ccd_slop * ref["cfg"].substeps
    assert ((WALL_FACE - 0.06 < x) & (x <= WALL_FACE + slop)).all(), x
    for _ in range(2):
        w = parallel.frame2_step(w, ref["cfg"])[0]
    x = w.bodies.pos[:, 1, 0].numpy()
    assert ((WALL_FACE - 0.06 < x) & (x <= WALL_FACE + 0.01)).all(), x
    kept = reference["ccd_escorts3"]
    jx3 = np.asarray(kept["world"].bodies.pos)[:, 1, 0]
    assert ((WALL_FACE - 0.06 < jx3) & (jx3 <= WALL_FACE + 0.01)).all(), jx3


def test_compaction_off_and_full_width_are_the_plain_frame(reference):
    """``batch_solve_capacity`` 0 or >= C runs the uncompacted frame:
    ``touched`` keeps C slots and every counter of the solve is 0, bitwise
    the same state either way."""
    ref = reference["ring_imminent"]
    outs = []
    for cap in (0, 16, 20):
        cfg = dataclasses.replace(ref["cfg"], batch_solve_capacity=cap)
        assert parallel._batch_solve_cap(cfg) == 0
        w, touched, _, _, aux = parallel.frame2_step(ref["port"], cfg,
                                                     tables=ref["tables"])
        assert touched.shape[1] == 16
        assert int(aux["solve_overflow"]) == int(aux["solve_dropped"]) == 0
        outs.append(w.bodies.pos)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_rollout_counts_solve_drops(reference):
    """``batched_rollout`` takes the solve counters as maxima over frames."""
    ref = reference["ring_imminent"]
    cfg = dataclasses.replace(ref["cfg"], frames_per_broadphase=2)
    _, _, diag = parallel.batched_rollout(ref["port"], cfg, 0, 2,
                                          record=lambda _: None)
    assert int(diag["solve_overflow"]) == 8
    assert int(diag["owner_overflow"]) == 0


def test_builders_give_the_same_batch():
    """Both builders describe each scene with the same arrays."""
    for name, (make, _) in SCENES.items():
        jw, tw = _pair(make)
        a, b = jax_to_numpy(jw), tio.world_to_numpy(tw)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
