"""``parallel.frame2_inputs``: what the frames of one call share (flags,
topology and shapes, the joint slots, the frame kernel's constant planes),
built once a call. A rollout builds it once and every frame reuses it,
bitwise the same as frames that each build their own
(``frame2_step(..., inputs=None)``), on a contact-only, a jointed and a
sleeping batch. Twins only, no JAX."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import starframe_tpu_torch as st  # noqa: E402
from starframe_tpu_torch import parallel  # noqa: E402
from starframe_tpu_torch.config import SolverConfig  # noqa: E402

FRAMES = 5


def _contact():
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=32, substeps=2,
                                  device="cpu")
    return sc.world, sc.config


def _jointed():
    sc = st.scenes.batchify(st.scenes.mechanism(substeps=2, device="cpu"), 2)
    return sc.world, dataclasses.replace(sc.config, joint_solver="colored")


def _sleeping():
    """tests/test_torch_frame2_sleep.py's config on a small batch settled
    for 30 frames, then its lower bodies put to sleep (the counter at
    ``sleep_frames``, velocities zeroed), so that frozen masses and the
    wake act inside the rollout."""
    sc = st.scenes.batched_worlds(n_worlds=2, n_bodies=32, substeps=2,
                                  device="cpu")
    w = parallel.batched_rollout(sc.world, sc.config, 0, 30,
                                 record=lambda _: None)[0]
    cfg = SolverConfig(substeps=4, slot_capacity=8, sleep_velocity=0.1,
                       sleep_frames=10)
    b = w.bodies
    low = (b.inv_mass > 0) & (b.pos[..., 1] < b.pos[..., 1].median())
    w = dataclasses.replace(w, bodies=dataclasses.replace(
        b, sleep_count=torch.where(low, cfg.sleep_frames, b.sleep_count).to(
            b.sleep_count.dtype),
        vel=torch.where(low[..., None], 0.0, b.vel),
        ang_vel=torch.where(low, 0.0, b.ang_vel)))
    return w, cfg


CASES = {"contact": _contact, "jointed": _jointed, "sleeping": _sleeping}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_builds_its_inputs_once(case, monkeypatch):
    w0, cfg = CASES[case]()
    cfg = dataclasses.replace(cfg, frames_per_broadphase=1)
    builds = []
    build = parallel.frame2_inputs

    def counted(*args, **kw):
        builds.append(args[0])
        return build(*args, **kw)

    monkeypatch.setattr(parallel, "frame2_inputs", counted)
    final, _, _ = parallel.batched_rollout(w0, cfg, 0, FRAMES,
                                           record=lambda _: None)
    assert len(builds) == 1
    w = w0
    for _ in range(FRAMES):  # fresh tables and inputs each frame
        w = parallel.frame2_step(w, cfg)[0]
    assert len(builds) == 1 + FRAMES
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        assert torch.equal(getattr(final.bodies, field),
                           getattr(w.bodies, field)), field
    assert not torch.equal(final.bodies.pos, w0.bodies.pos)
    if cfg.sleep_velocity > 0.0:
        asleep = (final.bodies.sleep_count >= cfg.sleep_frames) & (
            final.bodies.inv_mass > 0)
        assert asleep.any(), "nobody fell asleep: vacuous"
