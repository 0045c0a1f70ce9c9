#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Refuses to run without CUDA (there is no CPU fallback), prints the card's
   name and power limit and builds the kernels (``csrc/*.cu``, nvcc).
2. Holds each kernel against its plain PyTorch twin on a 64-world batch
   advanced into contact: the eligibility mask equal; the slot tables'
   integer outputs equal with ``partner_aware`` off and on, the budget to
   1e-6; one frame with ``touched`` equal, poses to 1e-4, velocities to
   1e-3.
3. Drives the main path, ``batched_rollout`` over 4096 worlds x 256 bodies
   (10 substeps, broadphase every 4 frames) for 60 frames: once to warm up,
   then timed between ``torch.cuda.synchronize()`` calls, with every kernel
   launch counter reset just before. Checks the hard counters are 0, the
   poses finite and on the ground's side, and that all three kernels ran.
4. At the main path's shapes (4096 worlds, from its final state) holds
   each kernel against its twin again and times both (CUDA events); then
   times the same rollout through the twins for a few frames. The mask and
   the tables as in step 2. The frame: ``touched`` equal, and each pose and
   velocity field within a tenth of float32's own spread there, the
   twin's distance from the same twin run in float64. The settled 4096-world
   piles are chaotic: one frame of float32 rounding moves the twin by
   ~1e-2 in angle and ~1 in angular velocity, so step 2's fixed bounds do
   not apply.
5. Reruns 10 frames from the same state and requires bitwise equality.

Prints a ``{"kernels": [...]}`` line (``max_abs_err``: the larger of the
two parity checks), then the card line, then ``{"ok": true, "device":
{...}}`` last. Any failed check raises.
"""

import json
import subprocess
import sys
import time

W_MAIN, N_BODIES, SUBSTEPS, FRAMES = 4096, 256, 10, 60
W_PARITY = 64
TWIN_FRAMES = 8
KERNELS = (
    # name, wrapper attribute, CUDA source, the TPU kernel it replaces
    ("elig", "build_elig_mask", "starframe_tpu_torch/csrc/elig.cu",
     "starframe_tpu/pallas/slots.py:41"),
    ("slots", "build_slot_tables", "starframe_tpu_torch/csrc/slots.cu",
     "starframe_tpu/pallas/slots.py:107"),
    ("frame2", "run_frame2", "starframe_tpu_torch/csrc/frame2.cu",
     "starframe_tpu/pallas/frame2.py:78"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


FRAME_FIELDS = ("posx", "posy", "ang", "velx", "vely", "angvel")


def agree(name: str, k, p, spread=None) -> float:
    """Check one kernel's outputs ``k`` against its twin's ``p`` (both as
    the wrappers return them); returns the max abs error. For the frame,
    ``spread`` is float32's own error per field (twin vs float64 twin)."""
    import torch

    if name == "elig":
        check(torch.equal(k, p), "elig: kernel != twin")
        return max_err(k, p)
    if name == "slots":
        for field, a, b in zip(("partner", "slot_act", "count", "count_touch",
                                "count_close"), k[:5], p[:5]):
            check(torch.equal(a, b), f"slots: {field} differs")
        err = max_err(k[5], p[5])
        check(err <= 1e-6, f"slots: budget off by {err}")
        return err
    check(torch.equal(k[6], p[6]), "frame2: touched differs")
    check(float(k[6].sum()) > 0, "frame2: no contacts, vacuous")
    errs = [max_err(a, b) for a, b in zip(k[:6], p[:6])]
    for field, e, s in zip(FRAME_FIELDS, errs, spread):
        check(e <= 0.1 * s, f"frame2: {field} off by {e}, more than a tenth "
              f"of float32's own spread {s}")
    print("parity frame2 at full size, max abs err (float32 spread): "
          + ", ".join(f"{f} {e:.3g} ({s:.3g})"
                      for f, e, s in zip(FRAME_FIELDS, errs, spread)))
    return max(errs)


def parity(dev, hopper, parallel, batched_worlds) -> dict:
    """Kernel vs twin on a 64-world batch in contact; max abs error each."""
    import torch

    sc = batched_worlds(n_worlds=W_PARITY, n_bodies=N_BODIES,
                        substeps=SUBSTEPS, device=dev)
    cfg = sc.config
    w, _, _ = parallel.batched_rollout(sc.world, cfg, 0, 30,
                                       record=lambda _: None)
    errs = {}

    body, col = parallel._frame2_arrays(w, cfg)
    eargs = (col["cbody"], col["layer"], col["lmask"], col["active"],
             col["sensor"], body["responds"], body["moves"])
    ek = hopper.build_elig_mask(*eargs)
    ep = hopper.elig_mask_plain(*eargs)
    check(torch.equal(ek, ep), "elig: kernel != twin")
    errs["elig"] = max_err(ek, ep)
    print(f"parity elig: equal ({int(ek.sum())} eligible pairs)")

    errs["slots"] = 0.0
    for frames in (1, 4):
        tk, bk = parallel.frame2_tables(w, cfg, frames=frames, elig=ek,
                                        return_budget=True)
        tp, bp = parallel.frame2_tables(w, cfg, frames=frames, elig=ek,
                                        return_budget=True, plain=True)
        for name, a, b in zip(("partner", "slot_act", "count", "count_touch",
                               "count_close"), tk, tp):
            check(torch.equal(a, b), f"slots[{frames}]: {name} differs")
        eb = max_err(bk, bp)
        check(eb <= 1e-6, f"slots[{frames}]: budget off by {eb}")
        errs["slots"] = max(errs["slots"], eb)
        print(f"parity slots partner_aware={frames > 1}: tables equal, "
              f"budget max abs err {eb:.3g}, touching candidates "
              f"{int(tk[3].sum())}")

    tables = parallel.frame2_tables(w, cfg, frames=4, elig=ek)
    wk, touched_k, *_ = parallel.frame2_step(w, cfg, tables=tables)
    wp, touched_p, *_ = parallel.frame2_step(w, cfg, tables=tables,
                                             plain=True)
    check(torch.equal(touched_k, touched_p), "frame2: touched differs")
    check(float(touched_k.sum()) > 0, "frame2: no contacts, vacuous")
    e_pose = max(max_err(wk.bodies.pos, wp.bodies.pos),
                 max_err(wk.bodies.angle, wp.bodies.angle))
    e_vel = max(max_err(wk.bodies.vel, wp.bodies.vel),
                max_err(wk.bodies.ang_vel, wp.bodies.ang_vel))
    check(e_pose <= 1e-4, f"frame2: pose off by {e_pose}")
    check(e_vel <= 1e-3, f"frame2: velocity off by {e_vel}")
    errs["frame2"] = max(e_pose, e_vel)
    print(f"parity frame2: touched equal ({int(touched_k.sum())} touching "
          f"slots), pose max abs err {e_pose:.3g}, velocity {e_vel:.3g}")
    return errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2

    from starframe_tpu_torch import hopper, parallel
    from starframe_tpu_torch.hopper import _build
    from starframe_tpu_torch.scenes import batched_worlds

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)}; build "
          f"{_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    # ---- 2. kernel vs twin ------------------------------------------------
    errs = parity(dev, hopper, parallel, batched_worlds)

    # ---- 3. the main path at full width ------------------------------------
    sc = batched_worlds(n_worlds=W_MAIN, n_bodies=N_BODIES, substeps=SUBSTEPS,
                        device=dev)
    cfg = sc.config
    active = int(((sc.world.bodies.flags & 1) != 0).sum())

    def rollout(n, plain=False):
        return parallel.batched_rollout(sc.world, cfg, 0, n,
                                        record=lambda _: None, plain=plain)

    rollout(FRAMES)  # warm-up
    torch.cuda.synchronize()
    wrappers = {name: getattr(hopper, attr) for name, attr, _, _ in KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    syncs0 = parallel.host_syncs
    t0 = time.perf_counter()
    final, _, diag = rollout(FRAMES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    syncs = parallel.host_syncs - syncs0
    diag = {k: int(v) for k, v in diag.items()}

    pos = final.bodies.pos
    dyn = final.bodies.inv_mass > 0
    check(tuple(pos.shape) == (W_MAIN, N_BODIES, 2), f"pos shape {pos.shape}")
    check(bool(torch.isfinite(pos).all()), "non-finite positions")
    check(bool(torch.isfinite(final.bodies.vel).all()), "non-finite velocities")
    check(diag["slot_overflow"] == 0, f"slot_overflow {diag['slot_overflow']}")
    check(diag["joint_overflow"] == 0, "joint_overflow")
    y_min = float(pos[..., 1][dyn].min())
    check(y_min > 0.2, f"a body sank into the ground (y = {y_min})")
    check(launches["elig"] >= 1, f"elig launched {launches['elig']} times")
    check(launches["slots"] >= FRAMES // 4,
          f"slots launched {launches['slots']} times")
    check(launches["frame2"] == FRAMES,
          f"frame2 launched {launches['frame2']} times")
    ms_frame = 1e3 * seconds / FRAMES
    bps = active * FRAMES / seconds
    print(f"main path: {W_MAIN}x{N_BODIES} worlds, {SUBSTEPS} substeps, "
          f"{FRAMES} frames in {seconds:.4f} s = {ms_frame:.4f} ms/frame, "
          f"{bps:.6g} body-steps/s ({active} active bodies/frame) on {card}")
    print(f"main path counters: {json.dumps(diag)}; launches "
          f"{json.dumps(launches)}; host syncs {syncs} "
          f"({syncs / FRAMES:.3f}/frame); min dynamic y {y_min:.4f}")

    # ---- 4. kernel vs twin, and their times, at the main path's shapes ---
    body, col = parallel._frame2_arrays(final, cfg)
    eargs = (col["cbody"], col["layer"], col["lmask"], col["active"],
             col["sensor"], body["responds"], body["moves"])
    elig = hopper.build_elig_mask(*eargs)
    sweep = parallel._sweep_bounds(final, cfg, cfg.frames_per_broadphase)
    sargs = (body["posx"], body["posy"], body["ang"], sweep, None,
             col["cbody"], col["vlx"], col["vly"], col["radius"], elig)
    skw = dict(C=cfg.slot_capacity, margin=cfg.contact_margin,
               dt=cfg.dt * cfg.frames_per_broadphase, partner_aware=True)
    tables = hopper.build_slot_tables(*sargs, **skw)[:5]
    gravity = final.gravity.expand(W_MAIN, 2).contiguous()
    fargs = [body[k] for k in ("posx", "posy", "ang", "velx", "vely",
                               "angvel", "invm", "invi", "dyn", "kin")]
    fargs += [col[k] for k in ("cbody", "vlx", "vly", "nverts", "radius",
                               "fric", "rest", "sensor")]
    fargs += [tables[0], tables[1], gravity]
    fkw = dict(C=cfg.slot_capacity, substeps=cfg.substeps,
               iterations=cfg.iterations, h=cfg.dt / cfg.substeps, dt=cfg.dt,
               margin=cfg.contact_margin, compliance=cfg.contact_compliance,
               relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping,
               owners=hopper.owner_csr(col["cbody"][0], N_BODIES))
    calls = {
        "elig": (lambda p: hopper.build_elig_mask(*eargs, plain=p)),
        "slots": (lambda p: hopper.build_slot_tables(*sargs, **skw, plain=p)),
        "frame2": (lambda p: hopper.run_frame2(*fargs, **fkw, plain=p)),
    }
    times = {}
    for name, call in calls.items():
        k, p = call(False), call(True)
        spread = None
        if name == "frame2":
            p64 = hopper.frame2_plain(
                *[a.double() if a.dtype == torch.float32 else a
                  for a in fargs], **fkw)
            spread = [max_err(a, b) for a, b in zip(p[:6], p64[:6])]
            del p64
        err = agree(name, k, p, spread)
        del k, p
        errs[name] = max(errs[name], err)
        print(f"parity {name} at {W_MAIN}x{N_BODIES}: agrees, max abs err "
              f"{err:.3g}")
        # twin, kernel, kernel, twin: the card's state is shared fairly
        p1 = cuda_ms(lambda: call(True), 2)
        k1 = cuda_ms(lambda: call(False), 5)
        k2 = cuda_ms(lambda: call(False), 5)
        p2 = cuda_ms(lambda: call(True), 2)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time {name} at {W_MAIN}x{N_BODIES}: kernel "
              f"{times[name][0]:.4f} ms, plain twin {times[name][1]:.4f} ms "
              f"on {card}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout(TWIN_FRAMES, plain=True)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0) / TWIN_FRAMES
    print(f"main path through the plain twins: {twin_ms:.4f} ms/frame over "
          f"{TWIN_FRAMES} frames, vs {ms_frame:.4f} ms/frame through the "
          f"kernels, on {card}")

    # ---- 5. determinism ----------------------------------------------------
    a, _, da = rollout(10)
    b, _, db = rollout(10)
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(a.bodies, field), getattr(b.bodies, field)),
              f"rerun differs in {field}")
    check({k: int(v) for k, v in da.items()}
          == {k: int(v) for k, v in db.items()}, "rerun counters differ")
    print("determinism: 10-frame rerun bitwise equal")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, _, src, tpu in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
