#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Refuses to run without CUDA (there is no CPU fallback), prints the card's
   name and power limit, builds the kernels (``csrc/*.cu``, one nvcc per
   source in parallel) and prints ptxas's register report for each.
2. Holds each kernel against its plain PyTorch twin on 64-world batches
   advanced into contact. The contact batch: the eligibility mask equal;
   the slot tables' integer outputs equal with ``partner_aware`` off and
   on, the budget to 1e-6; one frame with ``touched`` equal, poses to 1e-4,
   velocities to 1e-3. The jointed batches (``batchify`` of ``mechanism``
   and ``rope_bridge``, and 64 envs of the benchmark's walker 60 frames
   in, at 4 substeps): the joint slots equal, and one frame with joints
   under both joint tiers to the same bounds; the walker also at its own
   10 substeps, world by world as step 4 holds its jointed batches.
3. Drives the main path, ``batched_rollout`` over 4096 worlds x 256 bodies
   (10 substeps, broadphase every 4 frames) for 60 frames: once to warm up,
   then timed between ``torch.cuda.synchronize()`` calls, with every kernel
   launch counter reset just before. Checks the hard counters are 0, the
   poses finite and on the ground's side, and that all three kernels ran.
   Then drives the jointed path the same way: ``batched_rollout`` over
   ``batchify(mechanism(), 1024)`` and ``batchify(rope_bridge(), 1024)``
   (10 substeps) for 60 frames each, with the hard counters 0, the state
   finite, the joint-slot kernel launched and the frame kernel once per
   frame, and the joints' health over the worlds (median and 99th
   percentile) within bounds taken from the JAX package (below).
4. At the main path's shapes (4096 worlds, from its final state) holds
   each kernel against its twin again and times both (CUDA events); then
   times the same rollout through the twins for a few frames. The mask and
   the tables as in step 2. The frame: ``touched`` equal, and each pose and
   velocity field within a tenth of float32's own spread there, the
   twin's distance from the same twin run in float64. The settled 4096-world
   piles are chaotic: one frame of float32 rounding moves the twin by
   ~1e-2 in angle and ~1 in angular velocity, so step 2's fixed bounds do
   not apply. The same at 1024 worlds for the joint-slot kernel (equal)
   and the frame kernel with joints (``touched`` equal, and at most 1% of
   the worlds past poses 1e-4 or velocities 1e-3 times their fastest
   body's speed: see ``agree_worlds``), from each jointed run's final
   state.
5. Reruns 10 frames of the main path, of the mechanism batch and of the
   pile from the same state and requires bitwise equality.

The tile engine runs through the same steps. Step 3 drives
``tiled_rollout`` over ``scenes.pile(n_bodies=10_000, sleep=False)`` (10
substeps, 16 table and 8 solve slots, tables every 8 frames) for 240
frames with ``fuse=False``, warmed up and timed the same way, with the hard
counters 0, the state finite, every body inside the container, the tile
kernels' launches (tables at least once, manifolds once a frame, project
and apply once a substep, the whole-frame kernel never) and the pile's
health at frame 240 within bounds taken from the JAX package (below); then
the same 240 frames fused (the whole-frame kernel K10 once a frame, no
project or apply launch), bitwise equal to the unfused run. Then bench.py's
``pile`` config: ``scenes.pile(n_bodies=10_000)`` with its default sleep
and awake-prefix compaction, fused, for 7 chunks of 240 frames, each a
``tiled_rollout`` continuing from the last, timed each (the best of chunks
2-7 is bench.py's number), with the hard counters 0 in every chunk, the
state finite and inside the container, rows compacted in the last three
chunks, K10 and K6 once per frame that ran (none when nothing is awake), no
K8/K9 launch, at most one host sync a frame, the asleep share and the
health at frame ``PILE_SLEEP_HEALTH_FRAME`` within bounds taken from the
JAX package, and the last chunk rerun bitwise equal from the same state.
Step 2 holds the tile kernels against their twins on ``pile(1021)`` (4
tiles): integer outputs and ``touched`` equal, the rest to 1e-6, with the
manifolds also under a wake speed and a skipped tile, and K10 (2 and 10
substeps, a skipped tile) bitwise equal to the K8/K9 kernels launched once
a substep. Step 4 does so again at 10k bodies from the pile's final state,
and holds K10 against K8/K9 (bitwise) and its twin on the sleeping pile's
states after chunks 2 and 7 (compacted layouts with live and skipped
tiles), times each kernel and its twin, and times the pile through the
twins.

Events and compound bodies (bench.py's ``pile_events`` and
``pile_compound``) run through the same steps. Step 2 holds K6 with event
keys against its twin on ``pile(1021)`` (compacted, not, and with a
skipped tile: keys equal, the rest as without keys), and on the compound
scene of tests/test_tiled_compound.py (515 two-collider bodies, 5 tiles,
built with the port's builder, 30 frames in) K5 (equal, no active slot
pairing two rows of one body), K9's compound form (state and raw velocity
sums to 1e-6), the owner kernels (bitwise) and the compound frame (the
compound rows' whole frame in one launch) without and with CCD, tile 1
skipped: bitwise equal to K8, ``owner_sum``, K9's compound form and
``owner_velocity`` (with CCD, K7 and ``owner_min`` first) launched once a
substep, and within 1e-6 of its twin. Step 3 runs 240 fused
frames of ``pile(10_000, sleep=False)`` with events in turns with the same
rollout without (bitwise the same state and counters, every key -1 or a
pair a < b < M, K10 and the keyed K6 once a frame, a rerun bitwise equal),
then ``pile_compound(10_000)`` for 7 chunks of 240 frames (hard counters
0, ``owner_overflow`` included, the state finite and inside the
container, the compound frame and K6 once a frame that ran, no K10 and no
per-substep launch, at most one host sync a frame, health at frame 240
within bounds taken from the JAX package, the asleep share at frame
1680), the last chunk again through the tile layout directly (every
sibling row's state and sleep counter equal to its block's first, and the
chunk bitwise the same) and the first chunk again with ``fuse=False`` (K8,
K9's compound form and both owner kernels once a substep, bitwise the
compound frame's chunk). Step 4 times K6 with keys on the awake pile's
final state and K9's compound form, the owner kernels, K7 and the other
K8 and K9 forms (``<form>@compound``) and the compound frame (without and
with CCD, held bitwise against the per-substep kernels and to a tenth of
float32's spread against its twin) on the compound pile's, against their
twins, with their bounds at its shapes, and the compound pile through its
twins. Each tile kernel's time is printed twice: the call
(CUDA events around wrapper calls, host dispatch included) and the device
(its one launch replayed with the argument struct built once,
``launch_ms``).

Continuous collision (``cfg.ccd``, bullet bodies) runs through the same
steps. Step 2 holds K7 and the CCD forms of K8 and K9 against their twins
(1e-6) and K10's CCD form bitwise against K7 + K8 + K9 launched once a
substep, on tests/test_ccd.py's tile-engine bullet world (4 tiles, the
bullet 0.3 m from the wall at 200 and 1000 m/s, so its first substep
clamps), K7, ``owner_min`` (bitwise) and K9's compound CCD form with a
two-collider bullet, and K4's CCD form on ``_bullet_batch`` (4 worlds,
frames 1 and 2). Step 3 runs the projectile batch (``_bullet_batch`` at
4096 worlds: 30 frames at 200 and 1000 m/s, every bullet on the wall's
near face; 10 frames at 1000 m/s with restitution 0.9, every world
rebounding at 820-950 m/s), the main path with every dynamic body a
bullet (60 frames in turns with the same scene without CCD, checked as the
main path, a rerun bitwise equal), ``pile(10_000, sleep=False)`` with
every body a bullet (240 frames fused and unfused in turns with the fused
pile without CCD: bitwise equal, a rerun bitwise equal, hard counters 0,
health at frame 240 within the awake pile's bounds, K7 once a substep
unfused and never fused, and the rows K7 clamps in one frame at frames 30,
60 and 120) and ``pile_compound(10_000)`` with bullets (60 frames: the
compound frame's CCD form once a frame, a rerun bitwise equal; with
``fuse=False`` K7, ``owner_min``, K8's and K9's compound CCD forms once a
substep, bitwise equal). Step 4 times the CCD kernels at full size against
their twins, with their bounds.

K4's last three branches (solve-slot compaction, per-world owner tables,
sleep) and the batched contact keys run in step 3 on the main path's
scene: ``batched_compact`` (``batch_solve_capacity`` 4 of C = 8; while a
width drops an imminent slot, the next of ``COMPACT_WIDTHS``, down to the
tile engine's 8 of 16, saying so; 60 frames in turns with compaction off,
``solve_overflow`` 0, K4's ``Cs`` form once a frame, a rerun bitwise),
``batched_compact_ccd`` (the same with every dynamic body a bullet) and
the escorted projectile batch (``_bullet_batch`` with 4 static escorts
beside each bullet and 4 solve slots: the wall is dropped from the solve
and every bullet still rests on its face), ``batched_owners``
(``batch_uniform_topology=False``: bitwise the uniform run, in turns; then
a 4096-world batch of tests/test_frame2.py's ``_scene`` and
``_compound_scene`` alternating, 30 frames, ``owner_overflow`` 0),
``batched_sleep`` (the pile's sleep, 240 frames in turns with it off, the
asleep share, no asleep body moving, a rerun bitwise) and
``batched_events`` (``batched_rollout(with_keys=True)`` in turns with the
run without, bitwise the same state; 10 frames at K = 1 equal to a
``batched_step_events`` loop). Step 4 holds K4's ``Cs`` forms and its
per-world form against their twins at 4096 worlds (``touched``,
``partner_solve`` and ``nact`` equal, poses as ``agree_worlds``) and times
them.

K4 keeps each world's slot table in shared memory (``hopper.
frame2_table_rows``): step 1 prints ptxas's registers, stack and spills of
every K4 instance beside its shared bytes and resident blocks an SM at its
phase's shapes; step 3 checks that the main path counted one
``run_frame2.shared_table_launches`` a frame and prints its peak device
memory; step 6 checks that every K4 phase places all its table's rows
there (M, or the rows that may hold a slot where only they keep records:
the walker's) but the 16-slot uncompacted runs that ``batched_compact``
times its compacted ones against, which keep some rows in K4's global
table (``R < M``), and prints a SHA-256 digest of each K4 phase's final
state. Each K4 phase's start batch, config and frames come from
``tools/frame2_digests.py`` ``phase``, which computes the same digests for
any checkout, to compare a change with its parent. Step 3 also runs that
tool's ``walker`` and ``walker_owners`` phases, the benchmark's 4,096
BipedalWalker-v3 envs.

K7, K8, K9, K10 and the compound frame run one thread a (row, slot)
item, 32 rows x 8 slots a block: step 1 prints ptxas's registers, stack,
spills and shared bytes of each of their instances, beside its resident
blocks an SM. K5 (tile tables) spreads a tile over 8 blocks of 32 rows
and ranks with chunk-culled warp ballots, K2's design: step 1 prints its
ptxas line beside its resident blocks an SM (at least 2), and step 4
prints the share of (row, 32-candidate chunk) pairs and of its visits
its culling skips on the awake pile's final state and the pair tests it
leaves (``tile_chunk_skips``, which K5's operation count takes). K3's
device time is its one launch replayed on the mechanism batch. K6 runs rows on lanes (one thread a row and table slot) with each
slot's constants parked in shared memory: step 1 prints ptxas's line of
each of its instances (none may spill) beside its shared bytes and
resident blocks an SM at each of ``MANIFOLD_SHAPES`` (at least 2), and
step 4 prints the share of its (row, table slot) items with ``act > 0``
and of its warps that are empty at the awake pile's final state.

K2 (slot tables) keeps each world's mask as bits in shared memory and
ranks with warp ballots; K1 (eligibility) writes the mask 16 bytes a
thread: step 1 prints their ptxas lines
(K2 must keep no stack frame and spill nothing) and K2's shared bytes and
resident blocks an SM at each of ``SLOT_SHAPES``; step 2 also holds both
against their twins at their widest shapes, 64 worlds x 1024 colliders
with 32 slots (``parity_wide``: rows past C in the touch tier, in the swept
tier and with all three tiers); step 4 prints, for each phase of K2 at
the main path's final state, the share of (row, 32-partner chunk) pairs and
of the kernel's visits its culling skips and the pair tests it leaves
(``chunk_skips``, which K2's operation count takes), and both terms of each
bound.

Prints the run's wall time, a ``{"kernels": [...]}`` line (``max_abs_err``: the larger of the
two parity checks; ``frame2_joints`` is the frame kernel's joint
instantiation, timed on the mechanism batch; ``bound_ms``: the least time
for each call's bytes or operations, see ``bound``), then the card line,
then ``{"ok": true, "device": {...}}`` last. Any failed check raises.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time

W_MAIN, N_BODIES, SUBSTEPS, FRAMES = 4096, 256, 10, 60
W_PARITY = 64
# the slot kernels' widest shapes: 64 worlds x 1024 colliders, 32 slots
N_WIDE, C_WIDE = 1024, 32
W_JOINTED = 1024  # bench.py:232-237 runs the jointed configs at this width
TWIN_FRAMES = 8
KERNELS = (
    # name, wrapper attribute, CUDA source, the TPU kernel it replaces
    ("elig", "build_elig_mask", "starframe_tpu_torch/csrc/elig.cu",
     "starframe_tpu/pallas/slots.py:41"),
    ("slots", "build_slot_tables", "starframe_tpu_torch/csrc/slots.cu",
     "starframe_tpu/pallas/slots.py:107"),
    ("frame2", "run_frame2", "starframe_tpu_torch/csrc/frame2.cuh",
     "starframe_tpu/pallas/frame2.py:78"),
    ("joint_slots", "build_joint_slots",
     "starframe_tpu_torch/csrc/joint_slots.cu",
     "starframe_tpu/pallas/slots.py:306"),
    ("frame2_joints", "run_frame2", "starframe_tpu_torch/csrc/frame2.cuh",
     "starframe_tpu/pallas/frame2.py:78"),
)
CONTACT_KERNELS = ("elig", "slots", "frame2")
JOINTED = ("mechanism", "rope_bridge")
# (N, M, J, solve slots, rows that may hold a slot) of the benchmark's
# walker (K4 phase ``walker``): 199 edge bodies and 5 parts, 12 joint rows,
# 8 slots, at V = 8
WALKER_SHAPE = (204, 204, 12, 8, 5)
TILE_KERNELS = (
    ("tile_tables", "build_tile_tables",
     "starframe_tpu_torch/csrc/tile_tables.cu",
     "starframe_tpu/pallas/tiles.py:169"),
    ("tile_manifold", "tile_manifold",
     "starframe_tpu_torch/csrc/tile_manifold.cu",
     "starframe_tpu/pallas/tiles.py:419"),
    ("tile_project", "tile_project",
     "starframe_tpu_torch/csrc/tile_substep.cu",
     "starframe_tpu/pallas/tiles.py:943"),
    ("tile_apply", "tile_apply", "starframe_tpu_torch/csrc/tile_substep.cu",
     "starframe_tpu/pallas/tiles.py:1004"),
    ("tile_frame", "tile_frame", "starframe_tpu_torch/csrc/tile_frame.cu",
     "starframe_tpu/pallas/tiles.py:1220"),
)
# What each tile kernel reads of the tile layout, for its bound (the
# pointers of its Args struct in hopper/_build.py): state fields, consts
# fields, large-set fields. Of the solve slots, K8 and K9 read the solve
# masks (sm0, sm1) of every slot and the words of SOLVED_SLOT_WORDS only on
# a slot whose mask is set; K8 reads ``touched`` on every slot. K10 reads
# the same once a frame: its per-substep rereads hit L2, and its own
# corrections, ``lam`` and ``touched`` are scratch it writes first.
_STATE = ("px", "py", "an", "vx", "vy", "om")
TILE_READS = {
    "tile_tables": (
        _STATE[:5], ("vlx", "vly", "rad", "act", "mov", "lay", "msk",
                     "obody", "responds", "sen"),
        ("px", "py", "an", "vlx", "vly", "rad", "act", "lay", "msk")),
    "tile_manifold": (
        _STATE, ("vlx", "vly", "rad", "nv", "fric", "rst", "sen", "invm",
                 "invi"),
        ("px", "py", "an", "vlx", "vly", "rad", "nv", "fric", "rst", "sen")),
    "tile_project": (_STATE, ("invm", "invi", "dynb"), ("px", "py", "an")),
    "tile_apply": (_STATE, ("invm", "invi", "dynb", "kin"),
                   ("px", "py", "an")),
    "tile_frame": (_STATE, ("invm", "invi", "dynb", "kin"),
                   ("px", "py", "an")),
    "tile_ccd": (_STATE, ("dynb", "blt"), ("px", "py", "an")),
    "tile_frame_compound": (_STATE, ("invm", "invi", "dynb", "kin",
                                     "obody"), ("px", "py", "an")),
}
SOLVED_SLOT_WORDS = {
    # pidx_c; pdyn imb iib fric nax nay, 8 anchors, pm0 pm1
    "tile_project": 17,
    # pidx_c; pdyn imb iib fric rest nax nay, 8 anchors; the slot's 2 lam
    "tile_apply": 18,
    # the union of K8's and K9's input words: pidx_c; pdyn imb iib fric rest
    # nax nay, 8 anchors, pm0 pm1
    "tile_frame": 18,
}
# the pile: bench.py:266-280 runs it in chunks of 240 frames, the sleeping
# `pile` config in 7 of them (the first one compiles on the TPU)
PILE_N, PILE_FRAMES, PILE_TWIN_FRAMES, PILE_CHUNKS = 10_000, 240, 4, 7
PILE_PARITY_N = 1021  # 4 tiles of 256 colliders with the 3 statics

# The least time the card could take for a kernel's work: the larger of
# the bytes it must move (each input read once, each output written once)
# over HBM's 3.35 TB/s and its operations over the 67 TFLOP/s of float32
# outside the tensor cores (H100 SXM datasheet figures). The
# kernels' compares and selects are counted at the float32 rate. Operations
# per item, counted from the kernels' code: one candidate pair's box tests
# and tier select (K2, K5), one manifold of two polygons at 8 vertices
# (K4, K6), and one solved slot's projection and velocity pass per substep
# (K4, K8, K9).
PEAK_BYTES_S, PEAK_FLOPS_S = 3.35e12, 67e12
PAIR_FLOPS, MANIFOLD_FLOPS, PROJECT_FLOPS, VELOCITY_FLOPS = 20, 1000, 200, 220
JOINT_FLOPS = 100  # one joint slot's solve, per pass
UNION_FLOPS = 4  # a row's swept box against a chunk's union box (K2, K5)

# Joint health after 60 frames from the start, 10 substeps, per world
# (chip_smoke.joint_health, plus the fastest body's speed and, for the
# mechanism, how far the wheel's mean angular velocity over the run and its
# final one lie from the motor's 2 rad/s). Reference: the JAX package's
# frame-kernel path on the same scenes, `JAX_PLATFORMS=cpu python3
# tools/joint_health_bounds.py --worlds 256` (Pallas interpret mode on a
# CPU), as (median, 99th percentile) over its worlds. The mechanism is not
# a quiet scene there either: its pendulum links overlap at their pins, so
# contacts fight the pins, and in most worlds some body reaches ~90 m/s; the
# worst worlds are blow-ups, so they are reported, not bounded. Each
# quantile of the port's worlds must stay within 3x the reference's same
# quantile, floored at 1e-3 m, 0.05 rad/s and 1 m/s.
HEALTH_REFERENCE = {
    "mechanism": {
        "pin_gap": (0.09330, 0.36409), "stretch": (3.787e-5, 3.879e-5),
        "wheel_mean_err": (0.01180, 1.58514),
        "wheel_final_err": (0.0, 0.27254), "max_speed": (92.703, 210.328)},
    "rope_bridge": {
        "pin_gap": (1.073e-7, 9.765e-7), "stretch": (0.037576, 0.040650),
        "max_speed": (3.9875, 5.9304)},
}
HEALTH_FLOOR = {"pin_gap": 1e-3, "stretch": 1e-3, "wheel_mean_err": 0.05,
                "wheel_final_err": 0.05, "max_speed": 1.0}
MOTOR_SPEED = 2.0  # scenes.mechanism's default

# Pile health after 240 frames from the start, 10 substeps
# (chip_smoke.pile_health) of pile(n_bodies=10_000, sleep=False). Reference:
# the JAX package's XLA tier on the same scene, `JAX_PLATFORMS=cpu python3
# tools/pile_health_bounds.py --seeds 0 1 2` (CPU, minutes a seed), per seed
# 0, 1, 2. The port runs seed 0. Its centre of mass must lie within 0.3 m of
# the reference's seed 0, its lowest body no deeper than 0.1 m below the
# reference's lowest, and its fastest and mean speeds within 3x the
# reference's largest (the fastest body is a heavy-tailed number: 2.43,
# 3.23 and 2.40 m/s over the seeds). The reference's pair buffer overflowed
# by 0, 1 and 16 pairs in the three runs (`pair_overflow`).
PILE_HEALTH_REFERENCE = {
    "com_y": (18.24416, 18.23897, 18.28439),
    "min_y": (0.385594, 0.381567, 0.381492),
    "max_speed": (2.43117, 3.22629, 2.40076),
    "mean_speed": (0.158670, 0.188415, 0.177532)}

# Sleeping-pile health (bench.py's `pile` config: pile(n_bodies=10_000),
# sleep on) at frame PILE_SLEEP_HEALTH_FRAME, the end of the 7th 240-frame
# chunk, and the share of dynamic bodies asleep there. Reference: the JAX
# package's XLA tier with the same sleep config, `JAX_PLATFORMS=cpu python3
# tools/pile_health_bounds.py --sleep --frames 1680 --seeds 0 1 2` (CPU,
# ~26 minutes a seed), per seed; held as PILE_HEALTH_REFERENCE is. The
# asleep share must lie within the seeds' range widened by its own width
# on either side (0.8085-0.897): a sleep that freezes too eagerly or a pile
# that keeps jittering awake falls outside.
PILE_SLEEP_HEALTH_FRAME = 1680
PILE_SLEEP_HEALTH_REFERENCE = {
    "com_y": (18.03562, 18.02846, 18.07793),
    "min_y": (0.377700, 0.379307, 0.378075),
    "max_speed": (1.76000, 0.435943, 1.15827),
    "mean_speed": (0.005717, 0.002756, 0.003161)}
PILE_SLEEP_ASLEEP = (0.838, 0.8613, 0.8675)

# The events and compound paths' kernels: name, wrapper, its launch counter
# (K6 with event keys and K9's compound form count apart from their plain
# launches), CUDA source, what it replaces. The owner reductions replace
# XLA code of the JAX package, not a Pallas kernel.
EC_KERNELS = (
    ("tile_manifold_keys", "tile_manifold", "keys_launches",
     "starframe_tpu_torch/csrc/tile_manifold.cu",
     "starframe_tpu/pallas/tiles.py:419"),
    ("tile_apply_compound", "tile_apply", "compound_launches",
     "starframe_tpu_torch/csrc/tile_substep.cu",
     "starframe_tpu/pallas/tiles.py:1004"),
    ("owner_sum", "owner_sum", "launches",
     "starframe_tpu_torch/csrc/owner_reduce.cu",
     "starframe_tpu/pallas/tiles.py:1460 (_owner_shift_reduce: XLA code, "
     "not a Pallas kernel)"),
    ("owner_velocity", "owner_velocity", "launches",
     "starframe_tpu_torch/csrc/owner_reduce.cu",
     "starframe_tpu/pallas/tiles.py:1460 (_owner_shift_reduce: XLA code, "
     "not a Pallas kernel)"),
    ("tile_frame_compound", "tile_frame", "compound_launches",
     "starframe_tpu_torch/csrc/tile_compound_frame.cu",
     "starframe_tpu/pallas/tiles.py:943 and :1004 (_project_kernel and "
     "_apply_kernel(compound=True), a substep each with the owner sums, "
     "looped at :2031-2086)"),
)
COMPOUND_PARITY_N = 515  # tests/test_tiled_compound.py: 1033 rows, 5 tiles

# Compound-pile health at frame 240 from the start (bench.py's
# `pile_compound`: pile_compound(n_bodies=10_000), sleep on, 10 substeps;
# chip_smoke.pile_health), held as PILE_HEALTH_REFERENCE is. Reference: the
# JAX package's tile engine on the same scene, in interpret mode on a CPU,
# `JAX_PLATFORMS=cpu python3 tools/pile_health_bounds.py --scene compound
# --seeds 0 1 2` (~70 minutes a seed, three at once), per seed 0, 1, 2; its
# hard counters 0. Not the XLA tier, as for the pile: its grid broadphase
# drops ~4000 pairs a frame while this lattice falls (`pair_overflow`
# 3842-4011; ROADMAP.md C). At frame 240 the last rows have just landed:
# the fastest body is a heavy-tailed number.
PILE_COMPOUND_HEALTH_FRAME = 240
PILE_COMPOUND_HEALTH_REFERENCE = {
    "com_y": (7.956663, 7.960443, 7.959355),
    "min_y": (0.262114, 0.257949, 0.260877),
    "max_speed": (6.351058, 15.461591, 12.796039),
    "mean_speed": (0.395540, 0.482502, 0.409107)}

# CCD (bullet bodies, cfg.ccd): K7 and the CCD forms of K4, K8, K9 and K10
# (each counted apart from its plain launches), and the compound rows'
# owner minimum: name, wrapper, its launch counter, CUDA source, what it
# replaces.
CCD_KERNELS = (
    ("tile_ccd", "tile_ccd", "launches",
     "starframe_tpu_torch/csrc/tile_substep.cu",
     "starframe_tpu/pallas/tiles.py:759"),
    ("tile_project_ccd", "tile_project", "ccd_launches",
     "starframe_tpu_torch/csrc/tile_substep.cu",
     "starframe_tpu/pallas/tiles.py:943"),
    ("tile_apply_ccd", "tile_apply", "ccd_launches",
     "starframe_tpu_torch/csrc/tile_substep.cu",
     "starframe_tpu/pallas/tiles.py:1004"),
    ("tile_frame_ccd", "tile_frame", "ccd_launches",
     "starframe_tpu_torch/csrc/tile_frame.cu",
     "starframe_tpu/pallas/tiles.py:1220"),
    ("owner_min", "owner_min", "launches",
     "starframe_tpu_torch/csrc/owner_reduce.cu",
     "starframe_tpu/pallas/tiles.py:1483 (_owner_min3: XLA code, not a "
     "Pallas kernel)"),
    ("tile_frame_compound_ccd", "tile_frame", "compound_ccd_launches",
     "starframe_tpu_torch/csrc/tile_compound_frame.cu",
     "starframe_tpu/pallas/tiles.py:759, :943 and :1004 (_ccd_kernel, "
     "_project_kernel and _apply_kernel(compound=True), a substep each with "
     "the owner reductions, looped at :2010-2086)"),
    ("frame2_ccd", "run_frame2", "ccd_launches",
     "starframe_tpu_torch/csrc/frame2.cuh",
     "starframe_tpu/pallas/frame2.py:78"),
)
# K4's last three branches: per-frame solve-slot compaction (``Cs``), per
# world owner tables, and sleep (the frozen frame, no kernel of its own):
# name, the counter of run_frame2 that counts the form, the TPU kernel
A1_KERNELS = (
    ("frame2_compact", "compact_launches",
     "starframe_tpu/pallas/frame2.py:97 (Cs, :361-426)"),
    ("frame2_compact_ccd", "compact_launches",
     "starframe_tpu/pallas/frame2.py:97 (Cs with CCD, :361-426, 464-514)"),
    ("frame2_owners", "owner_launches",
     "starframe_tpu/pallas/frame2.py:98 (per-world owner tables, :178-190)"),
)
# (table width C, solve width Cs) to try, in order; a hard drop takes the
# next: the settled main path has rows with 8 imminent slots, so at its
# C = 8 every Cs drops some, and compaction then runs at the tile engine's
# widths, 8 of 16 (PERF.md §6)
COMPACT_WIDTHS = ((8, 4), (8, 6), (16, 8))
# the pile's sleep (starframe_tpu/scenes/pile.py:76-77) on the main path
SLEEP_VELOCITY, SLEEP_FRAMES, SLEEP_RUN = 0.1, 30, 240
HET_FRAMES = 30  # the alternating-topology batch: frames into contact
# tests/test_ccd.py: the wall's half-width 0.1 plus the bullet's radius 0.05;
# a bullet rests on the near face within the contact margin and ccd_slop
WALL_FACE = -0.15
PROJECTILE_W, PROJECTILE_FRAMES = 4096, 30
# One solved slot's TOI (K7, K4's CCD pass): two poses' anchor kinematics
# (8 anchor rotations and 2 normals) and 4 sin/cos of the partner, counted
# at ~20 operations each, and per point the closing, the allowed depth and
# the fraction.
CCD_FLOPS = 200
# K7 reads, of a solved slot: pidx_c; pdyn nax nay, 8 anchors
CCD_SLOT_WORDS = 12
# the pile's CCD states the tile kernels are timed on: frames into the fall
PILE_CCD_FRAMES = (30, 60, 120)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# each K4 phase's final-state digest, (R, M) and frame count
DIGESTS, TABLE_ROWS, PHASE_FRAMES = {}, {}, {}
# each timed tile kernel's device time, its one launch replayed
# (``launch_ms``), beside the call time of ``turns``
DEVICE_MS = {}


@functools.lru_cache(maxsize=None)
def digests_tool():
    """``tools/frame2_digests.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        "_frame2_digests", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "frame2_digests.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def table_rows(w, cfg) -> tuple:
    """``(R, rows)``: the rows of ``w``'s slot table that K4 keeps in
    shared memory under ``cfg``, and all the table's rows (M, or the rows
    that may hold a slot where only they keep records)."""
    from starframe_tpu_torch import parallel

    k4 = parallel.frame2_inputs(w, cfg).k4
    return k4.R, k4.table_rows


def k4_phase(name, dev) -> tuple:
    """``(world, cfg, frames)`` of K4 phase ``name``: its start batch,
    config and frame count from ``tools/frame2_digests.py`` ``phase``, the
    one definition this script, that tool and ``tools/frame2_times.py``
    run."""
    w, cfg, frames = digests_tool().phase(sys.modules[__name__], name, dev)
    PHASE_FRAMES[name] = frames
    return w, cfg, frames


def record_phase(name, w, cfg, frames, final, keys=None) -> None:
    """Keep a K4 phase's final-state digest (with its keys) and its form's
    ``(R, M)``; ``frames`` is what the run took, held to the phase's."""
    check(frames == PHASE_FRAMES[name],
          f"{name}: ran {frames} frames, the phase has {PHASE_FRAMES[name]}")
    tool = digests_tool()
    DIGESTS[name] = (tool.digest(final) if keys is None
                     else tool.keys_digest(final, keys))
    TABLE_ROWS[name] = table_rows(w, cfg)


def ptxas_report(log: str, name_re: str, label) -> dict:
    """``{label(match): (registers, stack bytes, spill stores, spill
    loads)}`` of every kernel whose mangled name matches ``name_re``, from
    the build's ptxas report."""
    import re

    out, inst = {}, None
    for line in log.splitlines():
        m = re.search(name_re, line)
        if m and "Function properties" in line:
            inst = label(m)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if inst and m:
            out[inst] = [int(m.group(1)), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if inst and m:
            out[inst].insert(0, int(m.group(1)))
            inst = None
    return {k: tuple(v) for k, v in out.items()}


def _flags(*bits) -> str:
    return ",".join("true" if b == "1" else "false" for b in bits)


def ptxas_k4(log: str) -> dict:
    """:func:`ptxas_report` of every K4 instance, as
    ``<V,kJ,kCcd,kRanked>`` (``<V,kJ,kCcd>`` for a build without the
    ranked table)."""
    return ptxas_report(
        log, r"frame2_kernelILi(\d+)ELb(\d)ELb(\d)E(?:Lb(\d)E)?",
        lambda m: f"<{m.group(1)},"
                  f"{_flags(*(g for g in m.group(2, 3, 4) if g))}>")


# (M, C) of every K2 phase: the main path at C = 8 and 16, the projectile
# and jointed batches (M = 128), the 64 x 1024 parity batch at C = 32
SLOT_SHAPES = ((256, 8), (256, 16), (128, 8), (1024, 32))


def ptxas_slots(log: str, lib) -> None:
    """Print ptxas's report of K2 (``slot_kernel<kVec>``) beside its shared
    memory and resident blocks an SM at each of ``SLOT_SHAPES``, and K1's
    (``elig_kernel<kStore>``); K2 must keep no stack frame and spill
    nothing."""
    k2 = ptxas_report(log, r"slot_kernelILb(\d)E",
                      lambda m: f"<{_flags(m.group(1))}>")
    k1 = ptxas_report(log, r"elig_kernelILi(\d+)E",
                      lambda m: f"<{m.group(1)}>")
    check(len(k2) == 2 and len(k1) == 3, f"ptxas reported {len(k2)} K2 "
          f"and {len(k1)} K1 instances, not 2 and 3")
    for name, insts in (("K2 slot_kernel", k2), ("K1 elig_kernel", k1)):
        for inst, (regs, stack, st_, ld) in sorted(insts.items()):
            print(f"{name}{inst}: {regs} registers, {stack} bytes stack, "
                  f"{st_} bytes spill stores, {ld} bytes spill loads")
    for inst, (_, stack, st_, ld) in k2.items():
        check(stack == 0 and st_ == 0 and ld == 0, f"K2 {inst}: {stack} "
              f"bytes stack, {st_} / {ld} bytes spilled")
    for m, c in SLOT_SHAPES:  # <true>: rows of 16-byte multiples, as here
        print(f"K2 slot_kernel<true> at M = {m}, C = {c}: "
              f"{lib.sf_slots_shared_bytes(m, c)} bytes of shared memory, "
              f"{lib.sf_slots_blocks_per_sm(m, c)} block(s) of "
              f"{512 if m > 256 else 256} threads an SM")


def slot_call_args(parallel, w, cfg) -> tuple:
    """``(eargs, sargs, skw)``: K1's arguments and K2's but the mask, as a
    rollout of ``w`` under ``cfg`` passes them at a table build
    (``parallel.frame2_elig``, ``frame2_tables`` over
    ``cfg.frames_per_broadphase`` frames, partner-aware past one)."""
    inputs = parallel.frame2_inputs(w, cfg)
    (posx, posy, ang, vx, vy, _), _ = parallel.frame2_planes(w, cfg)
    K = cfg.frames_per_broadphase
    if K > 1:
        vx, vy = parallel._sweep_bounds(w, cfg, K), None
    k4 = inputs.k4
    sargs = (posx, posy, ang, vx, vy, k4.cbody, k4.vlx, k4.vly, k4.radius)
    skw = dict(C=cfg.slot_capacity, margin=cfg.contact_margin, dt=cfg.dt * K,
               partner_aware=K > 1)
    return inputs.elig, sargs, skw


# (V, C, Cs) of K6's launches: the piles' hexagons (V = 6) at the awake
# pile's 16/8 and the compound pile's 24/8, and at Cs = C; the 4-vertex
# instance at the compound test scene's 8/8; the 8-vertex one at 16/8
MANIFOLD_SHAPES = ((6, 16, 8), (6, 24, 8), (6, 16, 16), (6, 24, 24),
                   (4, 8, 8), (8, 16, 8))


def ptxas_substep(log: str, lib) -> None:
    """ptxas's registers, stack, spills and shared bytes of K5, of K7 and of
    each (row, slot) instance of K8 and K9, of K10 and of the compound
    frame, beside its resident blocks an SM (256 threads a block; K5 must
    fit two); and K6's, beside its dynamic shared memory and resident
    blocks an SM at each of ``MANIFOLD_SHAPES``."""
    import re

    smem = {}
    inst = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            inst = m.group(1)
        m = re.search(r"(\d+) bytes smem", line)
        if inst and m:
            smem[inst] = int(m.group(1))
    kinds = (
        (r"tile_tables_kernel",
         lambda m: ("K5", lib.sf_tile_tables_blocks_per_sm())),
        (r"tile_ccd_kernel",
         lambda m: ("K7", lib.sf_tile_ccd_blocks_per_sm())),
        (r"tile_project_kernelILb(\d)E",
         lambda m: (f"K8 <{_flags(m.group(1))}>",
                    lib.sf_tile_substep_blocks_per_sm(0, 0, int(m.group(1))))),
        (r"tile_apply_kernelILb(\d)ELb(\d)E",
         lambda m: (f"K9 <{_flags(*m.group(1, 2))}>",
                    lib.sf_tile_substep_blocks_per_sm(
                        1, int(m.group(1)), int(m.group(2))))),
        (r"tile_frame_kernelILb(\d)E",
         lambda m: (f"K10 <{_flags(m.group(1))}>",
                    lib.sf_tile_frame_blocks_per_sm(int(m.group(1))))),
        (r"tile_compound_frame_kernelILb(\d)E",
         lambda m: (f"compound frame <{_flags(m.group(1))}>",
                    lib.sf_tile_compound_frame_blocks_per_sm(
                        int(m.group(1))))))
    seen = 0
    for name_re, label in kinds:
        for (name, blocks), (regs, stack, st_, ld) in sorted(ptxas_report(
                log, name_re, label).items()):
            mangled = [k for k in smem if re.search(name_re, k)
                       and label(re.search(name_re, k))[0] == name]
            shared = smem[mangled[0]] if mangled else 0
            check(blocks >= (2 if name == "K5" else 1),
                  f"{name}: {blocks} blocks fit an SM")
            print(f"{name}: {regs} registers, {stack} bytes stack, {st_} "
                  f"bytes spill stores, {ld} bytes spill loads, {shared} "
                  f"bytes shared, {blocks} blocks of 256 threads an SM")
            seen += 1
    check(seen == 12, f"ptxas reported {seen} K5/K7/K8/K9/K10/compound "
          "frame instances, not 12")
    k6 = ptxas_report(log, r"tile_manifold_kernelILi(\d)E",
                      lambda m: int(m.group(1)))
    check(sorted(k6) == [4, 6, 8], f"ptxas reported K6 instances "
          f"{sorted(k6)}")
    for vk, (regs, stack, st_, ld) in sorted(k6.items()):
        check(st_ == 0 and ld == 0, f"K6 <{vk}>: {st_} / {ld} bytes spilled")
        shapes = [sh for sh in MANIFOLD_SHAPES
                  if lib.sf_tile_manifold_width(sh[0]) == vk]
        print(f"K6 <{vk}>: {regs} registers, {stack} bytes stack, {st_} bytes "
              f"spill stores, {ld} bytes spill loads; " + "; ".join(
                  f"V = {v}, C = {c}, Cs = {cs}: "
                  f"{lib.sf_tile_manifold_shared_bytes(v, c, cs)} bytes "
                  f"shared, {lib.sf_tile_manifold_blocks_per_sm(v, c, cs)} "
                  "blocks of 256 threads an SM" for v, c, cs in shapes))
        for v, c, cs in shapes:
            check(lib.sf_tile_manifold_blocks_per_sm(v, c, cs) >= 2,
                  f"K6 <{vk}> at C = {c}, Cs = {cs}: under 2 blocks an SM")


def chunk_skips(sargs, skw, elig, budget) -> dict:
    """What K2's chunk culling (``csrc/slots.cu``) leaves to test on these
    inputs, recomputed in plain PyTorch, for each phase the kernel runs
    (``1``: the partner-aware sweep's, only when partner-aware; ``2``: the
    tables'). A row skips a 32-partner chunk when it has no eligible partner
    there or its swept box misses the union of the chunk's. ``row``: the
    share of (row, chunk) pairs skipped; ``warp``: the share of the
    kernel's (pair of rows, chunk) visits skipped (a warp takes rows i and
    i + n_warps and visits the union of their chunks); ``pairs``: the
    eligible pairs in the chunks the rows visit, which any kernel that
    culls so must test. ``budget`` is K2's, the partner-aware sweep."""
    import torch
    import torch.nn.functional as F

    from starframe_tpu_torch.hopper import slots

    posx, posy, ang, vx, vy, cbody, vlx, vly, radius = sargs
    _, close, sx, sy = slots._boxes(posx, posy, ang, vx,
                                    vx if vy is None else vy, cbody, vlx,
                                    vly, radius, skw["dt"], skw["margin"])
    W, M = cbody.shape
    K = -(-M // 32)
    n_eligible = (F.pad(elig != 0, (0, 0, 0, 32 * K - M)).view(W, K, 32, M)
                  .sum(2).transpose(1, 2))  # [W, M(i), K]
    half = 8 if M <= 256 else 16  # the kernel's warps a block
    rows = -(-M // (2 * half)) * 2 * half

    def union(x, lo):  # [W, K] min (lo) or max over each chunk, NaN ignored
        fill = float("inf") if lo else float("-inf")
        x = F.pad(torch.nan_to_num(x, nan=fill), (0, 32 * K - M), value=fill)
        x = x.view(W, K, 32)
        return (x.amin(-1) if lo else x.amax(-1))[:, None, :]

    phases = {2: (sx, sy)}
    if skw["partner_aware"]:
        phases = {1: (sx, sy), 2: (budget, budget)}
    out = {}
    for phase, (wx, wy) in phases.items():
        lx, hx, ly, hy = slots._swept(close, wx, wy)
        visit = ((n_eligible > 0)
                 & (union(lx, True) <= hx[..., None])
                 & (lx[..., None] <= union(hx, False))
                 & (union(ly, True) <= hy[..., None])
                 & (ly[..., None] <= union(hy, False)))
        pairs = F.pad(visit, (0, 0, 0, rows - M)).view(W, -1, 2, half, K)
        out[phase] = {
            "row": 1.0 - float(visit.float().mean()),
            "warp": 1.0 - float((pairs[:, :, 0] | pairs[:, :, 1])
                                .float().mean()),
            "pairs": int(n_eligible[visit].sum())}
    return out


def tile_chunk_skips(state, consts, large, edges, g, tkw) -> dict:
    """What K5's chunk culling (``csrc/tile_tables.cu``) leaves to test on
    these inputs, recomputed in plain PyTorch from the twin's boxes: a row
    that takes candidates (it responds, or is a moving sensor) skips a
    32-candidate chunk when the union swept box of the chunk's eligible
    candidates (moving window rows, active large-set slots) misses its own
    swept box. ``row``: the share of (row, chunk) pairs skipped; ``warp``:
    the share of the kernel's (pair of rows, chunk) visits skipped (a warp
    takes rows 2p and 2p + 1 and visits the union of their chunks);
    ``unions``: the union tests, one a (row, chunk); ``pairs``: the pairs
    in visited chunks that pass the filters before the box tests (an
    eligible candidate, not the row itself or a sibling, layers both
    ways), which any kernel that culls so must test; ``eligible``: those
    pairs in every chunk."""
    import torch

    from starframe_tpu_torch.hopper import tiles as ht

    Nt = state["px"].shape[0]
    dev = state["px"].device
    idx = ht._cand_index(Nt, dev)
    zl = torch.zeros_like(large["px"])

    def cand(x, xl):
        return ht._cand(x, xl, idx)

    c_an = cand(state["an"], large["an"])
    ca, sa = torch.cos(c_an), torch.sin(c_an)
    vlx = ht._cand_verts(consts["vlx"], large["vlx"], idx)
    vly = ht._cand_verts(consts["vly"], large["vly"], idx)
    c_px, c_py = cand(state["px"], large["px"]), cand(state["py"], large["py"])
    wx = c_px[None] + ca[None] * vlx - sa[None] * vly
    wy = c_py[None] + sa[None] * vlx + ca[None] * vly
    ext = torch.sqrt(vlx * vlx + vly * vly).amax(0)
    c_rad = cand(consts["rad"], large["rad"])
    ext = ext + c_rad
    c_part = cand(consts["mov"], large["act"])
    c_act = cand(consts["act"], large["act"])
    c_vx, c_vy = cand(state["vx"], zl), cand(state["vy"], zl)
    dt, K = tkw["dt"], tkw["sweep_frames"]
    if K > 1:
        gmag = torch.sqrt(g[0] * g[0] + g[1] * g[1])
        spd = torch.sqrt(c_vx * c_vx + c_vy * c_vy)
        swx = swy = torch.minimum(
            (spd + gmag * dt + tkw["sweep_slack"]) * (K * dt)
            + tkw["sweep_floor"] * ext, tkw["sweep_cap"] * ext) * (c_part > 0)
    else:
        swx, swy = torch.abs(c_vx) * dt, torch.abs(c_vy) * dt
    pad = c_rad + 0.5 * tkw["margin"]
    box = (wx.amin(0) - pad - swx, wx.amax(0) + pad + swx,
           wy.amin(0) - pad - swy, wy.amax(0) + pad + swy)
    elig = (c_part > 0) & (c_act > 0)  # [Nt, S]
    n_ch = elig.shape[1] // 32
    inf = float("inf")
    u = [torch.where(elig, b, inf if lo else -inf).view(Nt, n_ch, 32)
         for b, lo in zip(box, (True, False, True, False))]
    u = [x.amin(-1) if lo else x.amax(-1)
         for x, lo in zip(u, (True, False, True, False))]  # [Nt, n_ch]
    own = [ht._own(b, Nt) for b in box]  # [Nt, T]
    row_ok = (consts["responds"] > 0) | ((consts["sen"] > 0)
                                         & (consts["mov"] > 0))
    visit = (row_ok[..., None]
             & (u[0][:, None] <= own[1][..., None])
             & (own[0][..., None] <= u[1][:, None])
             & (u[2][:, None] <= own[3][..., None])
             & (own[2][..., None] <= u[3][:, None]))  # [Nt, T, n_ch]
    c_lay = cand(consts["lay"], large["lay"])
    c_msk = cand(consts["msk"], large["msk"])
    c_ob = cand(consts["obody"], torch.full_like(large["lay"], -1))
    gid = torch.arange(elig.shape[1], device=dev)
    o_gid = ht._own(gid[None].expand(Nt, -1), Nt)
    ok = (elig[:, :, None] & (gid[None, :, None] != o_gid[:, None, :])
          & (c_ob[:, :, None] != ht._own(c_ob, Nt)[:, None, :])
          & (((ht._own(c_msk, Nt)[:, None, :] >> c_lay[:, :, None]) & 1)
             != 0)
          & (((c_msk[:, :, None] >> ht._own(c_lay, Nt)[:, None, :]) & 1)
             != 0))  # [Nt, S, T]
    per_chunk = ok.view(Nt, n_ch, 32, -1).sum(2).transpose(1, 2)
    pairs2 = visit.view(Nt, -1, 2, n_ch)
    return {"row": 1.0 - float(visit.float().mean()),
            "warp": 1.0 - float((pairs2[:, :, 0] | pairs2[:, :, 1])
                                .float().mean()),
            "unions": visit.numel(),
            "pairs": int(per_chunk[visit].sum()),
            "eligible": int((per_chunk * row_ok[..., None]).sum())}


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def joint_health(pos, angle, joints) -> dict:
    """Each world's worst joint violation (numpy, float64, ``[W]``): the
    gap between the two anchors of a pin or weld (``pin_gap``), and a
    distance joint's length outside ``[lo, hi]`` (``stretch``). ``pos [W,
    N, 2]``, ``angle [W, N]``; ``joints`` holds the ``[W, J]`` joint arrays
    under their field names."""
    import numpy as np

    pos, angle = np.asarray(pos, np.float64), np.asarray(angle, np.float64)

    def anchor(body, local):
        p = np.take_along_axis(pos, body[..., None], axis=1)
        th = np.take_along_axis(angle, body, axis=1)
        c, s = np.cos(th), np.sin(th)
        lx, ly = local[..., 0], local[..., 1]
        return p + np.stack([c * lx - s * ly, s * lx + c * ly], axis=-1)

    jt = joints["jtype"]
    d = np.linalg.norm(anchor(joints["body_a"], joints["anchor_a"])
                       - anchor(joints["body_b"], joints["anchor_b"]),
                       axis=-1)
    point, dist = (jt == 2) | (jt == 5), jt == 1
    stretch = np.maximum(np.maximum(d - joints["hi"], joints["lo"] - d), 0.0)
    return {"pin_gap": np.where(point, d, 0.0).max(axis=1),
            "stretch": np.where(dist, stretch, 0.0).max(axis=1)}


def pile_health(pos, vel, dyn) -> dict:
    """A pile's aggregate health (numpy, float64): the dynamic bodies' mean
    height (the centre of mass: the pile's bodies have one density), the
    lowest one's, and their fastest and mean speed. ``pos``/``vel`` ``[N,
    2]``, ``dyn`` ``[N]`` bool."""
    import numpy as np

    p = np.asarray(pos, np.float64)[dyn]
    speed = np.linalg.norm(np.asarray(vel, np.float64)[dyn], axis=-1)
    return {"com_y": float(p[:, 1].mean()), "min_y": float(p[:, 1].min()),
            "max_speed": float(speed.max()),
            "mean_speed": float(speed.mean())}


def quantiles(x) -> list:
    """Median, 99th percentile and max of a per-world array."""
    import numpy as np

    return [float(v) for v in np.quantile(np.asarray(x, np.float64),
                                          (0.5, 0.99, 1.0))]


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


def launch_ms(call, reps: int = 20):
    """Device time of the one kernel launch ``call()`` makes: ``reps``
    replays of it (``_build.launch`` with its argument struct built once,
    no wrapper) captured in a CUDA graph, the graph's replay timed with
    CUDA events, so that the host's launch rate does not bound it (the
    cooperative whole-frame kernels, each far longer than a launch, are
    replayed without a graph); None if ``call()`` makes another number of
    launches. The call's outputs are kept alive while the launch replays
    into them."""
    import torch
    from starframe_tpu_torch.hopper import _build

    made, orig = [], _build.launch

    def record(name, args, device):
        made.append((name, args, device))
        orig(name, args, device)

    _build.launch = record
    try:
        out = call()
    finally:
        _build.launch = orig
    if len(made) != 1:
        return None
    if made[0][0] in ("sf_tile_frame", "sf_tile_compound_frame"):
        # cooperative: not captured; each runs far longer than its launch
        ms = cuda_ms(lambda: orig(*made[0]), reps)
        del out
        return ms
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            orig(*made[0])
    ms = cuda_ms(graph.replay, 1) / reps
    del out, graph
    return ms


def device_str(name) -> str:
    ms = DEVICE_MS.get(name)
    return "device not measured" if ms is None else f"device {ms:.4f} ms"


def turns(call, twin_reps: int = 2, kernel_reps: int = 5):
    """``(kernel ms, twin ms)`` of ``call(plain)``: twin, kernel, kernel,
    twin, so the card's state is shared fairly."""
    p1 = cuda_ms(lambda: call(True), twin_reps)
    k1 = cuda_ms(lambda: call(False), kernel_reps)
    k2 = cuda_ms(lambda: call(False), kernel_reps)
    p2 = cuda_ms(lambda: call(True), twin_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
    if name == "joint_slots":
        for field, a, b in zip(("jslot", "jside", "jact", "count"), k, p):
            check(torch.equal(a, b), f"joint_slots: {field} differs")
        return max(max_err(a, b) for a, b in zip(k, p))
    check(torch.equal(k[6], p[6]), f"{name}: touched differs")
    check(float(k[6].sum()) > 0, f"{name}: no contacts, vacuous")
    errs = [max_err(a, b) for a, b in zip(k[:6], p[:6])]
    for field, e, s in zip(FRAME_FIELDS, errs, spread):
        check(e <= 0.1 * s, f"{name}: {field} off by {e}, more than a tenth "
              f"of float32's own spread {s}")
    print(f"parity {name} at full size, max abs err (float32 spread): "
          + ", ".join(f"{f} {e:.3g} ({s:.3g})"
                      for f, e, s in zip(FRAME_FIELDS, errs, spread)))
    return max(errs)


def agree_worlds(name, k, p, max_share=0.01) -> float:
    """The frame with joints at full width, world by world: ``touched``
    equal everywhere, and in at most ``max_share`` of the worlds a pose
    further than 1e-4 from the twin's or a velocity further than 1e-3 times
    the world's fastest body speed (at least 1 m/s). Jointed worlds blow up
    (the mechanism's pendulum links overlap at their pins, so contacts
    fight the pins, in the JAX package too: bodies reach ~90 m/s, where one
    float32 ulp of a position is 1e-2 m/s of velocity), and there one ulp
    can flip a contact or friction decision, on either side of the
    reference. Returns the max abs error over all worlds."""
    import torch

    check(torch.equal(k[6], p[6]), f"{name}: touched differs")
    check(float(k[6].sum()) > 0, f"{name}: no contacts, vacuous")
    speed = torch.sqrt(p[3].double() ** 2 + p[4].double() ** 2).amax(dim=1)
    errs = [(a.double() - b.double()).abs().amax(dim=1)
            for a, b in zip(k[:6], p[:6])]
    pose = torch.stack(errs[:3]).amax(0)
    vel = torch.stack(errs[3:]).amax(0)
    off = (pose > 1e-4) | (vel > 1e-3 * torch.clamp(speed, min=1.0))
    n_off, W = int(off.sum()), off.shape[0]
    q = [float(x) for x in torch.quantile(pose, torch.tensor(
        [0.5, 0.99], dtype=pose.dtype, device=pose.device))]
    check(n_off <= max_share * W, f"{name}: {n_off} of {W} worlds off")
    print(f"parity {name} at {W} worlds: touched equal; {n_off} of {W} "
          f"worlds past poses 1e-4 / velocities 1e-3 x speed; pose err "
          f"median {q[0]:.3g}, 99th percentile {q[1]:.3g}, max "
          f"{float(pose.max()):.3g}; velocity err max {float(vel.max()):.3g} "
          f"(fastest body {float(speed.max()):.3g} m/s)")
    return max(float(pose.max()), float(vel.max()))


def frame_call(hopper, parallel, w, cfg, tables):
    """``(args, kwargs)`` of ``hopper.run_frame2`` for one frame of ``w``,
    as ``parallel.frame2_step`` builds them."""
    planes, masses = parallel.frame2_planes(w, cfg)
    inputs = parallel.frame2_inputs(w, cfg).k4
    return (*planes, tables[0], tables[1], inputs), dict(masses=masses)


def as_double(x):
    """``x`` with every float tensor in it (nested in tuples, dicts and
    dataclasses) as float64."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **as_double(
            {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}))
    if isinstance(x, dict):
        return {k: as_double(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(map(as_double, x))
    return x


def f32_spread(hopper, fargs, fkw, p):
    """Per field, how far the f32 twin's frame ``p`` lies from the same
    twin run in float64 on the same inputs."""
    p64 = hopper.frame2_plain(*as_double(fargs), **as_double(fkw))
    return [max_err(a, b) for a, b in zip(p[:6], p64[:6])]


def parity(dev, hopper, parallel, batched_worlds) -> dict:
    """Kernel vs twin on a 64-world batch in contact; max abs error each."""
    import torch

    sc = batched_worlds(n_worlds=W_PARITY, n_bodies=N_BODIES,
                        substeps=SUBSTEPS, device=dev)
    cfg = sc.config
    w, _, _ = parallel.batched_rollout(sc.world, cfg, 0, 30,
                                       record=lambda _: None)
    errs = {}

    eargs = parallel.frame2_inputs(w, cfg).elig
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
    errs["frame2"] = frame_parity("frame2", parallel, w, cfg, tables)
    return errs


def edge_batch(w, seed=0):
    """``w`` with its even worlds squeezed toward their centre to half
    their spacing and jostled (positions into contact, fast velocities: rows
    fill every tier) and its odd worlds squeezed to a fifth of their spacing
    (rows hold more than 32 touching partners)."""
    import dataclasses

    import torch

    g = torch.Generator().manual_seed(seed)
    b = w.bodies
    dyn = (b.inv_mass > 0)[..., None]
    even = (torch.arange(b.pos.shape[0], device=b.pos.device)
            % 2 == 0)[:, None, None]
    dpos = torch.randn(b.pos.shape, generator=g).to(b.pos.device)
    dvel = torch.randn(b.vel.shape, generator=g).to(b.pos.device)
    c = (b.pos * dyn).sum(1, keepdim=True) / dyn.sum(1, keepdim=True)
    pos = torch.where(even, c + 0.5 * (b.pos - c) + 0.25 * dpos,
                      c + 0.2 * (b.pos - c))
    pos = torch.where(dyn, pos, b.pos)
    vel = torch.where(dyn & even, b.vel + 20.0 * dvel, b.vel)
    return dataclasses.replace(w, bodies=dataclasses.replace(
        b, pos=pos.contiguous(), vel=vel.contiguous()))


def parity_wide(dev, hopper, parallel, batched_worlds) -> dict:
    """K1 and K2 against their twins at their widest shapes, ``W_PARITY``
    worlds x ``N_WIDE`` colliders with ``C_WIDE`` slots (:func:`edge_batch`):
    the mask equal, also with every fifth collider on layer 31 alone; the
    tables' integer outputs equal with ``partner_aware`` off and on, the
    budget to 1e-6; rows pass C within the touch tier, within the swept
    tier, and with candidates in all three tiers."""
    import dataclasses

    import torch

    sc = batched_worlds(n_worlds=W_PARITY, n_bodies=N_WIDE,
                        substeps=SUBSTEPS, device=dev)
    cfg = dataclasses.replace(sc.config, slot_capacity=C_WIDE)
    w = edge_batch(sc.world)
    eargs = slot_call_args(parallel, w, cfg)[0]
    ek = hopper.build_elig_mask(*eargs)
    check(torch.equal(ek, hopper.elig_mask_plain(*eargs)),
          "elig: kernel != twin at the wide batch")
    # every fifth collider on layer 31 and hitting only it: K1 tests the
    # layers byte by byte (its world-wide flag is off)
    cbody, layer, lmask, *rest = eargs
    top = torch.arange(layer.shape[1], device=layer.device) % 5 == 2
    layered = (cbody, torch.where(top, 31, layer),
               torch.where(top, -2 ** 31, lmask), *rest)
    lk = hopper.build_elig_mask(*layered)
    check(torch.equal(lk, hopper.elig_mask_plain(*layered))
          and bool((lk != ek).any()),
          "elig: kernel != twin at the wide batch on two layers")
    errs = {"elig": 0.0, "slots": 0.0}
    for frames in (1, 4):
        tk, bk = parallel.frame2_tables(w, cfg, frames=frames, elig=ek,
                                        return_budget=True)
        tp, bp = parallel.frame2_tables(w, cfg, frames=frames, elig=ek,
                                        return_budget=True, plain=True)
        for name, a, b in zip(("partner", "slot_act", "count", "count_touch",
                               "count_close"), tk, tp):
            check(torch.equal(a, b), f"wide slots[{frames}]: {name} differs")
        eb = max_err(bk, bp)
        check(eb <= 1e-6, f"wide slots[{frames}]: budget off by {eb}")
        errs["slots"] = max(errs["slots"], eb)
        count, touch, close = tk[2], tk[3], tk[4]
        rows = [int((touch > C_WIDE).sum()),
                int(((close < C_WIDE) & (count > C_WIDE)).sum()),
                int(((touch > 0) & (close > touch) & (count > close)
                     & (count > C_WIDE)).sum())]
        check(min(rows) > 0, f"wide slots[{frames}]: rows past C in the "
              f"touch tier, in the swept tier, with all three tiers: {rows}")
        print(f"parity slots at {W_PARITY}x{N_WIDE}, C = {C_WIDE}, "
              f"partner_aware={frames > 1}: tables equal, budget max abs err "
              f"{eb:.3g}; rows past C in the touch tier, in the swept tier, "
              f"with all three tiers: {rows}")
    print(f"parity elig at {W_PARITY}x{N_WIDE}: equal ({int(ek.sum())} "
          f"eligible pairs; {int(lk.sum())} on two layers)")
    return errs


def frame_parity(name, parallel, w, cfg, tables) -> float:
    """One frame through the kernel and the twin: ``touched`` equal, poses
    to 1e-4, velocities to 1e-3. Returns the max abs error."""
    import torch

    wk, touched_k, *_ = parallel.frame2_step(w, cfg, tables=tables)
    wp, touched_p, *_ = parallel.frame2_step(w, cfg, tables=tables,
                                             plain=True)
    check(torch.equal(touched_k, touched_p), f"{name}: touched differs")
    check(float(touched_k.sum()) > 0, f"{name}: no contacts, vacuous")
    e_pose = max(max_err(wk.bodies.pos, wp.bodies.pos),
                 max_err(wk.bodies.angle, wp.bodies.angle))
    e_vel = max(max_err(wk.bodies.vel, wp.bodies.vel),
                max_err(wk.bodies.ang_vel, wp.bodies.ang_vel))
    check(e_pose <= 1e-4, f"{name}: pose off by {e_pose}")
    check(e_vel <= 1e-3, f"{name}: velocity off by {e_vel}")
    print(f"parity {name}: touched equal ({int(touched_k.sum())} touching "
          f"slots), pose max abs err {e_pose:.3g}, velocity {e_vel:.3g}")
    return max(e_pose, e_vel)


def jointed_scene(name, n_worlds, dev, substeps=SUBSTEPS):
    """``(batch scene, single-world scene)`` of a jointed config."""
    from starframe_tpu_torch import scenes

    base = getattr(scenes, name)(substeps=substeps, device=dev)
    return scenes.batchify(base, n_worlds), base


def parity_joints(dev, hopper, parallel) -> dict:
    """K3 and K4 with joints, kernel vs twin, both joint tiers, at 4
    substeps (the CPU tests' depth: at 10 the mechanism's pendulum chain
    amplifies one ulp past the fixed bounds in some worlds, which step 4
    handles per world): on both jointed batches at 64 worlds 30 frames in,
    and on 64 envs of the benchmark's walker (K4 phase ``walker``, ``<8,
    true, false>``) 60 frames in. Then the walker at its own 10 substeps,
    world by world (``agree_worlds``): there a body at 15 m/s carries one
    frame's float32 rounding past the fixed bounds in a world or two (the
    twin moves further from itself run in float64)."""
    import dataclasses

    def walker(substeps):
        w, cfg, frames = digests_tool().walker(dev, FRAMES,
                                               n_worlds=W_PARITY)
        return w, dataclasses.replace(cfg, substeps=substeps), frames

    def batches():
        for name in JOINTED:
            sc, _ = jointed_scene(name, W_PARITY, dev, substeps=4)
            yield name, sc.world, sc.config, 30
        yield ("walker", *walker(4))

    errs = {"joint_slots": 0.0, "frame2_joints": 0.0}
    for name, w, cfg, frames in batches():
        w, _, _ = parallel.batched_rollout(w, cfg, 0, frames,
                                           record=lambda _: None)
        jk = parallel.frame2_joint_slots(w, cfg)
        jp = parallel.frame2_joint_slots(w, cfg, plain=True)
        errs["joint_slots"] = max(errs["joint_slots"],
                                  agree("joint_slots", jk, jp))
        print(f"parity joint_slots {name}: equal ({int(jk[3].sum())} "
              f"body-joint incidences, at most {int(jk[3].max())} a body)")
        tables = parallel.frame2_tables(w, cfg)
        for solver in ("colored", "jacobi"):
            cfg_s = dataclasses.replace(cfg, joint_solver=solver)
            e = frame_parity(f"frame2_joints {name} {solver}", parallel, w,
                             cfg_s, tables)
            errs["frame2_joints"] = max(errs["frame2_joints"], e)
    w, cfg, frames = walker(SUBSTEPS)
    w, _, _ = parallel.batched_rollout(w, cfg, 0, frames,
                                       record=lambda _: None)
    tables = parallel.frame2_tables(w, cfg)
    for solver in ("colored", "jacobi"):
        cfg_s = dataclasses.replace(cfg, joint_solver=solver)
        fargs, fkw = frame_call(hopper, parallel, w, cfg_s, tables)
        k, p = (hopper.run_frame2(*fargs, **fkw, plain=plain)
                for plain in (False, True))
        e = agree_worlds(f"frame2_joints walker {solver} at {SUBSTEPS} "
                         "substeps", k, p)
        errs["frame2_joints"] = max(errs["frame2_joints"], e)
    return errs


def run_walker(dev, hopper, parallel, card, name="walker") -> None:
    """The benchmark's 4,096 BipedalWalker-v3 envs (K4 phase ``walker``,
    or ``walker_owners``: with per-world owner lists) for their frames,
    timed after a warm-up: no joint or owner overflow, the phase's
    digest."""
    import torch

    w0, cfg, frames = k4_phase(name, dev)

    def rollout():
        return parallel.batched_rollout(w0, cfg, 0, frames,
                                        record=lambda _: None)

    rollout()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _, diag = rollout()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    W = w0.bodies.pos.shape[0]
    check(int(diag["joint_overflow"]) == 0, f"{name}: joint_overflow")
    check(int(diag["owner_overflow"]) == 0, f"{name}: owner_overflow")
    record_phase(name, w0, cfg, frames, final)
    print(f"{name}: {W} envs, {frames} frames in {seconds:.4f} s = "
          f"{1e3 * seconds / frames:.4f} ms/frame on {card}")


def run_jointed(name, dev, wrappers, parallel, card) -> dict:
    """Drive ``batched_rollout`` over a 1024-world jointed batch for 60
    frames (timed after a warm-up) and check it; returns what phase 4
    needs."""
    import torch

    w0, cfg, _ = k4_phase(name, dev)
    active = int(((w0.bodies.flags & 1) != 0).sum())

    def rollout(n):
        return parallel.batched_rollout(w0, cfg, 0, n, record=lambda _: None)

    rollout(FRAMES)  # warm-up
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, _, diag = rollout(FRAMES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"joint_slots": wrappers["joint_slots"].launches,
                "frame2_joints": wrappers["frame2_joints"].launches}
    slot_builds = wrappers["slots"].launches
    diag = {k: int(v) for k, v in diag.items()}
    record_phase(name, w0, cfg, FRAMES, final)

    b = final.bodies
    check(tuple(b.pos.shape) == (W_JOINTED, w0.bodies.n, 2),
          f"{name}: pos shape {b.pos.shape}")
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(bool(torch.isfinite(getattr(b, field)).all()),
              f"{name}: non-finite {field}")
    check(diag["slot_overflow"] == 0,
          f"{name}: slot_overflow {diag['slot_overflow']}")
    check(diag["joint_overflow"] == 0,
          f"{name}: joint_overflow {diag['joint_overflow']}")
    check(launches["joint_slots"] >= 1,
          f"{name}: joint_slots launched {launches['joint_slots']} times")
    check(launches["frame2_joints"] == FRAMES,
          f"{name}: frame kernel launched {launches['frame2_joints']} times")
    j = final.joints
    per_world = joint_health(
        b.pos.cpu().numpy(), b.angle.cpu().numpy(),
        {k: getattr(j, k).cpu().numpy() for k in (
            "jtype", "body_a", "body_b", "anchor_a", "anchor_b", "lo",
            "hi")})
    if name == "mechanism":
        wl = jointed_scene(name, 1, dev)[1].wheel
        mean = (b.angle[:, wl] - w0.bodies.angle[:, wl]) / (
            FRAMES * cfg.dt)
        per_world["wheel_mean_err"] = (mean - MOTOR_SPEED).abs().cpu().numpy()
        per_world["wheel_final_err"] = (
            b.ang_vel[:, wl] - MOTOR_SPEED).abs().cpu().numpy()
    per_world["max_speed"] = b.vel.norm(dim=-1).amax(dim=1).cpu().numpy()
    health = {k: quantiles(v) for k, v in per_world.items()}
    for key, ref in HEALTH_REFERENCE[name].items():
        for q, got, r in zip(("median", "99th percentile"), health[key], ref):
            bound = max(3 * r, HEALTH_FLOOR[key])
            check(got <= bound, f"{name}: {key} {q} over worlds {got} past "
                  f"its bound {bound}")
    ms_frame = 1e3 * seconds / FRAMES
    print(f"jointed path {name}: {W_JOINTED} worlds x {w0.bodies.n} "
          f"bodies ({active // W_JOINTED} active each), {cfg.substeps} "
          f"substeps, {cfg.joint_solver} joints ({cfg.max_joint_colors} "
          f"colours), {FRAMES} frames in {seconds:.4f} s = {ms_frame:.4f} "
          f"ms/frame, {active * FRAMES / seconds:.6g} body-steps/s "
          f"({active} active bodies/frame) on {card}")
    print(f"jointed path {name} counters: {json.dumps(diag)}; launches "
          f"{json.dumps(launches)}, slots {slot_builds}; joint health "
          f"(median, 99th percentile, max over worlds) {json.dumps(health)}")
    return dict(final=final, cfg=cfg, launches=launches, ms=ms_frame,
                world=w0)


def jointed_turns(hopper, parallel, jointed, errs, bounds, card) -> dict:
    """K3 and K4 with joints against their twins at 1024 worlds, from each
    jointed run's final state, and their times; returns the mechanism
    batch's ``{name: (kernel ms, twin ms)}``. ``errs`` keeps the worst
    error of each, ``bounds`` the mechanism batch's bound of each."""
    import torch

    times = {}
    for scene in JOINTED:
        w, jcfg = jointed[scene]["final"], jointed[scene]["cfg"]
        j = w.joints
        jargs = (j.body_a, j.body_b, (j.jtype != 0).to(torch.float32),
                 w.bodies.n)
        jkw = dict(JC=jcfg.joint_slot_capacity)
        jt = parallel.frame2_tables(w, jcfg)
        jfargs, jfkw = frame_call(hopper, parallel, w, jcfg, jt)
        jcalls = {
            "joint_slots": (
                lambda p: hopper.build_joint_slots(*jargs, **jkw, plain=p)),
            "frame2_joints": (
                lambda p: hopper.run_frame2(*jfargs, **jfkw, plain=p)),
        }
        W, N = w.bodies.inv_mass.shape
        entries = int(jt[1].sum())
        jwork = {
            "joint_slots": (jargs[:3], W * N * j.j * 3),
            "frame2_joints": (
                (jfargs, jfkw),
                entries * (MANIFOLD_FLOPS + jcfg.substeps * jcfg.iterations
                           * (PROJECT_FLOPS + VELOCITY_FLOPS))
                + W * N * jcfg.joint_slot_capacity * jcfg.substeps
                * (jcfg.max_joint_colors + 1) * JOINT_FLOPS),
        }
        for name, call in jcalls.items():
            k, p = call(False), call(True)
            err = (agree_worlds(f"{name} {scene}", k, p)
                   if name == "frame2_joints" else agree(name, k, p))
            if scene == "mechanism":
                bounds[name] = bound(jwork[name][0], k, jwork[name][1])
            del k, p
            errs[name] = max(errs[name], err)
            t = turns(call)
            device = ""
            if name == "joint_slots" and scene == "mechanism":
                DEVICE_MS[name] = launch_ms(lambda: call(False))
                device = f" ({device_str(name)})"
            print(f"time {name} on {scene} at {W_JOINTED} worlds: kernel "
                  f"{t[0]:.4f} ms{device}, plain twin {t[1]:.4f} ms, max abs "
                  f"err {err:.3g}, on {card}")
            if scene == "mechanism":
                times[name] = t
    return times


def nbytes(*xs) -> int:
    """Bytes of every tensor in ``xs`` (nested in tuples, lists, dicts)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (list, tuple)):
            total += nbytes(*x)
        elif dataclasses.is_dataclass(x):
            total += nbytes(*(getattr(x, f.name)
                              for f in dataclasses.fields(x)))
        elif hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def bound_terms(inputs, outputs, flops, extra_bytes=0) -> tuple:
    """``(bytes ms, operations ms)``: the least times for moving
    ``inputs``, ``outputs`` and ``extra_bytes`` more once each, and for
    doing ``flops`` operations, on one H100."""
    t_bytes = (nbytes(inputs) + nbytes(outputs) + extra_bytes) / PEAK_BYTES_S
    return 1e3 * t_bytes, 1e3 * float(flops) / PEAK_FLOPS_S


def bound(inputs, outputs, flops, extra_bytes=0) -> tuple:
    """``(bound_ms, bound_by)``: the larger of :func:`bound_terms`."""
    t_bytes, t_ops = bound_terms(inputs, outputs, flops, extra_bytes)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def to64(x):
    """Float tensors of ``x`` (nested in tuples, lists, dicts) in float64."""
    import torch

    if isinstance(x, dict):
        return {k: to64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to64(v) for v in x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.double()
    return x


def tile_inputs(w, cfg):
    """``(state, consts, large, edges, gravity)`` of the tile layout of
    ``w``, as ``tiled_rollout`` enters it."""
    from starframe_tpu_torch import tiled

    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    return state, consts, large, edges, w.gravity.contiguous()


def tile_calls(hopper, w, cfg):
    """Each tile kernel's call ``call(plain)`` on ``w``'s layout, chained as
    one frame chains them (each on its predecessor's twin outputs), and
    what its bound counts: ``(call, inputs, extra_bytes, flops)``, the
    inputs it reads whole and the bytes it reads only on solved slots."""
    import torch

    state, consts, large, edges, g = tile_inputs(w, cfg)
    Nt = state["px"].shape[0]
    C = -(-cfg.slot_capacity // 8) * 8
    Cs = min(-(-cfg.tile_solve_capacity // 8) * 8, C)
    h = cfg.dt / cfg.substeps
    live = torch.ones(Nt, device=g.device)
    tkw = dict(C=C, margin=cfg.contact_margin, dt=cfg.dt,
               sweep_frames=cfg.frames_per_broadphase,
               sweep_slack=cfg.broadphase_speed_slack,
               sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)
    tables = hopper.build_tile_tables(state, consts, large, *edges, g, **tkw,
                                      plain=True)
    mkw = dict(Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt)
    sol, pidx_c = hopper.tile_manifold(state, consts, large, *tables[:2],
                                       live, **mkw, plain=True)[:2]
    touched = torch.zeros(pidx_c.shape, device=g.device)
    pkw = dict(h=h, compliance=cfg.contact_compliance)
    proj = hopper.tile_project(state, consts, large, pidx_c, sol, g, touched,
                               live, **pkw, plain=True)
    akw = dict(h=h, relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    pargs = (state, consts, large, pidx_c, sol, g, touched, live)
    aargs = (state, proj[:4], consts, large, pidx_c, sol, proj[4], g, live)
    margs = (state, consts, large, *tables[:2], live)
    from starframe_tpu_torch.hopper.tiles import SOL

    sm = sol[:, [SOL["sm0"], SOL["sm1"]]]
    solved = int((sm != 0).any(dim=1).sum())
    skips = tile_chunk_skips(state, consts, large, edges, g, tkw)
    print(f"K5 chunk culling on {Nt} tiles (C = {C}, K = "
          f"{tkw['sweep_frames']}): {100 * skips['row']:.2f}% of (row, "
          f"32-candidate chunk) pairs skipped, {100 * skips['warp']:.2f}% of "
          f"the kernel's (pair of rows, chunk) visits; {skips['pairs']} "
          f"pairs left to test, {100 * skips['pairs'] / skips['eligible']:.2f}"
          "% of the eligible ones")

    def reads(name, *more):
        sk, ck, lk = TILE_READS[name]
        return ([state[k] for k in sk], [consts[k] for k in ck],
                [large[k] for k in lk], more)

    calls = {
        "tile_tables": (
            lambda p: hopper.build_tile_tables(state, consts, large, *edges,
                                               g, **tkw, plain=p),
            # K2's rule: a union test a (row, chunk) and the pair tests
            # its culling leaves
            reads("tile_tables", edges, g), 0,
            skips["unions"] * UNION_FLOPS + skips["pairs"] * PAIR_FLOPS),
        "tile_manifold": (
            lambda p: hopper.tile_manifold(*margs, **mkw, plain=p),
            reads("tile_manifold", *tables[:2], live), 0,
            int(tables[1].sum()) * MANIFOLD_FLOPS),
        "tile_project": (
            lambda p: hopper.tile_project(*pargs, **pkw, plain=p),
            reads("tile_project", sm, g, touched, live),
            4 * SOLVED_SLOT_WORDS["tile_project"] * solved,
            solved * PROJECT_FLOPS),
        "tile_apply": (
            lambda p: hopper.tile_apply(*aargs, **akw, plain=p),
            reads("tile_apply", sm, proj[:4], g, live),
            4 * SOLVED_SLOT_WORDS["tile_apply"] * solved,
            solved * VELOCITY_FLOPS),
    }
    plain64 = {
        "tile_project": lambda: hopper.tile_project_plain(*to64(pargs), **pkw),
        "tile_apply": lambda: hopper.tile_apply_plain(*to64(aargs), **akw),
    }
    return calls, plain64


# the ``touched`` output of the kernels that return one (held equal)
TOUCHED_OUTPUT = {("tile_project", 5), ("tile_frame", 6),
                  ("tile_project_ccd", 5), ("tile_frame_ccd", 6),
                  ("tile_frame_compound", 6),
                  ("tile_frame_compound_ccd", 6)}


def agree_tiles(name, k, p, spread=None) -> float:
    """One tile kernel's outputs against its twin's: the integer outputs
    and ``touched`` equal; the float outputs to 1e-6 or, with ``spread``,
    to a tenth of float32's own spread there (the twin against itself in
    float64; the batched frame's full-size rule for a chaotic pile) where
    that is larger: one substep from a settled state moves float32 by as
    little as 3e-7, and a tenth of that is under one ulp of the fields.
    Returns the max abs error."""
    import torch

    ks = list(k.values()) if isinstance(k, dict) else list(k)
    ps = list(p.values()) if isinstance(p, dict) else list(p)
    errs = []
    for n, (a, b) in enumerate(zip(ks, ps)):
        if a.dtype != torch.float32 or (name, n) in TOUCHED_OUTPUT:
            check(torch.equal(a, b), f"{name}: output {n} differs")
            continue
        e = max_err(a, b)
        errs.append(e)
        tol = 1e-6
        if spread is not None:
            tol = max(tol, 0.1 * spread[n])
        check(e <= tol, f"{name}: output {n} off by {e}, past {tol}")
    return max(errs) if errs else 0.0


def parity_tiles(dev, hopper) -> dict:
    """The four tile kernels against their twins on pile(1021) (4 tiles)
    30 frames in: K5 at one-frame and K-frame sweeps, K6 awake and with a
    wake speed and a skipped tile, one substep of K8 and K9."""
    import dataclasses

    import torch
    from starframe_tpu_torch import scenes, tiled

    sc = scenes.pile(n_bodies=PILE_PARITY_N, sleep=False, device=dev)
    w, _ = tiled.tiled_rollout(sc.world, sc.config, 30)
    errs = {}
    for K in (1, sc.config.frames_per_broadphase):
        cfg = dataclasses.replace(sc.config, frames_per_broadphase=K)
        calls, _ = tile_calls(hopper, w, cfg)
        for name, (call, *_) in calls.items():
            k, p = call(False), call(True)
            errs[name] = max(errs.get(name, 0.0), agree_tiles(name, k, p))
    state, consts, large, edges, g = tile_inputs(w, sc.config)
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=16, margin=0.05, dt=sc.config.dt,
        sweep_frames=8, plain=True)
    live = torch.ones(state["px"].shape[0], device=dev)
    live[1] = 0.0
    kw = dict(Cs=8, margin=0.05, dt=sc.config.dt, sleep_velocity=0.2)
    k = hopper.tile_manifold(state, consts, large, *tables[:2], live, **kw)
    p = hopper.tile_manifold(state, consts, large, *tables[:2], live, **kw,
                             plain=True)
    errs["tile_manifold"] = max(errs["tile_manifold"],
                                agree_tiles("tile_manifold", k, p))
    check(float(k[4].sum()) > 0, "tile_manifold: nothing woke, vacuous")
    check(not bool(k[0][1].any()), "tile_manifold: a skipped tile computed")
    errs["tile_manifold_keys"] = parity_keys(dev, hopper, tiled, w,
                                             sc.config, tables)
    print(f"parity tiles at {PILE_PARITY_N} bodies (4 tiles): K5 (K = 1, "
          f"{sc.config.frames_per_broadphase}), K6 (awake; waking, one tile "
          f"skipped: {int(k[4].sum())} rows woke), K8, K9: integer outputs "
          f"and touched equal, max abs err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    errs["tile_frame"] = 0.0
    for substeps in (2, sc.config.substeps):
        cfg = dataclasses.replace(sc.config, substeps=substeps)
        args, kw = frame_inputs(hopper, tiled, w, cfg, dead_tile=1)
        errs["tile_frame"] = max(errs["tile_frame"], frame_agree(
            hopper, args, kw, f"at {PILE_PARITY_N} bodies, {substeps} "
            "substeps, tile 1 skipped"))
    return errs


def manifold_inputs(hopper, tiled, w, cfg, dead_tile=None):
    """``(args, kwargs, keyed)`` of ``hopper.tile_manifold`` for a frame of
    ``w`` as ``tiled_rollout`` enters it: the layout (after the compacting
    re-sort when the pile sleeps), its K-frame tables and the frame's
    consts (sleepers frozen, ``tile_live``; ``dead_tile`` skipped too);
    ``keyed`` the further kwargs of its keyed form (the rows' and large
    slots' collider ids, as ``tiled_rollout(with_events=True)`` passes
    them)."""
    state, consts, large, body_id, _ = tiled._enter_tiles(w, cfg)
    g = w.gravity.contiguous()
    if cfg.sleep_velocity > 0.0 and cfg.tile_awake_compaction:
        state, consts, body_id = tiled._compact_resort(
            state, consts, body_id, cfg, g, "px",
            compound=w.colliders.m != w.bodies.n)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    kc = tiled._frame_consts(state, consts, cfg, edges)
    if dead_tile is not None:
        kc["tile_live"][dead_tile] = 0.0
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=tiled._table_cap(cfg),
        margin=cfg.contact_margin, dt=cfg.dt,
        sweep_frames=cfg.frames_per_broadphase,
        sweep_slack=cfg.broadphase_speed_slack,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)
    mkw = dict(Cs=tiled._solve_cap(cfg), margin=cfg.contact_margin,
               dt=cfg.dt,
               sleep_velocity=cfg.sleep_velocity * cfg.wake_velocity_factor)
    keyed = dict(event_ids=(body_id.reshape(-1, 256), large["cols"]),
                 n_colliders=w.colliders.m)
    return (state, kc, large, *tables[:2], kc["tile_live"]), mkw, keyed


def manifold_skips(act, live) -> tuple:
    """``(items, warps)``: of the live tiles' (row, table slot) items of
    K6's tables (``act [Nt, C, T]``, ``live [Nt]``), the share with ``act >
    0``, and of K6's warps (R rows x 32 / R slots: R = 16 from C = 16 up,
    else 32, as ``csrc/tile_manifold.cu`` ``block_rows``) the share whose
    slots are all empty, which K6 skips whole under compaction (``Cs <
    C``)."""
    a = act[live > 0]
    n, C, T = a.shape
    R = 16 if C >= 16 else 32
    warps = (a.reshape(n, C * R // 32, 32 // R, T // R, R) == 0).all(-1)
    return (float((a > 0).float().mean()),
            float(warps.all(2).float().mean()))


def frame_inputs(hopper, tiled, w, cfg, dead_tile=None):
    """``(args, kwargs)`` of ``hopper.tile_frame`` for a frame of ``w`` as
    ``tiled_rollout`` enters it: :func:`manifold_inputs`'s layout and
    consts with K6's solve tables."""
    margs, mkw, _ = manifold_inputs(hopper, tiled, w, cfg, dead_tile)
    state, kc, large = margs[:3]
    sol, pidx_c = hopper.tile_manifold(*margs, **mkw)[:2]
    kw = dict(substeps=cfg.substeps, h=cfg.dt / cfg.substeps,
              compliance=cfg.contact_compliance, relaxation=cfg.relaxation,
              max_dpos=cfg.max_dpos_eff,
              rest_threshold=cfg.restitution_threshold,
              lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    return (state, kc, large, pidx_c, sol, w.gravity.contiguous(),
            kc["tile_live"]), kw


def substep_pair(hopper, args, kw, owner=None):
    """The frame through the K8/K9 kernels, launched once a substep (with
    ``kw["ccd"]``, K7 first; with ``owner = (ob, kc)``, the owner kernels
    between them and K9's compound form): ``(state, touched)``."""
    from starframe_tpu_torch.hopper.tiles import substep_loop

    kw = dict(kw)
    toi = None
    if kw.pop("ccd", False):
        toi = (hopper.tile_ccd, hopper.owner_min, kw.pop("ccd_slop"))
    if owner is not None:
        owner = (hopper.owner_sum, hopper.owner_velocity, *owner)
    return substep_loop(hopper.tile_project, hopper.tile_apply, *args,
                        ccd=toi, owner=owner, **kw)


def frame_outputs(state, touched) -> list:
    return [state[k] for k in _STATE] + [touched]


def frame_agree(hopper, args, kw, what, spread=False, owner=None) -> float:
    """K10 against the K8/K9 kernels launched once a substep (with
    ``kw["ccd"]``: K10's CCD form against K7, K8 and K9) (bitwise equal)
    and against its twin (``agree_tiles``; with ``spread``, a tenth of
    float32's own spread there). With ``owner = (ob, kc)`` the compound
    frame against K8, ``owner_sum``, K9's compound form and
    ``owner_velocity`` (with CCD, K7 and ``owner_min`` first) the same way.
    Returns the max abs error against the twin."""
    name = ("tile_frame" + ("_compound" if owner is not None else "")
            + ("_ccd" if kw.get("ccd") else ""))
    import torch

    k = frame_outputs(*hopper.tile_frame(*args, **kw, owner=owner))
    ref = frame_outputs(*substep_pair(hopper, args, kw, owner))
    for field, a, b in zip(_STATE + ("touched",), k, ref):
        check(torch.equal(a, b), f"{name} {what}: {field} differs from "
              f"the per-substep kernels")
    check(float(k[6].sum()) > 0, f"{name} {what}: no contacts, vacuous")
    p = frame_outputs(*hopper.tile_frame(*args, **kw, owner=owner,
                                         plain=True))
    spread_v = None
    if spread:
        p64 = frame_outputs(*hopper.tile_frame_plain(*to64(args), **kw,
                                                     owner=owner))
        spread_v = [max_err(a, b) for a, b in zip(p, p64)]
    err = agree_tiles(name, k, p, spread_v)
    live = args[6]
    print(f"parity {name} {what}: equal to the per-substep kernels in every "
          f"output ({int(k[6].sum())} touching slots, {int((live > 0).sum())}"
          f" of {live.numel()} tiles live); against its twin max abs err "
          f"{err:.3g}")
    return err


def run_pile(dev, hopper, tiled, card) -> dict:
    """Drive ``tiled_rollout`` over pile(10_000, sleep=False) for 240 frames
    (after a warm-up), timed, and check it; returns what phase 4 needs."""
    import torch
    from starframe_tpu_torch import scenes

    sc = scenes.pile(n_bodies=PILE_N, sleep=False, device=dev)
    cfg = sc.config
    active = int(((sc.world.bodies.flags & 1) != 0).sum())
    dyn_n = int((sc.world.bodies.inv_mass > 0).sum())
    def timed(fuse):
        tiled.tiled_rollout(sc.world, cfg, PILE_FRAMES, fuse=fuse)  # warm-up
        torch.cuda.synchronize()
        for name, attr, _, _ in TILE_KERNELS:
            getattr(hopper, attr).launches = 0
        syncs0 = tiled.host_syncs
        t0 = time.perf_counter()
        final, diag = tiled.tiled_rollout(sc.world, cfg, PILE_FRAMES,
                                          fuse=fuse)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: getattr(hopper, attr).launches
                    for name, attr, _, _ in TILE_KERNELS}
        return (final, {k: int(v) for k, v in diag.items()}, seconds,
                launches, tiled.host_syncs - syncs0)

    final, diag, seconds, launches, syncs = timed(False)

    b = final.bodies
    dyn = b.inv_mass > 0
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(bool(torch.isfinite(getattr(b, field)).all()),
              f"pile: non-finite {field}")
    for key in ("slot_overflow", "solve_overflow", "window_overflow",
                "large_overflow"):
        check(diag[key] == 0, f"pile: {key} {diag[key]}")
    # inside the container: the walls' inner faces and the floor's top
    wall = float(sc.world.bodies.pos[2, 0]) - 0.5
    x, y = b.pos[dyn, 0], b.pos[dyn, 1]
    check(float(x.abs().max()) < wall, f"pile: a body left the container "
          f"(|x| = {float(x.abs().max())}, walls at {wall})")
    check(float(y.min()) > 0.0, f"pile: a body sank below the floor "
          f"(y = {float(y.min())})")
    check(launches["tile_tables"] >= 1,
          f"tile_tables launched {launches['tile_tables']} times")
    check(launches["tile_manifold"] == PILE_FRAMES,
          f"tile_manifold launched {launches['tile_manifold']} times")
    for name in ("tile_project", "tile_apply"):
        check(launches[name] == PILE_FRAMES * cfg.substeps,
              f"{name} launched {launches[name]} times")
    check(launches["tile_frame"] == 0, "fuse=False launched the whole-frame "
          "kernel")
    ms_frame = 1e3 * seconds / PILE_FRAMES
    health = pile_health(b.pos.cpu().numpy(), b.vel.cpu().numpy(),
                         dyn.cpu().numpy())
    print(f"pile path: pile({PILE_N}, sleep=False), fuse=False, {dyn_n} "
          f"dynamic bodies "
          f"+ {active - dyn_n} statics, {cfg.substeps} substeps, C = "
          f"{cfg.slot_capacity}, Cs = {cfg.tile_solve_capacity}, K = "
          f"{cfg.frames_per_broadphase}; {PILE_FRAMES} frames in "
          f"{seconds:.4f} s = {ms_frame:.4f} ms/frame, "
          f"{dyn_n * PILE_FRAMES / seconds:.6g} body-steps/s ({dyn_n} active "
          f"bodies/frame) on {card}")
    print(f"pile path counters: {json.dumps(diag)}; launches "
          f"{json.dumps(launches)}; host syncs {syncs} "
          f"({syncs / PILE_FRAMES:.3f}/frame); health at frame "
          f"{PILE_FRAMES}: {json.dumps(health)}")
    check_pile_health(health, PILE_HEALTH_REFERENCE, PILE_FRAMES)

    # the same frames with the substeps in K10: bitwise the same rollout
    fused, fdiag, fseconds, flaunches, fsyncs = timed(True)
    check(flaunches["tile_frame"] == PILE_FRAMES
          and flaunches["tile_manifold"] == PILE_FRAMES,
          f"fused: K10 launched {flaunches['tile_frame']} times, K6 "
          f"{flaunches['tile_manifold']}")
    check(flaunches["tile_project"] == flaunches["tile_apply"] == 0,
          "fused: the per-substep kernels ran")
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(fused.bodies, field),
                          getattr(final.bodies, field)),
              f"pile: fused and unfused rollouts differ in {field}")
    check(fdiag == diag, "pile: fused and unfused counters differ")
    fms = 1e3 * fseconds / PILE_FRAMES
    print(f"pile path fused (K10): {PILE_FRAMES} frames in {fseconds:.4f} s "
          f"= {fms:.4f} ms/frame, {dyn_n * PILE_FRAMES / fseconds:.6g} "
          f"body-steps/s (unfused {ms_frame:.4f} ms/frame); launches "
          f"{json.dumps(flaunches)}; host syncs {fsyncs}; bitwise equal to "
          f"the unfused rollout (pos, angle, vel, ang_vel, sleep_count, "
          f"counters), on {card}")
    return dict(final=final, cfg=cfg, sc=sc, launches=launches, ms=ms_frame)


def run_pile_sleep(dev, hopper, tiled, card) -> dict:
    """bench.py's ``pile`` config: ``pile(10_000)`` (sleep on, awake-prefix
    compaction, the substeps in K10) for 7 chunks of 240 frames, each a
    rollout continuing from the last, timed each, and checked; returns the
    states after chunks 2 and 7 and what the kernels line needs."""
    import torch
    from starframe_tpu_torch import scenes

    sc = scenes.pile(n_bodies=PILE_N, device=dev)
    cfg = sc.config
    check(cfg.sleep_velocity > 0.0 and cfg.tile_awake_compaction,
          "pile(): sleep or compaction off")
    dyn = sc.world.bodies.inv_mass > 0
    dyn_n = int(dyn.sum())
    wall = float(sc.world.bodies.pos[2, 0]) - 0.5
    torch.cuda.synchronize()
    for name, attr, _, _ in TILE_KERNELS:
        getattr(hopper, attr).launches = 0
    syncs0 = tiled.host_syncs
    w, states, chunks = sc.world, {}, []
    for c in range(1, PILE_CHUNKS + 1):
        start = w
        t0 = time.perf_counter()
        w, diag = tiled.tiled_rollout(w, cfg, PILE_FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        diag = {k: int(v) for k, v in diag.items()}
        b = w.bodies
        for field in ("pos", "angle", "vel", "ang_vel"):
            check(bool(torch.isfinite(getattr(b, field)).all()),
                  f"sleeping pile chunk {c}: non-finite {field}")
        for key in ("slot_overflow", "solve_overflow", "window_overflow",
                    "large_overflow"):
            check(diag[key] == 0, f"sleeping pile chunk {c}: {key} "
                  f"{diag[key]}")
        x, y = b.pos[dyn, 0], b.pos[dyn, 1]
        check(float(x.abs().max()) < wall and float(y.min()) > 0.0,
              f"sleeping pile chunk {c}: a body left the container")
        if c > PILE_CHUNKS - 3:
            check(diag["compacted_rows"] > 0,
                  f"sleeping pile chunk {c}: nothing compacted")
        asleep = float(((b.sleep_count >= cfg.sleep_frames) & dyn).sum()
                       / dyn_n)
        chunks.append(dict(ms=1e3 * seconds / PILE_FRAMES,
                           bps=dyn_n * PILE_FRAMES / seconds,
                           asleep=asleep, diag=diag))
        print(f"sleeping pile chunk {c} (frames {PILE_FRAMES * (c - 1) + 1}-"
              f"{PILE_FRAMES * c}): {chunks[-1]['ms']:.4f} ms/frame, "
              f"{chunks[-1]['bps']:.6g} body-steps/s, asleep share "
              f"{asleep:.4f}; counters {json.dumps(diag)}")
        if c * PILE_FRAMES == PILE_SLEEP_HEALTH_FRAME:
            health = pile_health(b.pos.cpu().numpy(), b.vel.cpu().numpy(),
                                 dyn.cpu().numpy())
            print(f"sleeping pile health at frame {c * PILE_FRAMES}: "
                  f"{json.dumps(health)}, asleep share {asleep:.4f} "
                  f"(JAX package: {PILE_SLEEP_ASLEEP})")
            check_pile_health(health, PILE_SLEEP_HEALTH_REFERENCE,
                              PILE_SLEEP_HEALTH_FRAME)
            lo, hi = min(PILE_SLEEP_ASLEEP), max(PILE_SLEEP_ASLEEP)
            lo, hi = lo - (hi - lo), hi + (hi - lo)
            check(lo <= asleep <= hi, f"sleeping pile: asleep share {asleep} "
                  f"at frame {c * PILE_FRAMES} outside {lo:.4f}-{hi:.4f}")
        if c in (2, PILE_CHUNKS):
            states[c] = w
    frames = PILE_CHUNKS * PILE_FRAMES
    launches = {name: getattr(hopper, attr).launches
                for name, attr, _, _ in TILE_KERNELS}
    syncs = tiled.host_syncs - syncs0
    check(launches["tile_project"] == launches["tile_apply"] == 0,
          "sleeping pile: the per-substep kernels ran")
    check(0 < launches["tile_frame"] == launches["tile_manifold"] <= frames,
          f"sleeping pile: K10 launched {launches['tile_frame']} times, K6 "
          f"{launches['tile_manifold']}, over {frames} frames")
    check(syncs <= frames, f"sleeping pile: {syncs} host syncs in {frames} "
          "frames")
    best = min(ch["ms"] for ch in chunks[1:])
    print(f"sleeping pile (bench.py's pile config): pile({PILE_N}), sleep "
          f"velocity {cfg.sleep_velocity}, {cfg.sleep_frames} frames, "
          f"compaction on, fused; best of chunks 2-{PILE_CHUNKS}: "
          f"{best:.4f} ms/frame, {dyn_n / best * 1e3:.6g} body-steps/s "
          f"({dyn_n} dynamic bodies/frame); per chunk ms/frame "
          + ", ".join(f"{ch['ms']:.4f}" for ch in chunks)
          + f"; launches over {frames} frames {json.dumps(launches)} (K10 "
          f"{launches['tile_frame'] / frames:.4f}/frame); host syncs "
          f"{syncs} ({syncs / frames:.3f}/frame); on {card}")

    # the last chunk again from the same state: bitwise the same
    again, adiag = tiled.tiled_rollout(start, cfg, PILE_FRAMES)
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(again.bodies, field),
                          getattr(w.bodies, field)),
              f"sleeping pile rerun differs in {field}")
    check({k: int(v) for k, v in adiag.items()} == chunks[-1]["diag"],
          "sleeping pile rerun counters differ")
    return dict(states=states, cfg=cfg, launches=launches, ms=best)


def check_pile_health(health, ref, frame) -> None:
    """A pile's aggregate health at ``frame`` within the bounds from the
    JAX package's ``ref`` (seeds 0, 1, 2): the centre of mass within 0.3 m
    of seed 0's, the lowest body no more than 0.1 m below the lowest, the
    fastest and mean speeds within 3x the largest."""
    check(abs(health["com_y"] - ref["com_y"][0]) <= 0.3,
          f"pile health: centre of mass at {health['com_y']}, reference "
          f"{ref['com_y'][0]}")
    check(health["min_y"] >= min(ref["min_y"]) - 0.1,
          f"pile health: lowest body at {health['min_y']}")
    for key in ("max_speed", "mean_speed"):
        limit = 3 * max(ref[key])
        check(health[key] <= limit,
              f"pile health: {key} {health[key]} past {limit}")
    print(f"pile health at frame {frame} within bounds of the JAX package's "
          f"(seeds 0, 1, 2): {json.dumps(ref)}")


def pile_turns(hopper, pile, errs, bounds, card) -> dict:
    """The four tile kernels against their twins at the pile's full size,
    from its final state, their times and bounds."""
    calls, plain64 = tile_calls(hopper, pile["final"], pile["cfg"])
    times = {}
    for name, (call, inputs, extra_bytes, flops) in calls.items():
        k, p = call(False), call(True)
        spread = None
        if name in plain64:
            p64 = plain64[name]()
            p64 = list(p64.values()) if isinstance(p64, dict) else list(p64)
            pl = list(p.values()) if isinstance(p, dict) else list(p)
            spread = [max_err(a, b) for a, b in zip(pl, p64)]
        err = agree_tiles(name, k, p, spread)
        errs[name] = max(errs[name], err)
        bounds[name] = bound(inputs, k, flops, extra_bytes)
        del k, p
        times[name] = turns(call)
        DEVICE_MS[name] = launch_ms(lambda: call(False))
        if name == "tile_manifold":
            items, warps = manifold_skips(*inputs[3][1:])
            print(f"K6 at {PILE_N} bodies (frame {PILE_FRAMES}): "
                  f"{100 * items:.2f}% of (row, table slot) items with act "
                  f"> 0, {100 * warps:.2f}% of its warps empty (skipped "
                  "whole)")
        print(f"time {name} at {PILE_N} bodies: kernel {times[name][0]:.4f} "
              f"ms ({device_str(name)}), plain twin {times[name][1]:.4f} ms, "
              f"bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), max abs err "
              f"{err:.3g}" + (f" (float32 spread "
                              f"{', '.join(f'{x:.3g}' for x in spread)})"
                              if spread else "") + f", on {card}")
    return times


def frame_turns(hopper, tiled, sleep, errs, bounds, card) -> tuple:
    """K10 at 10k bodies on the sleeping pile's states after chunks 2 and
    7 (compacted layouts, live and skipped tiles): against the K8/K9
    kernels (bitwise) and its twin (a tenth of float32's spread), and on
    chunk 7's state its bound and time, beside the K8/K9 pair launched once
    a substep on the same inputs. Returns ``(kernel ms, twin ms)``."""
    from starframe_tpu_torch.hopper.tiles import SOL

    cfg = sleep["cfg"]
    for c, w in sorted(sleep["states"].items()):
        args, kw = frame_inputs(hopper, tiled, w, cfg)
        errs["tile_frame"] = max(errs["tile_frame"], frame_agree(
            hopper, args, kw, f"at {PILE_N} bodies, the sleeping pile after "
            f"chunk {c}", spread=True))
    state, kc, large, pidx_c, sol, g, live = args
    on = live > 0  # a skipped tile reads none of its solve tables
    sm = sol[on][:, [SOL["sm0"], SOL["sm1"]]]
    solved = int((sm != 0).any(dim=1).sum())
    n = kw["substeps"]

    def reads(name, *more):
        sk, ck, lk = TILE_READS[name]
        return ([state[k] for k in sk], [kc[k] for k in ck],
                [large[k] for k in lk], more)

    k = hopper.tile_frame(*args, **kw)
    bounds["tile_frame"] = bound(
        reads("tile_frame", sm, g, live), k,
        n * solved * (PROJECT_FLOPS + VELOCITY_FLOPS),
        4 * SOLVED_SLOT_WORDS["tile_frame"] * solved)
    # one substep of K8 and K9 on the same inputs, for their bounds
    import torch

    proj = hopper.tile_project(state, kc, large, pidx_c, sol, g,
                               torch.zeros(pidx_c.shape, device=g.device),
                               live, h=kw["h"], compliance=kw["compliance"])
    new = hopper.tile_apply(
        state, proj[:4], kc, large, pidx_c, sol, proj[4], g, live,
        **{k: v for k, v in kw.items() if k not in ("substeps",
                                                   "compliance")})
    pair_bound = n * (
        bound(reads("tile_project", sm, g, proj[5], live), proj,
              solved * PROJECT_FLOPS,
              4 * SOLVED_SLOT_WORDS["tile_project"] * solved)[0]
        + bound(reads("tile_apply", sm, proj[:4], g, live), new,
                solved * VELOCITY_FLOPS,
                4 * SOLVED_SLOT_WORDS["tile_apply"] * solved)[0])
    del k, proj, new
    p1 = cuda_ms(lambda: substep_pair(hopper, args, kw), 5)
    times = turns(lambda p: hopper.tile_frame(*args, **kw, plain=p))
    p2 = cuda_ms(lambda: substep_pair(hopper, args, kw), 5)
    DEVICE_MS["tile_frame"] = launch_ms(lambda: hopper.tile_frame(*args,
                                                                  **kw))
    print(f"time tile_frame at {PILE_N} bodies (the sleeping pile after "
          f"chunk {PILE_CHUNKS}, {int(on.sum())} of {on.numel()} tiles live, "
          f"{solved} solved slots, {n} substeps): kernel {times[0]:.4f} ms "
          f"({device_str('tile_frame')}), "
          f"plain twin {times[1]:.4f} ms, the K8/K9 kernels once a substep "
          f"{(p1 + p2) / 2:.4f} ms; bound {bounds['tile_frame'][0]:.4f} ms "
          f"({bounds['tile_frame'][1]}; the frame's read set once), the "
          f"K8/K9 bounds over {n} substeps {pair_bound:.4f} ms; max abs err "
          f"against the twin {errs['tile_frame']:.3g}, on {card}")
    return times


def counted(hopper) -> dict:
    """Each tile kernel's launch counter: ``{name: (wrapper, attribute)}``."""
    pairs = {name: (getattr(hopper, attr), "launches")
             for name, attr, _, _ in TILE_KERNELS}
    pairs.update({name: (getattr(hopper, attr), cnt)
                  for name, attr, cnt, _, _ in EC_KERNELS + CCD_KERNELS})
    pairs["tile_apply_compound_ccd"] = (hopper.tile_apply,
                                        "compound_ccd_launches")
    pairs.update({name: (hopper.run_frame2, cnt)
                  for name, cnt, _ in A1_KERNELS})
    return pairs


def reset_counts(hopper) -> None:
    for fn, cnt in counted(hopper).values():
        setattr(fn, cnt, 0)


def read_counts(hopper) -> dict:
    return {name: getattr(fn, cnt) for name, (fn, cnt) in counted(hopper).items()}


def compound_scene(dev, n_dyn=COMPOUND_PARITY_N, seed=7):
    """tests/test_tiled_compound.py's compound scene (``_compound_scene``
    and ``_cfg``) through the port's builder: a ground, two walls and
    ``n_dyn`` two-collider bodies (dumbbells and L-shapes) spread in x,
    ``3 + 2 n_dyn`` collider rows. Returns ``(world, cfg)``."""
    import numpy as np
    from starframe_tpu_torch import Capacity, Shape, SolverConfig, WorldBuilder

    rng = np.random.default_rng(seed)
    b = WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(400.0, 0.5), friction=0.5)
    wl = b.add_static(pos=(-390.0, 10.0))
    b.add_collider(wl, Shape.box(0.5, 12.0), friction=0.5)
    wr = b.add_static(pos=(390.0, 10.0))
    b.add_collider(wr, Shape.box(0.5, 12.0), friction=0.5)
    cols = max(n_dyn // 4, 1)
    for i in range(n_dyn):
        row, col = divmod(i, cols)
        x = -(cols - 1) * 1.1 + col * 2.2 + rng.uniform(-0.1, 0.1)
        y = 0.8 + row * 1.6
        body = b.add_body(pos=(x, y), vel=rng.normal(scale=0.2, size=2),
                          ang_vel=float(rng.normal(scale=0.1)))
        if i % 3 == 0:  # L-shape: two offset boxes
            b.add_collider(body, Shape.box(0.55, 0.18), friction=0.5,
                           offset=(0.0, -0.3))
            b.add_collider(body, Shape.box(0.18, 0.3), friction=0.5,
                           offset=(-0.37, 0.18))
        else:  # dumbbell: two offset circles
            b.add_collider(body, Shape.circle(0.28), friction=0.5,
                           restitution=0.1, offset=(-0.3, 0.0))
            b.add_collider(body, Shape.circle(0.28), friction=0.5,
                           restitution=0.1, offset=(0.3, 0.0))
    m = 3 + 2 * n_dyn
    world, _ = b.build(Capacity(max_bodies=n_dyn + 3, max_colliders=m,
                                max_pairs=12 * m, max_joints=0, max_verts=6),
                       device=dev)
    cfg = SolverConfig(substeps=4, iterations=1, manifold_refresh="frame",
                       slot_capacity=8, broadphase="grid",
                       grid_cell_capacity=12)
    return world, cfg


def parity_keys(dev, hopper, tiled, w, cfg, tables) -> float:
    """K6 with event keys against its twin on ``w`` (pile(1021) 30 frames
    in): compacted (Cs = 8), not (Cs = 16), and compacted with tile 1
    skipped; ``keyc`` and the integer outputs equal, the rest as K6
    without keys, and equal to the launch without keys."""
    import torch

    state, consts, large, body_id, _ = tiled._enter_tiles(w, cfg)
    ids = (body_id.reshape(-1, 256), large["cols"])
    M = w.colliders.m
    err = 0.0
    for Cs, dead in ((8, None), (16, None), (8, 1)):
        live = torch.ones(state["px"].shape[0], device=dev)
        if dead is not None:
            live[dead] = 0.0
        kw = dict(Cs=Cs, margin=cfg.contact_margin, dt=cfg.dt,
                  event_ids=ids, n_colliders=M)
        k = hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                 **kw)
        p = hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                 **kw, plain=True)
        check(torch.equal(k[7], p[7]), f"tile_manifold_keys Cs={Cs}: keys "
              "differ from the twin")
        err = max(err, agree_tiles("tile_manifold", k[:7], p[:7]))
        bare = hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                    Cs=Cs, margin=cfg.contact_margin,
                                    dt=cfg.dt)
        for a, b in zip(k[:7], bare):
            check(torch.equal(a, b), "tile_manifold_keys: an output differs "
                  "from the launch without keys")
        n_keys = int((k[7] > 0).sum())
        check(n_keys > 1000, f"tile_manifold_keys Cs={Cs}: few keys, vacuous")
        if dead is not None:
            check(not bool(k[7][dead].any()), "tile_manifold_keys: a skipped "
                  "tile wrote keys")
        print(f"parity tile_manifold_keys at {PILE_PARITY_N} bodies, C = 16, "
              f"Cs = {Cs}" + (f", tile {dead} skipped" if dead else "")
              + f": keys equal ({n_keys} nonzero), the rest as without keys")
    return err


def parity_compound(dev, hopper, tiled) -> dict:
    """The compound kernels against their twins on tests/test_tiled_compound
    .py's scene 30 frames in (5 tiles, C = Cs = 8, 4 substeps): K5's tables
    (no active slot pairs two rows of one body), K9's compound form (state
    and raw velocity sums to 1e-6) and the owner kernels (bitwise)."""
    import torch
    from starframe_tpu_torch.hopper.tiles import T, WIN, win_start

    w0, cfg = compound_scene(dev)
    w, d = tiled.tiled_rollout(w0, cfg, 30)
    check(int(d["owner_overflow"]) == 0, "compound scene: owner_overflow")
    state, consts, large, _, _ = tiled._enter_tiles(w, cfg)
    Nt = state["px"].shape[0]
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    g = w.gravity.contiguous()
    tkw = dict(C=tiled._table_cap(cfg), margin=cfg.contact_margin, dt=cfg.dt,
               sweep_frames=cfg.frames_per_broadphase,
               sweep_slack=cfg.broadphase_speed_slack,
               sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)
    k = hopper.build_tile_tables(state, consts, large, *edges, g, **tkw)
    p = hopper.build_tile_tables(state, consts, large, *edges, g, **tkw,
                                 plain=True)
    errs = {"tile_tables": agree_tiles("tile_tables", k, p)}
    pidx, act = k[:2]
    ob = consts["obody"].reshape(-1)
    row = (win_start(Nt, dev)[:, None, None] * T
           + torch.clamp(pidx.long(), max=WIN * T - 1))
    partner_ob = torch.where(pidx < WIN * T, ob[row], -1)
    siblings = int(((act > 0) & (partner_ob == consts["obody"][:, None]))
                   .sum())
    check(siblings == 0, f"tile_tables: {siblings} active slots pair two "
          "rows of one body")
    check(int((ob[1:] == ob[:-1]).sum()) == COMPOUND_PARITY_N,
          "compound scene: sibling rows not contiguous")
    check(int((act > 0).sum()) > 100, "compound tables: few slots, vacuous")

    live = torch.ones(Nt, device=dev)
    live[1] = 0.0
    Cs, kc = tiled._solve_cap(cfg), cfg.max_colliders_per_body
    sol, pidx_c = hopper.tile_manifold(state, consts, large, pidx, act, live,
                                       Cs=Cs, margin=cfg.contact_margin,
                                       dt=cfg.dt)[:2]
    h = cfg.dt / cfg.substeps
    *corr, lam, _ = hopper.tile_project(
        state, consts, large, pidx_c, sol, g, torch.zeros_like(sol[:, 0]),
        live, h=h, compliance=cfg.contact_compliance)
    osum = hopper.owner_sum(corr, ob, kc)
    for a, b in zip(osum, hopper.owner_sum(corr, ob, kc, plain=True)):
        check(torch.equal(a, b), "owner_sum: kernel != twin")
    check(not torch.equal(osum[3], corr[3]), "owner_sum: no sibling summed")
    akw = dict(h=h, relaxation=cfg.relaxation, max_dpos=cfg.max_dpos_eff,
               rest_threshold=cfg.restitution_threshold,
               lin_damp=cfg.linear_damping, ang_damp=cfg.angular_damping)
    aargs = (state, osum, consts, large, pidx_c, sol, lam, g, live)
    ak, accv = hopper.tile_apply(*aargs, **akw, compound=True)
    ap, accv_p = hopper.tile_apply(*aargs, **akw, compound=True, plain=True)
    errs["tile_apply_compound"] = agree_tiles(
        "tile_apply_compound", list(ak.values()) + [accv],
        list(ap.values()) + [accv_p])
    check(float(accv[3].sum()) > 0, "tile_apply_compound: no velocity rows")
    check(not bool(accv[:, 1].any()), "tile_apply_compound: a skipped tile "
          "wrote sums")
    for damp in ((akw["lin_damp"], akw["ang_damp"]), (0.3, 0.2)):
        vkw = dict(h=h, lin_damp=damp[0], ang_damp=damp[1])
        vk = hopper.owner_velocity(ak, accv, ob, kc, **vkw)
        vp = hopper.owner_velocity(ak, accv, ob, kc, **vkw, plain=True)
        for f in ("vx", "vy", "om"):
            check(torch.equal(vk[f], vp[f]), f"owner_velocity: {f} kernel "
                  f"!= twin (damping {damp})")
    errs["owner_sum"] = errs["owner_velocity"] = 0.0
    print(f"parity compound at {COMPOUND_PARITY_N} bodies ({w.colliders.m} "
          f"rows, {Nt} tiles, 30 frames in): K5 tables equal, no slot pairs "
          f"siblings; owner_sum and owner_velocity bitwise equal; K9 "
          f"compound max abs err {errs['tile_apply_compound']:.3g} "
          f"({int((accv[3] > 0).sum())} rows with velocity sums)")
    errs.update(compound_frame_agree(hopper, tiled, w, cfg, f"at "
                                     f"{COMPOUND_PARITY_N} bodies, tile 1 "
                                     "skipped", dead_tile=1)[0])
    return errs


def compound_frame_agree(hopper, tiled, w, cfg, what, dead_tile=None,
                         spread=False) -> tuple:
    """The compound frame on ``w``'s frame (``frame_inputs``), without and
    with CCD (every dynamic row a bullet), against the per-substep kernels
    (bitwise) and its twin (``frame_agree``). Returns ``({name: max abs
    err}, {name: (args, kw, owner)})``."""
    args, kw = frame_inputs(hopper, tiled, w, cfg, dead_tile=dead_tile)
    owner = (args[1]["obody"].reshape(-1), cfg.max_colliders_per_body)
    errs = {"tile_frame_compound": frame_agree(hopper, args, kw, what,
                                               spread, owner)}
    bargs = (args[0], dict(args[1], blt=(args[1]["invm"] > 0).float()),
             *args[2:])
    bkw = dict(kw, ccd=True, ccd_slop=cfg.ccd_slop)
    errs["tile_frame_compound_ccd"] = frame_agree(
        hopper, bargs, bkw, what + ", every dynamic row a bullet", spread,
        owner)
    return errs, {"tile_frame_compound": (args, kw, owner),
                  "tile_frame_compound_ccd": (bargs, bkw, owner)}


def run_pile_events(dev, hopper, tiled, pile, card) -> dict:
    """bench.py's ``pile_events``: 240 fused frames of pile(10_000,
    sleep=False) with events, in turns with the same rollout without
    (without, with, with, without), timed each; checked and returned."""
    import torch

    sc, cfg = pile["sc"], pile["cfg"]
    M = sc.world.colliders.m
    dyn_n = int((sc.world.bodies.inv_mass > 0).sum())

    def run(events):
        torch.cuda.synchronize()
        reset_counts(hopper)
        syncs0 = tiled.host_syncs
        t0 = time.perf_counter()
        out = tiled.tiled_rollout(sc.world, cfg, PILE_FRAMES,
                                  with_events=events)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, read_counts(hopper),
                tiled.host_syncs - syncs0)

    run(True)  # warm-up: the key table and the keyed K6
    plain_a, t_a, _, _ = run(False)
    events, t_b, launches, syncs = run(True)
    again, t_c, _, _ = run(True)
    plain_b, t_d, _, _ = run(False)
    final, diag, keys = events
    diag = {k: int(v) for k, v in diag.items()}
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(final.bodies, field),
                          getattr(plain_a[0].bodies, field)),
              f"pile_events: {field} differs from the rollout without events")
        check(torch.equal(getattr(again[0].bodies, field),
                          getattr(final.bodies, field)),
              f"pile_events rerun differs in {field}")
    check(diag == {k: int(v) for k, v in plain_a[1].items()},
          "pile_events: counters differ from the rollout without events")
    for key in ("slot_overflow", "solve_overflow", "window_overflow",
                "large_overflow"):
        check(diag[key] == 0, f"pile_events: {key} {diag[key]}")
    Csol = tiled._solve_cap(cfg)
    check(tuple(keys.shape) == (PILE_FRAMES, -(-M // 256), Csol, 256)
          and keys.dtype == torch.int32,
          f"pile_events: keys {tuple(keys.shape)} {keys.dtype}")
    a, b = keys // M, keys % M
    check(bool(((keys == -1) | ((keys >= 0) & (a < b) & (b < M))).all()),
          "pile_events: a key is neither -1 nor a pair a < b < M")
    check(torch.equal(again[2], keys), "pile_events rerun: keys differ")
    per_frame = (keys >= 0).sum(dim=(1, 2, 3))
    check(int(per_frame.min()) > 0, "pile_events: a frame without touches")
    check(launches["tile_frame"] == PILE_FRAMES
          and launches["tile_manifold_keys"] == PILE_FRAMES
          and launches["tile_manifold"] == 0,
          f"pile_events: K10 launched {launches['tile_frame']} times, keyed "
          f"K6 {launches['tile_manifold_keys']}, plain K6 "
          f"{launches['tile_manifold']}")
    check(syncs <= PILE_FRAMES, f"pile_events: {syncs} host syncs")
    ms_ev = 1e3 * (t_b + t_c) / 2 / PILE_FRAMES
    ms_plain = 1e3 * (t_a + t_d) / 2 / PILE_FRAMES
    print(f"pile_events path (bench.py's pile_events): pile({PILE_N}, "
          f"sleep=False), fused, with_events; {PILE_FRAMES} frames in "
          f"{t_b:.4f}, {t_c:.4f} s = {ms_ev:.4f} ms/frame, "
          f"{dyn_n / ms_ev * 1e3:.6g} body-steps/s; without events in the "
          f"same call {t_a:.4f}, {t_d:.4f} s = {ms_plain:.4f} ms/frame, "
          f"{dyn_n / ms_plain * 1e3:.6g} body-steps/s; touching keys a frame "
          f"{int(per_frame.min())}-{int(per_frame.max())}; launches "
          f"{json.dumps(launches)}; host syncs {syncs} "
          f"({syncs / PILE_FRAMES:.3f}/frame); state, counters bitwise equal "
          f"to the run without events, rerun bitwise equal; on {card}")
    return dict(final=final, cfg=cfg, launches=launches, ms=ms_ev)


def run_pile_compound(dev, hopper, tiled, card) -> dict:
    """bench.py's ``pile_compound``: ``pile_compound(10_000)`` (sleep on,
    awake-prefix compaction) for 7 chunks of 240 frames, each a rollout
    continuing from the last, timed each, checked (the compound frame once
    a frame that runs, no per-substep launch); the first chunk again with
    ``fuse=False`` (K8, ``owner_sum``, K9's compound form and
    ``owner_velocity`` once a substep: bitwise the same chunk); the last
    chunk again through the tile layout directly (sibling rows identical,
    bitwise the same chunk)."""
    import torch
    from starframe_tpu_torch import scenes
    from starframe_tpu_torch.hopper.tiles import STATE_KEYS

    sc = scenes.pile_compound(n_bodies=PILE_N, device=dev)
    cfg = sc.config
    check(cfg.sleep_velocity > 0.0 and cfg.tile_awake_compaction,
          "pile_compound(): sleep or compaction off")
    check(tiled.use_tiled(sc.world, cfg), "pile_compound: off the tile engine")
    dyn = sc.world.bodies.inv_mass > 0
    dyn_n = int(dyn.sum())
    wall = float(sc.world.bodies.pos[2, 0]) - 0.5
    torch.cuda.synchronize()
    reset_counts(hopper)
    syncs0 = tiled.host_syncs
    w, chunks = sc.world, []
    for c in range(1, PILE_CHUNKS + 1):
        start = w
        t0 = time.perf_counter()
        w, diag = tiled.tiled_rollout(w, cfg, PILE_FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        diag = {k: int(v) for k, v in diag.items()}
        b = w.bodies
        for field in ("pos", "angle", "vel", "ang_vel"):
            check(bool(torch.isfinite(getattr(b, field)).all()),
                  f"compound pile chunk {c}: non-finite {field}")
        for key in ("slot_overflow", "solve_overflow", "window_overflow",
                    "large_overflow", "owner_overflow"):
            check(diag[key] == 0, f"compound pile chunk {c}: {key} "
                  f"{diag[key]}")
        x, y = b.pos[dyn, 0], b.pos[dyn, 1]
        check(float(x.abs().max()) < wall and float(y.min()) > 0.0,
              f"compound pile chunk {c}: a body left the container")
        asleep = float(((b.sleep_count >= cfg.sleep_frames) & dyn).sum()
                       / dyn_n)
        chunks.append(dict(ms=1e3 * seconds / PILE_FRAMES, asleep=asleep,
                           diag=diag, world=w if c == 1 else None))
        print(f"compound pile chunk {c} (frames {PILE_FRAMES * (c - 1) + 1}-"
              f"{PILE_FRAMES * c}): {chunks[-1]['ms']:.4f} ms/frame, "
              f"{dyn_n / chunks[-1]['ms'] * 1e3:.6g} body-steps/s, asleep "
              f"share {asleep:.4f}; counters {json.dumps(diag)}")
        if c * PILE_FRAMES == PILE_COMPOUND_HEALTH_FRAME:
            health = pile_health(b.pos.cpu().numpy(), b.vel.cpu().numpy(),
                                 dyn.cpu().numpy())
            print(f"compound pile health at frame {c * PILE_FRAMES}: "
                  f"{json.dumps(health)}")
            check_pile_health(health, PILE_COMPOUND_HEALTH_REFERENCE,
                              PILE_COMPOUND_HEALTH_FRAME)
    frames = PILE_CHUNKS * PILE_FRAMES
    launches = read_counts(hopper)
    syncs = tiled.host_syncs - syncs0
    ran = launches["tile_manifold"]  # K6 runs once a frame that runs
    per_substep = ran * cfg.substeps
    check(0 < ran <= frames, f"compound pile: K6 launched {ran} times")
    check(launches["tile_frame_compound"] == ran, f"compound pile: the "
          f"compound frame launched {launches['tile_frame_compound']} times "
          f"in {ran} frames that ran")
    for name in ("tile_frame", "tile_apply", "tile_project",
                 "tile_apply_compound", "owner_sum", "owner_velocity"):
        check(launches[name] == 0, f"compound pile: {name} launched "
              f"{launches[name]} times beside the compound frame")
    check(syncs <= frames, f"compound pile: {syncs} host syncs in {frames} "
          "frames")
    best = min(ch["ms"] for ch in chunks[1:])
    print(f"compound pile (bench.py's pile_compound): pile_compound({PILE_N}),"
          f" {sc.world.colliders.m} collider rows, C = {cfg.slot_capacity}, "
          f"sleep velocity {cfg.sleep_velocity}, compaction on; best of "
          f"chunks 2-{PILE_CHUNKS}: {best:.4f} ms/frame, "
          f"{dyn_n / best * 1e3:.6g} body-steps/s ({dyn_n} dynamic bodies/"
          f"frame); per chunk ms/frame "
          + ", ".join(f"{ch['ms']:.4f}" for ch in chunks)
          + f"; asleep share at frame {frames} {chunks[-1]['asleep']:.4f}; "
          f"launches over {frames} frames {json.dumps(launches)} (K6 "
          f"{ran / frames:.4f}/frame); host syncs {syncs} "
          f"({syncs / frames:.3f}/frame); on {card}")

    # the last chunk again, through the tile layout: sibling rows hold the
    # same state and sleep counter bit for bit, and it is the same chunk
    g = start.gravity.to(torch.float32).contiguous()
    state, consts, large, body_id, _ = tiled._enter_tiles(start, cfg)
    state, consts, body_id, prev, counters, _ = tiled._rollout_core(
        state, consts, large, body_id, g, cfg=cfg, n_frames=PILE_FRAMES,
        fuse=True, plain=False, compound=True)
    ob = consts["obody"].reshape(-1)
    same = ob[1:] == ob[:-1]
    check(int(same.sum()) == PILE_N, "compound pile: sibling rows apart")
    for name, x in [(k, state[k]) for k in STATE_KEYS] + [
            ("sleep", consts["sleep"])]:
        x = x.reshape(-1)
        check(torch.equal(x[1:][same], x[:-1][same]),
              f"compound pile: sibling rows differ in {name}")
    again = tiled._exit_tiles(start, state, consts, prev, body_id,
                              PILE_FRAMES)
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(again.bodies, field),
                          getattr(w.bodies, field)),
              f"compound pile rerun differs in {field}")
    check({k: int(v) for k, v in counters.items()}
          == {k: v for k, v in chunks[-1]["diag"].items() if k in counters},
          "compound pile rerun counters differ")
    print(f"compound pile: the last chunk rerun through the tile layout is "
          f"bitwise the same; every sibling row equal to its block's first "
          f"({int(same.sum())} blocks of two), state and sleep counters")

    # the first chunk again through the per-substep kernels: the compound
    # frame's bitwise reference over 240 frames
    torch.cuda.synchronize()
    reset_counts(hopper)
    t0 = time.perf_counter()
    loop, ldiag = tiled.tiled_rollout(sc.world, cfg, PILE_FRAMES, fuse=False)
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0) / PILE_FRAMES
    ulaunches = read_counts(hopper)
    uran = ulaunches["tile_manifold"]
    check(uran > 0, "compound pile, fuse=False: no frame ran")
    for name in ("tile_project", "tile_apply_compound", "owner_sum",
                 "owner_velocity"):
        check(ulaunches[name] == uran * cfg.substeps, f"compound pile, "
              f"fuse=False: {name} launched {ulaunches[name]} times, "
              f"{uran * cfg.substeps} substeps ran")
    check(ulaunches["tile_frame_compound"] == ulaunches["tile_frame"] == 0,
          "compound pile, fuse=False: a whole-frame kernel ran")
    first = chunks[0]["world"]
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(loop.bodies, field),
                          getattr(first.bodies, field)),
              f"compound pile: fuse=False differs from the compound frame "
              f"in {field} after {PILE_FRAMES} frames")
    check({k: int(v) for k, v in ldiag.items()} == chunks[0]["diag"],
          "compound pile: fuse=False counters differ")
    print(f"compound pile: the first chunk with fuse=False (K8, owner_sum, "
          f"K9 compound, owner_velocity once a substep: launches "
          f"{json.dumps({k: v for k, v in ulaunches.items() if v})}) is "
          f"bitwise the compound frame's; {loop_ms:.4f} ms/frame against the "
          f"fused chunk's {chunks[0]['ms']:.4f}, on {card}")
    return dict(final=w, sc=sc, cfg=cfg, launches=launches,
                ulaunches=ulaunches, ms=best)


def ec_turns(hopper, tiled, events, compound, errs, bounds, card) -> dict:
    """The events and compound kernels at 10k bodies against their twins,
    timed in turns, with their bounds: K6 with keys on the awake pile's
    final state, K9's compound form and the owner kernels on one substep
    of the compound pile's final state (compacted, live and skipped
    tiles)."""
    import torch
    from starframe_tpu_torch.hopper.tiles import SOL

    times = {}

    def report(name, call, inputs, outputs, flops, extra=0, bitwise=False,
               what=""):
        bounds[name] = bound(inputs, outputs, flops, extra)
        times[name] = turns(call)
        DEVICE_MS[name] = launch_ms(lambda: call(False))
        print(f"time {name} at {PILE_N} bodies{what}: kernel "
              f"{times[name][0]:.4f} ms ({device_str(name)}), "
              f"plain twin {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
              + ("bitwise equal to the twin" if bitwise else
                 f"max abs err {errs[name]:.3g}") + f", on {card}")

    w, cfg = events["final"], events["cfg"]
    state, consts, large, body_id, _ = tiled._enter_tiles(w, cfg)
    edges = tiled._edge_rows(state, consts, cfg)[:2]
    g = w.gravity.contiguous()
    tables = hopper.build_tile_tables(
        state, consts, large, *edges, g, C=tiled._table_cap(cfg),
        margin=cfg.contact_margin, dt=cfg.dt,
        sweep_frames=cfg.frames_per_broadphase,
        sweep_slack=cfg.broadphase_speed_slack,
        sweep_floor=cfg.tile_sweep_floor, sweep_cap=cfg.tile_sweep_cap)
    live = torch.ones(state["px"].shape[0], device=g.device)
    ids = (body_id.reshape(-1, 256), large["cols"])
    mkw = dict(Cs=tiled._solve_cap(cfg), margin=cfg.contact_margin,
               dt=cfg.dt, event_ids=ids, n_colliders=w.colliders.m)

    def keyed(p):
        return hopper.tile_manifold(state, consts, large, *tables[:2], live,
                                    **mkw, plain=p)

    k, p = keyed(False), keyed(True)
    check(torch.equal(k[7], p[7]), "tile_manifold_keys at 10k: keys differ")
    errs["tile_manifold_keys"] = max(errs["tile_manifold_keys"],
                                     agree_tiles("tile_manifold", k[:7],
                                                 p[:7]))
    sk, ck, lk = TILE_READS["tile_manifold"]
    report("tile_manifold_keys", keyed,
           ([state[x] for x in sk], [consts[x] for x in ck],
            [large[x] for x in lk], tables[:2], live, ids), k,
           int(tables[1].sum()) * MANIFOLD_FLOPS,
           what=" (the awake pile's final state)")
    del k, p

    args, kw = frame_inputs(hopper, tiled, compound["final"],
                            compound["cfg"])
    state, kc, large, pidx_c, sol, g, live = args
    ccfg = compound["cfg"]
    ob, oc = kc["obody"].reshape(-1), ccfg.max_colliders_per_body
    h = kw["h"]
    *corr, lam, _ = hopper.tile_project(
        state, kc, large, pidx_c, sol, g, torch.zeros_like(sol[:, 0]), live,
        h=h, compliance=kw["compliance"])
    osum = hopper.owner_sum(corr, ob, oc)
    akw = {x: v for x, v in kw.items() if x not in ("substeps",
                                                    "compliance")}
    aargs = (state, osum, kc, large, pidx_c, sol, lam, g, live)

    def apply_c(p):
        return hopper.tile_apply(*aargs, **akw, compound=True, plain=p)

    (ak, accv), (ap, accv_p) = apply_c(False), apply_c(True)
    errs["tile_apply_compound"] = max(
        errs["tile_apply_compound"],
        agree_tiles("tile_apply_compound", list(ak.values()) + [accv],
                    list(ap.values()) + [accv_p]))
    on = live > 0
    sm = sol[on][:, [SOL["sm0"], SOL["sm1"]]]
    solved = int((sm != 0).any(dim=1).sum())
    sk, ck, lk = TILE_READS["tile_apply"]
    where = (f" (the compound pile's final state, {int(on.sum())} of "
             f"{on.numel()} tiles live, {solved} solved slots)")
    report("tile_apply_compound", apply_c,
           ([state[x] for x in sk], [kc[x] for x in ck],
            [large[x] for x in lk], sm, osum, g, live), (ak, accv),
           solved * VELOCITY_FLOPS,
           4 * SOLVED_SLOT_WORDS["tile_apply"] * solved, what=where)
    del ap, accv_p

    def osum_call(p):
        return hopper.owner_sum(corr, ob, oc, plain=p)

    for a, b in zip(osum_call(False), osum_call(True)):
        check(torch.equal(a, b), "owner_sum at 10k: kernel != twin")
    rows = ob.numel()
    report("owner_sum", osum_call, (corr, ob), osum,
           rows * 4 * 4 * (oc - 1), bitwise=True, what=where)

    vkw = dict(h=h, lin_damp=kw["lin_damp"], ang_damp=kw["ang_damp"])

    def ovel(p):
        return hopper.owner_velocity(ak, accv, ob, oc, **vkw, plain=p)

    vk, vp = ovel(False), ovel(True)
    for f in ("vx", "vy", "om"):
        check(torch.equal(vk[f], vp[f]), f"owner_velocity at 10k: {f}")
    report("owner_velocity", ovel,
           ([ak[x] for x in ("vx", "vy", "om")], accv, ob),
           [vk[x] for x in ("vx", "vy", "om")],
           rows * (4 * 4 * (oc - 1) + 12), bitwise=True, what=where)

    # K7 and the other K8 and K9 forms on the same state (every dynamic
    # row a bullet for the CCD forms, the factors owner-minimised), for
    # their bounds at the compound pile's shapes
    bkc = dict(kc, blt=(kc["invm"] > 0).float())
    bargs = (state, bkc, large, pidx_c, sol, g, live)
    slop = ccfg.ccd_slop
    fr = hopper.owner_min([hopper.tile_ccd(*bargs, h=h, ccd_slop=slop)], ob,
                          oc)[0]
    zt = torch.zeros_like(sol[:, 0])
    pkw = dict(h=h, compliance=kw["compliance"])
    projc = hopper.tile_project(*bargs[:6], zt, live, **pkw, f=fr)
    osum_c = hopper.owner_sum(projc[:4], ob, oc)

    def reads(name, *more):
        sk, ck, lk = TILE_READS[name]
        return ([state[x] for x in sk], [bkc[x] for x in ck],
                [large[x] for x in lk], more)

    forms = {
        "tile_ccd": (lambda p: hopper.tile_ccd(*bargs, h=h, ccd_slop=slop,
                                               plain=p),
                     reads("tile_ccd", sm, g, live),
                     4 * CCD_SLOT_WORDS * solved, solved * CCD_FLOPS),
        "tile_project": (lambda p: hopper.tile_project(
            *args[:6], zt, live, **pkw, plain=p),
            reads("tile_project", sm, g, zt, live),
            4 * SOLVED_SLOT_WORDS["tile_project"] * solved,
            solved * PROJECT_FLOPS),
        "tile_project_ccd": (lambda p: hopper.tile_project(
            *bargs[:6], zt, live, **pkw, f=fr, plain=p),
            reads("tile_project", sm, g, zt, live, fr),
            4 * SOLVED_SLOT_WORDS["tile_project"] * solved,
            solved * PROJECT_FLOPS),
        "tile_apply": (lambda p: hopper.tile_apply(*aargs, **akw, plain=p),
                       reads("tile_apply", sm, osum, g, live),
                       4 * SOLVED_SLOT_WORDS["tile_apply"] * solved,
                       solved * VELOCITY_FLOPS),
        "tile_apply_compound_ccd": (lambda p: hopper.tile_apply(
            state, osum_c, bkc, large, pidx_c, sol, projc[4], g, live, **akw,
            compound=True, f=fr, plain=p),
            reads("tile_apply", sm, osum_c, g, live, fr),
            4 * SOLVED_SLOT_WORDS["tile_apply"] * solved,
            solved * VELOCITY_FLOPS),
    }
    def outs(x):  # a call's outputs as a flat list of tensors
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return list(x.values())
        return [t for v in x for t in outs(v)]

    for form, (call, inputs, extra, flops) in forms.items():
        name = form + "@compound"
        k, p = call(False), call(True)
        errs[name] = agree_tiles(form, outs(k), outs(p))
        report(name, call, inputs, k, flops, extra, what=where)
        del k, p

    # the compound frame, without and with CCD (every dynamic row a
    # bullet), beside the per-substep kernels on the same inputs
    ferrs, finputs = compound_frame_agree(
        hopper, tiled, compound["final"], ccfg, f"at {PILE_N} bodies, the "
        "compound pile's final state", spread=True)
    for name, (fargs, fkw, owner) in finputs.items():
        errs[name] = max(errs[name], ferrs[name])
        ccd = bool(fkw.get("ccd"))
        n = fkw["substeps"]
        owner_ops = rows * (4 * 4 * (oc - 1) + 4 * 4 * (oc - 1) + 12
                            + (2 * (oc - 1) if ccd else 0))
        sk, ck, lk = TILE_READS["tile_frame_compound"]
        fkc = fargs[1]

        def frame(p, fargs=fargs, fkw=fkw, owner=owner):
            return hopper.tile_frame(*fargs, **fkw, owner=owner, plain=p)

        report(name, frame,
               ([fargs[0][x] for x in sk],
                [fkc[x] for x in ck + (("blt",) if ccd else ())],
                [large[x] for x in lk], sm, g, live), frame(False),
               n * (solved * (PROJECT_FLOPS + VELOCITY_FLOPS
                              + (CCD_FLOPS if ccd else 0)) + owner_ops),
               4 * SOLVED_SLOT_WORDS["tile_frame"] * solved, what=where)
        loop = cuda_ms(lambda: substep_pair(hopper, fargs, fkw, owner), 5)
        print(f"time {name}: the per-substep kernels on the same inputs "
              f"({'K7, owner_min, ' if ccd else ''}K8, owner_sum, K9 "
              f"compound, owner_velocity once a substep) {loop:.4f} ms "
              f"against the compound frame's {times[name][0]:.4f} ms, on "
              f"{card}")
    return times


# ---- CCD: bullet bodies on both engines ------------------------------------


def bulleted(w):
    """``w`` with every dynamic body flagged a bullet (``BODY_BULLET``), so
    that CCD's TOI pass runs on every row."""
    import dataclasses

    import torch
    from starframe_tpu_torch.state import BODY_BULLET

    b = w.bodies
    flags = torch.where(b.inv_mass > 0, b.flags | BODY_BULLET, b.flags)
    return dataclasses.replace(w, bodies=dataclasses.replace(b, flags=flags))


def bullet_batch(dev, speed, restitution=0.0, worlds=4, two_colliders=False):
    """tests/test_ccd.py's ``_bullet_batch`` through the port's builder: a
    thin wall, a 0.05 m bullet at ``speed`` towards it and far-away pads,
    128 bodies, replicated ``worlds`` times; with ``two_colliders`` the
    bullet is two circles side by side. Returns ``(worlds, cfg)`` with
    test_ccd.py's ``KCFG`` (10 substeps, C = 8, ``ccd``)."""
    from starframe_tpu_torch import (
        Capacity,
        Shape,
        SolverConfig,
        WorldBuilder,
        parallel,
    )

    wb = WorldBuilder()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type="static")
    wb.add_collider(wall, Shape.box(0.1, 2.0), restitution=restitution)
    b = wb.add_body(pos=(-3.0, 0.0), vel=(speed, 0.0), bullet=True)
    offsets = ((0.0, -0.03), (0.0, 0.03)) if two_colliders else ((0.0, 0.0),)
    for off in offsets:
        wb.add_collider(b, Shape.circle(0.05), offset=off,
                        restitution=restitution)
    for i in range(126):
        pad = wb.add_body(pos=(1000.0 + 10.0 * i, 0.0))
        wb.add_collider(pad, Shape.circle(0.3))
    w, _ = wb.build(Capacity(max_bodies=128, max_colliders=127 + len(offsets),
                             max_pairs=512, max_joints=0, max_verts=4),
                    device=dev)
    cfg = SolverConfig(dt=1 / 60, substeps=10, ccd=True, slot_capacity=8)
    return parallel.replicate_world(w, worlds), cfg


def bullet_tiles(dev, speed, x0=-3.0, two_colliders=False):
    """tests/test_ccd.py's tile-engine bullet world through the port's
    builder: the wall, a bullet at ``x0`` flying at ``speed`` and 1022 pads
    far away, 1024 bodies (4 tiles; 5 with ``two_colliders``). Returns
    ``(world, cfg)``: ``KCFG`` with one-frame tables."""
    from starframe_tpu_torch import (
        Capacity,
        Shape,
        SolverConfig,
        WorldBuilder,
    )

    wb = WorldBuilder()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type="static")
    wb.add_collider(wall, Shape.box(0.1, 2.0))
    b = wb.add_body(pos=(x0, 0.0), vel=(speed, 0.0), bullet=True)
    offsets = ((0.0, -0.03), (0.0, 0.03)) if two_colliders else ((0.0, 0.0),)
    for off in offsets:
        wb.add_collider(b, Shape.circle(0.05), offset=off)
    for i in range(1022):
        pad = wb.add_body(pos=(1000.0 + 2.0 * (i % 256), 5.0 * (i // 256)))
        wb.add_collider(pad, Shape.circle(0.3))
    w, _ = wb.build(Capacity(max_bodies=1024,
                             max_colliders=1023 + len(offsets),
                             max_pairs=8192, max_joints=0, max_verts=4),
                    device=dev)
    cfg = SolverConfig(dt=1 / 60, substeps=10, ccd=True, slot_capacity=8,
                       frames_per_broadphase=1)
    return w, cfg


def ccd_tile_calls(hopper, tiled, w, cfg):
    """K7 and the CCD forms of K8 and K9 on ``w``'s layout, chained as a
    frame's first substep chains them (each on its predecessor's twin
    outputs; on compound rows the factors owner-minimised), with what each
    bound counts, their float64 twins, K10's arguments, and the factors:
    ``(calls, plain64, (args, kw), f)``."""
    import torch
    from starframe_tpu_torch.hopper.tiles import SOL

    args, kw = frame_inputs(hopper, tiled, w, cfg)
    kw.update(ccd=True, ccd_slop=cfg.ccd_slop)
    state, kc, large, pidx_c, sol, g, live = args
    h = kw["h"]
    compound = w.colliders.m != w.bodies.n
    f = hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop, plain=True)
    if compound:
        f = hopper.owner_min([f], kc["obody"].reshape(-1),
                             cfg.max_colliders_per_body, plain=True)[0]
    touched = torch.zeros(pidx_c.shape, device=g.device)
    pkw = dict(h=h, compliance=kw["compliance"])
    proj = hopper.tile_project(state, kc, large, pidx_c, sol, g, touched,
                               live, **pkw, f=f, plain=True)
    akw = {x: v for x, v in kw.items()
           if x not in ("substeps", "compliance", "ccd", "ccd_slop")}
    on = live > 0
    sm = sol[on][:, [SOL["sm0"], SOL["sm1"]]]
    solved = int((sm != 0).any(dim=1).sum())
    pargs = (state, kc, large, pidx_c, sol, g, touched, live)
    aargs = (state, proj[:4], kc, large, pidx_c, sol, proj[4], g, live)

    def reads(name, *more):
        sk, ck, lk = TILE_READS[name]
        return ([state[x] for x in sk], [kc[x] for x in ck],
                [large[x] for x in lk], more)

    calls = {
        "tile_ccd": (
            lambda p: hopper.tile_ccd(*args, h=h, ccd_slop=cfg.ccd_slop,
                                      plain=p),
            reads("tile_ccd", sm, g, live), 4 * CCD_SLOT_WORDS * solved,
            solved * CCD_FLOPS),
        "tile_project_ccd": (
            lambda p: hopper.tile_project(*pargs, **pkw, f=f, plain=p),
            reads("tile_project", sm, g, touched, live, f),
            4 * SOLVED_SLOT_WORDS["tile_project"] * solved,
            solved * PROJECT_FLOPS),
        "tile_apply_ccd": (
            lambda p: hopper.tile_apply(*aargs, **akw, f=f, plain=p),
            reads("tile_apply", sm, proj[:4], g, live, f),
            4 * SOLVED_SLOT_WORDS["tile_apply"] * solved,
            solved * VELOCITY_FLOPS),
    }
    plain64 = {
        "tile_ccd": lambda: hopper.tile_ccd_plain(
            *to64(args), h=h, ccd_slop=cfg.ccd_slop),
        "tile_project_ccd": lambda: hopper.tile_project_plain(
            *to64(pargs), **pkw, f=f.double()),
        "tile_apply_ccd": lambda: hopper.tile_apply_plain(
            *to64(aargs), **akw, f=f.double()),
    }
    if compound:  # K9's compound form: the CCD instance of the compound rows
        del calls["tile_apply_ccd"], plain64["tile_apply_ccd"]
    return calls, plain64, (args, kw), f


def ccd_agree(hopper, name, call, plain64=None):
    """One CCD kernel against its twin (``agree_tiles``; with ``plain64``, to
    a tenth of float32's own spread where that is larger)."""
    k, p = call(False), call(True)
    spread = None
    if plain64 is not None:
        p64 = plain64()
        p64 = list(p64.values()) if isinstance(p64, dict) else (
            [p64] if hasattr(p64, "dtype") else list(p64))
        pl = list(p.values()) if isinstance(p, dict) else (
            [p] if hasattr(p, "dtype") else list(p))
        spread = [max_err(a, b) for a, b in zip(pl, p64)]
    k = [k] if hasattr(k, "dtype") else k
    p = [p] if hasattr(p, "dtype") else p
    return agree_tiles(name, k, p, spread)


def parity_ccd(dev, hopper, tiled, parallel) -> dict:
    """The CCD kernels against their twins on tests/test_ccd.py's scenes,
    built with the port's builder: K7, K8's and K9's CCD forms and K10's
    CCD form (bitwise equal to K7 + K8 + K9) on the 4-tile bullet world at
    200 and 1000 m/s, the bullet 0.3 m from the wall (its first substep
    clamps); K7, ``owner_min`` (bitwise) and K9's compound CCD form on the
    same world with a two-collider bullet; K4's CCD form on ``_bullet_batch``
    at 4 worlds, one and two frames in (the frame of the impact)."""
    import torch

    errs = {n: 0.0 for n, *_ in CCD_KERNELS}
    for speed in (200.0, 1000.0):
        w, cfg = bullet_tiles(dev, speed, x0=-0.3)
        calls, _, (args, kw), f = ccd_tile_calls(hopper, tiled, w, cfg)
        check(int((f < 1.0).sum()) == 1, f"tile_ccd at {speed} m/s: the "
              f"bullet did not clamp ({int((f < 1.0).sum())} rows)")
        for name, (call, *_) in calls.items():
            errs[name] = max(errs[name], ccd_agree(hopper, name, call))
        errs["tile_frame_ccd"] = max(errs["tile_frame_ccd"], frame_agree(
            hopper, args, kw, f"on the bullet world at {speed} m/s"))
        print(f"parity ccd tiles at {speed} m/s: K7 clamps the bullet to f = "
              f"{float(f[f < 1.0]):.6g}; max abs err "
              + ", ".join(f"{n} {errs[n]:.3g}" for n in (
                  "tile_ccd", "tile_project_ccd", "tile_apply_ccd",
                  "tile_frame_ccd")))

    w, cfg = bullet_tiles(dev, 1000.0, x0=-0.3, two_colliders=True)
    calls, _, (args, kw), f = ccd_tile_calls(hopper, tiled, w, cfg)
    errs["tile_ccd"] = max(errs["tile_ccd"],
                           ccd_agree(hopper, "tile_ccd", calls["tile_ccd"][0]))
    state, kc, large, pidx_c, sol, g, live = args
    ob, oc = kc["obody"].reshape(-1), cfg.max_colliders_per_body
    raw = hopper.tile_ccd(*args, h=kw["h"], ccd_slop=cfg.ccd_slop)
    mk = hopper.owner_min([raw], ob, oc)[0]
    mp = hopper.owner_min([raw], ob, oc, plain=True)[0]
    check(torch.equal(mk, mp), "owner_min: kernel != twin")
    check(int((mk < 1.0).sum()) == 2 and int((raw < 1.0).sum()) >= 1,
          "owner_min: the bullet's two rows do not share its clamp")
    proj = hopper.tile_project(
        state, kc, large, pidx_c, sol, g, torch.zeros_like(sol[:, 0]), live,
        h=kw["h"], compliance=kw["compliance"], f=mk, plain=True)
    corr = hopper.owner_sum(proj[:4], ob, oc, plain=True)
    akw = {x: v for x, v in kw.items()
           if x not in ("substeps", "compliance", "ccd", "ccd_slop")}

    def apply_cc(p):
        out, accv = hopper.tile_apply(state, corr, kc, large, pidx_c, sol,
                                      proj[4], g, live, **akw, compound=True,
                                      f=mk, plain=p)
        return list(out.values()) + [accv]

    errs["tile_apply_ccd"] = max(errs["tile_apply_ccd"],
                                 agree_tiles("tile_apply_ccd", apply_cc(False),
                                             apply_cc(True)))
    print("parity ccd tiles, two-collider bullet: K7 against its twin, "
          "owner_min bitwise (both rows at the body's clamp), K9's compound "
          "CCD form max abs err "
          f"{errs['tile_apply_ccd']:.3g}")

    for speed in (200.0, 1000.0):
        bw, bcfg = bullet_batch(dev, speed)
        for frames in (1, 2):
            w = bw
            if frames > 1:
                w, _, _ = parallel.batched_rollout(bw, bcfg, 0, frames - 1,
                                                   record=lambda _: None)
            tables = parallel.frame2_tables(w, bcfg)
            errs["frame2_ccd"] = max(errs["frame2_ccd"], frame_parity(
                f"frame2_ccd at {speed} m/s, frame {frames}", parallel, w,
                bcfg, tables))
    return errs


def run_projectile(dev, hopper, parallel, card) -> dict:
    """The projectile batch at full width: ``_bullet_batch`` at 4096 worlds,
    30 frames through ``batched_rollout`` at 200 and 1000 m/s (every
    world's bullet on the wall's near face, hard counters 0, K4's CCD form
    once a frame), and 10 frames at 1000 m/s with restitution 0.9 (every
    world rebounding at 820-950 m/s)."""
    import torch

    out = {}
    for name in ("projectile_200", "projectile_1000", "projectile_1000_rest"):
        bw, cfg, frames = k4_phase(name, dev)
        speed = float(name.split("_")[1])
        rest = 0.9 if name.endswith("_rest") else 0.0
        torch.cuda.synchronize()
        reset_counts(hopper)
        hopper.run_frame2.launches = 0
        t0 = time.perf_counter()
        final, _, diag = parallel.batched_rollout(bw, cfg, 0, frames,
                                                  record=lambda _: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        diag = {k: int(v) for k, v in diag.items()}
        launches = hopper.run_frame2.ccd_launches
        check(launches == frames and hopper.run_frame2.launches == 0,
              f"projectile: K4's CCD form launched {launches} times")
        record_phase(name, bw, cfg, frames, final)
        for key in ("slot_overflow", "joint_overflow"):
            check(diag[key] == 0, f"projectile: {key} {diag[key]}")
        x = final.bodies.pos[:, 1, 0]
        vx = final.bodies.vel[:, 1, 0]
        check(bool(torch.isfinite(final.bodies.pos).all()),
              "projectile: non-finite positions")
        if rest == 0.0:
            ok = (x > WALL_FACE - 0.06) & (x <= WALL_FACE + 0.01)
            check(bool(ok.all()), f"projectile at {speed} m/s: "
                  f"{int((~ok).sum())} of {PROJECTILE_W} bullets off the "
                  f"face (x in [{float(x.min())}, {float(x.max())}])")
        else:
            ok = (vx > -950.0) & (vx < -820.0)
            check(bool(ok.all()), f"projectile restitution: {int((~ok).sum())}"
                  f" of {PROJECTILE_W} worlds outside (-950, -820) m/s "
                  f"([{float(vx.min())}, {float(vx.max())}])")
        ms = 1e3 * seconds / frames
        key = f"{speed:g} m/s" + (f", restitution {rest:g}" if rest else "")
        out[key] = ms
        print(f"projectile batch ({PROJECTILE_W} worlds x 128 bodies, "
              f"{key}, {frames} frames): {ms:.4f} ms/frame, "
              f"{PROJECTILE_W * 128 * frames / seconds:.6g} body-steps/s; "
              f"bullet x in [{float(x.min()):.6g}, {float(x.max()):.6g}], "
              f"vx in [{float(vx.min()):.6g}, {float(vx.max()):.6g}]; "
              f"counters {json.dumps(diag)}; K4 CCD launches {launches}; "
              f"on {card}")
    return out


def run_main_ccd(dev, hopper, parallel, card) -> dict:
    """The main path with CCD: ``batched_worlds(4096)`` with every dynamic
    body a bullet (K4's TOI pass on every row), 60 frames, timed in turns
    with the same scene and ``ccd=False`` (off, on, on, off), checked as the
    main path is, and a 10-frame rerun bitwise equal."""
    import dataclasses

    import torch

    w, cfg, _ = k4_phase("main_ccd", dev)
    cfgs = {False: dataclasses.replace(cfg, ccd=False), True: cfg}
    active = int(((w.bodies.flags & 1) != 0).sum())

    def rollout(ccd, n):
        return parallel.batched_rollout(w, cfgs[ccd], 0, n,
                                        record=lambda _: None)

    for ccd in (False, True):  # warm-up
        rollout(ccd, 10)
    runs = {False: [], True: []}
    for ccd in (False, True, True, False):
        torch.cuda.synchronize()
        reset_counts(hopper)
        hopper.run_frame2.launches = 0
        t0 = time.perf_counter()
        final, _, diag = rollout(ccd, FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (hopper.run_frame2.ccd_launches,
                    hopper.run_frame2.launches)
        check(launches == ((FRAMES, 0) if ccd else (0, FRAMES)),
              f"main path ccd={ccd}: K4 launches (ccd, plain) {launches}")
        runs[ccd].append((final, {k: int(v) for k, v in diag.items()},
                          seconds))
    final, diag, _ = runs[True][0]
    check(torch.equal(final.bodies.pos, runs[True][1][0].bodies.pos),
          "main path with CCD: the two timed runs differ")
    record_phase("main_ccd", w, cfgs[True], FRAMES, final)
    b = final.bodies
    dyn = b.inv_mass > 0
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(bool(torch.isfinite(getattr(b, field)).all()),
              f"main path with CCD: non-finite {field}")
    for key in ("slot_overflow", "joint_overflow"):
        check(diag[key] == 0, f"main path with CCD: {key} {diag[key]}")
    y_min = float(b.pos[..., 1][dyn].min())
    check(y_min > 0.2, f"main path with CCD: a body sank (y = {y_min})")
    a, _, da = rollout(True, 10)
    c, _, dc = rollout(True, 10)
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(a.bodies, field), getattr(c.bodies, field)),
              f"main path with CCD: rerun differs in {field}")
    check({k: int(v) for k, v in da.items()}
          == {k: int(v) for k, v in dc.items()},
          "main path with CCD: rerun counters differ")
    ms = {ccd: 1e3 * sum(r[2] for r in runs[ccd]) / (2 * FRAMES)
          for ccd in runs}
    moved = float((runs[True][0][0].bodies.pos
                   - runs[False][0][0].bodies.pos).abs().max())
    print(f"main path with CCD: {W_MAIN}x{N_BODIES} worlds, every dynamic "
          f"body a bullet, {SUBSTEPS} substeps, {FRAMES} frames: "
          f"{ms[True]:.4f} ms/frame, {active / ms[True] * 1e3:.6g} "
          f"body-steps/s, against {ms[False]:.4f} ms/frame "
          f"({active / ms[False] * 1e3:.6g}) without CCD in turns (off, on, "
          f"on, off: " + ", ".join(
              f"{1e3 * r[2] / FRAMES:.4f}" for r in (
                  runs[False][0], runs[True][0], runs[True][1],
                  runs[False][1]))
          + f" ms/frame); counters {json.dumps(diag)}; min dynamic y "
          f"{y_min:.4f}; largest pose difference from the run without CCD "
          f"{moved:.4g} m; a 10-frame rerun bitwise equal; on {card}")
    return dict(final=final, cfg=cfgs[True], ms=ms[True], ms_off=ms[False],
                launches=FRAMES)


def run_pile_ccd(dev, hopper, tiled, card) -> dict:
    """``pile(10_000, sleep=False)`` with CCD and every body a bullet, 240
    frames fused (K10's CCD form) and ``fuse=False`` (K7, K8, K9 once a
    substep) in turns, beside the fused pile without CCD: bitwise equal
    fused and unfused, a rerun bitwise equal, hard counters 0, inside the
    container, health at frame 240 within the awake pile's bounds, K7 ten
    times a frame unfused and never fused; then how many rows K7 clamps in
    one frame at frames 30, 60 and 120 of the fall."""
    import dataclasses

    import torch
    from starframe_tpu_torch import scenes
    from starframe_tpu_torch.hopper.tiles import substep_loop

    sc = scenes.pile(n_bodies=PILE_N, sleep=False, device=dev)
    w = bulleted(sc.world)
    cfg = dataclasses.replace(sc.config, ccd=True)
    plain_cfg = dataclasses.replace(sc.config, ccd=False)
    dyn = w.bodies.inv_mass > 0
    dyn_n = int(dyn.sum())
    wall = float(w.bodies.pos[2, 0]) - 0.5
    configs = {"plain": (plain_cfg, True), "fused": (cfg, True),
               "unfused": (cfg, False)}
    for c, fuse in configs.values():  # warm-up
        tiled.tiled_rollout(w, c, 10, fuse=fuse)
    runs = {k: [] for k in configs}
    for key in ("plain", "unfused", "fused", "fused", "unfused", "plain"):
        c, fuse = configs[key]
        torch.cuda.synchronize()
        reset_counts(hopper)
        t0 = time.perf_counter()
        final, diag = tiled.tiled_rollout(w, c, PILE_FRAMES, fuse=fuse)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[key].append((final, {k: int(v) for k, v in diag.items()},
                          seconds, read_counts(hopper)))
    fused, fdiag, _, flaunch = runs["fused"][0]
    unfused, udiag, _, ulaunch = runs["unfused"][0]
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(fused.bodies, field),
                          getattr(unfused.bodies, field)),
              f"pile_ccd: fused and unfused differ in {field}")
        check(torch.equal(getattr(fused.bodies, field),
                          getattr(runs["fused"][1][0].bodies, field)),
              f"pile_ccd: the fused rerun differs in {field}")
        check(bool(torch.isfinite(getattr(fused.bodies, field)).all()),
              f"pile_ccd: non-finite {field}")
    check(fdiag == udiag == runs["fused"][1][1],
          "pile_ccd: counters differ between the runs")
    for key in ("slot_overflow", "solve_overflow", "window_overflow",
                "large_overflow"):
        check(fdiag[key] == 0, f"pile_ccd: {key} {fdiag[key]}")
    per_substep = PILE_FRAMES * cfg.substeps
    check(flaunch["tile_frame_ccd"] == PILE_FRAMES
          and flaunch["tile_ccd"] == 0 and flaunch["tile_frame"] == 0,
          f"pile_ccd fused: launches {json.dumps(flaunch)}")
    check(ulaunch["tile_ccd"] == per_substep
          and ulaunch["tile_project_ccd"] == per_substep
          and ulaunch["tile_apply_ccd"] == per_substep
          and ulaunch["tile_frame_ccd"] == 0 and ulaunch["tile_project"] == 0,
          f"pile_ccd unfused: launches {json.dumps(ulaunch)}")
    b = fused.bodies
    x, y = b.pos[dyn, 0], b.pos[dyn, 1]
    check(float(x.abs().max()) < wall and float(y.min()) > 0.0,
          "pile_ccd: a body left the container")
    health = pile_health(b.pos.cpu().numpy(), b.vel.cpu().numpy(),
                         dyn.cpu().numpy())
    print(f"pile_ccd health at frame {PILE_FRAMES}: {json.dumps(health)}")
    check_pile_health(health, PILE_HEALTH_REFERENCE, PILE_FRAMES)
    ms = {k: 1e3 * sum(r[2] for r in v) / (len(v) * PILE_FRAMES)
          for k, v in runs.items()}

    # rows K7 clamps in one frame of the fall, at a few frames in
    states, clamped = {}, {}
    cur, done = w, 0
    for at in PILE_CCD_FRAMES:
        cur, _ = tiled.tiled_rollout(cur, cfg, at - done)
        done = at
        states[at] = cur
        args, kw = frame_inputs(hopper, tiled, cur, cfg)
        counts = []

        def toi(*a, **k):
            f = hopper.tile_ccd(*a, **k)
            counts.append(int((f < 1.0).sum()))
            return f

        substep_loop(hopper.tile_project, hopper.tile_apply, *args,
                     ccd=(toi, hopper.owner_min, cfg.ccd_slop), **kw)
        clamped[at] = counts
    print(f"pile_ccd: pile({PILE_N}, sleep=False), every body a bullet, "
          f"{cfg.substeps} substeps, {PILE_FRAMES} frames: fused (K10's CCD "
          f"form) {ms['fused']:.4f} ms/frame, "
          f"{dyn_n / ms['fused'] * 1e3:.6g} body-steps/s; fuse=False (K7, "
          f"K8, K9) {ms['unfused']:.4f} ms/frame, "
          f"{dyn_n / ms['unfused'] * 1e3:.6g}; the fused pile without CCD "
          f"{ms['plain']:.4f} ms/frame, {dyn_n / ms['plain'] * 1e3:.6g} "
          f"(turns: plain, unfused, fused, fused, unfused, plain: "
          + ", ".join(f"{1e3 * r[2] / PILE_FRAMES:.4f}" for k in (
              "plain", "unfused", "fused") for r in runs[k])
          + f" ms/frame by kind); fused and unfused and a rerun bitwise "
          f"equal; counters {json.dumps(fdiag)}; launches fused "
          f"{json.dumps({k: v for k, v in flaunch.items() if v})}, unfused "
          f"{json.dumps({k: v for k, v in ulaunch.items() if v})}; rows "
          f"clamped (f < 1) per substep of one frame: "
          + "; ".join(f"frame {at}: {c}" for at, c in clamped.items())
          + f"; on {card}")
    return dict(final=fused, cfg=cfg, states=states, ms=ms["fused"],
                ms_unfused=ms["unfused"], ms_plain=ms["plain"],
                launches=ulaunch, flaunches=flaunch, clamped=clamped)


def run_compound_ccd(dev, hopper, tiled, card) -> dict:
    """``pile_compound(10_000)`` (sleep on) with CCD and every body a
    bullet, 60 frames from the start: the compound frame's CCD form once a
    frame, hard counters 0, inside the container, a rerun bitwise equal;
    then the same frames with ``fuse=False`` (K7, ``owner_min``, K8's CCD
    form and K9's compound CCD form once a substep), bitwise equal."""
    import dataclasses

    import torch
    from starframe_tpu_torch import scenes

    sc = scenes.pile_compound(n_bodies=PILE_N, device=dev)
    w = bulleted(sc.world)
    cfg = dataclasses.replace(sc.config, ccd=True)
    check(tiled.use_tiled(w, cfg), "compound pile with CCD: off the tile "
          "engine")
    frames = 60
    tiled.tiled_rollout(w, cfg, 5)  # warm-up
    torch.cuda.synchronize()
    reset_counts(hopper)
    t0 = time.perf_counter()
    final, diag = tiled.tiled_rollout(w, cfg, frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(hopper)
    diag = {k: int(v) for k, v in diag.items()}
    for key in ("slot_overflow", "solve_overflow", "window_overflow",
                "large_overflow", "owner_overflow"):
        check(diag[key] == 0, f"compound pile with CCD: {key} {diag[key]}")
    b = final.bodies
    dyn = b.inv_mass > 0
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(bool(torch.isfinite(getattr(b, field)).all()),
              f"compound pile with CCD: non-finite {field}")
    wall = float(w.bodies.pos[2, 0]) - 0.5
    check(float(b.pos[dyn, 0].abs().max()) < wall
          and float(b.pos[dyn, 1].min()) > 0.0,
          "compound pile with CCD: a body left the container")
    ran = launches["tile_manifold"]
    check(launches["tile_frame_compound_ccd"] == ran and ran > 0,
          f"compound pile with CCD: the compound frame launched "
          f"{launches['tile_frame_compound_ccd']} times, {ran} frames ran")
    for name in ("tile_ccd", "owner_min", "tile_project_ccd",
                 "tile_apply_compound_ccd", "tile_frame_ccd",
                 "tile_apply_ccd", "tile_frame_compound"):
        check(launches[name] == 0, f"compound pile with CCD: {name} "
              f"launched {launches[name]} times beside the compound frame")
    again, dagain = tiled.tiled_rollout(w, cfg, frames)
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(again.bodies, field), getattr(b, field)),
              f"compound pile with CCD: rerun differs in {field}")
    # the per-substep kernels: the compound frame's bitwise reference
    torch.cuda.synchronize()
    reset_counts(hopper)
    t0 = time.perf_counter()
    loop, ldiag = tiled.tiled_rollout(w, cfg, frames, fuse=False)
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0) / frames
    ulaunches = read_counts(hopper)
    uran = ulaunches["tile_manifold"] * cfg.substeps
    for name in ("tile_ccd", "owner_min", "tile_project_ccd",
                 "tile_apply_compound_ccd"):
        check(ulaunches[name] == uran and uran > 0,
              f"compound pile with CCD, fuse=False: {name} launched "
              f"{ulaunches[name]} times, {uran} substeps ran")
    check(ulaunches["tile_frame_compound_ccd"] == 0,
          "compound pile with CCD, fuse=False: the compound frame ran")
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(loop.bodies, field), getattr(b, field)),
              f"compound pile with CCD: fuse=False differs in {field}")
    check({k: int(v) for k, v in ldiag.items()} == diag,
          "compound pile with CCD: fuse=False counters differ")
    ms = 1e3 * seconds / frames
    dyn_n = int(dyn.sum())
    print(f"compound pile with CCD: pile_compound({PILE_N}), every body a "
          f"bullet, {frames} frames: {ms:.4f} ms/frame, "
          f"{dyn_n / ms * 1e3:.6g} body-steps/s; counters {json.dumps(diag)}"
          f"; launches {json.dumps({k: v for k, v in launches.items() if v})}"
          f"; a rerun bitwise equal; fuse=False bitwise equal at "
          f"{loop_ms:.4f} ms/frame (launches "
          f"{json.dumps({k: v for k, v in ulaunches.items() if v})}); on "
          f"{card}")
    return dict(final=final, cfg=cfg, ms=ms, launches=launches,
                ulaunches=ulaunches)


def ccd_turns(hopper, tiled, parallel, pccd, cccd, mccd, errs, bounds,
              card) -> dict:
    """The CCD kernels at full size against their twins, timed in turns,
    with their bounds: K7 and the CCD forms of K8, K9 and K10 on the CCD
    pile at frame 60 of its fall (every row a bullet), ``owner_min`` on the
    compound CCD pile's final state, K4's CCD form at 4096 worlds from the
    main path with CCD's final state."""
    import torch
    from starframe_tpu_torch.hopper.tiles import SOL

    times = {}
    at = PILE_CCD_FRAMES[1]
    w, cfg = pccd["states"][at], pccd["cfg"]
    calls, plain64, (args, kw), f = ccd_tile_calls(hopper, tiled, w, cfg)
    where = (f" (the CCD pile at frame {at}, every row a bullet, "
             f"{int((f < 1.0).sum())} rows clamped in the first substep)")
    for name, (call, inputs, extra, flops) in calls.items():
        errs[name] = max(errs[name], ccd_agree(hopper, name, call,
                                               plain64[name]))
        k = call(False)
        bounds[name] = bound(inputs, k, flops, extra)
        del k
        times[name] = turns(call)
        DEVICE_MS[name] = launch_ms(lambda: call(False))
        print(f"time {name} at {PILE_N} bodies{where}: kernel "
              f"{times[name][0]:.4f} ms ({device_str(name)}), plain twin "
              f"{times[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}), max abs err {errs[name]:.3g}, on {card}")

    errs["tile_frame_ccd"] = max(errs["tile_frame_ccd"], frame_agree(
        hopper, args, kw, f"at {PILE_N} bodies{where}", spread=True))
    state, kc, large, pidx_c, sol, g, live = args
    sm = sol[live > 0][:, [SOL["sm0"], SOL["sm1"]]]
    solved = int((sm != 0).any(dim=1).sum())
    n = kw["substeps"]
    sk, ck, lk = TILE_READS["tile_frame"]
    k = hopper.tile_frame(*args, **kw)
    bounds["tile_frame_ccd"] = bound(
        ([state[x] for x in sk], [kc[x] for x in ck + ("blt",)],
         [large[x] for x in lk], sm, g, live), k,
        n * solved * (PROJECT_FLOPS + VELOCITY_FLOPS + CCD_FLOPS),
        4 * SOLVED_SLOT_WORDS["tile_frame"] * solved)
    del k
    plain_kw = {x: v for x, v in kw.items() if x not in ("ccd", "ccd_slop")}
    p1 = cuda_ms(lambda: substep_pair(hopper, args, kw), 3)
    times["tile_frame_ccd"] = turns(
        lambda p: hopper.tile_frame(*args, **kw, plain=p))
    p2 = cuda_ms(lambda: substep_pair(hopper, args, kw), 3)
    no_ccd = cuda_ms(lambda: hopper.tile_frame(*args, **plain_kw), 5)
    DEVICE_MS["tile_frame_ccd"] = launch_ms(
        lambda: hopper.tile_frame(*args, **kw))
    print(f"time tile_frame_ccd at {PILE_N} bodies{where}: kernel "
          f"{times['tile_frame_ccd'][0]:.4f} ms "
          f"({device_str('tile_frame_ccd')}), plain twin "
          f"{times['tile_frame_ccd'][1]:.4f} ms, K7 + K8 + K9 once a "
          f"substep {(p1 + p2) / 2:.4f} ms, the non-CCD K10 on the same "
          f"inputs {no_ccd:.4f} ms; bound "
          f"{bounds['tile_frame_ccd'][0]:.4f} ms "
          f"({bounds['tile_frame_ccd'][1]}), max abs err against the twin "
          f"{errs['tile_frame_ccd']:.3g}, on {card}")

    cw, ccfg = cccd["final"], cccd["cfg"]
    cargs, ckw = frame_inputs(hopper, tiled, cw, ccfg)
    ob, oc = cargs[1]["obody"].reshape(-1), ccfg.max_colliders_per_body
    fr = hopper.tile_ccd(*cargs, h=ckw["h"], ccd_slop=ccfg.ccd_slop)

    def omin(p):
        return hopper.owner_min([fr], ob, oc, plain=p)

    check(torch.equal(omin(False)[0], omin(True)[0]),
          "owner_min at 10k: kernel != twin")
    bounds["owner_min"] = bound((fr, ob), omin(False), ob.numel() * 2 * (oc - 1))
    times["owner_min"] = turns(omin)
    DEVICE_MS["owner_min"] = launch_ms(lambda: omin(False))
    print(f"time owner_min at {PILE_N} bodies (the compound CCD pile's final "
          f"state, {ob.numel()} rows): kernel {times['owner_min'][0]:.4f} ms "
          f"({device_str('owner_min')}), "
          f"plain twin {times['owner_min'][1]:.4f} ms, bound "
          f"{bounds['owner_min'][0]:.4f} ms ({bounds['owner_min'][1]}), "
          f"bitwise equal to the twin, on {card}")

    mw, mcfg = mccd["final"], mccd["cfg"]
    elig = parallel.frame2_elig(mw, mcfg)
    tables = parallel.frame2_tables(mw, mcfg,
                                    frames=mcfg.frames_per_broadphase,
                                    elig=elig)
    fargs, fkw = frame_call(hopper, parallel, mw, mcfg, tables)

    def call(p):
        return hopper.run_frame2(*fargs, **fkw, plain=p)

    kk, pp = call(False), call(True)
    spread = f32_spread(hopper, fargs, fkw, pp)
    errs["frame2_ccd"] = max(errs["frame2_ccd"],
                             agree("frame2_ccd", kk, pp, spread))
    entries = int(tables[1].sum())
    bounds["frame2_ccd"] = bound(
        (fargs, fkw), kk, entries * (MANIFOLD_FLOPS + mcfg.substeps
                                     * mcfg.iterations
                                     * (PROJECT_FLOPS + VELOCITY_FLOPS
                                        + CCD_FLOPS)))
    del kk, pp
    times["frame2_ccd"] = turns(call)
    print(f"time frame2_ccd at {W_MAIN}x{N_BODIES} (every dynamic body a "
          f"bullet): kernel {times['frame2_ccd'][0]:.4f} ms, plain twin "
          f"{times['frame2_ccd'][1]:.4f} ms, bound "
          f"{bounds['frame2_ccd'][0]:.4f} ms ({bounds['frame2_ccd'][1]}), max "
          f"abs err {errs['frame2_ccd']:.3g}, on {card}")
    return times


def escorted_batch(dev, escorts, worlds, speed=1000.0):
    """tests/test_ccd.py's ``_bullet_batch`` with ``escorts`` static circles
    0.02 m from the bullet, behind and beside it
    (tests/test_torch_frame2_compact.py): their slots rank before the
    wall's, so a row that solves ``escorts`` slots drops the wall from its
    solve. Returns ``(worlds, cfg)``: C = 8, ``Cs = escorts``, CCD."""
    import math

    from starframe_tpu_torch import (
        Capacity,
        Shape,
        SolverConfig,
        WorldBuilder,
        parallel,
    )

    wb = WorldBuilder()
    wb.gravity = (0.0, 0.0)
    wall = wb.add_body(pos=(0.0, 0.0), body_type="static")
    wb.add_collider(wall, Shape.box(0.1, 2.0))
    b = wb.add_body(pos=(-3.0, 0.0), vel=(speed, 0.0), bullet=True)
    wb.add_collider(b, Shape.circle(0.05))
    for k in range(escorts):
        th = math.pi / 2 + math.pi * k / max(escorts - 1, 1)
        e = wb.add_body(pos=(-3.0 + 0.12 * math.cos(th), 0.12 * math.sin(th)),
                        body_type="static")
        wb.add_collider(e, Shape.circle(0.05))
    for i in range(126 - escorts):
        pad = wb.add_body(pos=(1000.0 + 10.0 * i, 0.0))
        wb.add_collider(pad, Shape.circle(0.3))
    w, _ = wb.build(Capacity(max_bodies=128, max_colliders=128, max_pairs=512,
                             max_joints=0, max_verts=4), device=dev)
    cfg = SolverConfig(dt=1 / 60, substeps=10, ccd=True, slot_capacity=8,
                       batch_solve_capacity=escorts)
    return parallel.replicate_world(w, worlds), cfg


def run_batched_compact(dev, hopper, parallel, card, ccd=False) -> dict:
    """``batched_compact`` (with ``ccd``: ``batched_compact_ccd``, every
    dynamic body a bullet): the main path with ``batch_solve_capacity`` 4 of
    C = 8 (the next of ``COMPACT_WIDTHS`` while one drops an imminent slot,
    which the phase's search says), 60 frames in turns with compaction off
    at the same C (off, on, on, off), checked as the main path is,
    ``solve_overflow`` 0 and ``solve_dropped`` reported, K4's ``Cs`` form
    once a frame, the two timed runs and a 10-frame rerun bitwise equal."""
    import torch

    tag = "batched_compact_ccd" if ccd else "batched_compact"
    name = "compact_ccd" if ccd else "compact"
    w, on_cfg, _ = k4_phase(name, dev)  # the width search warms up
    cfgs = {True: on_cfg, False: k4_phase(name + "_off", dev)[1]}
    C, Cs = on_cfg.slot_capacity, on_cfg.batch_solve_capacity
    active = int(((w.bodies.flags & 1) != 0).sum())

    def rollout(on, n):
        return parallel.batched_rollout(w, cfgs[on], 0, n,
                                        record=lambda _: None)

    rollout(False, 10)
    counter = "ccd_launches" if ccd else "launches"
    runs = {False: [], True: []}
    for on in (False, True, True, False):
        torch.cuda.synchronize()
        reset_counts(hopper)
        hopper.run_frame2.launches = 0
        t0 = time.perf_counter()
        final, _, diag = rollout(on, FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_form = getattr(hopper.run_frame2, counter)
        n_cs = hopper.run_frame2.compact_launches
        check(n_form == FRAMES and n_cs == (FRAMES if on else 0),
              f"{tag} Cs={on}: K4 launches {n_form}, Cs form {n_cs}")
        runs[on].append((final, {k: int(v) for k, v in diag.items()},
                         seconds, n_cs))
    final, diag, _, launches = runs[True][0]
    record_phase(name, w, cfgs[True], FRAMES, final)
    record_phase(name + "_off", w, cfgs[False], FRAMES, runs[False][0][0])
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(final.bodies, field),
                          getattr(runs[True][1][0].bodies, field)),
              f"{tag}: the two timed runs differ in {field}")
        check(bool(torch.isfinite(getattr(final.bodies, field)).all()),
              f"{tag}: non-finite {field}")
    for key in ("slot_overflow", "joint_overflow", "solve_overflow",
                "owner_overflow"):
        check(diag[key] == 0, f"{tag}: {key} {diag[key]}")
    b = final.bodies
    y_min = float(b.pos[..., 1][b.inv_mass > 0].min())
    check(y_min > 0.2, f"{tag}: a body sank (y = {y_min})")
    a, _, da = rollout(True, 10)
    c, _, dc = rollout(True, 10)
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(a.bodies, field), getattr(c.bodies, field)),
              f"{tag}: rerun differs in {field}")
    check({k: int(v) for k, v in da.items()}
          == {k: int(v) for k, v in dc.items()}, f"{tag}: rerun counters")
    ms = {on: 1e3 * sum(r[2] for r in runs[on]) / (2 * FRAMES) for on in runs}
    moved = float((final.bodies.pos - runs[False][0][0].bodies.pos).abs().max())
    print(f"{tag}: {W_MAIN}x{N_BODIES} worlds, {SUBSTEPS} substeps, "
          f"{'every dynamic body a bullet, ' if ccd else ''}{Cs} solve slots "
          f"of {C}, {FRAMES} frames: {ms[True]:.4f} ms/frame "
          f"({active / ms[True] * 1e3:.6g} body-steps/s) against "
          f"{ms[False]:.4f} without compaction, in turns (off, on, on, off: "
          + ", ".join(f"{1e3 * r[2] / FRAMES:.4f}" for r in (
              runs[False][0], runs[True][0], runs[True][1], runs[False][1]))
          + f" ms/frame); counters {json.dumps(diag)}; min dynamic y "
          f"{y_min:.4f}; largest pose difference from the run without "
          f"{moved:.4g} m; K4's Cs form {launches} launches; a 10-frame rerun "
          f"bitwise equal; on {card}")
    return dict(final=final, cfg=cfgs[True], ms=ms[True], ms_off=ms[False],
                launches=launches)


def run_compact_projectile(dev, hopper, parallel, card) -> dict:
    """The projectile batch with compaction below each bullet row's
    candidate count: ``escorted_batch`` at 4096 worlds, 4 escorts and 4
    solve slots, 1000 m/s, 30 frames. The wall's slot is dropped from the
    solve in the impact frame (``solve_dropped``); the time of impact still
    takes it (over all C slots), so every bullet rests on the wall's near
    face, as PERF.md §2's CCD bound requires."""
    import torch

    bw, cfg, _ = k4_phase("escorted", dev)
    torch.cuda.synchronize()
    reset_counts(hopper)
    t0 = time.perf_counter()
    final, _, diag = parallel.batched_rollout(bw, cfg, 0, PROJECTILE_FRAMES,
                                              record=lambda _: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diag = {k: int(v) for k, v in diag.items()}
    n_cs = hopper.run_frame2.compact_launches
    check(n_cs == PROJECTILE_FRAMES
          and hopper.run_frame2.ccd_launches == PROJECTILE_FRAMES,
          f"escorted projectile: K4's Cs CCD form launched {n_cs} times")
    record_phase("escorted", bw, cfg, PROJECTILE_FRAMES, final)
    for key in ("slot_overflow", "solve_overflow"):
        check(diag[key] == 0, f"escorted projectile: {key} {diag[key]}")
    check(diag["solve_dropped"] >= PROJECTILE_W, "escorted projectile: the "
          f"wall was not dropped from the solve ({diag['solve_dropped']})")
    x = final.bodies.pos[:, 1, 0]
    ok = (x > WALL_FACE - 0.06) & (x <= WALL_FACE + 0.01)
    check(bool(ok.all()), f"escorted projectile: {int((~ok).sum())} of "
          f"{PROJECTILE_W} bullets off the face (x in [{float(x.min())}, "
          f"{float(x.max())}])")
    ms = 1e3 * seconds / PROJECTILE_FRAMES
    print(f"escorted projectile batch ({PROJECTILE_W} worlds x 128 bodies, 4 "
          f"escorts, Cs = 4 of 8, 1000 m/s, {PROJECTILE_FRAMES} frames): "
          f"{ms:.4f} ms/frame; bullet x in [{float(x.min()):.6g}, "
          f"{float(x.max()):.6g}]; counters {json.dumps(diag)}; on {card}")
    return dict(ms=ms)


def scene_world(dev, compound, n=128):
    """tests/test_frame2.py's ``_scene`` (seed 0) or, with ``compound``, its
    ``_compound_scene`` (seed 3: every 4th dynamic body owns three
    colliders), through the port's builder."""
    import numpy as np
    from starframe_tpu_torch import Capacity, Shape, WorldBuilder

    rng = np.random.default_rng(3 if compound else 0)
    b = WorldBuilder(gravity=(0.0, -9.81))
    g = b.add_static(pos=(0.0, -0.5))
    b.add_collider(g, Shape.box(40.0, 0.5), friction=0.5)
    cols = 12 if compound else int(np.ceil(np.sqrt((n - 1) * 2)))
    n_col = n_bod = 1
    i = 0
    while n_bod < n:
        many = compound and i % 4 == 0
        if n_col + (3 if many else 1) > n:
            break
        row, col = divmod(i, cols)
        body = b.add_body(pos=(-(cols - 1) * 0.55 + col * 1.1
                               + rng.uniform(-0.05, 0.05), 0.7 + row * 1.1),
                          vel=rng.normal(scale=0.3, size=2),
                          ang_vel=float(rng.normal(scale=0.2)))
        if many:
            b.add_collider(body, Shape.box(0.3, 0.12), friction=0.5,
                           restitution=0.2)
            b.add_collider(body, Shape.box(0.12, 0.3), friction=0.5,
                           restitution=0.2, offset=(0.18, 0.2))
            b.add_collider(body, Shape.circle(0.14), friction=0.5,
                           restitution=0.2, offset=(-0.25, 0.0))
        elif compound:
            b.add_collider(body, Shape.circle(0.4) if i % 2 else
                           Shape.box(0.35, 0.3), friction=0.5,
                           restitution=0.2)
        else:
            b.add_collider(body, Shape.circle(0.45) if i % 2 == 0 else
                           Shape.box(0.4, 0.35), friction=0.5,
                           restitution=0.2)
        n_col += 3 if many else 1
        n_bod += 1
        i += 1
    w, _ = b.build(Capacity(max_bodies=n, max_colliders=n, max_pairs=8 * n,
                            max_joints=0, max_verts=4), device=dev)
    return w


def run_batched_owners(dev, hopper, parallel, card) -> dict:
    """``batched_owners``: the main path with per-world owner tables
    (``batch_uniform_topology=False``), 60 frames in turns with world 0's
    lists (uniform, per world, per world, uniform): bitwise the same state
    and counters, K4's per-world form once a frame; then a 4096-world batch
    of two alternating topologies (tests/test_frame2.py's ``_scene`` and
    ``_compound_scene``, 128 bodies) for ``HET_FRAMES`` frames into contact,
    ``owner_overflow`` and every hard counter 0."""
    import dataclasses

    import torch

    w0, cfg, _ = k4_phase("owners", dev)
    cfgs = {False: dataclasses.replace(cfg, batch_uniform_topology=True),
            True: cfg}

    def rollout(per_world, n):
        return parallel.batched_rollout(w0, cfgs[per_world], 0, n,
                                        record=lambda _: None)

    for pw in (False, True):
        rollout(pw, 10)
    runs = {False: [], True: []}
    for pw in (False, True, True, False):
        torch.cuda.synchronize()
        reset_counts(hopper)
        hopper.run_frame2.launches = 0
        t0 = time.perf_counter()
        final, _, diag = rollout(pw, FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_ow = hopper.run_frame2.owner_launches
        check(hopper.run_frame2.launches == FRAMES
              and n_ow == (FRAMES if pw else 0),
              f"batched_owners per_world={pw}: per-world form {n_ow}")
        runs[pw].append((final, {k: int(v) for k, v in diag.items()},
                         seconds, n_ow))
    uni, per = runs[False][0], runs[True][0]
    record_phase("owners", w0, cfgs[True], FRAMES, per[0])
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(uni[0].bodies, field),
                          getattr(per[0].bodies, field)),
              f"batched_owners: per-world tables differ in {field}")
    check(uni[1] == per[1], f"batched_owners: counters {uni[1]} {per[1]}")
    ms = {pw: 1e3 * sum(r[2] for r in runs[pw]) / (2 * FRAMES) for pw in runs}

    hw, hcfg, _ = k4_phase("owners_alternating", dev)
    parallel.batched_rollout(hw, hcfg, 0, 2, record=lambda _: None)
    torch.cuda.synchronize()
    reset_counts(hopper)
    t0 = time.perf_counter()
    hfinal, _, hdiag = parallel.batched_rollout(hw, hcfg, 0, HET_FRAMES,
                                                record=lambda _: None)
    torch.cuda.synchronize()
    hms = 1e3 * (time.perf_counter() - t0) / HET_FRAMES
    hdiag = {k: int(v) for k, v in hdiag.items()}
    record_phase("owners_alternating", hw, hcfg, HET_FRAMES, hfinal)
    check(hopper.run_frame2.owner_launches == HET_FRAMES,
          "alternating topologies: per-world form launches "
          f"{hopper.run_frame2.owner_launches}")
    for key in ("slot_overflow", "owner_overflow", "joint_overflow"):
        check(hdiag[key] == 0, f"alternating topologies: {key} {hdiag[key]}")
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(bool(torch.isfinite(getattr(hfinal.bodies, field)).all()),
              f"alternating topologies: non-finite {field}")
    print(f"batched_owners: {W_MAIN}x{N_BODIES} worlds, per-world owner "
          f"tables, {FRAMES} frames: {ms[True]:.4f} ms/frame against "
          f"{ms[False]:.4f} with world 0's lists, in turns (uniform, per "
          f"world, per world, uniform: " + ", ".join(
              f"{1e3 * r[2] / FRAMES:.4f}" for r in (
                  runs[False][0], runs[True][0], runs[True][1],
                  runs[False][1]))
          + f" ms/frame), bitwise the same state and counters; the "
          f"alternating batch ({W_MAIN} worlds of 128 bodies, 1 and 3 "
          f"colliders a body, {HET_FRAMES} frames): {hms:.4f} ms/frame, "
          f"counters {json.dumps(hdiag)}; on {card}")
    return dict(final=hfinal, cfg=hcfg, launches=per[3], ms=ms[True],
                ms_off=ms[False])


def run_batched_sleep(dev, hopper, parallel, card) -> dict:
    """``batched_sleep``: the main path with the pile's sleep
    (``SLEEP_VELOCITY``, ``SLEEP_FRAMES``) for ``SLEEP_RUN`` frames, timed
    in turns with the run without sleep (off, on, on, off; the second run
    with sleep holds every body asleep before and after a frame bitwise
    where it was, and is bitwise the first), hard counters 0, K4 once a
    frame; reports the asleep share."""
    import dataclasses

    import torch
    from starframe_tpu_torch import SolverConfig

    w0, cfg, _ = k4_phase("sleep", dev)
    cfgs = {False: dataclasses.replace(
        cfg, sleep_velocity=SolverConfig.sleep_velocity,
        sleep_frames=SolverConfig.sleep_frames), True: cfg}
    moved = []
    prev = [w0]

    def frozen(w):
        # bodies asleep before and after the frame (not woken): unmoved
        p = prev[0]
        keep = (parallel._asleep(p.bodies, cfgs[True])
                & parallel._asleep(w.bodies, cfgs[True]))
        move = ((w.bodies.pos != p.bodies.pos).any(dim=-1)
                | (w.bodies.angle != p.bodies.angle))
        moved.append((keep & move).sum())
        prev[0] = w
        return None

    def rollout(on, n, record=lambda _: None):
        return parallel.batched_rollout(w0, cfgs[on], 0, n, record=record)

    for on in (False, True):
        rollout(on, 10)
    runs = {False: [], True: []}
    for k, on in enumerate((False, True, True, False)):
        torch.cuda.synchronize()
        hopper.run_frame2.launches = 0
        t0 = time.perf_counter()
        final, _, diag = rollout(on, SLEEP_RUN,
                                 frozen if k == 2 else (lambda _: None))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(hopper.run_frame2.launches == SLEEP_RUN,
              f"batched_sleep: K4 launched {hopper.run_frame2.launches} times")
        runs[on].append((final, {k: int(v) for k, v in diag.items()},
                         seconds))
    final, diag, _ = runs[True][0]
    record_phase("sleep", w0, cfgs[True], SLEEP_RUN, final)
    for field in ("pos", "angle", "vel", "ang_vel", "sleep_count"):
        check(torch.equal(getattr(final.bodies, field),
                          getattr(runs[True][1][0].bodies, field)),
              f"batched_sleep: the rerun differs in {field}")
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(bool(torch.isfinite(getattr(final.bodies, field)).all()),
              f"batched_sleep: non-finite {field}")
    for key in ("slot_overflow", "joint_overflow"):
        check(diag[key] == 0, f"batched_sleep: {key} {diag[key]}")
    n_moved = int(torch.stack(moved).sum())
    check(n_moved == 0, f"batched_sleep: {n_moved} asleep body-frames moved")
    b = final.bodies
    dyn = b.inv_mass > 0
    share = float(parallel._asleep(b, cfgs[True]).sum() / dyn.sum())
    check(share > 0, "batched_sleep: nothing fell asleep")
    y_min = float(b.pos[..., 1][dyn].min())
    check(y_min > 0.2, f"batched_sleep: a body sank (y = {y_min})")
    ms = {on: 1e3 * sum(r[2] for r in runs[on]) / (2 * SLEEP_RUN)
          for on in runs}
    print(f"batched_sleep: {W_MAIN}x{N_BODIES} worlds, sleep velocity "
          f"{SLEEP_VELOCITY} for {SLEEP_FRAMES} frames, {SLEEP_RUN} frames: "
          f"{ms[True]:.4f} ms/frame against {ms[False]:.4f} without sleep, in "
          f"turns (off, on, on, off: " + ", ".join(
              f"{1e3 * r[2] / SLEEP_RUN:.4f}" for r in (
                  runs[False][0], runs[True][0], runs[True][1],
                  runs[False][1]))
          + f" ms/frame); {100 * share:.2f}% of the dynamic bodies asleep at "
          f"frame {SLEEP_RUN}; no asleep body moved; the rerun bitwise equal; "
          f"counters {json.dumps(diag)}; min dynamic y {y_min:.4f}; on {card}")
    return dict(ms=ms[True], ms_off=ms[False], share=share)


def run_batched_events(dev, hopper, parallel, card) -> dict:
    """``batched_events``: ``batched_rollout(with_keys=True)`` on the main
    path for 60 frames in turns with the same rollout without keys
    (bitwise the same state, every key -1 or a pair a < b < M); then 10
    frames at K = 1 with keys against a loop of ``batched_step_events``:
    the keys equal frame by frame."""
    import dataclasses

    import torch

    w0, cfg, _ = k4_phase("events", dev)
    M = w0.colliders.m

    def rollout(keys, n, c=cfg):
        return parallel.batched_rollout(w0, c, 0, n, record=lambda _: None,
                                        with_keys=keys)

    for keys in (False, True):
        rollout(keys, 10)
    runs = {False: [], True: []}
    for keys in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, traj, diag = rollout(keys, FRAMES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n_touch = 0
        if keys:
            k = traj[1]
            check(tuple(k.shape) == (FRAMES, W_MAIN, cfg.slot_capacity, M),
                  f"batched_events: keys shape {tuple(k.shape)}")
            live = k[k >= 0]
            n_touch = int(live.numel())
            check(n_touch > 0 and bool(((live // M) < (live % M)).all()),
                  "batched_events: a key is not a pair a < b < M")
            table_mb = k[0].numel() * k.element_size() / 1e6
            if "events" not in DIGESTS:
                record_phase("events", w0, cfg, FRAMES, final, keys=k)
            del traj, k, live
        runs[keys].append((final, {k: int(v) for k, v in diag.items()},
                           seconds, n_touch))
    a, b = runs[False][0], runs[True][0]
    for field in ("pos", "angle", "vel", "ang_vel"):
        check(torch.equal(getattr(a[0].bodies, field),
                          getattr(b[0].bodies, field)),
              f"batched_events: keys change {field}")
    check(a[1] == b[1], "batched_events: keys change the counters")
    c1 = dataclasses.replace(cfg, frames_per_broadphase=1)
    _, (_, keys), _ = rollout(True, 10, c1)
    w = w0
    for f in range(10):
        w, kf, _ = parallel.batched_step_events(w, c1)
        check(torch.equal(keys[f], kf),
              f"batched_events: frame {f} keys differ from batched_step_events")
    ms = {k: 1e3 * sum(r[2] for r in runs[k]) / (2 * FRAMES) for k in runs}
    print(f"batched_events: {W_MAIN}x{N_BODIES} worlds, with_keys=True, "
          f"{FRAMES} frames: {ms[True]:.4f} ms/frame against {ms[False]:.4f} "
          f"without keys, in turns (off, on, on, off: " + ", ".join(
              f"{1e3 * r[2] / FRAMES:.4f}" for r in (
                  runs[False][0], runs[True][0], runs[True][1],
                  runs[False][1]))
          + f" ms/frame), bitwise the same state; a key table is "
          f"{table_mb:.1f} MB a frame ({FRAMES * table_mb / 1e3:.2f} GB over "
          f"the run), {b[3]} touching slot-keys over it; 10 frames at K = 1 "
          f"equal to batched_step_events; on {card}")
    return dict(ms=ms[True], ms_off=ms[False], table_mb=table_mb)


def a1_turns(hopper, parallel, phases, errs, bounds, card) -> dict:
    """K4's ``Cs`` form (with and without CCD) and its per-world form at
    4096 worlds against their twins, from each phase's final state, timed
    in turns, with their bounds: ``touched`` equal, poses and velocities as
    ``agree_worlds`` holds the joint form, ``partner_solve`` and ``nact``
    equal."""
    import torch

    times = {}
    for name, ph in phases.items():
        w, cfg = ph["final"], ph["cfg"]
        elig = parallel.frame2_elig(w, cfg)
        tables = parallel.frame2_tables(w, cfg,
                                        frames=cfg.frames_per_broadphase,
                                        elig=elig)
        fargs, fkw = frame_call(hopper, parallel, w, cfg, tables)
        Cs = parallel._batch_solve_cap(cfg)

        def call(p):
            return hopper.run_frame2(*fargs, **fkw, plain=p)

        k, p = call(False), call(True)
        errs[name] = agree_worlds(name, k, p)
        C, W, M = cfg.slot_capacity, w.bodies.pos.shape[0], w.colliders.m
        entries = int(tables[1].sum())
        solved = entries
        if Cs:
            check(torch.equal(k[7], p[7]), f"{name}: partner_solve differs")
            check(torch.equal(k[8], p[8]), f"{name}: nact differs")
            solved = int(torch.clamp(k[8][:, 1], max=Cs).sum())
        steps = cfg.substeps * cfg.iterations
        flops = (entries * MANIFOLD_FLOPS
                 + solved * steps * (PROJECT_FLOPS + VELOCITY_FLOPS)
                 + (entries * cfg.substeps * CCD_FLOPS if cfg.ccd else 0)
                 + (W * M * C * C if Cs else 0))
        bounds[name] = bound((fargs, fkw), k, flops)
        del k, p
        times[name] = turns(call)
        print(f"time {name} at {W}x{w.bodies.n} ({entries} table entries, "
              f"{solved} solved): kernel {times[name][0]:.4f} ms, plain twin "
              f"{times[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}), max abs err {errs[name]:.3g}, on {card}")
    return times


def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2

    from starframe_tpu_torch import hopper, parallel, tiled
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
    for line in _build.build_log().splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print("ptxas:", line.strip())
    # K4's instances: ptxas's report beside the shared memory and resident
    # blocks an SM at the shapes of the phases that run each (the main
    # path; the mechanism and rope batches, and for V = 8 the walker's; the
    # V = 8 test scene for V = 8), each with the rows that may hold a slot
    # and with every row flagged, the ranked instances at those whose
    # table is ranked (the walker's, the jointed batches', a static floor
    # of 32 dynamic bodies in 256), the others at the rest
    k4 = ptxas_k4(_build.build_log())
    lib = _build.library()
    for inst, (regs, stack, st_, ld) in sorted(k4.items()):
        V, kJ, kCcd, ranked = inst.strip("<>").split(",")
        walker = ((WALKER_SHAPE,) if V == "8" else ())
        shapes = (((128, 128, 10, 12, 18), (128, 128, 50, 8, 47)) + walker
                  if kJ == "true"
                  else ((N_BODIES, N_BODIES, 0, 8, N_BODIES - 3),
                        (N_BODIES, N_BODIES, 0, 8, 32))
                  if V == "4" else ((128, 128, 0, 8, 16),))
        shapes = [(*sh[:4], rs) for sh in shapes for rs in (sh[4], sh[1])]
        print(f"K4 {inst}: {regs} registers, {stack} bytes stack, {st_} "
              f"bytes spill stores, {ld} bytes spill loads")
        for n, m, j, csol, rs in shapes:
            lay = hopper.frame2.frame2_layout(n, m, int(V), j, csol, rs)
            if lay.ranked != (ranked == "true"):
                continue
            smem, rows = lay.bytes, lay.R
            blocks = lib.sf_frame2_blocks_per_sm(
                int(V), j, int(kCcd == "true"), n, m, csol, rs)
            threads = lib.sf_frame2_block_threads(n, m, int(V), j, csol, rs)
            check(blocks >= 1, f"K4 {inst}: no block fits an SM")
            print(f"K4 {inst} at N = {n}, M = {m}, J = {j}, {csol} solve "
                  f"slots: {smem} bytes of shared memory, table rows {rows} "
                  f"of {lay.rows} ({rs} of {m} may hold a slot), {blocks} "
                  f"block(s) of {threads} threads an SM")
    check(len(k4) == 16, f"ptxas reported {len(k4)} K4 instances, not 16")
    ptxas_slots(_build.build_log(), lib)
    ptxas_substep(_build.build_log(), lib)

    # ---- 2. kernel vs twin ------------------------------------------------
    errs = parity(dev, hopper, parallel, batched_worlds)
    for name, err in parity_wide(dev, hopper, parallel,
                                 batched_worlds).items():
        errs[name] = max(errs[name], err)
    errs.update(parity_joints(dev, hopper, parallel))
    errs.update(parity_tiles(dev, hopper))
    cerrs = parity_compound(dev, hopper, tiled)
    errs["tile_tables"] = max(errs["tile_tables"], cerrs.pop("tile_tables"))
    errs.update(cerrs)
    for name, err in parity_ccd(dev, hopper, tiled, parallel).items():
        errs[name] = max(errs.get(name, 0.0), err)

    # ---- 3. the main path at full width ------------------------------------
    w0, cfg, _ = k4_phase("main", dev)
    active = int(((w0.bodies.flags & 1) != 0).sum())

    def rollout(n, plain=False):
        return parallel.batched_rollout(w0, cfg, 0, n, record=lambda _: None,
                                        plain=plain)

    rollout(FRAMES)  # warm-up
    torch.cuda.synchronize()
    wrappers = {name: getattr(hopper, attr) for name, attr, _, _ in KERNELS}
    for fn in wrappers.values():
        fn.launches = 0
    hopper.run_frame2.shared_table_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final, _, diag = rollout(FRAMES)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    shared_launches = hopper.run_frame2.shared_table_launches
    record_phase("main", w0, cfg, FRAMES, final)
    launches = {name: wrappers[name].launches for name in CONTACT_KERNELS}
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
    check(shared_launches == FRAMES, f"main path: {shared_launches} of "
          f"{FRAMES} K4 launches with the whole slot table in shared memory")
    ms_frame = 1e3 * seconds / FRAMES
    bps = active * FRAMES / seconds
    print(f"main path: {W_MAIN}x{N_BODIES} worlds, {SUBSTEPS} substeps, "
          f"{FRAMES} frames in {seconds:.4f} s = {ms_frame:.4f} ms/frame, "
          f"{bps:.6g} body-steps/s ({active} active bodies/frame) on {card}")
    print(f"main path counters: {json.dumps(diag)}; launches "
          f"{json.dumps(launches)}; min dynamic y {y_min:.4f}")
    print(f"main path: K4 slot table in shared memory on {shared_launches} "
          f"of {FRAMES} launches (run_frame2.shared_table_launches); peak "
          f"device memory {peak_gib:.3f} GiB on {card}")

    jointed = {name: run_jointed(name, dev, wrappers, parallel, card)
               for name in JOINTED}
    for name in ("walker", "walker_owners"):
        run_walker(dev, hopper, parallel, card, name)
    launches.update(jointed["mechanism"]["launches"])
    pile = run_pile(dev, hopper, tiled, card)
    launches.update(pile["launches"])
    sleep = run_pile_sleep(dev, hopper, tiled, card)
    launches["tile_frame"] = sleep["launches"]["tile_frame"]
    events = run_pile_events(dev, hopper, tiled, pile, card)
    launches["tile_manifold_keys"] = events["launches"]["tile_manifold_keys"]
    compound = run_pile_compound(dev, hopper, tiled, card)
    launches["tile_frame_compound"] = compound["launches"][
        "tile_frame_compound"]
    # the per-substep compound kernels, from the compound pile's fuse=False
    # chunk (the compound frame's reference)
    for name in ("tile_apply_compound", "owner_sum", "owner_velocity"):
        launches[name] = compound["ulaunches"][name]
    # CCD: the projectile batch, the main path and the piles with bullets
    projectile = run_projectile(dev, hopper, parallel, card)
    mccd = run_main_ccd(dev, hopper, parallel, card)
    pccd = run_pile_ccd(dev, hopper, tiled, card)
    cccd = run_compound_ccd(dev, hopper, tiled, card)
    for name in ("tile_ccd", "tile_project_ccd", "tile_apply_ccd"):
        launches[name] = pccd["launches"][name]
    launches["tile_frame_ccd"] = pccd["flaunches"]["tile_frame_ccd"]
    launches["owner_min"] = cccd["ulaunches"]["owner_min"]
    launches["tile_frame_compound_ccd"] = cccd["launches"][
        "tile_frame_compound_ccd"]
    launches["frame2_ccd"] = mccd["launches"]
    # K4's last branches: compaction (with CCD too), per-world owner
    # tables, sleep and the contact keys on the main path
    a1 = {"frame2_compact": run_batched_compact(dev, hopper, parallel, card)}
    a1["frame2_compact_ccd"] = run_batched_compact(dev, hopper, parallel,
                                                   card, ccd=True)
    eproj = run_compact_projectile(dev, hopper, parallel, card)
    a1["frame2_owners"] = run_batched_owners(dev, hopper, parallel, card)
    bsleep = run_batched_sleep(dev, hopper, parallel, card)
    bevents = run_batched_events(dev, hopper, parallel, card)
    for name in a1:
        launches[name] = a1[name]["launches"]

    # ---- 4. kernel vs twin, and their times, at the main path's shapes ---
    eargs, sargs, skw = slot_call_args(parallel, final, cfg)
    elig = hopper.build_elig_mask(*eargs)
    *tables, budget = hopper.build_slot_tables(*sargs, elig, **skw)
    skips = chunk_skips(sargs, skw, elig, budget)
    W, M = eargs[0].shape
    for phase, sk in skips.items():
        print(f"K2 chunk culling at the main path's final state, phase "
              f"{phase}: {100 * sk['row']:.2f}% of (row, 32-partner chunk) "
              f"pairs skipped, {100 * sk['warp']:.2f}% of the kernel's (pair "
              f"of rows, chunk) visits; {sk['pairs']} eligible pairs left to "
              f"test, {100 * sk['pairs'] / int(elig.sum()):.2f}% of all")
    sargs += (elig,)
    fargs, fkw = frame_call(hopper, parallel, final, cfg, tables)
    calls = {
        "elig": (lambda p: hopper.build_elig_mask(*eargs, plain=p)),
        "slots": (lambda p: hopper.build_slot_tables(*sargs, **skw, plain=p)),
        "frame2": (lambda p: hopper.run_frame2(*fargs, **fkw, plain=p)),
    }
    entries = int(tables[1].sum())
    work = {  # (inputs, operations) of each call, for its bound
        "elig": (eargs, W * M * M * 8),
        # K2: an operation a mask byte, a union test a (row, chunk) and the
        # pair tests its culling leaves, in each phase
        "slots": (sargs, W * M * M + sum(
            W * M * -(-M // 32) * UNION_FLOPS + sk["pairs"] * PAIR_FLOPS
            for sk in skips.values())),
        "frame2": ((fargs, fkw), entries * (MANIFOLD_FLOPS + cfg.substeps
                                            * cfg.iterations
                                            * (PROJECT_FLOPS
                                               + VELOCITY_FLOPS))),
    }
    times, bounds = {}, {}
    for name, call in calls.items():
        k, p = call(False), call(True)
        spread = f32_spread(hopper, fargs, fkw, p) if name == "frame2" else None
        err = agree(name, k, p, spread)
        bounds[name] = bound(work[name][0], k, work[name][1])
        terms = bound_terms(work[name][0], k, work[name][1])
        del k, p
        errs[name] = max(errs[name], err)
        print(f"parity {name} at {W_MAIN}x{N_BODIES}: agrees, max abs err "
              f"{err:.3g}")
        times[name] = turns(call)
        print(f"time {name} at {W_MAIN}x{N_BODIES}: kernel "
              f"{times[name][0]:.4f} ms, plain twin {times[name][1]:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}; bytes "
              f"{terms[0]:.4f} ms, operations {terms[1]:.4f} ms) on {card}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout(TWIN_FRAMES, plain=True)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0) / TWIN_FRAMES
    print(f"main path through the plain twins: {twin_ms:.4f} ms/frame over "
          f"{TWIN_FRAMES} frames, vs {ms_frame:.4f} ms/frame through the "
          f"kernels, on {card}")

    # the jointed kernels at 1024 worlds, from each jointed run's final state
    times.update(jointed_turns(hopper, parallel, jointed, errs, bounds,
                               card))

    # the tile kernels at the pile's full size, from its final state; K10
    # on the sleeping pile's states
    times.update(pile_turns(hopper, pile, errs, bounds, card))
    times["tile_frame"] = frame_turns(hopper, tiled, sleep, errs, bounds,
                                      card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled.tiled_rollout(pile["sc"].world, pile["cfg"], PILE_TWIN_FRAMES,
                        plain=True)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0) / PILE_TWIN_FRAMES
    print(f"pile path through the plain twins: {twin_ms:.4f} ms/frame over "
          f"{PILE_TWIN_FRAMES} frames, vs {pile['ms']:.4f} ms/frame through "
          f"the kernels, on {card}")

    # the events and compound kernels at 10k bodies; the compound pile
    # through its twins
    times.update(ec_turns(hopper, tiled, events, compound, errs, bounds,
                          card))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled.tiled_rollout(compound["sc"].world, compound["cfg"],
                        PILE_TWIN_FRAMES, plain=True)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.perf_counter() - t0) / PILE_TWIN_FRAMES
    print(f"compound pile through the plain twins: {twin_ms:.4f} ms/frame "
          f"over {PILE_TWIN_FRAMES} frames from the start, vs "
          f"{compound['ms']:.4f} ms/frame through the kernels (best chunk), "
          f"on {card}")
    frames = PILE_CHUNKS * PILE_FRAMES
    print("launches a frame: pile_events K6 with keys "
          f"{events['launches']['tile_manifold_keys'] / PILE_FRAMES:.4f}, "
          f"K10 {events['launches']['tile_frame'] / PILE_FRAMES:.4f}; "
          "pile_compound "
          + ", ".join(f"{n} {compound['launches'][n] / frames:.4f}"
                      for n in ("tile_manifold", "tile_frame_compound",
                                "tile_project", "tile_apply_compound",
                                "owner_sum", "owner_velocity", "tile_frame")))

    # the CCD kernels at full size
    times.update(ccd_turns(hopper, tiled, parallel, pccd, cccd, mccd, errs,
                           bounds, card))
    print("ccd launches a frame: pile_ccd unfused K7 "
          f"{pccd['launches']['tile_ccd'] / PILE_FRAMES:.4f}, K8 "
          f"{pccd['launches']['tile_project_ccd'] / PILE_FRAMES:.4f}, K9 "
          f"{pccd['launches']['tile_apply_ccd'] / PILE_FRAMES:.4f}; fused "
          f"K10 {pccd['flaunches']['tile_frame_ccd'] / PILE_FRAMES:.4f}, K7 "
          f"{pccd['flaunches']['tile_ccd'] / PILE_FRAMES:.4f}; compound "
          f"frame CCD {cccd['launches']['tile_frame_compound_ccd'] / 60:.4f}"
          f" (fuse=False: owner_min "
          f"{cccd['ulaunches']['owner_min'] / 60:.4f}); main path K4 "
          f"CCD {mccd['launches'] / FRAMES:.4f}; projectile ms/frame "
          f"{json.dumps(projectile)}")

    # K4's Cs and per-world forms at full size
    times.update(a1_turns(hopper, parallel, a1, errs, bounds, card))
    print("a1 launches a frame: " + ", ".join(
        f"{n} {a1[n]['launches'] / FRAMES:.4f}" for n in a1)
        + f"; ms/frame: compacted {a1['frame2_compact']['ms']:.4f} (off "
        f"{a1['frame2_compact']['ms_off']:.4f}), compacted with CCD "
        f"{a1['frame2_compact_ccd']['ms']:.4f} (off "
        f"{a1['frame2_compact_ccd']['ms_off']:.4f}), per-world owners "
        f"{a1['frame2_owners']['ms']:.4f} (uniform "
        f"{a1['frame2_owners']['ms_off']:.4f}), sleep {bsleep['ms']:.4f} (off "
        f"{bsleep['ms_off']:.4f}, {100 * bsleep['share']:.2f}% asleep), keys "
        f"{bevents['ms']:.4f} (off {bevents['ms_off']:.4f}), escorted "
        f"projectile {eproj['ms']:.4f}")

    # ---- 5. determinism ----------------------------------------------------
    a, _, da = rollout(10)
    b, _, db = rollout(10)
    mw, mcfg = jointed["mechanism"]["world"], jointed["mechanism"]["cfg"]
    ma, _, dma = parallel.batched_rollout(mw, mcfg, 0, 10,
                                          record=lambda _: None)
    mb, _, dmb = parallel.batched_rollout(mw, mcfg, 0, 10,
                                          record=lambda _: None)
    pa, dpa = tiled.tiled_rollout(pile["sc"].world, pile["cfg"], 10)
    pb, dpb = tiled.tiled_rollout(pile["sc"].world, pile["cfg"], 10)
    for run, (x, y, dx, dy) in (("main path", (a, b, da, db)),
                                ("mechanism", (ma, mb, dma, dmb)),
                                ("pile", (pa, pb, dpa, dpb))):
        for field in ("pos", "angle", "vel", "ang_vel"):
            check(torch.equal(getattr(x.bodies, field),
                              getattr(y.bodies, field)),
                  f"{run} rerun differs in {field}")
        check({k: int(v) for k, v in dx.items()}
              == {k: int(v) for k, v in dy.items()},
              f"{run} rerun counters differ")
    print("determinism: 10-frame reruns of the main path, the mechanism "
          "batch and the pile bitwise equal (and the sleeping pile's last "
          "chunk, above)")

    # ---- 6. the slot table's placement and the K4 phases' digests --------
    split = digests_tool().SPLIT
    for name, (r, m) in TABLE_ROWS.items():
        check((r < m) if name in split else (r == m), f"{name}: K4 kept {r} "
              f"of its table's {m} rows' slot records in shared memory")
    check(sorted(DIGESTS) == sorted(digests_tool().PHASES),
          f"digests of {sorted(DIGESTS)}")
    print("K4 table rows in shared memory (R / the table's rows) on each "
          "phase: "
          + ", ".join(f"{n} {r}/{m}" for n, (r, m) in TABLE_ROWS.items())
          + f" (all M but {', '.join(split)}, the uncompacted tables "
          "batched_compact times its own against)")
    print("frame2 digests: " + json.dumps(DIGESTS))

    print("device ms (the one launch replayed, struct built once): "
          + json.dumps(DEVICE_MS))
    # no single PyTorch call computes any of these kernels: library_ms null
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    ec = tuple((n, a, src, tpu)
               for n, a, _, src, tpu in EC_KERNELS + CCD_KERNELS)
    ec += tuple((n, "run_frame2", "starframe_tpu_torch/csrc/frame2.cuh", tpu)
                for n, _, tpu in A1_KERNELS)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, _, src, tpu in KERNELS + TILE_KERNELS + ec]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
