"""Static configuration: solver parameters and fixed world capacities.

A copy of ``starframe_tpu/config.py`` with the same fields and defaults, so
one configuration drives both packages. Equivalent of starframe's plain
params structs (``PhysicsParams``-style defaults — SURVEY.md §5.6 [K-med]).
Both dataclasses are frozen and hashable; array shapes are derived from
:class:`Capacity` at world-build time and never change afterwards (the
fixed-capacity design mandated by BASELINE.json:5). Fields that only the
JAX package's other tiers read (grid broadphase, tile engine, sleep, CCD)
are kept so configurations stay interchangeable; the port
raises where it meets one it does not run yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Capacity:
    """Fixed array capacities for one world. All shapes are static under jit.

    Every buffer has an overflow counter in :class:`~starframe_tpu.diagnostics.
    Diagnostics` — silent truncation is the #1 correctness risk of the
    fixed-shape design (SURVEY.md §7.8) and tests assert the counters are 0.
    """

    max_bodies: int = 128
    max_colliders: int = 128
    max_pairs: int = 1024
    max_joints: int = 0
    max_verts: int = 8  # max vertices per convex polygon core

    def __post_init__(self):
        if self.max_verts < 2:
            raise ValueError("max_verts must be >= 2 (capsules need 2)")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """XPBD solver configuration.

    Defaults follow the bench configs of BASELINE.json: 60 Hz frames with
    10 XPBD substeps (BASELINE.json:7) per Müller et al. 2020 "small steps".
    """

    dt: float = 1.0 / 60.0
    substeps: int = 10
    # Jacobi position-solve sweeps per substep. 1 matches the small-steps
    # paper's Gauss-Seidel; Jacobi benefits slightly from 2.
    iterations: int = 1
    # Under-relaxation for Jacobi accumulation (applied on top of dividing by
    # the per-body constraint count). 1.0 = plain averaged Jacobi.
    relaxation: float = 1.0
    # Speculative contact margin: manifolds are kept while surface separation
    # < margin so contacts created at frame start stay valid as bodies move
    # during substeps. Constraints only activate at actual penetration.
    contact_margin: float = 0.05
    # Baumgarte-free XPBD compliance for contacts (0 = rigid).
    contact_compliance: float = 0.0
    # Restitution is skipped below this approach speed (prevents jitter).
    restitution_threshold: float = 0.5
    # Global damping applied in the velocity pass, per second.
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    # Max angular correction stability clamp (radians per substep-projection).
    max_dpos: float = 1e3
    # PhysX-style depenetration rate limit (m/s and rad/s): position
    # corrections are clipped to at most this * h per substep, so XPBD's
    # velocity reconstruction (v += dx/h) can never convert a deep spawn
    # overlap into a launch. Deep overlaps resolve over several substeps at
    # this speed instead. 10 m/s never binds in sane scenes (resting-stack
    # corrections reconstruct to < 1 m/s) but stops the 100+ m/s explosions
    # unclamped corrections produce.
    max_depenetration_velocity: float = 10.0
    # Broadphase: 'dense' (O(n^2) masked; best under ~512 colliders) or
    # 'grid' (sort-and-segment spatial hash; BASELINE.json:5 "sort-and-
    # segment pair generator"). 'auto' picks by collider capacity.
    broadphase: str = "auto"
    # Grid broadphase: number of colliders one cell can hold before overflow.
    # Objects whose AABB extent exceeds one cell go through the dense "large
    # set" path (2-level HGrid equivalent, SURVEY.md §7.3); that threshold is
    # fixed at 1.0 cells — it is a completeness bound of the 9-neighborhood
    # scan, not a tunable (see broadphase.grid_pairs).
    grid_cell_capacity: int = 8
    max_large: int = 64
    # Constraint accumulation lowering: 'matmul' = one-hot MXU contraction
    # (fast for small worlds, e.g. batched RL), 'scatter' = XLA scatter-add
    # (for big single worlds), 'auto' = matmul while bodies <= threshold.
    accum: str = "auto"
    matmul_accum_max_bodies: int = 1024
    # Joint position solve: 'colored' = graph-colored exact Gauss-Seidel
    # batches (colors from the native greedy coloring at build time,
    # BASELINE.json:5); 'jacobi' = one averaged pass with the contacts.
    joint_solver: str = "colored"
    # Static upper bound on color batches per substep (scenes needing more
    # still work: the solver normalizes by per-body count within a batch).
    max_joint_colors: int = 8
    # Velocity at which bodies are considered for sleeping (0 disables).
    sleep_velocity: float = 0.0
    sleep_frames: int = 30
    # Wake-on-fast-contact threshold = sleep_velocity * this factor. At 1.0
    # any not-quite-sleepable neighbor resets a sleeper's counter every
    # frame, so surface jitter in a settled pile cascades wake waves through
    # the whole contact network and half the pile never sleeps (measured:
    # the 10k pile plateaus at 54% asleep). Waking only on contacts
    # decisively faster than the sleep threshold (2x) lets mutually-resting
    # bodies run their counters out; a genuinely struck sleeper still wakes
    # (impacts carry speeds far above 2x the sleep threshold).
    wake_velocity_factor: float = 2.0
    # Whole-frame Pallas kernel (pallas/frame2.py): True/"auto" = use on TPU
    # for worlds whose shapes fit the kernel; False = never.
    use_pallas: object = "auto"
    # Manifold regeneration cadence: 'frame' = narrowphase once per frame at
    # frame-start poses with a velocity-expanded speculative margin (the
    # reference's pipeline order, SURVEY.md §3.2: broadphase -> narrowphase ->
    # substeps); 'substep' = regenerate at every substep's integrated pose
    # (TGS-style; more accurate for fast rolling contact, ~10x the manifold
    # math). The Pallas frame kernel always runs 'frame'.
    manifold_refresh: str = "frame"
    # Partner slots per dynamic collider in the slot-table broadphase
    # (pallas/slots.py). Rows with more true overlaps than this are truncated
    # and counted in the overflow diagnostic.
    slot_capacity: int = 8
    # Joint slots per body for the whole-frame kernel's joint tier (a body
    # attached to more joints than this overflows — counted, not silent).
    joint_slot_capacity: int = 4
    # The batched Pallas path assumes every world in a batch shares one
    # collider->body topology (true for replicate_world / same-built
    # scenes) and reduces collider corrections to bodies with one MXU dot
    # from world 0's topology. Set False for heterogeneous batches (e.g.
    # domain-randomized compounds): the kernel then uses PER-WORLD owner
    # tables (parallel.collider_owner_tables) — still the kernel path, at
    # a small VPU cost for the gather-sum reduction.
    batch_uniform_topology: bool = True
    # Owner-table capacity for the heterogeneous path: max colliders any
    # single body may own. A body with more overflows (HARD counter
    # `owner_overflow` — its extra colliders' corrections would drop).
    max_colliders_per_body: int = 4
    # Per-frame solve-slot compaction for the BATCHED slot kernel (the
    # frame2 twin of `tile_solve_capacity`): the substep loop runs at this
    # many rank-selected (closest-first, three-tier) slots per collider
    # instead of the full K-frame table width `slot_capacity`. <= 0
    # disables. Dropping an imminent (sep < contact_margin) candidate is
    # the HARD `solve_overflow`; dropping a merely pmask-active one is the
    # soft `solve_dropped` (zero impulse this frame, re-admitted at the
    # next frame's manifolds). Measured r5 on the 4096x256 flagship batch:
    # mean pmask-active 1.24 vs tables at 16 — 8 is exact there and cuts
    # every per-substep kernel op's width 2x.
    batch_solve_capacity: int = 0
    # Rollouts rebuild the slot-table broadphase every K-th frame (sweeps are
    # inflated to stay a valid candidate superset for K frames — solved
    # contacts are unchanged, only speculative slot pressure rises). 1 =
    # every frame. Applies to batched_rollout on the slot-kernel path.
    # A per-frame velocity guard forces an early rebuild when any body's
    # SPEED exceeds the bound the tables were built for (impulse transfer
    # from a faster body — the one way a body can escape its swept AABB).
    frames_per_broadphase: int = 1
    # Extra speed headroom (m/s) added to every dynamic body's K-frame sweep
    # bound: tolerates impulse-acquired speed up to this much without a
    # forced rebuild, at the cost of bigger swept AABBs (more speculative
    # slot pressure). Useful when settling scenes rebuild too often; 0 keeps
    # sweeps tight and rebuilds on any super-gravity speed gain.
    broadphase_speed_slack: float = 0.0
    # Multiplicative headroom on the K-frame sweep budget (partner-aware
    # slot tables). The raw budget ``max(v_own, v_partners) * K * dt`` is
    # exactly tight: in contact-rich scenes small per-bounce impulse gains
    # overrun it near the window's end and the staleness guard forces
    # rebuilds nearly every frame (measured r3: ~1/3 of a bouncing batch
    # escapes by frame K-1 at 1.0). 1.3 buys the window-long impulse tail
    # at a modest speculative-slot-pressure cost; the guard stays the exact
    # correctness backstop either way.
    broadphase_budget_headroom: float = 1.3
    # Tile-engine K-frame sweep budget shape (pallas/tiles.py build_tile_
    # tables; the single-world analogue of broadphase_budget_headroom). Each
    # body's slot tables stay valid while it moves less than
    #   min((speed + g*dt + slack) * K * dt + floor * extent, cap * extent)
    # — the FLOOR buys settled bodies headroom against impulse jitter
    # (their speeds GROW between builds, so a pure speed budget trips the
    # positional guard constantly at settle), the CAP bounds a fast faller's
    # speculative slot pressure. Any values are SOUND: the rollout's
    # positional guard forces a table rebuild the moment a body escapes its
    # budget; these only trade rebuild frequency against slot pressure.
    # Swept on the settling 10k pile (r3): floor 0.25 / cap 1.0 forced 38/50
    # rebuilds; 0.4 / 1.5 forces 18/50 at 2.43 vs 2.68 ms/frame with only
    # soft (speculative) drops and hard counters 0.
    tile_sweep_floor: float = 0.4
    tile_sweep_cap: float = 1.5
    # Tile-engine per-frame solve-slot compaction (pallas/tiles.py). The
    # slot TABLES hold ``slot_capacity`` candidates per body so they stay a
    # valid superset for K frames of speculative motion — but within ONE
    # frame, manifolds are frame-frozen, so only candidates with a manifold
    # point inside the speculative margin can contribute to ANY substep
    # (the rest are exact zeros in every projection). The manifold kernel
    # rank-selects those active candidates into this many solve slots and
    # the 10-substep project/apply loop runs at this width instead of
    # slot_capacity — measured on the settled 10k pile, live (touch+margin)
    # candidates peak at 8/row while the K-frame tables need 16. Rounded up
    # to a multiple of 8 (sublane groups) and clamped to slot_capacity;
    # <= 0 disables compaction (solve width = slot_capacity). Selection is
    # ranked by CURRENT min separation (closest first), so an overflowing
    # row drops its most-speculative active manifolds first. Dropping a
    # manifold that is merely inside the velocity-expanded margin is a
    # one-frame-staleness soft drop (``solve_dropped`` — re-admitted at the
    # next frame's manifold pass); dropping one with sep < contact_margin
    # (imminent/touching) counts into ``solve_overflow`` — a HARD counter
    # (tests and the bench assert it is 0; raise this knob if it fires).
    tile_solve_capacity: int = 8
    # Continuous collision detection for bodies flagged ``bullet=True``
    # (state.BODY_BULLET): each substep, a bullet's integrated advance is
    # clamped at its earliest time of impact against the frame's speculative
    # manifolds, so it lands on the surface (plus ``ccd_slop`` of allowed
    # penetration to activate the contact) instead of crossing thin geometry
    # in one substep. Zero cost when off (static gate); requires
    # manifold_refresh='frame' (the clamp trusts frame-start normals —
    # post-tunnel re-narrowphase would pick the far side).
    ccd: bool = False
    # Penetration depth a TOI-clamped bullet is allowed per substep: deep
    # enough that the contact constraint activates and restitution sees the
    # true approach speed, shallow enough that the depenetration rate cap
    # resolves it within a substep.
    ccd_slop: float = 0.005
    # Axis the tile engine sorts/cuts big single worlds along ('x' or 'y').
    # Pick the axis the scene is WIDE in for window locality; pick the axis
    # it SETTLES along to let whole slabs sleep (a pile settling bottom-up
    # under 'y' lets its settled bottom tiles skip all work).
    tile_sort_axis: str = "x"
    # Finer-than-tile island work saving (requires sleep_velocity > 0):
    # tiled rollouts re-sort bodies by (awake-neighborhood, sort-axis) so
    # sleeping bodies no awake body can reach cluster into trailing tiles,
    # whose whole windows go asleep and skip ALL kernel work (tile_live).
    # The keep set is exact 1-hop from the dense (pre-truncation) candidate
    # mask — every sleeper an awake body's swept AABB overlaps stays in the
    # live prefix, so contacts and wake signals are preserved — plus a 2nd
    # hop from the slot tables so a woken body's own neighbors wake cleanly.
    # The positional guard forces a full re-sort (not just a table rebuild)
    # while the layout is partitioned, keeping the window invariant sound.
    tile_awake_compaction: bool = True

    @property
    def h(self) -> float:
        """Substep length."""
        return self.dt / self.substeps

    @property
    def max_dpos_eff(self) -> float:
        """Per-substep position-correction clip: the tighter of ``max_dpos``
        and the depenetration rate limit (``max_depenetration_velocity * h``).
        All solver tiers clip with this, which bounds reconstructed velocity
        at ``max_depenetration_velocity``."""
        return min(self.max_dpos, self.max_depenetration_velocity * self.h)
