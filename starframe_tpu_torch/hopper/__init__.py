"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch twins."""

from .frame2 import (
    frame2_plain,
    owner_csr,
    owner_csr_tables,
    run_frame2,
)
from .slots import (
    build_elig_mask,
    build_joint_slots,
    build_slot_tables,
    elig_mask_plain,
    joint_slots_plain,
    slot_tables_plain,
)
from .tiles import (
    build_tile_tables,
    owner_min,
    owner_min_plain,
    owner_sum,
    owner_sum_plain,
    owner_velocity,
    owner_velocity_plain,
    run_tiled_frame,
    tile_apply,
    tile_apply_plain,
    tile_ccd,
    tile_ccd_plain,
    tile_frame,
    tile_frame_plain,
    tile_manifold,
    tile_manifold_plain,
    tile_project,
    tile_project_plain,
    tile_tables_plain,
)

__all__ = ["build_elig_mask", "build_joint_slots", "build_slot_tables",
           "build_tile_tables", "elig_mask_plain", "frame2_plain",
           "joint_slots_plain", "owner_csr", "owner_csr_tables", "owner_min", "owner_min_plain",
           "owner_sum", "owner_sum_plain", "owner_velocity",
           "owner_velocity_plain", "run_frame2", "run_tiled_frame",
           "slot_tables_plain", "tile_apply", "tile_apply_plain", "tile_ccd",
           "tile_ccd_plain", "tile_frame", "tile_frame_plain", "tile_manifold",
           "tile_manifold_plain", "tile_project", "tile_project_plain",
           "tile_tables_plain"]
