"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch twins."""

from .frame2 import frame2_plain, owner_csr, run_frame2
from .slots import (
    build_elig_mask,
    build_joint_slots,
    build_slot_tables,
    elig_mask_plain,
    joint_slots_plain,
    slot_tables_plain,
)

__all__ = ["build_elig_mask", "build_joint_slots", "build_slot_tables",
           "elig_mask_plain", "frame2_plain", "joint_slots_plain",
           "owner_csr", "run_frame2", "slot_tables_plain"]
