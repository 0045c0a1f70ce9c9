"""World snapshots: the bridge between the two packages.

The keys are the JAX package's pytree paths (``"bodies/pos"``,
``"colliders/verts"``, ``"gravity"``, ``"step_count"``, ...), so a file
written by ``starframe_tpu.io.save`` loads here, and a world built by either
package can be handed to the other as a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import Bodies, Colliders, Joints, World

_GROUPS = (("bodies", Bodies), ("colliders", Colliders), ("joints", Joints))


def world_to_numpy(world: World) -> dict:
    """``{"bodies/pos": ndarray, ...}`` with the JAX package's keys."""
    out = {}
    for name, _ in _GROUPS:
        group = getattr(world, name)
        for f in dataclasses.fields(group):
            out[f"{name}/{f.name}"] = getattr(group, f.name).cpu().numpy()
    out["gravity"] = world.gravity.cpu().numpy()
    out["step_count"] = world.step_count.cpu().numpy()
    return out


def target_device(device) -> torch.device:
    """``device`` as a ``torch.device``. The port's entry points default to
    the card (``"cuda"``); without one that default raises, and a caller
    that wants the CPU passes ``device="cpu"``: there is no quiet fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to build on the CPU")
    return device


def world_from_numpy(arrays: dict, device="cuda") -> World:
    """Build a :class:`World` on ``device`` (the card unless the caller asks
    for the CPU) from a ``world_to_numpy`` dict (or an ``np.load`` of a
    snapshot). Dtypes are kept as stored."""
    device = target_device(device)

    def t(key):
        # copy: arrays exported by jax are read-only views
        return torch.as_tensor(np.array(arrays[key]), device=device)

    groups = {
        name: cls(**{f.name: t(f"{name}/{f.name}")
                     for f in dataclasses.fields(cls)})
        for name, cls in _GROUPS
    }
    return World(**groups, gravity=t("gravity"), step_count=t("step_count"))


def load_npz(path: str, device="cuda") -> World:
    """Read a snapshot written by ``starframe_tpu.io.save`` (or by
    ``np.savez`` of a :func:`world_to_numpy` dict)."""
    with np.load(path) as data:
        return world_from_numpy({k: data[k] for k in data.files}, device)
