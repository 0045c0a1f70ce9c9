"""Contact events from canonical pair keys: started / ended masks and pair
sets.

The PyTorch counterpart of the key half of ``starframe_tpu/events.py``:
the slot and tile engines report each touching contact as one int32 key
``min(a, b) * n_colliders + max(a, b)`` of its two collider ids (``-1``
marks an empty slot); these functions turn key tables into pair sets and
diff consecutive frames. ``tiled_rollout(..., with_events=True)`` returns
one key table a frame. ``diff_contacts``, ``ContactEvents`` and
``touching_keys`` read the single-world XLA tier's ``Contacts``, which the
port does not have yet (ROADMAP.md A3).
"""

from __future__ import annotations

import numpy as np
import torch


def touching_keys_from_slots(touched, partner, n_colliders: int):
    """Canonical pair keys of the batched slot kernel's touch output:
    ``touched``/``partner`` are ``[..., C, M]`` slot tables (the own
    collider on the last axis). Returns int32 keys of the same shape,
    ``-1`` where not touching; a dynamic pair appears in both rows with the
    same key."""
    own = torch.arange(touched.shape[-1], dtype=torch.int32,
                       device=touched.device).expand(touched.shape)
    partner = partner.to(torch.int32)
    key = torch.minimum(own, partner) * n_colliders + torch.maximum(
        own, partner)
    return torch.where(touched > 0, key, -1)


def slot_touch_set(touched, partner, n_colliders: int) -> set:
    """Host-side set of touching ``(collider_a, collider_b)`` pairs (a < b)
    of ONE world's slot tables."""
    return keys_to_set(touching_keys_from_slots(touched, partner,
                                                n_colliders), n_colliders)


def key_event_masks(prev_keys, cur_keys):
    """Started/ended masks between two frames' key tables (any shape, ``-1``
    for an empty slot): ``started[i]`` is ``cur_keys[i] >= 0`` and not among
    ``prev_keys``, ``ended`` the same the other way round. Sorts and
    ``searchsorted``, no atomics: deterministic on the card. A key held by
    two rows gives the same answer in both."""
    p = torch.sort(prev_keys.reshape(-1)).values
    c = torch.sort(cur_keys.reshape(-1)).values

    def in_sorted(arr, q):
        i = torch.clamp(torch.searchsorted(arr, q.reshape(-1)), 0,
                        arr.shape[0] - 1)
        return (arr[i] == q.reshape(-1)).reshape(q.shape)

    started = (cur_keys >= 0) & ~in_sorted(p, cur_keys)
    ended = (prev_keys >= 0) & ~in_sorted(c, prev_keys)
    return started, ended


def keys_to_set(keys, n_colliders: int) -> set:
    """Host-side set of ``(collider_a, collider_b)`` tuples of a key table
    (``-1`` entries skipped)."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    k = np.unique(np.asarray(keys).reshape(-1))
    k = k[k >= 0]
    return {(int(x) // n_colliders, int(x) % n_colliders) for x in k}
