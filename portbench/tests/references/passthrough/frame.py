"""``reference.frame``'s interface, re-exported."""

from reference.frame import frame, rollout

__all__ = ["frame", "rollout"]
