"""``reference.world``'s interface, re-exported."""

from reference.world import build, cast, cast_geom, shapes

__all__ = ["build", "cast", "cast_geom", "shapes"]
