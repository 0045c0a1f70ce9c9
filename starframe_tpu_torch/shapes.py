"""Shape constructors and mass properties.

A copy of ``starframe_tpu/shapes.py`` (pure numpy): importing that module
would import jax through the ``starframe_tpu`` package.

Covers starframe's shape taxonomy — circle, box/rect, capsule, convex polygon
including hexagons, with optional corner rounding (SURVEY.md §2 row 4;
BASELINE.json:5 "circle/capsule/convex-poly") — under the unified
rounded-convex-polygon representation used by :mod:`starframe_tpu.state`:
``verts[V, 2]`` core vertices (CCW) dilated by ``radius``.

- ``circle(r)``        -> 1 vertex, radius r
- ``capsule(hl, r)``   -> 2 vertices (segment along x), radius r
- ``box(hx, hy, r=0)`` -> 4 vertices (+ optional rounding)
- ``polygon(verts, r)``/``hexagon(r)`` -> general convex cores

Mass properties are exact for circles, capsules, and sharp polygons, and use
the exact Minkowski-sum decomposition (core + edge strips + corner arcs) for
rounded polygons.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Shape:
    """A rounded convex polygon: core ``verts[V, 2]`` (CCW) + dilation radius."""

    verts: np.ndarray
    radius: float = 0.0

    def __post_init__(self):
        v = np.asarray(self.verts, np.float32).reshape(-1, 2)
        object.__setattr__(self, "verts", v)
        if len(v) >= 3 and _polygon_area(v) < 0:
            raise ValueError("polygon vertices must be counter-clockwise")
        if self.radius < 0:
            raise ValueError("radius must be >= 0")
        if len(v) == 1 and self.radius <= 0:
            raise ValueError("a single-vertex shape (circle) needs radius > 0")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def circle(radius: float) -> "Shape":
        return Shape(verts=np.zeros((1, 2), np.float32), radius=radius)

    @staticmethod
    def capsule(half_length: float, radius: float) -> "Shape":
        """Capsule along the local x axis: full length 2*(half_length+radius)."""
        return Shape(
            verts=np.array([[-half_length, 0.0], [half_length, 0.0]], np.float32),
            radius=radius,
        )

    @staticmethod
    def segment(a, b, radius: float) -> "Shape":
        return Shape(verts=np.array([a, b], np.float32), radius=radius)

    @staticmethod
    def box(hx: float, hy: float, radius: float = 0.0) -> "Shape":
        """Rectangle with half-extents (hx, hy); ``radius`` rounds the corners
        (the core shrinks so the outer extent stays hx/hy)."""
        cx, cy = hx - radius, hy - radius
        if cx <= 0 or cy <= 0:
            raise ValueError("rounding radius exceeds half-extents")
        v = np.array([[cx, cy], [-cx, cy], [-cx, -cy], [cx, -cy]], np.float32)
        # reorder CCW starting from +x+y: above is CCW already? area check:
        if _polygon_area(v) < 0:
            v = v[::-1].copy()
        return Shape(verts=v, radius=radius)

    @staticmethod
    def square(half: float, radius: float = 0.0) -> "Shape":
        return Shape.box(half, half, radius)

    @staticmethod
    def polygon(verts, radius: float = 0.0) -> "Shape":
        v = np.asarray(verts, np.float32)
        if _polygon_area(v) < 0:
            v = v[::-1].copy()
        return Shape(verts=v, radius=radius)

    @staticmethod
    def regular_polygon(n: int, circumradius: float, radius: float = 0.0) -> "Shape":
        ang = np.arange(n) * (2 * np.pi / n)
        v = circumradius * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        return Shape(verts=v.astype(np.float32), radius=radius)

    @staticmethod
    def hexagon(circumradius: float, radius: float = 0.0) -> "Shape":
        return Shape.regular_polygon(6, circumradius, radius)

    # -- geometry -----------------------------------------------------------

    @property
    def nverts(self) -> int:
        return len(self.verts)

    def aabb(self):
        lo = self.verts.min(axis=0) - self.radius
        hi = self.verts.max(axis=0) + self.radius
        return lo, hi

    # -- mass properties ------------------------------------------------------

    def mass_properties(self, density: float = 1.0) -> tuple[float, float]:
        """Return (mass, moment_of_inertia_about_body_origin).

        Exact for all shapes via the Minkowski-sum decomposition of the
        rounded polygon into: the core polygon, one rectangle strip per core
        edge (thickness = radius), and circular-arc sectors at the vertices
        that together form one full disc of the dilation radius.
        """
        v = self.verts.astype(np.float64)
        r = float(self.radius)
        n = len(v)

        if n == 1:
            m = density * np.pi * r * r
            c = v[0]
            i = m * (0.5 * r * r + c @ c)  # disc + parallel axis to origin
            return float(m), float(i)

        if n == 2:
            return _capsule_mass(v[0], v[1], r, density)

        m, i = _polygon_mass(v, density)
        if r > 0:
            # edge strips: rectangle of length L, thickness r, outward of edge
            for k in range(n):
                a, b = v[k], v[(k + 1) % n]
                e = b - a
                L = np.linalg.norm(e)
                if L < 1e-12:
                    continue
                t = e / L
                nrm = np.array([t[1], -t[0]])  # outward for CCW
                center = (a + b) / 2 + nrm * (r / 2)
                ms = density * L * r
                i_strip = ms * (L * L + r * r) / 12.0 + ms * (center @ center)
                m += ms
                i += i_strip
            # corner arcs: all vertex arcs of a convex polygon sum to 2π, i.e.
            # one full disc split across vertices; per-vertex arc angle is the
            # exterior angle. Inertia of a sector of angle θ about its apex is
            # (θ/2π) * full-disc-about-center, plus parallel axis to origin
            # with the sector centroid ≈ apex for thin radii — we use the
            # exact sector formulas.
            for k in range(n):
                p = v[k]
                a_prev = v[k - 1]
                a_next = v[(k + 1) % n]
                e0 = p - a_prev
                e1 = a_next - p
                theta = _exterior_angle(e0, e1)
                if theta <= 1e-12:
                    continue
                msec = density * 0.5 * theta * r * r
                # sector about apex: ∫ρ ρ² dρ dφ = θ r⁴/4 * density
                i_apex = density * theta * (r ** 4) / 4.0
                # bisector direction for sector centroid
                t0 = e0 / max(np.linalg.norm(e0), 1e-12)
                t1 = e1 / max(np.linalg.norm(e1), 1e-12)
                n0 = np.array([t0[1], -t0[0]])
                n1 = np.array([t1[1], -t1[0]])
                bis = n0 + n1
                bl = np.linalg.norm(bis)
                bis = bis / bl if bl > 1e-12 else n0
                # sector centroid distance from apex: (2/3) r sin(θ/2)/(θ/2) ... for
                # a circular sector: d = (4 r sin(θ/2)) / (3 θ)
                d = (4.0 * r * np.sin(theta / 2.0)) / (3.0 * theta)
                csec = p + bis * d
                i_origin = i_apex - msec * d * d + msec * (csec @ csec)
                m += msec
                i += i_origin
        return float(m), float(i)

    def centroid(self) -> np.ndarray:
        v = self.verts.astype(np.float64)
        n = len(v)
        if n == 1:
            return v[0].astype(np.float32)
        if n == 2:
            return ((v[0] + v[1]) / 2).astype(np.float32)
        a = 0.0
        c = np.zeros(2)
        for k in range(n):
            p, q = v[k], v[(k + 1) % n]
            cr = p[0] * q[1] - p[1] * q[0]
            a += cr
            c += (p + q) * cr
        a *= 0.5
        return (c / (6.0 * a)).astype(np.float32)


def _polygon_area(v: np.ndarray) -> float:
    x, y = v[:, 0], v[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _polygon_mass(v: np.ndarray, density: float) -> tuple[float, float]:
    """Mass and inertia about the origin for a (sharp) CCW polygon."""
    m = 0.0
    i = 0.0
    n = len(v)
    for k in range(n):
        p, q = v[k], v[(k + 1) % n]
        cr = p[0] * q[1] - p[1] * q[0]
        m += cr
        i += cr * (p @ p + p @ q + q @ q)
    m *= 0.5 * density
    i *= density / 12.0
    return float(m), float(i)


def _capsule_mass(a: np.ndarray, b: np.ndarray, r: float, density: float):
    """Exact 2D capsule mass/inertia about the body origin."""
    L = float(np.linalg.norm(b - a))
    mid = (a + b) / 2
    axis = (b - a) / max(L, 1e-12) if L > 1e-12 else np.array([1.0, 0.0])
    # rectangle part: L x 2r, centered at mid, aligned to axis
    m_rect = density * L * 2 * r
    i_rect_c = m_rect * (L * L + 4 * r * r) / 12.0
    m = m_rect
    i = i_rect_c + m_rect * (mid @ mid)
    # two half discs at the ends; each: mass ρπr²/2, about its flat-edge
    # center I = (1/2) m_h r²; centroid at d = 4r/(3π) outward along axis
    m_h = density * np.pi * r * r / 2.0
    d = 4.0 * r / (3.0 * np.pi)
    for end, direction in ((a, -axis), (b, axis)):
        c = end + direction * d
        i_c = 0.5 * m_h * r * r - m_h * d * d
        i += i_c + m_h * (c @ c)
        m += m_h
    return float(m), float(i)


def _exterior_angle(e0: np.ndarray, e1: np.ndarray) -> float:
    """Turn angle at a vertex between incoming edge e0 and outgoing e1."""
    a0 = np.arctan2(e0[1], e0[0])
    a1 = np.arctan2(e1[1], e1[0])
    d = a1 - a0
    while d <= -np.pi:
        d += 2 * np.pi
    while d > np.pi:
        d -= 2 * np.pi
    return abs(d)
