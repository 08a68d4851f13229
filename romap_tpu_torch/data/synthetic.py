"""Synthetic multi-object scenes with analytic ground truth.

The reference validates end-to-end on a synthetic `room` sequence with GT
poses/bboxes/depth (README.md:72); that dataset is not shipped, so this module
generates equivalent scenes analytically: lambertian-ish colored spheres and
boxes on a transparent background, ray-traced in NumPy at arbitrary
resolution, with exact instance masks, z-depth, camera poses, and per-frame
2D bboxes. Used by tests, the offline-runner e2e test, and bench.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SphereObject:
    center: np.ndarray  # [3] world
    radius: float
    instance_id: int
    base_color: np.ndarray  # [3] in [0,1]

    def aabb_half_extents(self) -> np.ndarray:
        return np.full(3, self.radius, np.float32)

    def gt_cuboid(self):
        """(center, half_extents, yaw) of the bounding cuboid (yaw-free)."""
        return (np.asarray(self.center, np.float64),
                np.full(3, float(self.radius)), 0.0)

    def hit(self, o, d):
        """Ray-sphere: o [..,3], d unit [..,3] -> (t, hit). Nearest positive root."""
        oc = o - self.center
        b = np.sum(oc * d, -1)
        c = np.sum(oc * oc, -1) - self.radius**2
        disc = b * b - c
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        t0 = -b - sq
        t1 = -b + sq
        t = np.where(t0 > 1e-3, t0, t1)
        return t, ok & (t > 1e-3)

    def surface_distance(self, p):
        """|sdf| of points to the sphere surface (part selection in compounds)."""
        return np.abs(np.linalg.norm(p - self.center, axis=-1) - self.radius)

    def surface_points(self, n: int, rng) -> np.ndarray:
        """Uniform samples on the sphere surface, OBJECT frame (centered)."""
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return (v * self.radius).astype(np.float32)

    def shade(self, p):
        """Color at surface point: base color modulated by the normal plus a
        high-frequency surface checker (view-consistent, so a NeRF can fit it
        exactly, and corner-rich so ORB tracks it)."""
        n = (p - self.center) / self.radius
        mod = 0.5 + 0.5 * n  # [-1,1] -> [0,1] per axis
        # aperiodic blocky noise (NOT a checker: regular patterns make every
        # corner descriptor identical and the matchers' ratio tests reject
        # them all) — same idea as the Room wall texture
        c1 = _hash01(*(np.floor((n[..., k] + 1.0) * 9.0) for k in range(3)))
        c2 = _hash01(*(np.floor((n[..., k] + 1.0) * 21.0 + 3) for k in range(3)))
        tex = (0.15 + 0.6 * c1 + 0.35 * c2)[..., None]
        return np.clip(self.base_color * (0.55 + 0.45 * mod) * tex, 0, 1)


@dataclasses.dataclass
class BoxObject:
    """Textured axis-yawed box (the non-sphere geometry the reference's real
    scenes exercise — ref README.md:61-66 demo objects are boxes/keyboards).
    Same protocol as SphereObject: hit/shade/center/instance_id/extents."""

    center: np.ndarray  # [3] world
    half: np.ndarray  # [3] half extents in the box frame
    yaw: float  # rotation about world z
    instance_id: int
    base_color: np.ndarray

    def _rot(self):
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    def aabb_half_extents(self) -> np.ndarray:
        r = np.abs(self._rot())
        return (r @ np.asarray(self.half, np.float64)).astype(np.float32)

    def gt_cuboid(self):
        """(center_world, half_extents, yaw) of the minimal z-yaw-aligned
        bounding cuboid — the quantity the SLAM object layer estimates
        (18-yaw scoring, ref include/MapObject.h cuboid a1..a3). For a
        yawed box that is the BODY-frame half extents, NOT the yaw-
        inflated world AABB that `aabb_half_extents` returns."""
        return (np.asarray(self.center, np.float64),
                np.asarray(self.half, np.float64), float(self.yaw))

    @property
    def radius(self) -> float:  # bounding-sphere radius (sidecar compat)
        return float(np.linalg.norm(self.half))

    def hit(self, o, d):
        """Slab-test ray-OBB: transform rays into the box frame."""
        r = self._rot()
        ob = (o - self.center) @ r  # world->box (r is orthonormal)
        db = d @ r
        inv = 1.0 / np.where(np.abs(db) > 1e-12, db, 1e-12)
        t0 = (-np.asarray(self.half) - ob) * inv
        t1 = (np.asarray(self.half) - ob) * inv
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        ok = (tmax > np.maximum(tmin, 1e-3))
        t = np.where(tmin > 1e-3, tmin, tmax)
        return t, ok & (t > 1e-3)

    def surface_distance(self, p):
        """|sdf| of points to the box surface (part selection in compounds)."""
        q = np.abs((p - self.center) @ self._rot()) - np.asarray(self.half)
        outside = np.linalg.norm(np.maximum(q, 0), axis=-1)
        inside = np.minimum(q.max(-1), 0)
        return np.abs(outside + inside)

    def shade(self, p):
        """Blocky aperiodic texture in box-local coords + per-face tint (so
        every face has trackable corners and faces are distinguishable)."""
        q = (p - self.center) @ self._rot()
        u = q / np.asarray(self.half)
        face = np.argmax(np.abs(u), axis=-1)
        tint = 0.75 + 0.25 * (face / 2.0)[..., None]
        c1 = _hash01(*(np.floor((q[..., k] + 2.0) * 14.0) for k in range(3)))
        c2 = _hash01(*(np.floor((q[..., k] + 2.0) * 33.0 + 5) for k in range(3)))
        tex = (0.2 + 0.55 * c1 + 0.35 * c2)[..., None]
        return np.clip(self.base_color * tint * tex, 0, 1)

    def surface_points(self, n: int, rng) -> np.ndarray:
        """Uniform-ish samples on the box surface, OBJECT frame (= centered,
        yaw kept — the GT sidecar is consumed in the object frame)."""
        areas = np.array([self.half[1] * self.half[2],
                          self.half[0] * self.half[2],
                          self.half[0] * self.half[1]], np.float64)
        areas = np.repeat(areas, 2)
        areas /= areas.sum()
        faces = rng.choice(6, size=n, p=areas)
        pts = rng.uniform(-1, 1, (n, 3)) * np.asarray(self.half)
        for f in range(6):
            m = faces == f
            pts[m, f // 2] = (1 if f % 2 else -1) * self.half[f // 2]
        return (pts @ self._rot().T).astype(np.float32)


class CompoundObject:
    """Union of primitives sharing one instance id — concave silhouettes
    (an L of two boxes) and compound shapes (box + sphere) that a sphere
    fit cannot score; the chamfer mesh metric handles these."""

    def __init__(self, parts, instance_id: int):
        self.parts = parts
        self.instance_id = instance_id
        los, his = [], []
        for p in self.parts:
            h = p.aabb_half_extents()
            los.append(np.asarray(p.center) - h)
            his.append(np.asarray(p.center) + h)
        lo, hi = np.min(los, axis=0), np.max(his, axis=0)
        self.center = ((lo + hi) / 2).astype(np.float64)
        self._half = ((hi - lo) / 2).astype(np.float32)

    def aabb_half_extents(self) -> np.ndarray:
        return self._half

    def gt_cuboid(self):
        """Minimal z-yaw-aligned bounding cuboid of the union: the frame is
        the first part's yaw (all current compound scenes share one yaw;
        spheres are yaw-invariant), each part contributes its AABB in that
        frame, and the union box is mapped back to world."""
        yaws = [float(getattr(p, "yaw", 0.0)) for p in self.parts]
        yaw = yaws[0]
        c, s = np.cos(yaw), np.sin(yaw)
        rf = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        los, his = [], []
        for p, py in zip(self.parts, yaws):
            cf = rf.T @ np.asarray(p.center, np.float64)
            if hasattr(p, "half"):
                dy = py - yaw
                cd, sd = np.cos(dy), np.sin(dy)
                rd = np.abs(np.array([[cd, -sd, 0], [sd, cd, 0],
                                      [0, 0, 1.0]]))
                h = rd @ np.asarray(p.half, np.float64)
            else:
                h = np.full(3, float(p.radius))
            los.append(cf - h)
            his.append(cf + h)
        lo, hi = np.min(los, axis=0), np.max(his, axis=0)
        return rf @ ((lo + hi) / 2), (hi - lo) / 2, yaw

    @property
    def radius(self) -> float:
        return float(np.linalg.norm(self._half))

    def hit(self, o, d):
        best_t = np.full(o.shape[:-1], np.inf)
        any_hit = np.zeros(o.shape[:-1], bool)
        for p in self.parts:
            t, ok = p.hit(o, d)
            closer = ok & (t < best_t)
            best_t = np.where(closer, t, best_t)
            any_hit |= ok
        return best_t, any_hit & np.isfinite(best_t)

    def shade(self, p):
        """Delegate to the part whose surface is nearest to the hit point."""
        dists = np.stack([q.surface_distance(p) for q in self.parts], -1)
        which = np.argmin(dists, -1)
        out = self.parts[0].shade(p)
        for i, q in enumerate(self.parts[1:], 1):
            out = np.where((which == i)[..., None], q.shade(p), out)
        return out

    def surface_points(self, n: int, rng) -> np.ndarray:
        """Object-frame surface samples, excluding points buried inside a
        sibling part (union surface only)."""
        per = max(64, n // len(self.parts) * 2)
        pts = []
        for p in self.parts:
            sp = p.surface_points(per, rng) + (np.asarray(p.center)
                                               - self.center)
            keep = np.ones(len(sp), bool)
            for q in self.parts:
                if q is p:
                    continue
                keep &= q.surface_distance(
                    sp + self.center) > 1e-3  # outside-or-on sibling
            pts.append(sp[keep])
        pts = np.concatenate(pts, 0)
        if len(pts) > n:
            pts = pts[rng.choice(len(pts), n, replace=False)]
        return pts.astype(np.float32)


@dataclasses.dataclass
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    h: int
    w: int

    @property
    def intrinsics(self):
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float32)


def look_at_pose(eye, target, up=(0, 0, 1.0)):
    """Twc with camera +z looking at target (OpenCV convention: x right, y down)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    twc = np.eye(4, dtype=np.float32)
    twc[:3, 0], twc[:3, 1], twc[:3, 2], twc[:3, 3] = x, y, z, eye
    return twc


def _hash01(ix, iy, iz):
    """Deterministic pseudo-noise on integer lattice coords -> [0,1)."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263
         + iz.astype(np.int64) * 2147483647) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return (h % 8192) / 8192.0


@dataclasses.dataclass
class Room:
    """Axis-aligned textured box room enclosing the scene. The procedural
    multi-scale blocky noise gives ORB plenty of corners (the reference's
    room sequence is a textured synthetic room, README.md:72)."""

    half: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([4.0, 4.0, 3.0]))

    def hit(self, o, d):
        """Nearest wall hit: returns (t [..,], rgb [..,3]). Rays assumed to
        start inside the box."""
        best_t = np.full(o.shape[:-1], np.inf)
        hit_p = np.zeros_like(o)
        for axis in range(3):
            for sgn in (-1.0, 1.0):
                bound = sgn * self.half[axis]
                denom = d[..., axis]
                t = np.where(np.abs(denom) > 1e-9,
                             (bound - o[..., axis]) / np.where(
                                 np.abs(denom) > 1e-9, denom, 1.0), np.inf)
                valid = (t > 1e-3) & np.isfinite(t)
                p = o + np.where(np.isfinite(t), t, 0.0)[..., None] * d
                for other in range(3):
                    if other == axis:
                        continue
                    valid &= np.abs(p[..., other]) <= self.half[other] + 1e-4
                closer = valid & (t < best_t)
                best_t = np.where(closer, t, best_t)
                hit_p = np.where(closer[..., None], p, hit_p)
        # blocky noise texture (coarse, moderate contrast — enough for the
        # SLAM to track, without starving foreground objects of features)
        c = (0.75 * _hash01(*(np.floor(hit_p[..., k] * 4) for k in range(3)))
             + 0.25 * _hash01(*(np.floor(hit_p[..., k] * 9 + 7) for k in range(3))))
        rgb = np.stack([0.35 + 0.45 * c, 0.35 + 0.42 * c, 0.38 + 0.4 * c], -1)
        return best_t, rgb


def render_frame(cam: Camera, twc: np.ndarray, objects: list[SphereObject],
                 room: Room | None = None):
    """Analytic render -> (rgb u8 [H,W,3], depth f32 z [H,W], instance u8 [H,W])."""
    ys, xs = np.mgrid[0 : cam.h, 0 : cam.w]
    d_cam = np.stack(
        [(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, np.ones_like(xs, np.float64)],
        -1,
    )
    d_norm = np.linalg.norm(d_cam, axis=-1)
    d = d_cam / d_norm[..., None]
    r, t = twc[:3, :3], twc[:3, 3]
    d_w = d @ r.T
    o_w = np.broadcast_to(t, d_w.shape)

    best_t = np.full((cam.h, cam.w), np.inf)
    rgb = np.ones((cam.h, cam.w, 3))  # white background
    inst = np.zeros((cam.h, cam.w), np.uint8)
    if room is not None:
        t_room, rgb_room = room.hit(o_w, d_w)
        closer = np.isfinite(t_room)
        rgb = np.where(closer[..., None], rgb_room, rgb)
        best_t = np.where(closer, t_room, best_t)
    for obj in objects:
        th, hit = obj.hit(o_w, d_w)
        closer = hit & (th < best_t)
        # sanitize miss rays (inf/NaN t) before shading: their p is never
        # selected, but inf would trip argmin-based part selection/warnings
        p = o_w + np.where(np.isfinite(th), th, 0.0)[..., None] * d_w
        col = obj.shade(p)
        rgb = np.where(closer[..., None], col, rgb)
        inst = np.where(closer, np.uint8(obj.instance_id), inst)
        best_t = np.where(closer, th, best_t)

    # best_t is distance along the unit ray; camera z-depth = t / |d_cam|
    zdepth = np.where(np.isfinite(best_t), best_t / d_norm, 0.0)
    return (rgb * 255).astype(np.uint8), zdepth.astype(np.float32), inst


def instance_bbox(inst: np.ndarray, instance_id: int):
    """Tight 2D bbox (x, y, h, w) of an instance mask, or None."""
    ys, xs = np.nonzero(inst == instance_id)
    if len(ys) == 0:
        return None
    x0, x1 = int(xs.min()), int(xs.max())
    y0, y1 = int(ys.min()), int(ys.max())
    return (x0, y0, y1 - y0 + 1, x1 - x0 + 1)


def orbit_eye(target, radius, theta, phi=0.5):
    return np.array(
        [
            target[0] + radius * np.cos(theta) * np.cos(phi),
            target[1] + radius * np.sin(theta) * np.cos(phi),
            target[2] + radius * np.sin(phi),
        ]
    )


def make_scene(n_objects: int = 1, seed: int = 0) -> list[SphereObject]:
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n_objects):
        angle = 2 * np.pi * i / max(n_objects, 1)
        center = np.array([2.5 * np.cos(angle), 2.5 * np.sin(angle), 0.0]) if n_objects > 1 else np.zeros(3)
        objs.append(
            SphereObject(
                center=center,
                radius=float(rng.uniform(0.35, 0.55)),
                instance_id=i + 1,
                base_color=rng.uniform(0.3, 1.0, 3),
            )
        )
    return objs


def make_sequence(
    cam: Camera, objects: list[SphereObject], n_frames: int, radius: float = 2.0,
    target=None, seed: int = 0, room: Room | None = None, arc: float = 2 * np.pi,
):
    """Orbit sequence around the scene -> list of dicts with all GT.
    `arc` < 2*pi gives a partial sweep (smoother inter-frame baselines for
    the SLAM path); `room` adds textured walls."""
    frames = []
    center = np.mean([o.center for o in objects], axis=0) if target is None else np.asarray(target)
    for k in range(n_frames):
        theta = arc * k / n_frames
        phi = 0.45 + 0.15 * np.sin(3 * theta)
        eye = orbit_eye(center, radius, theta, phi)
        twc = look_at_pose(eye, center)
        rgb, depth, inst = render_frame(cam, twc, objects, room=room)
        bboxes = {o.instance_id: instance_bbox(inst, o.instance_id) for o in objects}
        frames.append(
            dict(stamp=f"{k:06d}.{0:04d}", rgb=rgb, depth=depth, instance=inst,
                 twc=twc, bboxes=bboxes)
        )
    return frames
