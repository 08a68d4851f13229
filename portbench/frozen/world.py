"""Frozen copy of the port's room-scene writer: `romap_tpu_torch/data/world.py::
write_room_dataset` with the generator it calls (`data/synthetic.py`:
spheres, the textured room, the orbit, the analytic render and the 2D
boxes) and the dataset writer (`data/formats.py::write_dataset`, with
`utils/camera.py::rot_to_quat`). Copied so that a later change to the
program cannot move the benchmark's scenes. NumPy only; nothing of the
program is imported.

Changes from the program's writer, each for a scene the benchmark needs:
`make_sequence` and `write_room_dataset` take the orbit's `arc` and
`radius` and an object list where the program's writer fixes them (the
defaults are the program's); `write_dataset` returns without writing depth
when `use_depth` is false, as the program's does, and writes no `bbox/`
files (the offline runner reads only `obj_offline/`). The GT sidecar is
left out. `portbench/scene.py` renders the same frames on the card; a test
holds it to `render_frame` here.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class SphereObject:
    center: np.ndarray  # [3] world
    radius: float
    instance_id: int
    base_color: np.ndarray  # [3] in [0,1]

    def aabb_half_extents(self) -> np.ndarray:
        return np.full(3, self.radius, np.float32)

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

    def shade(self, p):
        """Color at surface point: base color modulated by the normal plus
        blocky aperiodic noise."""
        n = (p - self.center) / self.radius
        mod = 0.5 + 0.5 * n  # [-1,1] -> [0,1] per axis
        c1 = _hash01(*(np.floor((n[..., k] + 1.0) * 9.0) for k in range(3)))
        c2 = _hash01(*(np.floor((n[..., k] + 1.0) * 21.0 + 3) for k in range(3)))
        tex = (0.15 + 0.6 * c1 + 0.35 * c2)[..., None]
        return np.clip(self.base_color * (0.55 + 0.45 * mod) * tex, 0, 1)


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


def room_camera(res: int = 480) -> Camera:
    """The room writer's camera: res x 4/3 res, f = 0.95 res."""
    return Camera(fx=res * 0.95, fy=res * 0.95, cx=res * 2 / 3, cy=res / 2,
                  h=res, w=int(res * 4 / 3))


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
    """Axis-aligned textured box room enclosing the scene."""

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
        p = o_w + np.where(np.isfinite(th), th, 0.0)[..., None] * d_w
        col = obj.shade(p)
        rgb = np.where(closer[..., None], col, rgb)
        inst = np.where(closer, np.uint8(obj.instance_id), inst)
        best_t = np.where(closer, th, best_t)

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


def orbit_poses(objects: list[SphereObject], n_frames: int, radius: float = 2.4,
                arc: float = 2.2) -> list[np.ndarray]:
    """The orbit of `make_sequence`: Twc of each frame."""
    center = np.mean([o.center for o in objects], axis=0)
    out = []
    for k in range(n_frames):
        theta = arc * k / n_frames
        phi = 0.45 + 0.15 * np.sin(3 * theta)
        out.append(look_at_pose(orbit_eye(center, radius, theta, phi), center))
    return out


def make_sequence(cam: Camera, objects: list[SphereObject], n_frames: int,
                  radius: float = 2.4, room: Room | None = None, arc: float = 2.2):
    """Orbit sequence around the scene -> list of dicts with all GT."""
    frames = []
    for k, twc in enumerate(orbit_poses(objects, n_frames, radius, arc)):
        rgb, depth, inst = render_frame(cam, twc, objects, room=room)
        bboxes = {o.instance_id: instance_bbox(inst, o.instance_id) for o in objects}
        frames.append(dict(stamp=f"{k:06d}.{0:04d}", rgb=rgb, depth=depth, instance=inst,
                           twc=twc, bboxes=bboxes))
    return frames


def rot_to_quat(r: np.ndarray) -> tuple[float, float, float, float]:
    """3x3 rotation -> quaternion (x, y, z, w), w >= 0."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        qw = (r[k, j] - r[j, k]) / s
        qx, qy, qz = q
    if qw < 0:
        qx, qy, qz, qw = -qx, -qy, -qz, -qw
    return float(qx), float(qy), float(qz), float(qw)


def write_dataset(root: str, cam, frames: list[dict], objects=None, use_depth=True):
    """Write a reference-format dataset: config.yaml, img.txt,
    groundtruth.txt, rgb/ and instance/ PNGs (depth/ with `use_depth`) and
    obj_offline/<i>.txt (class, centre, identity rotation, 1.1 x the half
    extents, then the frames' boxes)."""
    import cv2

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "instance"), exist_ok=True)
    if use_depth:
        os.makedirs(os.path.join(root, "depth"), exist_ok=True)

    factor = 1.0 / 5000.0
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n")
        f.write(f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n")
        f.write(f"Camera.H: {cam.h}\nCamera.W: {cam.w}\n")
        f.write(f"DepthMapFactor: {factor}\n")

    with open(os.path.join(root, "img.txt"), "w") as fimg, open(
        os.path.join(root, "groundtruth.txt"), "w"
    ) as fgt:
        fimg.write("# stamp filename\n")
        fgt.write("# stamp tx ty tz qx qy qz qw\n")
        for i, fr in enumerate(frames):
            name = f"{i:06d}.png"
            cv2.imwrite(os.path.join(root, "rgb", name),
                        cv2.cvtColor(fr["rgb"], cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(root, "instance", name), fr["instance"])
            if use_depth:
                d16 = np.clip(fr["depth"] / factor, 0, 65535).astype(np.uint16)
                cv2.imwrite(os.path.join(root, "depth", name), d16)
            fimg.write(f"{fr['stamp']} {name}\n")
            twc = fr["twc"]
            q = rot_to_quat(twc[:3, :3])
            t = twc[:3, 3]
            fgt.write(
                f"{fr['stamp']} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )

    if objects is not None:
        os.makedirs(os.path.join(root, "obj_offline"), exist_ok=True)
        for oi, obj in enumerate(objects):
            with open(os.path.join(root, "obj_offline", f"{oi}.txt"), "w") as f:
                f.write("# class tx ty tz qx qy qz qw a1 a2 a3\n")
                c = obj.center
                h = obj.aabb_half_extents() * 1.1
                f.write(
                    f"{obj.instance_id} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"0 0 0 1 {h[0]:.6f} {h[1]:.6f} {h[2]:.6f}\n"
                )
                for fr in frames:
                    bb = fr["bboxes"].get(obj.instance_id)
                    if bb is not None:
                        x, y, hh, ww = bb
                        f.write(f"{fr['stamp']} {x} {y} {hh} {ww}\n")


def write_room_dataset(root: str, n_frames: int = 80, res: int = 480,
                       n_objects: int = 1, seed: int = 0, arc: float = 2.2,
                       radius: float = 2.4) -> None:
    """The room sequence: textured box room + spheres on an orbit, written
    in the reference's on-disk layout with GT depth."""
    cam = room_camera(res)
    objs = make_scene(n_objects, seed=seed)
    if n_objects == 1:
        objs[0].radius = 0.6
    frames = make_sequence(cam, objs, n_frames, radius=radius, room=Room(), arc=arc)
    write_dataset(root, cam, frames, objects=objs, use_depth=True)
