"""The benchmark's scenes, rendered on the card from the seed.

The frozen writer (`portbench/frozen/world.py`) renders a 640 x 480 frame
in NumPy in 0.6 s with 4 spheres: 48 s of set-up for 80 frames.
This module renders the same frames (room walls, spheres, instance masks,
2D boxes) with the same arithmetic in float64 torch on the card, a chunk of
frames at a time; `tests/test_portbench_scene.py` holds it to the frozen
`render_frame`. Scene geometry and colours come from the seed through the
frozen `make_scene`; the orbit is the writer's.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.frozen import world

F64 = torch.float64


def _hash01(ix, iy, iz):
    h = (ix.long() * 374761393 + iy.long() * 668265263 + iz.long() * 2147483647) & 0x7FFFFFFF
    h = ((h ^ (h >> 13)) * 1274126177) & 0x7FFFFFFF
    return (h % 8192).to(F64) / 8192.0


def _room_hit(half, o, d):
    best_t = torch.full(o.shape[:-1], float("inf"), dtype=F64, device=o.device)
    hit_p = torch.zeros_like(o)
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            bound = sgn * float(half[axis])
            denom = d[..., axis]
            big = torch.abs(denom) > 1e-9
            t = torch.where(big, (bound - o[..., axis]) / torch.where(big, denom, 1.0),
                            float("inf"))
            fin = torch.isfinite(t)
            valid = (t > 1e-3) & fin
            p = o + torch.where(fin, t, 0.0)[..., None] * d
            for other in range(3):
                if other != axis:
                    valid &= torch.abs(p[..., other]) <= float(half[other]) + 1e-4
            closer = valid & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            hit_p = torch.where(closer[..., None], p, hit_p)
    c = (0.75 * _hash01(*(torch.floor(hit_p[..., k] * 4) for k in range(3)))
         + 0.25 * _hash01(*(torch.floor(hit_p[..., k] * 9 + 7) for k in range(3))))
    rgb = torch.stack([0.35 + 0.45 * c, 0.35 + 0.42 * c, 0.38 + 0.4 * c], -1)
    return best_t, rgb


def _sphere(obj, o, d):
    center = torch.as_tensor(obj.center, dtype=F64, device=o.device)
    oc = o - center
    b = torch.sum(oc * d, -1)
    c = torch.sum(oc * oc, -1) - obj.radius**2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 1e-3, t0, t1)
    hit = (disc > 0) & (t > 1e-3)
    p = o + torch.where(torch.isfinite(t), t, 0.0)[..., None] * d
    n = (p - center) / obj.radius
    mod = 0.5 + 0.5 * n
    c1 = _hash01(*(torch.floor((n[..., k] + 1.0) * 9.0) for k in range(3)))
    c2 = _hash01(*(torch.floor((n[..., k] + 1.0) * 21.0 + 3) for k in range(3)))
    tex = (0.15 + 0.6 * c1 + 0.35 * c2)[..., None]
    base = torch.as_tensor(obj.base_color, dtype=F64, device=o.device)
    return t, hit, torch.clamp(base * (0.55 + 0.45 * mod) * tex, 0, 1)


def render(cam: world.Camera, poses: list[np.ndarray], objects, device, chunk: int = 16):
    """Frames of `world.render_frame` (room on) at each Twc of `poses`:
    (rgb u8 [F, H, W, 3], instance u8 [F, H, W], boxes int32 [F, n_obj, 4]
    as (x, y, h, w), or -1 where an object is not seen), on `device`."""
    ys, xs = torch.meshgrid(torch.arange(cam.h, device=device, dtype=F64),
                            torch.arange(cam.w, device=device, dtype=F64), indexing="ij")
    d_cam = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, torch.ones_like(xs)], -1)
    d_unit = d_cam / torch.linalg.vector_norm(d_cam, dim=-1)[..., None]
    half = world.Room().half
    rgbs, insts, boxes = [], [], []
    for s in range(0, len(poses), chunk):
        twc = torch.as_tensor(np.stack(poses[s : s + chunk]), device=device).to(F64)
        d_w = torch.einsum("hwj,fij->fhwi", d_unit, twc[:, :3, :3])
        o_w = twc[:, None, None, :3, 3].expand(d_w.shape)
        best_t, rgb = _room_hit(half, o_w, d_w)
        inst = torch.zeros(best_t.shape, dtype=torch.uint8, device=device)
        for obj in objects:
            th, hit, col = _sphere(obj, o_w, d_w)
            closer = hit & (th < best_t)
            rgb = torch.where(closer[..., None], col, rgb)
            inst = torch.where(closer, torch.tensor(obj.instance_id, dtype=torch.uint8,
                                                    device=device), inst)
            best_t = torch.where(closer, th, best_t)
        rgbs.append((rgb * 255).to(torch.uint8))
        insts.append(inst)
        boxes.append(_boxes(inst, objects))
    return torch.cat(rgbs), torch.cat(insts), torch.cat(boxes)


def _boxes(inst: torch.Tensor, objects) -> torch.Tensor:
    """[F, H, W] masks -> [F, n_obj, 4] tight (x, y, h, w), -1 where absent."""
    f, h, w = inst.shape
    ids = torch.tensor([o.instance_id for o in objects], device=inst.device, dtype=torch.uint8)
    m = inst[:, None] == ids[None, :, None, None]  # [F, n, H, W]
    rows, cols = m.any(dim=3), m.any(dim=2)  # [F, n, H], [F, n, W]
    yr = torch.arange(h, device=inst.device)
    xr = torch.arange(w, device=inst.device)
    y0 = torch.where(rows, yr, h).amin(-1)
    y1 = torch.where(rows, yr, -1).amax(-1)
    x0 = torch.where(cols, xr, w).amin(-1)
    x1 = torch.where(cols, xr, -1).amax(-1)
    out = torch.stack([x0, y0, y1 - y0 + 1, x1 - x0 + 1], -1).int()
    return torch.where(rows.any(-1)[..., None], out, torch.full_like(out, -1))


def make(scene: dict, seed: int, device) -> dict:
    """The traffic's scene (`scene` of its traffic file) from `seed`:
    objects, camera, poses and frames, on the host as NumPy."""
    scene_seed = seed % (2**32)
    if scene["layout"] == "ring":
        objects = world.make_scene(scene["objects"], seed=scene_seed)
    else:
        raise ValueError(f"unknown scene layout {scene['layout']!r}")
    if len(objects) != scene["objects"]:
        raise ValueError(f"layout gives {len(objects)} objects, the traffic asks {scene['objects']}")
    cam = world.room_camera(scene["res"])
    poses = world.orbit_poses(objects, scene["frames"], scene["orbit_radius"], scene["orbit_arc"])
    rgb, inst, boxes = render(cam, poses, objects, device)
    return dict(objects=objects, cam=cam, poses=poses, rgb=rgb.cpu().numpy(),
                instance=inst.cpu().numpy(), boxes=boxes.cpu().numpy())


def as_frames(sc: dict) -> list[dict]:
    """The frozen writer's frame dicts (stamp, rgb, instance, twc, bboxes)."""
    out = []
    for k, twc in enumerate(sc["poses"]):
        bb = {o.instance_id: (None if sc["boxes"][k, i, 0] < 0
                              else tuple(int(v) for v in sc["boxes"][k, i]))
              for i, o in enumerate(sc["objects"])}
        out.append(dict(stamp=f"{k:06d}.{0:04d}", rgb=sc["rgb"][k], instance=sc["instance"][k],
                        twc=twc, bboxes=bb))
    return out
