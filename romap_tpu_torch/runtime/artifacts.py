"""Evaluation artifacts, the reference's output contract (counterpart of
romap_tpu/runtime/artifacts.py; same files, names, manifests and scaling).

Per object:
  <out>/<objId>/test_img/<stamp>.png       rendered RGB (u8)
  <out>/<objId>/test_depth/<stamp>.png     depth x 20000 as 16-bit
  <out>/<objId>/test_mask/<stamp>.png      mask x 255 (u8)
  <out>/<objId>/video_img|video_depth/i.png  360-orbit renders (half-res
                                             center crop, 60 poses, phi=30)
  <out>/<objId>/test.txt                   held-out view manifest
                                           (object-centric poses)
  <out>/<objId>/train.txt                  training bbox manifest
  <out>/<objId>/obj.ply (+ obj.obj/.mtl/.tga)  marching-cubes mesh
"""

from __future__ import annotations

import os

import numpy as np
import torch

from romap_tpu_torch.utils.camera import rot_to_quat
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import marching_cubes as mc
from romap_tpu_torch.runtime.renderer import orbit_poses, render_view
from romap_tpu_torch.utils import tracing
from romap_tpu_torch.utils.mesh_io import save_obj, save_ply


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _imwrite_rgb(path: str, rgb01: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, cv2.cvtColor(
        np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR
    ))


def _imwrite_depth16(path: str, depth: np.ndarray) -> None:
    import cv2

    # x20000 "looks obvious" (ref nerf.cu:343-345)
    cv2.imwrite(path, np.clip(depth * 20000.0, 0, 65535).astype(np.uint16))


def _imwrite_mask(path: str, mask: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, np.clip(mask * 255.0, 0, 255).astype(np.uint8))


def extract_object_mesh(params_one, aabb_min, aabb_max, cfg, spec) -> mc.Mesh:
    """Density grid (on the params' device) -> marching cubes -> 1-ring
    normals -> vertex colours at the warped vertices. An SDF field meshes
    its zero level (`density_on_grid` gives -f) and colours each vertex
    from its own normal (`colors_at_points`)."""
    res = cfg.train.mc_resolution
    box_min, box_max = _np(aabb_min), _np(aabb_max)
    with tracing.span("mesh.density"):
        density = nerf.density_on_grid(params_one, cfg, spec, res)
    with tracing.span("mesh.march"):
        mesh = mc.compute_normals(mc.marching_cubes(density, box_min, box_max, res,
                                                    cfg.train.mc_threshold))
    tracing.count("mesh.verts", len(mesh.verts))
    tracing.count("mesh.faces", len(mesh.faces))
    if len(mesh.verts) > 0:
        with tracing.span("mesh.colors"):
            warped = (mesh.verts - box_min) / (box_max - box_min)
            pts = torch.as_tensor(warped, dtype=torch.float32).to(density.device)
            colors = nerf.colors_at_points(params_one, pts, cfg, spec, mesh.normals,
                                           extent=box_max - box_min).cpu().numpy()
        mesh = mesh._replace(colors=colors)
    return mesh


def render_test_artifacts(
    out_path: str,
    obj_id: int,
    params_one,
    intrinsics: np.ndarray,
    tow: np.ndarray,
    aabb_min,
    aabb_max,
    img_hw: tuple[int, int],
    test_views: list[dict],  # {stamp, twc, box(x,y,h,w)}
    train_views: list[dict],  # {stamp, twc, box}
    obj_class: int,
    radius: float,
    cfg,
    spec,
    video: bool = True,
    unwrap_obj: bool = True,
) -> str:
    """Write the full per-object artifact tree; returns the object dir."""
    base = os.path.join(out_path, str(obj_id))
    for sub in ("test_img", "test_depth", "test_mask", "video_img", "video_depth"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    # --- held-out test views ------------------------------------------------
    with open(os.path.join(base, "test.txt"), "w") as f:
        f.write("#stamp  box.x  box.y  box.h  box.w  tx  ty  tz  qx  qy  qz  qw (object-centric)\n")
        for view in test_views:
            stamp, twc, box = view["stamp"], view["twc"], view["box"]
            toc = tow @ twc
            q = rot_to_quat(toc[:3, :3])
            t = toc[:3, 3]
            x, y, h, w = box
            f.write(
                f"{stamp} {x} {y} {h} {w} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )
            rgb, depth, mask = render_view(
                params_one, intrinsics, twc, tow, aabb_min, aabb_max, box, cfg, spec
            )
            _imwrite_rgb(os.path.join(base, "test_img", f"{stamp}.png"), rgb)
            _imwrite_depth16(os.path.join(base, "test_depth", f"{stamp}.png"), depth)
            _imwrite_mask(os.path.join(base, "test_mask", f"{stamp}.png"), mask)

    # --- training manifest ----------------------------------------------------
    with open(os.path.join(base, "train.txt"), "w") as f:
        f.write("#class Bbox\n")
        bb = _np(aabb_max)
        f.write(f"{obj_class} {bb[0]:.6f} {bb[1]:.6f} {bb[2]:.6f} \n")
        f.write("#stamp box.x box.y box.h box.w  tx  ty  tz  qx  qy  qz  qw (object-centric)\n")
        for view in train_views:
            stamp, twc, box = view["stamp"], view["twc"], view["box"]
            toc = tow @ twc
            q = rot_to_quat(toc[:3, :3])
            t = toc[:3, 3]
            x, y, h, w = box
            f.write(
                f"{stamp} {x} {y} {h} {w} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )

    # --- 360 orbit video -------------------------------------------------------
    if video:
        h_img, w_img = img_hw
        box = (w_img // 4, h_img // 4, h_img // 2, w_img // 2)  # half-res crop
        for i, toc in enumerate(orbit_poses(60, 30.0, radius)):
            # toc is object->? — GenerateRenderVideoRays uses it directly as
            # camera->object, so pass identity tow and toc as the pose.
            rgb, depth, mask = render_view(
                params_one, intrinsics, toc, np.eye(4, dtype=np.float32),
                aabb_min, aabb_max, box, cfg, spec,
            )
            _imwrite_rgb(os.path.join(base, "video_img", f"{i}.png"), rgb)
            _imwrite_depth16(os.path.join(base, "video_depth", f"{i}.png"), depth)

    # --- mesh -------------------------------------------------------------------
    mesh = extract_object_mesh(params_one, aabb_min, aabb_max, cfg, spec)
    save_ply(mesh, os.path.join(base, "obj.ply"))
    if unwrap_obj and len(mesh.faces):
        # UV-unwrapped OBJ + mtl + baked TGA atlas (ref save_mesh unwrap_it,
        # marching_cubes.cu:522-650)
        save_obj(mesh, os.path.join(base, "obj.obj"), unwrap=True)
    return base
