"""Build a (FrameStore, ObjectsState) pair from a synthetic scene
(counterpart of romap_tpu/data/world.py::build_synthetic_world), on the
numpy scene generator `romap_tpu_torch.data.synthetic` (a copy of
romap_tpu's)."""

from __future__ import annotations

import numpy as np
import torch

from romap_tpu_torch.data.synthetic import Camera, make_scene, make_sequence
from romap_tpu_torch.data.frame_store import FrameStore
from romap_tpu_torch.models.nerf import ObjectsState


def build_synthetic_world(n_objects: int, n_frames: int, res: int,
                          use_depth: bool = False, capacity: int | None = None,
                          seed: int = 0, device="cpu"):
    """Returns (cam, objects, frames, store, objs_state); the store and the
    object table live on `device`."""
    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(n_objects, seed=seed)
    frames = make_sequence(cam, objects, n_frames,
                           radius=2.2 if n_objects == 1 else 5.5, seed=seed)

    store = FrameStore(len(frames), cam.h, cam.w, cam.intrinsics,
                       use_depth=use_depth, device=device)
    for i, f in enumerate(frames):
        store.add_frame(i, f["stamp"], f["rgb"], f["instance"], f["twc"],
                        depth=f["depth"] if use_depth else None)

    capacity = capacity or n_objects
    max_b = len(frames)
    aabb_min = np.zeros((capacity, 3), np.float32)
    aabb_max = np.ones((capacity, 3), np.float32)
    tow = np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1))
    iid = np.zeros(capacity, np.int32)
    bboxes = np.zeros((capacity, max_b, 5), np.int32)
    n_bbox = np.zeros(capacity, np.int32)
    for oi, obj in enumerate(objects):
        half = obj.aabb_half_extents() * 1.1  # ref nerf.cu:170-172 inflation
        aabb_min[oi], aabb_max[oi] = -half, half
        tow[oi, :3, 3] = -obj.center  # world -> object (identity rotation)
        iid[oi] = obj.instance_id
        nb = 0
        for fi, f in enumerate(frames):
            bb = f["bboxes"][obj.instance_id]
            if bb is not None:
                bboxes[oi, nb] = (fi, *bb)
                nb += 1
        n_bbox[oi] = nb
    put = lambda a: torch.from_numpy(a).to(device)
    objs = ObjectsState(
        aabb_min=put(aabb_min), aabb_max=put(aabb_max), tow=put(tow),
        instance_id=put(iid), bboxes=put(bboxes), n_bbox=put(n_bbox),
        active=put(n_bbox > 0),
    )
    return cam, objects, frames, store, objs
