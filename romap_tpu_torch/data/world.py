"""Synthetic worlds for the port (counterpart of romap_tpu/data/world.py).

`build_synthetic_world` builds a (FrameStore, ObjectsState) pair on a device
from the numpy scene generator `romap_tpu_torch.data.synthetic` (a copy of
romap_tpu's). The dataset writers below it (`write_room_dataset`,
`write_adversarial_dataset`, `rewrite_gt_sidecar`, `degrade_frames` and their
helpers) write the on-disk sequences the SLAM frontend `native/build/mono_tum`
reads; they are numpy only and copies of the reference's, with only their
imports changed (held by tests/test_torch_port_copies.py and
tests/test_torch_world.py).
"""

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


def _shift_mask(m: np.ndarray, dilate: bool) -> np.ndarray:
    """One 4-neighborhood binary dilation/erosion step (no scipy needed)."""
    n = [np.roll(m, s, a) for a in (0, 1) for s in (1, -1)]
    # rolled-in wraparound rows/cols must not leak mask across the border
    n[0][0, :] = n[1][-1, :] = False
    n[2][:, 0] = n[3][:, -1] = False
    if dilate:
        return m | n[0] | n[1] | n[2] | n[3]
    return m & n[0] & n[1] & n[2] & n[3]


def degrade_frames(frames: list[dict], rng, mask_noise: int = 0,
                   det_jitter: int = 0, det_dropout: float = 0.0,
                   exposure: float = 0.0) -> None:
    """In-place detector/photometric degradations — the failure modes the
    reference's real scenes exercise (ref src/Tracking.cc:393-469 is mostly
    detector-noise armor) and that clean synthetic masks never stress:

      mask_noise   — per-frame random erosion OR dilation of each instance
                     mask by 1..mask_noise px (imperfect segmentation)
      det_jitter   — uniform +-px jitter on every detection box edge
      det_dropout  — probability a frame loses ALL detections (detector miss)
      exposure     — sinusoidal gain drift amplitude (auto-exposure wander)
    """
    n = len(frames)
    h = w = None
    for k, fr in enumerate(frames):
        if exposure > 0:
            gain = 1.0 + exposure * np.sin(2 * np.pi * 1.5 * k / max(n, 1))
            fr["rgb"] = np.clip(
                fr["rgb"].astype(np.float32) * gain, 0, 255).astype(np.uint8)
        if mask_noise > 0:
            inst = fr["instance"]
            for iid in np.unique(inst):
                if iid == 0:
                    continue
                m = inst == iid
                steps = int(rng.integers(1, mask_noise + 1))
                dilate = bool(rng.random() < 0.5)
                m2 = m
                for _ in range(steps):
                    m2 = _shift_mask(m2, dilate)
                inst = np.where(m & ~m2, 0, inst)
                inst = np.where(m2 & (inst == 0), np.uint8(iid), inst)
            fr["instance"] = inst
        if det_dropout > 0 and rng.random() < det_dropout:
            fr["bboxes"] = {iid: None for iid in fr["bboxes"]}
            continue
        if det_jitter > 0:
            h, w = fr["instance"].shape
            jit = {}
            for iid, bb in fr["bboxes"].items():
                if bb is None:
                    jit[iid] = None
                    continue
                x, y, bh, bw = bb
                j = lambda: int(rng.integers(-det_jitter, det_jitter + 1))
                x, y = max(0, x + j()), max(0, y + j())
                bh = max(4, bh + j())
                bw = max(4, bw + j())
                bh, bw = min(bh, h - y), min(bw, w - x)
                jit[iid] = (x, y, bh, bw) if bh >= 4 and bw >= 4 else None
            fr["bboxes"] = jit


def _write_gt_sidecar(root: str, objs, seed: int = 0) -> None:
    """GT geometry sidecar (not part of the reference layout — consumed by
    the eval harness): center/radius for spheres, plus kind, tight AABB
    half-extents, and object-frame surface samples so the chamfer mesh
    metric can score NON-sphere geometry."""
    import json
    import os

    rng = np.random.default_rng(seed + 101)
    out = {}
    for i, o in enumerate(objs):
        entry = {"center": [float(c) for c in o.center],
                 "radius": float(o.radius),
                 "kind": type(o).__name__,
                 "half_extents": [float(h) for h in o.aabb_half_extents()]}
        if hasattr(o, "gt_cuboid"):
            # minimal yaw-aligned cuboid — what the SLAM object layer
            # estimates; half_extents above is the WORLD AABB, which for
            # yawed geometry is inflated and would bias ext_ratio even for
            # a perfect estimate
            cc, ch, cy = o.gt_cuboid()
            entry["cuboid_center"] = [float(x) for x in cc]
            entry["cuboid_half_extents"] = [float(x) for x in ch]
            entry["cuboid_yaw"] = float(cy)
        if hasattr(o, "surface_points"):
            entry["surface_points"] = np.round(
                o.surface_points(1024, rng), 5).tolist()
        out[str(i)] = entry
    with open(os.path.join(root, "gt_objects.json"), "w") as f:
        json.dump(out, f)


ADVERSARIAL_SCENES = ("concave", "boxnoise", "compound", "exposure")


def write_adversarial_dataset(root: str, scene: str, n_frames: int = 80,
                              res: int = 480, seed: int = 0) -> None:
    """Adversarial variants of the room sequence (VERDICT r4 next #2) —
    non-sphere geometry and detector/photometric noise, standing in for the
    reference's real scene1/scene2 this environment cannot download
    (ref README.md:61-66):

      concave  — L-shaped two-box compound (concave silhouette), clean
      boxnoise — yawed box + mask erosion/dilation(2px) + bbox jitter(4px)
                 + 15% detection-dropout frames
      compound — box pedestal + sphere cap (mixed curvature), mild mask noise
      exposure — sphere + sinusoidal exposure drift (25%) + 1px mask noise
    """
    from romap_tpu_torch.data.formats import write_dataset
    from romap_tpu_torch.data.synthetic import Camera, Room, make_sequence

    obj, degrade = _adversarial_objects(scene, seed)
    cam = Camera(fx=res * 0.95, fy=res * 0.95, cx=res * 2 / 3, cy=res / 2,
                 h=res, w=int(res * 4 / 3))
    frames = make_sequence(cam, [obj], n_frames, radius=2.4, room=Room(),
                           arc=2.2)
    if degrade:
        degrade_frames(frames, np.random.default_rng(seed + 13), **degrade)
    write_dataset(root, cam, frames, objects=[obj], use_depth=True)
    _write_gt_sidecar(root, [obj], seed)


def rewrite_gt_sidecar(root: str, scene: str, seed: int = 0) -> None:
    """Regenerate ONLY gt_objects.json for an existing adversarial dataset
    (object construction is seed-deterministic) — lets sidecar-format
    upgrades re-score completed runs without re-rendering frames."""
    obj, _ = _adversarial_objects(scene, seed)
    _write_gt_sidecar(root, [obj], seed)


def _adversarial_objects(scene: str, seed: int):
    from romap_tpu_torch.data.synthetic import BoxObject, CompoundObject, SphereObject

    rng = np.random.default_rng(seed + 7)
    col = lambda: rng.uniform(0.35, 1.0, 3)
    degrade = {}
    if scene == "concave":
        obj = CompoundObject([
            BoxObject(center=np.array([0.0, 0.0, -0.28]),
                      half=np.array([0.55, 0.26, 0.16]), yaw=0.35,
                      instance_id=1, base_color=col()),
            BoxObject(center=np.array([-0.33, 0.1, 0.22]),
                      half=np.array([0.2, 0.26, 0.36]), yaw=0.35,
                      instance_id=1, base_color=col()),
        ], instance_id=1)
    elif scene == "boxnoise":
        obj = BoxObject(center=np.zeros(3), half=np.array([0.5, 0.36, 0.3]),
                        yaw=0.5, instance_id=1, base_color=col())
        degrade = dict(mask_noise=2, det_jitter=4, det_dropout=0.15)
    elif scene == "compound":
        obj = CompoundObject([
            BoxObject(center=np.array([0.0, 0.0, -0.3]),
                      half=np.array([0.42, 0.42, 0.13]), yaw=0.0,
                      instance_id=1, base_color=col()),
            SphereObject(center=np.array([0.0, 0.0, 0.12]), radius=0.34,
                         instance_id=1, base_color=col()),
        ], instance_id=1)
        degrade = dict(mask_noise=1)
    elif scene == "exposure":
        obj = SphereObject(center=np.zeros(3), radius=0.6, instance_id=1,
                           base_color=col())
        degrade = dict(exposure=0.25, mask_noise=1)
    else:
        raise ValueError(f"unknown adversarial scene {scene!r}; "
                         f"options: {ADVERSARIAL_SCENES}")
    return obj, degrade


def write_room_dataset(root: str, n_frames: int = 80, res: int = 480,
                       n_objects: int = 1, seed: int = 0) -> None:
    """The canonical synthetic 'room' sequence for the online pipeline:
    textured box room + hash-noise spheres, partial orbit (stable monocular
    geometry), written in the reference's on-disk layout including
    bbox/<stamp>.txt detections, instance masks and GT depth."""
    import numpy as np

    from romap_tpu_torch.data.formats import write_dataset
    from romap_tpu_torch.data.synthetic import Camera, Room, make_scene, make_sequence

    cam = Camera(fx=res * 0.95, fy=res * 0.95, cx=res * 2 / 3, cy=res / 2,
                 h=res, w=int(res * 4 / 3))
    objs = make_scene(n_objects, seed=seed)
    if n_objects == 1:
        objs[0].radius = 0.6
    frames = make_sequence(cam, objs, n_frames, radius=2.4, room=Room(),
                           arc=2.2)
    write_dataset(root, cam, frames, objects=objs, use_depth=True)
    _write_gt_sidecar(root, objs, seed)
