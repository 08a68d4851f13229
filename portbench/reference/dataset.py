"""The reference's reader of a dataset directory in the reference system's
layout (config.yaml, img.txt, groundtruth.txt, rgb/ and instance/ PNGs,
obj_offline/<i>.txt): frames and the object table, as RO-MAP's
OfflineNeRF reads them (`Core/src/nerf_data.cu`, `Core/src/nerf.cu`
ReadBboxOffline). NumPy and OpenCV; nothing of the program.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch


def _rows(path: str) -> list[list[str]]:
    with open(path) as f:
        return [ln.split() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]


def _rotation(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    x, y, z, w = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _pose(vals) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = _rotation(*vals[3:7])
    m[:3, 3] = vals[0:3]
    return m


def read(root: str, device) -> tuple[dict, list[dict]]:
    """(frames, objects): frames {pixels [F, H, W, 3] u8 RGB, instance
    [F, H, W] u8, poses [F, 4, 4] Twc, intrinsics [4]}; objects, one dict
    each (slot, aabb_min/max, tow, instance_id, bboxes [B, 5], n_bbox,
    active), on `device`."""
    import cv2

    cam = {}
    with open(os.path.join(root, "config.yaml")) as f:
        for ln in f:
            if ":" in ln and not ln.startswith("%"):
                k, v = ln.split(":", 1)
                cam[k.strip()] = v.strip()
    intr = np.array([float(cam[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy")], np.float32)
    names = _rows(os.path.join(root, "img.txt"))
    stamp_idx = {r[0]: i for i, r in enumerate(names)}
    poses = np.stack([_pose([float(v) for v in r[1:8]])
                      for r in _rows(os.path.join(root, "groundtruth.txt"))])
    rgb = np.stack([cv2.cvtColor(cv2.imread(os.path.join(root, "rgb", r[1]), cv2.IMREAD_COLOR),
                                 cv2.COLOR_BGR2RGB) for r in names])
    inst = np.stack([cv2.imread(os.path.join(root, "instance", r[1]), cv2.IMREAD_UNCHANGED)
                     for r in names]).astype(np.uint8)
    put = lambda a: torch.as_tensor(a, device=device)
    frames = dict(pixels=put(rgb), instance=put(inst), poses=put(poses), intrinsics=put(intr))
    objects = []
    for slot, path in enumerate(sorted(glob.glob(os.path.join(root, "obj_offline", "*.txt")))):
        rows = _rows(path)
        head = [float(v) for v in rows[0]]
        two = _pose(head[1:8])
        tow = np.eye(4, dtype=np.float32)
        tow[:3, :3] = two[:3, :3].T
        tow[:3, 3] = -two[:3, :3].T @ two[:3, 3]
        half = np.array(head[8:11], np.float32)
        boxes = [(stamp_idx[r[0]], *(int(float(v)) for v in r[1:5]))
                 for r in rows[1:] if r[0] in stamp_idx]
        boxes = np.asarray(boxes, np.int32).reshape(-1, 5)
        objects.append(dict(slot=slot, aabb_min=put(-half), aabb_max=put(half), tow=put(tow),
                            instance_id=int(head[0]), bboxes=put(boxes), n_bbox=len(boxes),
                            active=len(boxes) > 0))
    return frames, objects
