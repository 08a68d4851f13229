"""Device-resident keyframe store shared by every object NeRF (counterpart
of romap_tpu/data/frame_store.py).

Pixels and instance masks stay uint8 on the device (converted after the
gather); the host keeps numpy staging buffers and a stamp -> index map, and
`arrays()` updates the device copy incrementally: a changed frame is copied
into its row, a pose rewrite re-uploads only the [F, 4, 4] pose table, and
init, growth or a bulk load re-upload everything.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class FrameArrays(NamedTuple):
    """Device tensors with a fixed frame capacity F (leading axis)."""

    pixels: torch.Tensor  # [F, H, W, 3] uint8 RGB
    depth: torch.Tensor  # [F, H, W] float32 z-depth, or [1, 1, 1] without depth
    instance: torch.Tensor  # [F, H, W] uint8 instance id mask
    poses: torch.Tensor  # [F, 4, 4] float32 Twc
    intrinsics: torch.Tensor  # [4] float32 (fx, fy, cx, cy)

    @property
    def has_depth(self) -> bool:
        return self.depth.ndim == 3 and self.depth.shape[1] > 1


class FrameStore:
    """Host coordinator over FrameArrays on `device`."""

    def __init__(self, capacity: int, h: int, w: int, intrinsics, use_depth: bool,
                 depth_scale: float = 1.0, device="cpu"):
        self.capacity = capacity
        self.h = h
        self.w = w
        self.use_depth = use_depth
        self.depth_scale = depth_scale
        self.device = torch.device(device)
        self.stamp_to_idx: dict[str, int] = {}
        self.count = 0
        self._pixels = np.zeros((capacity, h, w, 3), np.uint8)
        self._depth = (np.zeros((capacity, h, w), np.float32) if use_depth
                       else np.zeros((1, 1, 1), np.float32))
        self._instance = np.zeros((capacity, h, w), np.uint8)
        self._poses = np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1))
        self._intrinsics = np.asarray(intrinsics, np.float32)
        self._dirty_full = True  # init / growth
        self._dirty_frames: set[int] = set()
        self._dirty_poses = False
        self._arrays: FrameArrays | None = None

    def _grow(self, min_capacity: int) -> None:
        """Grow the frame budget by 1.5x (or to min_capacity)."""
        new_cap = max(min_capacity, int(self.capacity * 3 / 2) + 1)
        pad = new_cap - self.capacity

        def grow(a):
            return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)

        self._pixels = grow(self._pixels)
        self._instance = grow(self._instance)
        if self.use_depth:
            self._depth = grow(self._depth)
        eye = np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
        self._poses = np.concatenate([self._poses, eye], axis=0)
        self.capacity = new_cap
        self._dirty_full = True

    def add_frame(self, idx: int, stamp: str, rgb_u8, instance_u8, pose_twc,
                  depth=None) -> None:
        """Stage one keyframe for upload at the next `arrays()`."""
        if idx >= self.capacity:
            self._grow(idx + 1)
        self.stamp_to_idx[stamp] = idx
        self._pixels[idx] = rgb_u8
        self._instance[idx] = instance_u8
        self._poses[idx] = np.asarray(pose_twc, np.float32)
        if self.use_depth and depth is not None:
            self._depth[idx] = np.asarray(depth, np.float32) * self.depth_scale
        self.count = max(self.count, idx + 1)
        self._dirty_frames.add(idx)
        self._dirty_poses = True

    def update_poses(self, start: int, poses) -> None:
        """Rewrite a pose window."""
        poses = np.asarray(poses, np.float32)
        self._poses[start : start + len(poses)] = poses
        self._dirty_poses = True

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A copy on the device (never a view of the staging buffers)."""
        return torch.tensor(a, device=self.device)

    def arrays(self) -> FrameArrays:
        """The device view, updated incrementally (see module docstring)."""
        full = (self._dirty_full or self._arrays is None
                or 2 * len(self._dirty_frames) >= max(self.count, 1))
        if full:
            self._arrays = FrameArrays(
                pixels=self._put(self._pixels), depth=self._put(self._depth),
                instance=self._put(self._instance), poses=self._put(self._poses),
                intrinsics=self._put(self._intrinsics))
        elif self._dirty_frames or self._dirty_poses:
            a = self._arrays
            for idx in sorted(self._dirty_frames):  # in place, row by row
                a.pixels[idx].copy_(self._put(self._pixels[idx]))
                a.instance[idx].copy_(self._put(self._instance[idx]))
                if self.use_depth:
                    a.depth[idx].copy_(self._put(self._depth[idx]))
            if self._dirty_poses:
                a = a._replace(poses=self._put(self._poses))
            self._arrays = a
        self._dirty_full = False
        self._dirty_frames.clear()
        self._dirty_poses = False
        return self._arrays
