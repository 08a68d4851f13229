"""Port FrameStore vs romap_tpu's: the device view after adds past the
capacity (growth), a pose-window rewrite and an incremental frame update
must hold the same arrays, with uint8 pixels and masks."""

import numpy as np
import torch

from romap_tpu.data.frame_store import FrameStore as JStore
from romap_tpu_torch.data.frame_store import FrameStore as TStore

torch.set_num_threads(2)


def frame(rng, h, w):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = q, rng.normal(size=3)
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 4, (h, w), dtype=np.uint8), pose,
            rng.uniform(0.5, 3, (h, w)).astype(np.float32))


def assert_same(t, j):
    for name in ("pixels", "depth", "instance", "poses", "intrinsics"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert t.has_depth == j.has_depth


def test_frame_store_growth_pose_rewrite_and_incremental_updates():
    rng = np.random.default_rng(0)
    h, w = 6, 5
    intr = [5.0, 5.0, 2.5, 3.0]
    stores = [TStore(2, h, w, intr, use_depth=True, depth_scale=0.5),
              JStore(2, h, w, intr, use_depth=True, depth_scale=0.5)]
    frames = [frame(rng, h, w) for _ in range(6)]

    def add(i):
        rgb, inst, pose, depth = frames[i]
        for s in stores:
            s.add_frame(i, f"{i:06d}", rgb, inst, pose, depth=depth)

    for i in range(4):  # past the capacity of 2: grows
        add(i)
    t, j = (s.arrays() for s in stores)
    assert stores[0].capacity == stores[1].capacity >= 4
    assert t.pixels.dtype == torch.uint8 and t.instance.dtype == torch.uint8
    assert_same(t, j)

    new_poses = np.stack([frame(rng, h, w)[2] for _ in range(2)])
    for s in stores:
        s.update_poses(1, new_poses)
    assert_same(*(s.arrays() for s in stores))

    add(1)  # one changed frame: copied into its row in place
    assert_same(*(s.arrays() for s in stores))
    assert stores[0].stamp_to_idx == stores[1].stamp_to_idx
    assert stores[0].count == stores[1].count == 4
