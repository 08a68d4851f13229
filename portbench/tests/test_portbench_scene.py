"""The card's renderer against the frozen NumPy writer, and the frozen
writer against the program's own (the copy has not drifted)."""

import numpy as np
import pytest

from portbench import scene
from portbench.frozen import world


@pytest.mark.parametrize("n_objects, arc", [(4, 2 * np.pi), (3, 2.2)])
def test_torch_render_equals_frozen_render(n_objects, arc):
    """room4's ring and full orbit, and the writer's own arc."""
    cam = world.room_camera(36)
    objs = world.make_scene(n_objects, seed=9)
    poses = world.orbit_poses(objs, 5, 2.4, arc)
    rgb, inst, boxes = scene.render(cam, poses, objs, "cpu", chunk=2)
    for k, twc in enumerate(poses):
        r, _, i = world.render_frame(cam, twc, objs, room=world.Room())
        assert np.array_equal(i, inst[k].numpy())
        # float64 in another order: a texel's floor may flip at a block's edge
        assert np.mean(np.any(r != rgb[k].numpy(), axis=-1)) < 2e-3
        for j, o in enumerate(objs):
            bb = world.instance_bbox(i, o.instance_id)
            assert (bb is None and boxes[k, j, 0] == -1) or bb == tuple(boxes[k, j].tolist())


def test_frozen_writer_equals_the_programs():
    from romap_tpu_torch.data import synthetic
    cam = world.room_camera(30)
    ours = world.make_sequence(cam, world.make_scene(3, seed=4), 3, radius=2.4, room=world.Room())
    cam_p = synthetic.Camera(cam.fx, cam.fy, cam.cx, cam.cy, cam.h, cam.w)
    theirs = synthetic.make_sequence(cam_p, synthetic.make_scene(3, seed=4), 3, radius=2.4,
                                     room=synthetic.Room(), arc=2.2)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a["rgb"], b["rgb"]) and np.array_equal(a["instance"], b["instance"])
        assert np.array_equal(a["twc"], b["twc"]) and a["bboxes"] == b["bboxes"]
