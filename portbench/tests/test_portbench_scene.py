"""The card's renderer against the frozen NumPy writer, and the frozen
writer against the program's own (the copy has not drifted)."""

import glob
import json
import os

import numpy as np
import pytest

from portbench import scene
from portbench.frozen import world


@pytest.mark.parametrize("n_objects, arc", [(10, 2 * np.pi), (4, 2 * np.pi), (3, 2.2)])
def test_torch_render_equals_frozen_render(n_objects, arc):
    """room10's ring and full orbit, a ring of four, and the writer's own
    arc."""
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


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    os.path.dirname(scene.__file__), "traffic", "*.json"))), ids=os.path.basename)
def test_no_two_objects_of_a_traffics_room_touch(path):
    """Every room a traffic file asks for holds spheres apart, whatever the
    seed, and the orbit never enters one."""
    with open(path) as f:
        sc = json.load(f)["scene"]
    for seed in (0, 1, 2**31 + 5):
        objs = world.make_scene(sc["objects"], seed=seed)
        for i, a in enumerate(objs):
            for b in objs[i + 1:]:
                assert np.linalg.norm(a.center - b.center) > a.radius + b.radius
        for twc in world.orbit_poses(objs, sc["frames"], sc["orbit_radius"], sc["orbit_arc"]):
            assert all(np.linalg.norm(twc[:3, 3] - o.center) > o.radius for o in objs)
