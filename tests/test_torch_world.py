"""The port's dataset writers (`romap_tpu_torch.data.world`) against
romap_tpu's on the CPU: the room sequence and every adversarial scene write
the same files with the same bytes for two seeds, `rewrite_gt_sidecar`
rewrites the same sidecar, and `degrade_frames` degrades the same frames
alike for the same generator."""

import copy
import os

import numpy as np
import pytest

from romap_tpu.data import synthetic as jsyn
from romap_tpu.data import world as jworld
from romap_tpu_torch.data import world as tworld

N_FRAMES, RES = 3, 48
SEEDS = (0, 3)


def tree_bytes(root: str) -> dict[str, bytes]:
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def assert_same_tree(got: str, want: str) -> None:
    a, b = tree_bytes(got), tree_bytes(want)
    assert sorted(a) == sorted(b)
    assert len(a) > 0
    for k in b:
        assert a[k] == b[k], k


@pytest.mark.parametrize("seed", SEEDS)
def test_room_dataset_bytes_equal_reference(tmp_path, seed):
    got, want = str(tmp_path / "torch"), str(tmp_path / "jax")
    tworld.write_room_dataset(got, n_frames=N_FRAMES, res=RES, seed=seed)
    jworld.write_room_dataset(want, n_frames=N_FRAMES, res=RES, seed=seed)
    assert_same_tree(got, want)
    assert os.path.isfile(os.path.join(got, "gt_objects.json"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scene", jworld.ADVERSARIAL_SCENES)
def test_adversarial_dataset_bytes_equal_reference(tmp_path, scene, seed):
    got, want = str(tmp_path / "torch"), str(tmp_path / "jax")
    tworld.write_adversarial_dataset(got, scene, n_frames=N_FRAMES, res=RES, seed=seed)
    jworld.write_adversarial_dataset(want, scene, n_frames=N_FRAMES, res=RES, seed=seed)
    assert_same_tree(got, want)
    # the sidecar alone, rewritten in place, is the reference's again
    os.remove(os.path.join(got, "gt_objects.json"))
    tworld.rewrite_gt_sidecar(got, scene, seed=seed)
    assert_same_tree(got, want)


def test_unknown_adversarial_scene_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown adversarial scene"):
        tworld.write_adversarial_dataset(str(tmp_path / "d"), "no such scene")


@pytest.mark.parametrize("knobs", [
    dict(mask_noise=2, det_jitter=4, det_dropout=0.4),
    dict(exposure=0.25, mask_noise=1),
])
def test_degrade_frames_equals_reference(knobs):
    cam = jsyn.Camera(fx=40.0, fy=40.0, cx=24.0, cy=24.0, h=RES, w=RES)
    frames = jsyn.make_sequence(cam, jsyn.make_scene(2, seed=1), 6, radius=5.5, seed=1)
    got, want = copy.deepcopy(frames), copy.deepcopy(frames)
    tworld.degrade_frames(got, np.random.default_rng(5), **knobs)
    jworld.degrade_frames(want, np.random.default_rng(5), **knobs)
    changed = False
    for g, w, f in zip(got, want, frames):
        assert g["bboxes"] == w["bboxes"]
        for k in ("rgb", "instance"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
            changed |= not np.array_equal(g[k], f[k])
        changed |= g["bboxes"] != f["bboxes"]
    assert changed  # the knobs did degrade something
