"""The port's own copies of the four romap_tpu modules it needs
(`config`, `data.synthetic`, `data.formats`, `utils.camera`) and of the numpy
function `runtime.pose_refine.build_refine_batch` behave as the originals:
equal configs, bit-equal scenes, datasets that each side's reader reads
back from either side's writer, equal camera math and equal pixel batches.
The dataset writers of `data.world` and every function of
`utils.eval_psnr` are the reference's source with only the imports changed
(`romap_tpu.` -> `romap_tpu_torch.`); tests/test_torch_world.py holds the
writers' output byte for byte."""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

from romap_tpu import config as jcfg
from romap_tpu.data import formats as jformats
from romap_tpu.data import synthetic as jsyn
from romap_tpu.data import world as jworld
from romap_tpu.runtime import pose_refine as jpr
from romap_tpu.utils import camera as jcam
from romap_tpu.utils import eval_psnr as jeval
from romap_tpu_torch import config as tcfg
from romap_tpu_torch.data import formats as tformats
from romap_tpu_torch.data import synthetic as tsyn
from romap_tpu_torch.data import world as tworld
from romap_tpu_torch.ops import mlp as tmlp
from romap_tpu_torch.runtime import pose_refine as tpr
from romap_tpu_torch.utils import camera as tcam
from romap_tpu_torch.utils import eval_psnr as teval

REFERENCE_JSON = {  # the schema of the reference's Core/configs/base.json
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.9, "nested": {
        "otype": "ExponentialDecay", "decay_start": 1000, "decay_interval": 500,
        "decay_base": 0.5, "nested": {"otype": "Adam", "learning_rate": 0.02, "beta1": 0.8,
                                      "beta2": 0.95, "epsilon": 1e-12, "l2_reg": 1e-5}}},
    "encoding": {"otype": "HashGrid", "n_levels": 12, "n_features_per_level": 4,
                 "log2_hashmap_size": 17, "base_resolution": 8},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 32, "n_hidden_layers": 2},
}


# the port's own config fields that the JAX config does not have, by
# section: instant-ngp's view branch and NeuS2's SDF field and its loss
# terms; at these values the field is RO-MAP's head (one 64 x 1 head, 4
# outputs, no direction), a density field, and the SDF's terms are unread
PORT_OWN_DEFAULTS = {
    "network": dict(sh_degree=0, rgb_n_neurons=64, rgb_n_hidden_layers=2, field="density",
                    init_variance=0.3, appearance_dims=32, appearance_frames=0,
                    proposal_levels=5, proposal_features=2, proposal_log2_hashmap_size=17,
                    proposal_base_resolution=16, proposal_max_resolutions=(128, 256),
                    proposal_n_neurons=16, proposal_n_hidden_layers=1),
    "train": dict(eikonal_lambda=0.1, cos_anneal_end=50000, proposal_samples=(256, 96),
                  interlevel_lambda=1.0, distortion_lambda=0.002),
}


def _jax_fields(got, want) -> dict:
    """The port's config as a dict of the fields the JAX config has; the
    port's own fields must sit at the defaults that mean RO-MAP's head."""
    d = dataclasses.asdict(got)
    for part, defaults in PORT_OWN_DEFAULTS.items():
        theirs = dataclasses.asdict(want)[part]
        own = {k: d[part].pop(k) for k in set(d[part]) - set(theirs)}
        assert own == defaults, part
    assert not tmlp.view_dependent(got.network)
    return d


@pytest.mark.parametrize("preset", [None, "flagship", "fast", "quality", "tcnn"])
def test_config_equals_jax(preset):
    if preset is None:
        got, want = tcfg.NerfConfig(), jcfg.NerfConfig()
    else:
        got = tcfg.NerfConfig(encoding=tcfg.EncodingConfig.preset(preset))
        want = jcfg.NerfConfig(encoding=jcfg.EncodingConfig.preset(preset))
    assert _jax_fields(got, want) == dataclasses.asdict(want)
    assert got.encoding.plane_specs == want.encoding.plane_specs
    assert got.encoding.n_output_dims == want.encoding.n_output_dims
    assert got.encoding.per_level_scale == want.encoding.per_level_scale


def test_load_network_config_equals_jax(tmp_path):
    path = tmp_path / "base.json"
    path.write_text(json.dumps(REFERENCE_JSON))
    got, want = tcfg.load_network_config(str(path)), jcfg.load_network_config(str(path))
    assert _jax_fields(got, want) == dataclasses.asdict(want)
    assert got.optimizer.decay_start == 1000 and got.network.n_hidden_layers == 2
    with pytest.raises(ValueError):
        tcfg.EncodingConfig.preset("no such preset")


@pytest.mark.parametrize("n_objects,seed", [(1, 0), (3, 2)])
def test_scene_and_sequence_bit_equal(n_objects, seed):
    cam_args = dict(fx=40.0, fy=40.0, cx=24.0, cy=24.0, h=48, w=48)
    got_objs = tsyn.make_scene(n_objects, seed=seed)
    want_objs = jsyn.make_scene(n_objects, seed=seed)
    assert [type(o).__name__ for o in got_objs] == [type(o).__name__ for o in want_objs]
    for g, w in zip(got_objs, want_objs):
        np.testing.assert_array_equal(g.center, w.center)
        np.testing.assert_array_equal(g.aabb_half_extents(), w.aabb_half_extents())
    got = tsyn.make_sequence(tsyn.Camera(**cam_args), got_objs, 5, seed=seed)
    want = jsyn.make_sequence(jsyn.Camera(**cam_args), want_objs, 5, seed=seed)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and g["stamp"] == w["stamp"] and g["bboxes"] == w["bboxes"]
        for k in ("rgb", "depth", "instance", "twc"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dataset_written_by_either_reads_back_in_both(tmp_path, writer):
    cam = jsyn.Camera(fx=30.0, fy=30.0, cx=16.0, cy=16.0, h=32, w=32)
    objects = jsyn.make_scene(2, seed=1)
    frames = jsyn.make_sequence(cam, objects, 4, radius=5.5, seed=1)
    write = jformats.write_dataset if writer == "jax" else tformats.write_dataset
    root = str(tmp_path / "ds")
    write(root, cam, frames, objects=objects, use_depth=True)
    metas = [m.load_dataset_meta(root, use_depth=True) for m in (jformats, tformats)]
    for a, b in zip(dataclasses.astuple(metas[0]), dataclasses.astuple(metas[1])):
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b
    for i in range(len(frames)):
        got = tformats.load_frame_images(metas[1], i, use_depth=True)
        want = jformats.load_frame_images(metas[0], i, use_depth=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], frames[i]["rgb"])
    for oi in range(len(objects)):
        path = os.path.join(root, "obj_offline", f"{oi}.txt")
        got, want = tformats.load_object_file(path), jformats.load_object_file(path)
        for a, b in zip(dataclasses.astuple(got), dataclasses.astuple(want)):
            np.testing.assert_array_equal(a, b)


def test_camera_functions_agree():
    rng = np.random.default_rng(4)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r_t, r_j = tcam.quat_to_rot(*q), jcam.quat_to_rot(*q)
        np.testing.assert_array_equal(r_t, r_j)
        np.testing.assert_array_equal(tcam.rot_to_quat(r_t), jcam.rot_to_quat(r_j))
        t = rng.normal(size=3)
        m_t, m_j = tcam.pose_from_tq(t, q), jcam.pose_from_tq(t, q)
        np.testing.assert_array_equal(m_t, m_j)
        np.testing.assert_array_equal(tcam.invert_pose(m_t), jcam.invert_pose(m_j))
        np.testing.assert_allclose(tcam.invert_pose(m_t) @ m_t, np.eye(4), atol=1e-5)


@pytest.mark.parametrize("case", ["mixed", "no_background", "too_few", "five_views"])
def test_build_refine_batch_equals_jax(case):
    """Equal arrays (or both None) for crops with object and background
    pixels, an all-object crop, one with fewer than 32 object pixels, and 5
    views (padded to 8)."""
    rng = np.random.default_rng(7)
    n_views = 5 if case == "five_views" else 2
    boxes, crops = [], []
    for i in range(n_views):
        h, w = 12 + i, 10 + 2 * i
        mask = (rng.random((h, w)) < 0.6).astype(np.uint8) * 255
        if case == "no_background":
            mask[:] = 255
        if case == "too_few":
            mask[:] = 0
            mask[0, :5] = 255
        boxes.append((3 * i, 2 * i, h, w))
        crops.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8), mask))
    got = tpr.build_refine_batch(boxes, crops, n_px=60, seed=3)
    want = jpr.build_refine_batch(boxes, crops, n_px=60, seed=3)
    if case == "too_few":
        assert got is None and want is None
        return
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


WORLD_WRITERS = ("_shift_mask", "degrade_frames", "_write_gt_sidecar", "write_adversarial_dataset",
                 "rewrite_gt_sidecar", "_adversarial_objects", "write_room_dataset")


def functions_of(module) -> list[str]:
    return sorted(n for n, f in vars(module).items()
                  if inspect.isfunction(f) and f.__module__ == module.__name__)


def as_port_source(fn) -> str:
    """The reference function's source with its imports moved to the port."""
    return inspect.getsource(fn).replace("romap_tpu.", "romap_tpu_torch.")


@pytest.mark.parametrize("name", WORLD_WRITERS)
def test_world_writer_is_the_reference_source(name):
    assert inspect.getsource(getattr(tworld, name)) == as_port_source(getattr(jworld, name))


def test_world_module_holds_every_reference_function():
    assert tworld.ADVERSARIAL_SCENES == jworld.ADVERSARIAL_SCENES
    assert functions_of(tworld) == functions_of(jworld)
    assert set(WORLD_WRITERS) | {"build_synthetic_world"} == set(functions_of(jworld))


@pytest.mark.parametrize("name", functions_of(jeval))
def test_eval_psnr_function_is_the_reference_source(name):
    assert inspect.getsource(getattr(teval, name)) == as_port_source(getattr(jeval, name))


def test_eval_psnr_module_holds_every_reference_function():
    assert functions_of(teval) == functions_of(jeval)
    assert "romap_tpu_torch.utils.mesh_io" in inspect.getsource(teval._mesh_metrics)
