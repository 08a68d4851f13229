"""A field that the harness has never seen, written here: two MLPs, a view
direction input, leaves nested under `mlp`. It comes in through a
configuration's `"reference"` alone, and the harness's leaves, counts and
`check.follow` take it as they take RO-MAP's field."""

import json
import math
import os
import sys
import types

import pytest
import torch

from conftest import ROOT, TINY_CONFIG
from portbench import check, counts, program, registry
from portbench.frozen import work
from portbench.reference import encodings, train
from portbench.reference.precision import FP32

HIDDEN, GEO = 16, 5  # the toy's widths: density net 8 -> 16 -> GEO, colour net


def _dir_features(dirs):
    """A degree-1 direction encoding: 1, x, y, z."""
    return torch.cat([torch.ones_like(dirs[:, :1]), dirs], dim=-1)


def _leaf_shapes(cfg):
    e = encodings.out_dims(cfg["encoding"])
    shapes = encodings.leaf_shapes(cfg["encoding"])
    shapes.update({"density.w0": (e, HIDDEN), "density.w1": (HIDDEN, GEO),
                   "rgb.w0": (GEO + 4, HIDDEN), "rgb.w1": (HIDDEN, 3)})
    return shapes


def _forward(w, pts, dirs, cfg, q, c):
    s = pts.shape[1]
    h = encodings.encode(w, pts.reshape(-1, 3), cfg["encoding"], q, c)
    geo = q(torch.relu(h @ q(w["density.w0"]))) @ q(w["density.w1"])
    d = _dir_features(dirs)[:, None, :].expand(-1, s, -1).reshape(-1, 4)
    rgb = q(torch.relu(torch.cat([geo, d], -1) @ q(w["rgb.w0"]))) @ q(w["rgb.w1"])
    raw = torch.cat([rgb, geo[:, :1]], -1)
    return raw.reshape(*pts.shape[:-1], 4)


TOY = types.ModuleType("portbench.reference.toy")
TOY.leaf_shapes = _leaf_shapes
TOY.init_weights = lambda gen, cfg, n: train.init_leaves(gen, _leaf_shapes(cfg), n)
TOY.fresh_state = train.fresh_state
TOY.forward = _forward
TOY.step = lambda state, frames, obj, draws, cfg, q=FP32: train.step(
    _forward, state, frames, obj, draws, cfg, q)


@pytest.fixture
def toy_cfg(monkeypatch):
    """tcnn's file at the tests' tiny sizes, naming the toy field."""
    monkeypatch.setitem(sys.modules, "portbench.reference.toy", TOY)
    with open(os.path.join(ROOT, "portbench", "configs", "tcnn.json")) as f:
        cfg = json.load(f)
    for part, upd in TINY_CONFIG.items():
        cfg[part] = {**cfg[part], **upd}
    cfg["reference"] = "toy"
    return cfg


def test_the_toy_resolves_through_the_registry(toy_cfg):
    assert registry.reference(toy_cfg) is TOY
    with open(os.path.join(ROOT, "portbench", "configs", "tcnn.json")) as f:
        tcnn = json.load(f)
    assert registry.reference(tcnn).__name__ == f"portbench.reference.{tcnn['reference']}"


@pytest.mark.parametrize("name", ["precision", "dataset"])
def test_a_reference_that_is_no_field_is_refused(toy_cfg, name):
    with pytest.raises(ValueError, match="not a field"):
        registry.reference(dict(toy_cfg, reference=name))


def test_leaves_by_path():
    t = lambda *s: torch.zeros(s)
    nested = {"table": t(2, 10, 2), "mlp": {"density": {"w0": t(2, 8, 16), "w1": t(2, 16, 5)},
                                            "rgb": {"w0": t(2, 9, 16), "w1": t(2, 16, 3)}}}
    got = program.leaves(nested, "hashgrid")
    assert list(got) == ["table", "density.w0", "density.w1", "rgb.w0", "rgb.w1"]
    assert got["rgb.w0"] is nested["mlp"]["rgb"]["w0"]
    flat = {"table": {"lines": t(3), "planes": [t(1), t(2)], "plane_lines": [t(3), t(4)]},
            "mlp": {"w0": t(5), "w1": t(6)}}
    assert list(program.leaves(flat, "mxgrid")) == [
        "lines", "planes0", "planes1", "plane_lines0", "plane_lines1", "w0", "w1"]


def test_counts_of_the_toys_matrices(toy_cfg):
    w = counts.of(toy_cfg, 3, "cpu")
    p = 64 * 8
    mlp = 3 * 2 * p * (8 * HIDDEN + HIDDEN * GEO + (GEO + 4) * HIDDEN + HIDDEN * 3)
    h = encodings.hash_sizes(toy_cfg["encoding"])
    fwd = work.hash_work("forward", 4, 2, h["total"], "float32", 3, p)
    bwd = work.hash_work("backward", 4, 2, h["total"], "float32", 3, p)
    assert w["flops_per_obj_step"] == pytest.approx(mlp + (fwd[1] + bwd[1]) / 3)
    assert w["encode_fwd_s"] == pytest.approx(work.least_seconds(*fwd))


def test_follow_runs_the_toys_step(toy_cfg, tmp_path):
    """`check.follow` on a scene the benchmark made, through the toy's own
    `fresh_state` and `step`: every leaf read, the nested ones by path."""
    from portbench import scene
    from portbench.frozen import world
    from portbench.reference import dataset

    sc = scene.make(dict(layout="ring", objects=2, frames=6, res=48, orbit_radius=2.4,
                         orbit_arc=2 * math.pi), 11, "cpu")
    world.write_dataset(str(tmp_path), sc["cam"], scene.as_frames(sc), objects=sc["objects"],
                        use_depth=False)
    frames, objects = dataset.read(str(tmp_path), "cpu")
    gen = torch.Generator().manual_seed(3)
    weights = TOY.init_weights(gen, toy_cfg, len(objects))
    out = check.follow(toy_cfg, frames, objects, weights,
                       check.draws(gen, len(objects), toy_cfg["train"], 2))
    assert set(out["grad_norm"]) == set(_leaf_shapes(toy_cfg)) == set(weights)
    active = [o["slot"] for o in objects if o["active"]]
    assert active and torch.isfinite(torch.as_tensor(out["losses"][:, active])).all()
    for name in ("density.w0", "rgb.w0", "rgb.w1", "table"):
        assert (out["change_norm"][name][active] > 0).all(), name
