"""The port's spans and counters (`romap_tpu_torch/utils/tracing.py`): off
costs no clock, hook or record_function and changes no number; on, each
train step holds its layers' spans, the spans lie on a profiler's
timeline, and the offline runner counts its waves, meshes and frames."""

from __future__ import annotations

import json
import os
import statistics
import time

import pytest
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import EncodingConfig, NerfConfig, NetworkConfig, TrainConfig
from romap_tpu_torch.data.formats import write_dataset
from romap_tpu_torch.data.synthetic import Camera, make_scene, make_sequence
from romap_tpu_torch.data.world import build_synthetic_world
from romap_tpu_torch.models import nerf
from romap_tpu_torch.runtime.offline import OfflineRunner
from romap_tpu_torch.utils import tracing

torch.set_num_threads(2)

ENCODINGS = {
    "mxgrid": dict(kind="mxgrid", mx_levels=2, mx_max_resolution=32, mx_features=8,
                   mx_plane_res=16, mx_plane_features=4, mx_impl="xla"),
    "hashgrid": dict(kind="hashgrid", n_levels=4, log2_hashmap_size=10,
                     desired_resolution=64.0),
}


def tiny_cfg(kind="mxgrid", mc_resolution=9):
    return NerfConfig(encoding=EncodingConfig(**ENCODINGS[kind]),
                      train=TrainConfig(rays_per_batch=64, samples_per_ray=4,
                                        mc_resolution=mc_resolution))


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def world():
    _, _, _, store, objs = build_synthetic_world(2, 3, 32)
    return store.arrays(), objs


def train(world, kind="mxgrid", steps=3):
    frames, objs = world
    cfg = tiny_cfg(kind)
    spec = nerf.make_field_spec(cfg)
    g = torch.Generator().manual_seed(0)
    state = nerf.init_train_state(g, objs.capacity, cfg, spec)
    return nerf.train_objects(state, objs, frames, cfg, spec, steps, generator=g)


def test_tracing_off_reads_no_clock_registers_no_hook_enters_no_record_function(
        world, monkeypatch):
    hooks = []
    real_hook = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: hooks.append(fn) or real_hook(self, fn))

    def forbidden(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", forbidden)
    monkeypatch.setattr(tracing, "_profiler_active", forbidden)
    monkeypatch.setattr(tracing.torch.profiler, "record_function", forbidden)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        train(world)
    assert hooks == []
    monkeypatch.undo()
    assert tracing.drain()["spans"] == [] and tracing.drain()["counters"] == []
    assert tracing.span("train.step", step=0) is tracing.span("batch")


def test_tracing_on_changes_no_number(world):
    off = train(world)
    tracing.enable()
    on = train(world)
    tracing.disable()
    assert len(tracing.drain()["spans"]) > 0
    for name in ("params", "ema", "opt", "step", "loss"):
        a, b = torch.utils._pytree.tree_leaves(getattr(off, name)), \
            torch.utils._pytree.tree_leaves(getattr(on, name))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("kind", sorted(ENCODINGS))
def test_each_train_step_holds_its_layers(world, kind):
    tracing.enable()
    with tracing.span("train.wave", wave=7):
        train(world, kind, steps=3)
    spans = tracing.drain()["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["ids"] for s in steps] == [{"wave": 7, "step": i} for i in range(3)]
    for st in steps:
        kids = [s for s in spans if s["parent"] == st["id"]]
        assert sorted(s["name"] for s in kids) == sorted(nerf.STEP_SPANS + ("batch",))
        for s in kids:
            assert s["ids"] == st["ids"]
            assert st["start_ns"] <= s["start_ns"] <= s["end_ns"] <= st["end_ns"]
        order = [s["name"] for s in sorted(kids, key=lambda s: s["start_ns"])]
        assert order == ["batch", "batch", "encode.fwd", "mlp.fwd", "loss.fwd", "loss.bwd",
                         "mlp.bwd", "encode.bwd", "optimizer.update"]


def test_view_dependent_field_nests_its_networks_in_mlp_fwd(world):
    """instant-ngp's field: `mlp.density`, `dir.encode` and `mlp.rgb` open
    in that order inside `mlp.fwd`; the backward chain keeps its one
    `mlp.bwd` and no new name; `field.view_points` counts O x R x S points
    through the colour network a step."""
    frames, objs = world
    cfg = NerfConfig(encoding=EncodingConfig(**ENCODINGS["hashgrid"]),
                     network=NetworkConfig(sh_degree=4),
                     train=TrainConfig(rays_per_batch=64, samples_per_ray=4))
    spec = nerf.make_field_spec(cfg)
    g = torch.Generator().manual_seed(0)
    state = nerf.init_train_state(g, objs.capacity, cfg, spec)
    tracing.enable()
    nerf.train_objects(state, objs, frames, cfg, spec, 2, generator=g)
    d = tracing.drain()
    spans = d["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 2
    for st in steps:
        kids = [s for s in spans if s["parent"] == st["id"]]
        assert sorted(s["name"] for s in kids) == sorted(nerf.STEP_SPANS + ("batch",))
        (fwd,) = [s for s in kids if s["name"] == "mlp.fwd"]
        inner = sorted((s for s in spans if s["parent"] == fwd["id"]),
                       key=lambda s: s["start_ns"])
        assert [s["name"] for s in inner] == ["mlp.density", "dir.encode", "mlp.rgb"]
        for s in inner:
            assert fwd["start_ns"] <= s["start_ns"] <= s["end_ns"] <= fwd["end_ns"]
        assert [s["name"] for s in kids].count("mlp.bwd") == 1
    inner_names = {"mlp.density", "dir.encode", "mlp.rgb"}
    assert {s["name"] for s in spans} == set(nerf.STEP_SPANS) | {"train.step"} | inner_names
    assert sum(s["name"] in inner_names for s in spans) == 3 * len(steps)  # none elsewhere
    points = [c for c in d["counters"] if c["name"] == "field.view_points"]
    r, s_ = cfg.train.rays_per_batch, cfg.train.samples_per_ray
    assert [(c["ids"]["step"], c["n"]) for c in points] == [(i, objs.capacity * r * s_)
                                                           for i in range(2)]


def test_spans_lie_on_the_profilers_timeline(world, tmp_path):
    tracing.enable()
    offset_ns = time.time_ns() - time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train(world, steps=2)
    tracing.disable()
    spans = tracing.drain()["spans"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                    key=lambda e: e["ts"])
    assert sorted(e["name"] for e in events) == sorted(s["name"] for s in spans)
    gaps = []
    for name in {s["name"] for s in spans}:
        ours = [s for s in spans if s["name"] == name]
        theirs = [e for e in events if e["name"] == name]
        for s, e in zip(ours, theirs):
            gaps.append(abs((s["start_ns"] + offset_ns) / 1e3 - base_us - e["ts"]))
    assert statistics.median(gaps) < 100.0, statistics.median(gaps)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """A 48 x 48, 6-frame, 2-object dataset and a third object file whose one
    bbox row names a frame the dataset does not have (a slot with no bboxes)."""
    root = str(tmp_path_factory.mktemp("tracing_ds"))
    cam = Camera(fx=43.2, fy=43.2, cx=24, cy=24, h=48, w=48)
    objects = make_scene(2)
    write_dataset(root, cam, make_sequence(cam, objects, 6, radius=5.5), objects=objects,
                  use_depth=False)
    obj_dir = os.path.join(root, "obj_offline")
    with open(os.path.join(obj_dir, "0.txt")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(obj_dir, "2.txt"), "w") as f:
        f.write("\n".join(lines[:2] + ["999.0000 1 1 4 4"]) + "\n")
    return root


def test_offline_runner_counts_waves_meshes_and_frames(dataset_dir, tmp_path):
    tracing.enable()
    r = OfflineRunner(dataset_dir, tiny_cfg(), device="cpu")
    assert r.create_nerfs_from_dir() == 3
    r.train(waves=2, steps_per_wave=2, mesh_every=3, out_dir=str(tmp_path / "out"))
    tracing.disable()
    d = tracing.drain()
    assert r.objs_state.active.tolist() == [True, True, False]

    per_wave = {}
    for c in d["counters"]:
        if "wave" in c["ids"]:
            per_wave.setdefault(c["ids"]["wave"], {})[c["name"]] = c["n"]
    n_params = sum(a.numel() for a in pytree.tree_leaves(r.state.params))
    # traced steps run eagerly: no graph captured or replayed
    assert per_wave == {w: {"slot_steps_issued": 3 * 2, "slot_steps_trained": 2 * 2,
                            "slots_active": 2, "optimizer.fused_params": n_params,
                            "train.graph_captures": 0, "train.graph_replays": 0}
                        for w in (1, 2)}

    spans = d["spans"]
    names = [s["name"] for s in spans]
    assert names.count("frames.load") == 1
    totals = {c["name"]: c["n"] for c in d["counters"] if c["name"].startswith("frames.")}
    assert totals == {"frames.loaded": 6, "frames.bytes": 6 * 48 * 48 * 4}

    waves = [s for s in spans if s["name"] == "train.wave"]
    assert [s["ids"] for s in waves] == [{"wave": 1}, {"wave": 2}]
    for s, sec in zip(waves, r.wave_seconds):
        assert 0 <= (s["end_ns"] - s["start_ns"]) / 1e9 - sec < 1e-3
    for child in ("train.barrier",):
        assert sorted(s["ids"]["wave"] for s in spans if s["name"] == child) == [1, 2]
    assert names.count("train.log") == 2

    rounds = [s for s in spans if s["name"] == "mesh.round"]
    assert len(rounds) == 1  # save_meshes' round: mesh_every is past the last wave
    objects = [s for s in spans if s["name"] == "mesh.object"]
    assert [s["ids"] for s in objects] == [{"object": i} for i in range(3)]
    assert all(s["parent"] == rounds[0]["id"] for s in objects)
    for part in ("mesh.density", "mesh.march"):
        assert sorted(s["ids"]["object"] for s in spans if s["name"] == part) == [0, 1, 2]
    verts = {c["ids"]["object"]: c["n"] for c in d["counters"] if c["name"] == "mesh.verts"}
    assert sorted(verts) == [0, 1, 2]
    assert {o: len(r.meshes[o].verts) for o in range(3)} == verts


def test_summary_counts_each_name(world):
    """The summary counts each span under its parent's name and its own: the train
    step's encodes and a mesh grid's stay apart."""
    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    tracing.enable()
    state = train(world, steps=2)
    with tracing.span("mesh.density"):
        nerf.density_on_grid(torch.utils._pytree.tree_map(lambda a: a[0], state.ema), cfg,
                             spec, 9)
    tracing.count("mesh.verts", 5)
    tracing.count("mesh.verts", 7)
    s = tracing.summary(tracing.drain())
    assert s["spans"]["train.step"]["count"] == 2
    assert s["spans"]["train.step/batch"]["count"] == 4
    assert s["spans"]["train.step/encode.fwd"]["count"] == 2
    assert s["spans"]["mesh.density/encode.fwd"]["count"] == 1
    assert "encode.fwd" not in s["spans"]
    step = s["spans"]["train.step"]
    assert step["total_s"] > 0 and step["median_ms"] > 0 and step["mean_ms"] > 0
    assert s["counters"]["mesh.verts"] == dict(count=2, total=12)
