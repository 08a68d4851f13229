"""The port's offline slice vs romap_tpu on the CPU: the MX_SNAP override,
geometry helpers, the density grid and vertex colours, marching cubes,
the mesh writers, the view renderer, the offline runner end to end (file
tree and rendered images against JAX's runner), the runner's two
deliberate divergences from the reference, and that the slice runs with
jax blocked.

Both sides take the same numpy inputs; trained weights move from JAX to
the port with `romap_tpu_torch.utils.jax_bridge`.
"""

import dataclasses
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romap_tpu.config import EncodingConfig, NerfConfig, TrainConfig
from romap_tpu.data.formats import write_dataset
from romap_tpu.data.synthetic import Camera, make_scene, make_sequence
from romap_tpu.models import nerf as jnerf
from romap_tpu.ops import geometry as jgeo
from romap_tpu.ops import marching_cubes as jmc
from romap_tpu.runtime import renderer as jrenderer
from romap_tpu.runtime.offline import OfflineRunner as JRunner
from romap_tpu.utils import mesh_io as jmesh_io
from romap_tpu_torch.models import nerf as tnerf
from romap_tpu_torch.ops import geometry as tgeo
from romap_tpu_torch.ops import hashgrid_cuda, mlp_cuda, mxgrid_cuda, optimizer_cuda
from romap_tpu_torch.ops import marching_cubes as tmc
from romap_tpu_torch.runtime import artifacts as tartifacts
from romap_tpu_torch.runtime import offline as toffline
from romap_tpu_torch.runtime import renderer as trenderer
from romap_tpu_torch.runtime.offline import OfflineRunner as TRunner
from romap_tpu_torch.utils import jax_bridge, tracing
from romap_tpu_torch.utils import mesh_io as tmesh_io
from tests.test_torch_train import port_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg(cp_only: bool = False, mc_resolution: int = 17):
    enc = dict(kind="mxgrid", mx_levels=2, mx_max_resolution=32, mx_features=8,
               mx_impl="xla")
    enc.update(mx_plane_specs=()) if cp_only else enc.update(mx_plane_res=(16, 8),
                                                            mx_plane_features=4)
    return NerfConfig(encoding=EncodingConfig(**enc),
                      train=TrainConfig(rays_per_batch=128, samples_per_ray=8,
                                        render_samples_per_ray=16,
                                        mc_resolution=mc_resolution))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """The 64 x 64, 8-frame, 2-object dataset of tests/test_offline_e2e.py."""
    root = str(tmp_path_factory.mktemp("romap_ds_torch"))
    res = 64
    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(2)
    frames = make_sequence(cam, objects, 8, radius=5.5)
    write_dataset(root, cam, frames, objects=objects, use_depth=True)
    return root


def jax_params(cfg, seed=0, n=2):
    """JAX-initialised state (numpy leaves) and the port's copy of it."""
    spec = jnerf.make_field_spec(cfg)
    js = jax.device_get(jnerf.init_train_state(jax.random.PRNGKey(seed), n, cfg, spec))
    return spec, js, jax_bridge.train_state_from_jax(js)


def one(tree, oi, lib):
    return (jax.tree.map(lambda a: jnp.asarray(a[oi]), tree) if lib == "jax"
            else jax.tree.map(lambda a: a[oi], tree))


@pytest.mark.parametrize("value", [None, "0", "1"])
@pytest.mark.parametrize("snap", [True, False])
def test_mx_snap_override_matches_jax(monkeypatch, value, snap):
    """MX_SNAP=1/0 overrides mx_snap_levels in both packages alike."""
    if value is None:
        monkeypatch.delenv("MX_SNAP", raising=False)
    else:
        monkeypatch.setenv("MX_SNAP", value)
    cfg = NerfConfig(encoding=EncodingConfig(mx_snap_levels=snap))
    want = jnerf.make_field_spec(cfg)
    got = tnerf.make_field_spec(port_config(cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.snap_levels == (snap if value is None else value == "1")


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    lo, hi = np.array([-0.4, -0.3, -0.2], np.float32), np.array([0.5, 0.6, 0.1], np.float32)
    np.testing.assert_allclose(
        tgeo.unwarp_point(torch.from_numpy(p), torch.from_numpy(lo), torch.from_numpy(hi)),
        np.asarray(jgeo.unwarp_point(p, lo, hi)), rtol=1e-6, atol=1e-7)
    for a, b in zip(trenderer.orbit_poses(60, 30.0, 2.5), jrenderer.orbit_poses(60, 30.0, 2.5)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cp_only", [False, True])
def test_density_grid_and_colors_match_jax(cp_only):
    cfg = tiny_cfg(cp_only)
    jspec, js, ts = jax_params(cfg, seed=1)
    tcfg = port_config(cfg)
    tspec = tnerf.make_field_spec(tcfg)
    for oi in range(2):
        want = np.asarray(jnerf.density_on_grid(one(js.ema, oi, "jax"), cfg, jspec, 9))
        got = tnerf.density_on_grid(one(ts.ema, oi, "torch"), tcfg, tspec, 9)
        assert got.dtype == torch.float32 and got.shape == (9**3,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
        pts = np.random.default_rng(oi).uniform(0, 1, (40, 3)).astype(np.float32)
        want = np.asarray(jnerf.colors_at_points(one(js.ema, oi, "jax"), jnp.asarray(pts),
                                                 cfg, jspec))
        got = tnerf.colors_at_points(one(ts.ema, oi, "torch"), torch.from_numpy(pts), tcfg, tspec)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def blob_density(res, seed):
    rng = np.random.default_rng(seed)
    g = np.linspace(-1, 1, res)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    d = 3.0 * np.exp(-3 * (x**2 + 1.5 * y**2 + z**2)) + 0.3 * rng.normal(size=x.shape)
    return d.astype(np.float32).reshape(-1)


@pytest.mark.parametrize("res", [17, 24])
def test_marching_cubes_matches_jax(res):
    assert np.array_equal(tmc.build_triangle_table(), jmc.build_triangle_table())
    dens = blob_density(res, seed=res)
    lo, hi = np.array([-0.5, -0.4, -0.3], np.float32), np.array([0.5, 0.6, 0.2], np.float32)
    want = jmc.compute_normals(jmc.marching_cubes(dens, lo, hi, res, 2.0))
    got = tmc.compute_normals(tmc.marching_cubes(torch.from_numpy(dens), lo, hi, res, 2.0))
    assert len(got.faces) > 100 and got.faces.dtype == np.int32
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.verts, want.verts, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.normals, want.normals, rtol=0, atol=1e-5)


def test_mesh_writers_match_jax(tmp_path):
    """save_ply and save_obj (with the unwrap, .mtl and baked TGA) write the
    same bytes as JAX's writers; load_ply reads back the same arrays."""
    res = 17
    lo, hi = np.array([-0.5, -0.4, -0.3], np.float32), np.array([0.5, 0.6, 0.2], np.float32)
    mesh = tmc.compute_normals(tmc.marching_cubes(blob_density(res, 3), lo, hi, res, 2.0))
    colors = np.random.default_rng(0).uniform(0, 1, mesh.verts.shape).astype(np.float32)
    mesh = mesh._replace(colors=colors)
    jmesh = jmc.Mesh(*mesh)
    for lib, writer, m in (("t", tmesh_io, mesh), ("j", jmesh_io, jmesh)):
        writer.save_ply(m, str(tmp_path / f"{lib}.ply"))
        writer.save_obj(m, str(tmp_path / f"{lib}_flat.obj"))
        writer.save_obj(m, str(tmp_path / f"{lib}.obj"), unwrap=True)
    for name in ("{}.ply", "{}_flat.obj", "{}.obj", "{}.tga"):
        got = (tmp_path / name.format("t")).read_bytes()
        want = (tmp_path / name.format("j")).read_bytes()
        assert got == want.replace(b"mtllib j.mtl", b"mtllib t.mtl"), name
    assert (tmp_path / "t.mtl").read_text() == (tmp_path / "j.mtl").read_text().replace("j.tga",
                                                                                          "t.tga")
    got, want = tmesh_io.load_ply(str(tmp_path / "t.ply")), jmesh_io.load_ply(str(tmp_path / "j.ply"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.faces, mesh.faces)


def test_render_view_matches_jax(monkeypatch):
    """One bbox view from the same params and the same jitter; the port's
    ray chunking does not change a pixel."""
    cfg = tiny_cfg()
    jspec, js, ts = jax_params(cfg, seed=2)
    tcfg = port_config(cfg)
    tspec = tnerf.make_field_spec(tcfg)
    intr = np.array([57.6, 57.6, 32.0, 32.0], np.float32)
    twc = np.eye(4, dtype=np.float32)
    twc[:3, 3] = (0.1, -0.05, -3.0)
    tow = np.eye(4, dtype=np.float32)
    lo, hi = np.array([-0.6, -0.5, -0.7], np.float32), np.array([0.6, 0.5, 0.7], np.float32)
    box = (10, 12, 30, 40)
    key = jax.random.PRNGKey(3)
    want = jrenderer.render_view(one(js.ema, 0, "jax"), intr, twc, tow, lo, hi, box, cfg,
                                 jspec, key=key)
    jitter = torch.from_numpy(np.array(jax.random.uniform(
        key, (jrenderer._bucket(30 * 40), cfg.train.render_samples_per_ray))))[: 30 * 40]
    got = trenderer.render_view(one(ts.ema, 0, "torch"), intr, twc, tow, lo, hi, box, tcfg,
                                tspec, jitter=jitter)
    assert want[2].mean() > 0.05  # some pixels are on the object
    for name, a, b in zip(("rgb", "depth", "mask"), got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
    monkeypatch.setattr(trenderer, "RAY_CHUNK", 77)
    chunked = trenderer.render_view(one(ts.ema, 0, "torch"), intr, twc, tow, lo, hi, box, tcfg,
                                    tspec, jitter=jitter)
    for a, b in zip(chunked, got):
        np.testing.assert_array_equal(a, b)


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("cp_only", [False, True])
def test_offline_runner_matches_jax(dataset_dir, tmp_path, monkeypatch, cp_only):
    """Both runners, tiny config, 1 wave x 3 steps then the artifacts with
    video: the same file names. Then the port renders with JAX's EMA
    params and JAX's jitter: test_img within 1/255 of JAX's on >= 99 % of
    pixels."""
    cfg = tiny_cfg(cp_only)
    jr = JRunner(dataset_dir, cfg, use_depth=True)
    tr = TRunner(dataset_dir, port_config(cfg), use_depth=True, device="cpu")
    assert jr.create_nerfs_from_dir() == tr.create_nerfs_from_dir() == 2
    for r, lib in ((jr, "j"), (tr, "t")):
        r.train(waves=1, steps_per_wave=3, mesh_every=1, out_dir=str(tmp_path / f"{lib}_out"))
        r.render_test_artifacts(str(tmp_path / f"{lib}_art"), test_every=4, video=True)
    assert tr.state.step.tolist() == [3, 3]
    assert np.isfinite(tr.state.loss.numpy()).all()
    assert tree_files(tmp_path / "t_out") == tree_files(tmp_path / "j_out") == ["0.ply", "1.ply"]
    names = tree_files(tmp_path / "t_art")
    assert names == tree_files(tmp_path / "j_art")
    assert sum(n.startswith("0/video_img/") for n in names) == 60
    for oi in range(2):
        for f in ("test.txt", "train.txt"):
            assert ((tmp_path / "t_art" / str(oi) / f).read_text()
                    == (tmp_path / "j_art" / str(oi) / f).read_text())

    # the port renders JAX's trained EMA params, with the jitter JAX draws
    jstate = jax.device_get(jr.state)
    tr.state = tr.state._replace(ema=jax_bridge.train_state_from_jax(jstate).ema)
    real = trenderer.render_view

    def jax_jitter_view(*args, **kw):
        x0, y0, h, w = args[6]
        s = cfg.train.render_samples_per_ray
        jit = jax.random.uniform(jax.random.PRNGKey(0), (jrenderer._bucket(h * w), s))
        return real(*args, jitter=torch.from_numpy(np.array(jit))[: h * w], **kw)

    monkeypatch.setattr(tartifacts, "render_view", jax_jitter_view)
    tr.render_test_artifacts(str(tmp_path / "t_art2"), test_every=4, video=False)
    shares = []
    for oi in range(2):
        for name in sorted(os.listdir(tmp_path / "j_art" / str(oi) / "test_img")):
            a = cv2.imread(str(tmp_path / "t_art2" / str(oi) / "test_img" / name)).astype(int)
            b = cv2.imread(str(tmp_path / "j_art" / str(oi) / "test_img" / name)).astype(int)
            shares.append(np.mean(np.abs(a - b) <= 1))
    assert len(shares) >= 2 and min(shares) >= 0.99, shares


def test_rebuilt_object_table_keeps_one_copy_of_held_out_views(dataset_dir, tmp_path):
    """Divergence from romap_tpu (offline.py:123): rebuilding the table
    does not append the held-out views a second time."""
    r = TRunner(dataset_dir, port_config(tiny_cfg()), use_depth=True, holdout=4, device="cpu")
    r.create_nerfs_from_dir()
    r._build_object_table()
    first = [len(o["holdout_views"]) for o in r.objects]
    r._build_object_table()
    assert [len(o["holdout_views"]) for o in r.objects] == first
    assert min(first) >= 1
    n_train = r.objs_state.n_bbox.tolist()
    assert [a + b for a, b in zip(first, n_train)] == [len(o["data"].stamps) for o in r.objects]


def test_empty_held_out_set_raises(dataset_dir, tmp_path):
    """Divergence from romap_tpu (offline.py:207): with holdout set, an
    object with no held-out view raises instead of being scored on its
    training views. The first bbox row of this object names a frame the
    dataset does not have, so no serial that is a multiple of 100 is kept."""
    src = os.path.join(dataset_dir, "obj_offline", "0.txt")
    lines = open(src).read().splitlines()
    obj = tmp_path / "0.txt"
    obj.write_text("\n".join(lines[:2] + ["999.0000 1 1 4 4"] + lines[2:]) + "\n")
    r = TRunner(dataset_dir, port_config(tiny_cfg()), use_depth=True, holdout=100, device="cpu")
    r.create_nerf(str(obj))
    r.train(waves=1, steps_per_wave=1, out_dir=str(tmp_path / "out"))
    assert r.objects[0]["holdout_views"] == []
    with pytest.raises(ValueError, match="no held-out view"):
        r.render_test_artifacts(str(tmp_path / "art"), video=False)


def test_offline_cli_runs_with_jax_blocked(dataset_dir, tmp_path):
    """The slice imports no jax: the CLI runs end to end on the CPU in a
    process where `import jax` fails."""
    out = tmp_path / "cli_out"
    code = (
        "import sys, torch\n"
        "sys.modules['jax'] = None\n"
        "torch.set_num_threads(2)\n"
        "import romap_tpu_torch.runtime.offline as off\n"
        "import romap_tpu_torch.ops.cuda_lib, romap_tpu_torch.ops.mxgrid_cuda\n"
        "import romap_tpu_torch.utils.jax_bridge\n"
        f"off.main(['-', {dataset_dir!r}, '1', '--device', 'cpu', '--waves', '1',"
        f" '--steps-per-wave', '2', '--rays', '64', '--samples', '4', '--mc-res', '9',"
        f" '--mx-features', '8', '--mx-max-res', '32', '--no-video', '--out', {str(out)!r}])\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
    assert "Training completed" in res.stdout
    for oi in range(2):
        assert (out / f"{oi}.ply").exists() and (out / str(oi) / "obj.ply").exists()
        assert len(os.listdir(out / str(oi) / "test_img")) >= 1


def test_offline_cli_writes_its_trace(dataset_dir, tmp_path):
    """`--trace PATH`: the run's spans, counters, the kernels' launches
    (K0-K10, H0-H2, A1, M1-M2) and the summary as Chrome trace JSON; tracing
    is off again after the run."""
    trace = tmp_path / "trace.json"
    toffline.main(["-", dataset_dir, "1", "--device", "cpu", "--waves", "1",
                   "--steps-per-wave", "2", "--rays", "64", "--samples", "4", "--mc-res", "9",
                   "--mx-features", "8", "--mx-max-res", "32", "--no-video",
                   "--out", str(tmp_path / "out"), "--trace", str(trace)])
    assert not tracing.enabled()
    with open(trace) as f:
        t = json.load(f)
    spans = [e for e in t["traceEvents"] if e["ph"] == "X"]
    assert {"frames.load", "train.wave", "train.step", "encode.bwd", "mesh.round",
            "mesh.object"} <= {e["name"] for e in spans}
    assert all(e["dur"] >= 0 for e in spans)
    summary = t["summary"]["spans"]
    assert summary["train.wave/train.step"]["count"] == 2
    # the step's encodes and the meshes' are summarised apart
    assert summary["train.step/encode.fwd"]["count"] == 2
    assert summary["mesh.density/encode.fwd"]["count"] == sum(
        e["name"] == "mesh.density" for e in spans) >= 2
    assert t["summary"]["counters"]["slot_steps_issued"]["total"] == 2 * 2
    assert {c["name"] for c in t["counters"]} >= {"slot_steps_trained", "frames.loaded",
                                                   "mesh.verts"}
    # the CPU launches none
    assert t["launches"] == {k: 0 for k in (*mxgrid_cuda.KERNELS, *hashgrid_cuda.KERNELS,
                                            *optimizer_cuda.KERNELS, *mlp_cuda.KERNELS)}
