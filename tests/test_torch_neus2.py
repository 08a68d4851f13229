"""NeuS2's neural-surface field on the port (`NetworkConfig(field="sdf")`):
the SDF network over the hash grid, its normal n = grad f through H0's twin
(forward) and H3's (backward), NeuS's colour network and SDF-to-alpha
render and the eikonal term, held to the benchmark's plain reference of
that field (`portbench/reference/neus2.py`, whose normal is autograd's
`create_graph` gradient) on the CPU in fp32 at tiny sizes: 4 levels of
2^10 rows, 64 rays x 8 samples.

Tolerances: the port and the reference run the same fp32 arithmetic in
another order (batched products, the table's gradient summed by scatter,
the normal by explicit slopes against autograd's chain), so values agree
to a few fp32 roundings of the largest entry: 1e-5 relative for forward
values and losses, 1e-4 for gradients and one Adam step (whose update
divides by the gradient's own size). The second-order path is what the
gradient test holds: with the normal detached it departs by more than ten
times its tolerance."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from portbench import calibrate, check, program, scene
from portbench.faults import FAULTS
from portbench.frozen import world
from portbench.reference import dataset, encodings, neus2
from portbench.reference.precision import FP32
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import hashgrid_cuda, mlp_cuda
from romap_tpu_torch.ops.losses import RayBatch, composite_loss
from romap_tpu_torch.ops.render import SDF_CHANNELS
from romap_tpu_torch.runtime import artifacts, pose_refine
from romap_tpu_torch.runtime.offline import OfflineRunner
from romap_tpu_torch.utils import checkpoint, tracing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "neus2.offline.room10"
TINY = {"encoding": dict(n_levels=4, log2_hashmap_size=10),
        "train": dict(rays_per_batch=64, samples_per_ray=8, mc_resolution=17,
                      compute_dtype="float32")}
TINY_TRAFFIC = {"scene": dict(res=48, frames=12, objects=4), "steps_per_wave": 2}


def tiny_cfg() -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "neus2.json")) as f:
        cfg = json.load(f)
    for part, upd in TINY.items():
        cfg[part] = {**cfg[part], **upd}
    return cfg


def close(got, want, rtol):
    """Agreement to `rtol` of the largest entry of `want`."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (err, scale)


def rel_gap(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A 48 x 48, 6-frame room of 2 spheres from the benchmark's scene."""
    root = str(tmp_path_factory.mktemp("neus2_scene"))
    sc = scene.make(dict(layout="ring", objects=2, frames=6, res=48, orbit_radius=2.4,
                         orbit_arc=2 * math.pi), 11, "cpu")
    world.write_dataset(root, sc["cam"], scene.as_frames(sc), objects=sc["objects"],
                        use_depth=False)
    return root


def state_with(cfg: dict, n: int, seed: int):
    """The program's state for `n` slots holding the reference's weights
    from `seed` (installed as the benchmark does), and those weights."""
    ncfg = program.nerf_config(cfg)
    spec = nerf.make_field_spec(ncfg)
    st = nerf.init_train_state(torch.Generator().manual_seed(0), n, ncfg, spec)
    w = neus2.init_weights(torch.Generator().manual_seed(seed), cfg, n)
    program.install(st, w, "hashgrid")
    return ncfg, spec, st, w


def test_params_tree_is_the_sdf_and_colour_networks_and_the_variance():
    cfg = tiny_cfg()
    _, _, st, w = state_with(cfg, 2, 1)
    assert set(st.params["mlp"]) == {"sdf", "rgb", "variance"}
    assert set(st.params["mlp"]["sdf"]) == {"w0", "w1"}
    assert set(st.params["mlp"]["rgb"]) == {"w0", "w1", "w2"}
    assert st.params["mlp"]["rgb"]["w0"].shape == (2, 3 + 3 + 16 + 15, 64)
    assert list(neus2.leaf_shapes(cfg))[1:] == ["sdf.w0", "sdf.w1", "rgb.w0", "rgb.w1",
                                                "rgb.w2", "variance"]
    assert torch.equal(w["variance"], torch.full((2, 1), 0.3))
    fresh = nerf.init_train_state(torch.Generator().manual_seed(0), 3, program.nerf_config(cfg),
                                  nerf.make_field_spec(program.nerf_config(cfg)))
    assert torch.equal(fresh.params["mlp"]["variance"], torch.full((3, 1), 0.3))
    got = program.leaves(st.params, "hashgrid")
    for k, v in w.items():
        assert torch.equal(got[k], v), k


def _field_inputs(seed: int):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((2, 16, 8, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((2, 16, 3), generator=g), dim=-1)
    extent = 0.5 + torch.rand((2, 3), generator=g)
    return pts, dirs, extent


def test_field_equals_the_reference():
    """The port's raw channels (rgb logits, f, n, inv_s, the anneal ratio)
    on seeded weights against the reference's `forward`, object by object
    (rtol 1e-5 of the largest entry of each)."""
    cfg = tiny_cfg()
    ncfg, spec, st, w = state_with(cfg, 2, 3)
    with torch.no_grad():
        st.params["mlp"]["variance"].copy_(torch.tensor([[0.2], [0.45]]))
    pts, dirs, extent = _field_inputs(4)
    raw = nerf.field_apply(st.params, pts, dirs, ncfg, spec, extent=extent,
                           anneal=torch.tensor([0.25, 1.0]))
    assert raw.shape == (2, 16, 8, SDF_CHANNELS) and raw.dtype == torch.float32
    c = encodings.folding(cfg["encoding"], "cpu")
    for i in range(2):
        wi = {k: v[i] for k, v in w.items()}
        wi["variance"] = st.params["mlp"]["variance"][i].detach()
        rgb, f, n, inv_s = neus2.forward(wi, pts[i], dirs[i], extent[i], cfg, FP32, c)
        close(raw[i, ..., :3], rgb, 1e-5)
        close(raw[i, ..., 3], f, 1e-5)
        close(raw[i, ..., 4:7], n, 1e-5)
        close(raw[i, ..., 7], inv_s.expand(16, 8), 1e-6)
        assert float(n.norm(dim=-1).mean()) > 1e-3  # the normal is no zero
    assert torch.equal(raw[0, ..., 8], torch.full((16, 8), 0.25))
    assert torch.equal(raw[1, ..., 8], torch.ones(16, 8))
    # the colour depends on the direction, the geometry does not
    other = nerf.field_apply(st.params, pts, -dirs, ncfg, spec, extent=extent)
    assert torch.equal(other[..., 3:8], raw[..., 3:8])
    assert (other[..., :3] - raw[..., :3]).abs().max() > 1e-3


def _one_step(scene_dir, cfg, seed=7, draw_seed=8):
    """One `train_objects` step of the offline runner's state from the
    reference's weights, and the reference's step on the same inputs:
    (followed objects' [(slot, logged, seen, new)], the state, weights)."""
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    r.create_nerfs_from_dir()
    r._build_object_table()
    n = r.objs_state.capacity
    w = neus2.init_weights(torch.Generator().manual_seed(seed), cfg, n)
    program.install(r.state, w, "hashgrid")
    st = nerf.train_objects(r.state, r.objs_state, r.store.arrays(), ncfg, r.spec, 1,
                            generator=torch.Generator().manual_seed(draw_seed))
    frames, objects = dataset.read(scene_dir, "cpu")
    draws = check.draws(torch.Generator().manual_seed(draw_seed), n, cfg["train"], 1)[0]
    followed = []
    for obj in objects:
        if obj["active"]:
            i = obj["slot"]
            new, logged, seen = neus2.step(neus2.fresh_state({k: v[i] for k, v in w.items()}),
                                           frames, obj, tuple(x[i] for x in draws), cfg)
            followed.append((i, logged, seen, new))
    return followed, st, w, ncfg


def test_one_train_step_equals_the_reference(scene_dir):
    """One step against `reference.neus2.step` on the same weights, draws,
    frames and object table: the logged loss (1e-5), every leaf's gradient
    as Adam holds it, the variance's included, and the updated params and
    EMA (1e-4)."""
    cfg = tiny_cfg()
    followed, st, w, ncfg = _one_step(scene_dir, cfg)
    b1 = ncfg.optimizer.beta1
    grads = {k: v / (1 - b1) for k, v in program.leaves(st.opt.mu, "hashgrid").items()}
    params, ema = program.leaves(st.params, "hashgrid"), program.leaves(st.ema, "hashgrid")
    assert len(followed) == 2
    for i, logged, seen, new in followed:
        close(st.loss[i], logged, 1e-5)
        for k in w:
            close(grads[k][i], seen[k], 1e-4)
            close(params[k][i] - w[k][i], new["params"][k] - w[k][i], 1e-4)
            close(ema[k][i] - w[k][i], new["ema"][k] - w[k][i], 1e-4)
        assert float(seen["variance"].abs().max()) > 0.0


def test_a_detached_normal_fails_the_gradient_comparison(scene_dir, monkeypatch):
    """With the normal cut from the graph (no second-order pass: the render's
    cosine and the eikonal term then reach neither the table nor the SDF
    network through it), the gradients of `table` and `sdf.w0` depart from
    the reference's by more than ten times the 1e-4 tolerance."""
    cfg = tiny_cfg()
    real = nerf._sdf_geometry

    def detached(*args, **kwargs):
        geo, normal = real(*args, **kwargs)
        return geo, normal.detach()

    monkeypatch.setattr(nerf, "_sdf_geometry", detached)
    followed, st, _, ncfg = _one_step(scene_dir, cfg)
    grads = {k: v / (1 - ncfg.optimizer.beta1)
             for k, v in program.leaves(st.opt.mu, "hashgrid").items()}
    for leaf in ("table", "sdf.w0"):
        gap = max(rel_gap(grads[leaf][i], seen[leaf]) for i, _, seen, _ in followed)
        assert gap > 10 * 1e-4, (leaf, gap)


def test_the_render_equals_the_reference():
    """`composite_loss` of an SDF raw (NeuS's render: the opacity, the
    colour over the background, the cut on background rays, the eikonal
    term) against the reference's `loss_of` on the same values, ray by ray
    of one object: the training loss and the logged loss (1e-5), and the
    gradient of the loss in f, n and the rgb logits (1e-5)."""
    cfg = tiny_cfg()
    g = torch.Generator().manual_seed(21)
    r, s = 48, 8
    f = 0.05 * torch.randn((1, r, s), generator=g)
    normal = 0.8 * torch.randn((1, r, s, 3), generator=g)
    logits = torch.randn((1, r, s, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((1, r, 3), generator=g), dim=-1)
    tmin = 1.0 + torch.rand((1, r), generator=g)
    tmax = tmin + 0.2 + torch.rand((1, r), generator=g)
    jitter = torch.rand((1, r, s), generator=g)
    t = tmin[..., None] + ((tmax - tmin) / s)[..., None] * (torch.arange(s) + jitter)
    is_obj = torch.rand((1, r), generator=g) > 0.4
    bg, target = torch.rand((1, r, 3), generator=g), torch.rand((1, r, 3), generator=g)
    inv_s, anneal = 30.0, 0.3
    batch = RayBatch(points=None, t=t, rgb_target=target, depth_target=torch.zeros((1, r)),
                     is_object=is_obj, bg_color=bg, valid=torch.ones(1, dtype=torch.bool),
                     dirs=dirs, tmin=tmin, tmax=tmax)
    leaves = [x.clone().requires_grad_(True) for x in (f, normal, logits)]
    fp, np_, lp = leaves
    raw = torch.cat([lp, fp[..., None], np_, torch.full((1, r, s, 1), inv_s),
                     torch.full((1, r, s, 1), anneal)], dim=-1)
    loss, aux = composite_loss(raw, batch, program.nerf_config(cfg).train)
    got = torch.autograd.grad(loss.sum(), leaves)
    ref_leaves = [x[0].clone().requires_grad_(True) for x in (f, normal, logits)]
    fr, nr, lr = ref_leaves
    stratum = (t[0, :, -1] - t[0, :, 0]) / (s - 1 + jitter[0, :, -1] - jitter[0, :, 0])
    want_loss, want_logged = neus2.loss_of(lr, fr, nr, torch.tensor(inv_s), dirs[0], t[0],
                                           stratum, anneal, target[0], is_obj[0], bg[0],
                                           cfg["train"])
    want = torch.autograd.grad(want_loss, ref_leaves)
    close(loss[0], want_loss, 1e-5)
    close(aux["logged_loss"][0], want_logged, 1e-5)
    for a, b in zip(got, want):
        close(a[0], b, 1e-5)
    assert 0.0 < float(aux["mask"].min()) and float(aux["mask"].max()) <= 1.0 + 1e-6


def test_mesh_is_the_zero_level_and_colours_look_along_the_normal():
    """`density_on_grid` of an SDF field is -f, bit for bit the field's
    distance channel at the grid points; a vertex's colour is the field's
    at direction -n / |n| with its own normal, against the reference's
    forward there (1e-5)."""
    cfg = tiny_cfg()
    ncfg, spec, st, w = state_with(cfg, 1, 5)
    one = pytree.tree_map(lambda a: a[0], st.params)
    res = 9
    grid = nerf.density_on_grid(one, ncfg, spec, res)
    lin = torch.arange(res, dtype=torch.float32) / (res - 1)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(1, -1, 1, 3)
    dirs = torch.nn.functional.normalize(torch.randn((1, res**3, 3)), dim=-1)
    raw = nerf.field_apply(st.params, pts, dirs, ncfg, spec, dtype=torch.float32,
                           extent=torch.ones((1, 3)))
    assert torch.equal(grid, -raw[0, :, 0, 3])

    p = torch.rand((40, 3), generator=torch.Generator().manual_seed(6))
    extent = torch.tensor([0.7, 1.1, 0.9])
    colours = nerf.colors_at_points(one, p, ncfg, spec, extent=extent.numpy())
    wi = {k: v[0] for k, v in w.items()}
    c = encodings.folding(cfg["encoding"], "cpu")
    _, _, n, _ = neus2.forward(wi, p[:, None], torch.zeros((40, 3)), extent, cfg, FP32, c)
    head_on = -torch.nn.functional.normalize(n[:, 0], dim=-1)
    rgb, _, _, _ = neus2.forward(wi, p[:, None], head_on, extent, cfg, FP32, c)
    close(colours, torch.sigmoid(rgb[:, 0]), 1e-5)


def test_offline_runner_trains_renders_meshes_and_checkpoints(scene_dir, tmp_path):
    cfg = tiny_cfg()
    ncfg = program.nerf_config(cfg)
    assert ncfg.train.mc_threshold == 0.0
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    assert r.create_nerfs_from_dir() == 2
    out = str(tmp_path / "out")
    r.train(waves=2, steps_per_wave=3, mesh_every=1, out_dir=out)
    assert r.state.step.tolist() == [6, 6]
    assert torch.isfinite(r.state.loss).all()
    assert not torch.equal(r.state.params["mlp"]["variance"], torch.full((2, 1), 0.3))
    assert any(len(m.verts) for m in r.meshes.values())
    for oi, mesh in r.meshes.items():
        if len(mesh.verts):
            assert mesh.colors.shape == mesh.verts.shape and np.isfinite(mesh.colors).all()
    assert sorted(f for f in os.listdir(out) if f.endswith(".ply")) == ["0.ply", "1.ply"]
    r.render_test_artifacts(out, video=False)
    assert any(f.endswith(".png") for _, _, fs in os.walk(out) for f in fs)

    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(path, r.state, r.objs_state)
    raw = checkpoint.load_checkpoint(path)
    fresh = nerf.init_train_state(torch.Generator().manual_seed(9), r.objs_state.capacity, ncfg,
                                  r.spec)
    back = checkpoint.restore_train_state(raw["state"], fresh)
    a, b = pytree.tree_leaves(r.state), pytree.tree_leaves(back)
    assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(back.params["mlp"]["variance"], r.state.params["mlp"]["variance"])


def test_step_spans_and_counter(scene_dir):
    """Tracing on, one step: `mlp.sdf`, `sdf.normal` (holding an inner
    `encode.fwd`) under `mlp.fwd`, `render.sdf` under `loss.fwd`, each
    once; `field.sdf_points` counts the O x N points whose normal the step
    takes; the backward's chain opens `encode.bwd` and `mlp.bwd`."""
    cfg = tiny_cfg()
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    r.create_nerfs_from_dir()
    r._build_object_table()
    tracing.enable()
    try:
        tracing.drain()
        nerf.train_objects(r.state, r.objs_state, r.store.arrays(), ncfg, r.spec, 1,
                           generator=torch.Generator().manual_seed(3))
    finally:
        tracing.disable()
        drained = tracing.drain()
    names = {s["id"]: s["name"] for s in drained["spans"]}
    under = [(names.get(s["parent"]), s["name"]) for s in drained["spans"]]
    for pair in (("mlp.fwd", "mlp.sdf"), ("mlp.fwd", "sdf.normal"), ("sdf.normal", "encode.fwd"),
                 ("loss.fwd", "render.sdf")):
        assert under.count(pair) == 1, pair
    bwd = [s["name"] for s in drained["spans"] if s["name"].endswith(".bwd")]
    assert bwd.count("encode.bwd") >= 1 and bwd.count("mlp.bwd") >= 1
    counts = [c["n"] for c in drained["counters"] if c["name"] == "field.sdf_points"]
    assert counts == [r.objs_state.capacity * 64 * 8]


def test_pose_refinement_raises():
    cfg = tiny_cfg()
    ncfg, spec, st, _ = state_with(cfg, 1, 11)
    one = pytree.tree_map(lambda a: a[0], st.params)
    with pytest.raises(NotImplementedError, match="SDF"):
        pose_refine.make_view_loss(one, None, torch.eye(4)[None], torch.eye(4), None, None,
                                   None, None, None, None, None, ncfg, spec, 1)


def test_an_sdf_field_needs_the_hash_grid_and_the_view_branch():
    cfg = tiny_cfg()
    with pytest.raises(ValueError, match="sh_degree"):
        program.nerf_config({**cfg, "network": {**cfg["network"], "sh_degree": 0}})
    mx = program.nerf_config({**cfg, "encoding": {"kind": "mxgrid"}})
    with pytest.raises(NotImplementedError, match="hash grid"):
        nerf.make_field_spec(mx)


@pytest.mark.parametrize("node", ["encode", "last_product", "points_gradient"])
def test_a_second_order_gradient_through_a_kernel_node_raises(node):
    """The autograd nodes whose backward launches a kernel on the card
    (`_Encode`, `_LastProduct`, `_PointsGradient`; their twins on the CPU)
    are once differentiable: a `create_graph` gradient through one of them
    raises where it is differentiated again (a backward pass through it,
    or a gradient in a leaf the node read), and does not drop terms."""
    g = torch.Generator().manual_seed(31)
    spec = nerf.make_field_spec(program.nerf_config(tiny_cfg()))
    table = (1e-2 * torch.randn((1, spec.total_params, 2), generator=g)).requires_grad_(True)
    pts = torch.rand((1, 20, 3), generator=g).requires_grad_(True)
    if node == "encode":
        out = hashgrid_cuda._Encode.apply(pts, table, spec)
        first = torch.autograd.grad((out**2).sum(), pts, create_graph=True)[0]
        again = table
    elif node == "last_product":
        h = torch.randn((1, 20, 8), generator=g).requires_grad_(True)
        w = torch.randn((1, 8, 3), generator=g).requires_grad_(True)
        out = mlp_cuda._LastProduct.apply(h, w)
        first = torch.autograd.grad((out**2).sum(), h, create_graph=True)[0]
        again = w
    else:
        gg = torch.randn((1, 20, spec.n_output_dims), generator=g).requires_grad_(True)
        out = hashgrid_cuda._PointsGradient.apply(pts.detach(), table, gg, spec)
        first = torch.autograd.grad((out**2).sum(), gg, create_graph=True)[0]
        again = table
    with pytest.raises(RuntimeError, match="differentiate twice"):
        first.sum().backward()
    with pytest.raises(RuntimeError):
        torch.autograd.grad(first.sum(), again)


def overrides(dtype: str) -> dict:
    cfg = tiny_cfg()
    return {"config": {p: dict(cfg[p], compute_dtype=dtype) if p == "train" else cfg[p]
                       for p in TINY}, "traffic": TINY_TRAFFIC}


def test_the_cell_follows_the_reference_and_its_control_departs():
    """The benchmark's own comparison on the cell's traffic at tiny sizes:
    fp32 on the CPU reads fp32 rounding (loss and gradient under 1e-5,
    changes under 1e-4) and is correct; the control one precision down
    (bf16 forward values) departs by a thousand times that in the loss and
    in the changes, and by more than a hundred in the gradient and the
    share of flipped first steps (every flip reads 0 in fp32). The cell's
    limits sit between bf16 and the fp8 control at the cell's size (64
    rays an object read bf16's noise some ten times higher), so this size
    is judged by the departure and not by them."""
    rows = calibrate.readings(WORKLOAD, [5], control=True, device="cpu",
                              overrides=overrides("float32"))
    prog, ctl = rows[0]["program"], rows[0]["control"]
    assert rows[0]["correct"] is True
    assert prog["loss_gap"] < 1e-5 and prog["grad_gap"] < 1e-5
    assert prog["change_gap"] < 1e-4 and prog["ema_gap"] < 1e-4
    for k in ("loss_gap", "change_gap", "ema_gap"):
        assert ctl[k] > 1000 * prog[k], k
    assert ctl["grad_gap"] > 100 * prog["grad_gap"]
    assert prog["flip_share"] == 0.0 < ctl["flip_share"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    """Each fault of `portbench/faults.py` planted in the timed path, judged
    by the cell's own limits."""
    rows = calibrate.readings(WORKLOAD, [2**31 + 3], fault=fault, device="cpu",
                              overrides=overrides("float32"))
    assert rows[0]["correct"] is False


def test_the_mesh_round_meshes_through_the_artifacts(scene_dir, monkeypatch):
    """The offline runner's mesh round goes through
    `artifacts.extract_object_mesh` (the name the benchmark times) with the
    SDF's threshold 0."""
    cfg = tiny_cfg()
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    r.create_nerfs_from_dir()
    r._build_object_table()
    seen = []
    real = artifacts.extract_object_mesh
    monkeypatch.setattr(artifacts, "extract_object_mesh",
                        lambda *a, **k: seen.append(a[3].train.mc_threshold) or real(*a, **k))
    r.meshes = {}
    r.extract_meshes()
    assert seen == [0.0, 0.0]
