"""nerfacto on the port (`NetworkConfig(field="nerfacto")`): the proposal
sampler, the two proposal
fields, the appearance codes, the render over bins and nerfstudio's
interlevel and distortion losses, held to the benchmark's plain reference
(`portbench/reference/nerfacto.py`) on the CPU in fp32 at tiny sizes: a
4-level 2^10 field grid, 3-level 2^9 proposal grids, 64 rays x (16, 8)
proposal and 8 field samples, 2-3 slots. No JAX.

Tolerances: the port and the reference run the same fp32 arithmetic in
another order (batched products, the tables' gradients summed by scatter,
the distortion's pairwise sum through running sums), so values agree to a
few fp32 roundings of the largest entry: 1e-5 relative for bins, forward
values and losses, 1e-4 for gradients, and 1e-3 of a leaf's norm for its
change over three Adam steps."""

from __future__ import annotations

import contextlib
import dataclasses
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
from portbench.reference import dataset, nerfacto
from portbench.reference.precision import FP32
from romap_tpu_torch.config import EncodingConfig, NerfConfig, NetworkConfig, TrainConfig
from romap_tpu_torch.data.synthetic import Camera, make_scene, make_sequence
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import losses, optimizer_cuda, render, sampler
from romap_tpu_torch.runtime import pose_refine
from romap_tpu_torch.runtime.manager import NerfManagerOnline
from romap_tpu_torch.runtime.offline import OfflineRunner
from romap_tpu_torch.utils import checkpoint, tracing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "nerfacto.offline.room10"
TINY = {"encoding": dict(n_levels=4, log2_hashmap_size=10),
        "network": dict(proposal_levels=3, proposal_log2_hashmap_size=9,
                        proposal_max_resolutions=[16, 32], appearance_frames=6),
        "train": dict(rays_per_batch=64, samples_per_ray=8, proposal_samples=[16, 8],
                      mc_resolution=17, compute_dtype="float32")}
TINY_TRAFFIC = {"scene": dict(res=48, frames=12, objects=4), "steps_per_wave": 2}


def tiny_cfg() -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "nerfacto.json")) as f:
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


def close_norm(got, want, rtol):
    """Agreement to `rtol` of the norm of `want`, as the benchmark's
    `change_gap` reads a leaf: Adam's update divides by the gradient's own
    size, so an entry whose gradient is at round-off moves by round-off."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    err = float(torch.linalg.vector_norm(got - want))
    assert err <= rtol * max(float(torch.linalg.vector_norm(want)), 1e-30), err


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A 48 x 48, 6-frame room of 3 spheres from the benchmark's scene."""
    root = str(tmp_path_factory.mktemp("nerfacto_scene"))
    sc = scene.make(dict(layout="ring", objects=3, frames=6, res=48, orbit_radius=2.4,
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
    w = nerfacto.init_weights(torch.Generator().manual_seed(seed), cfg, n)
    program.install(st, w, "hashgrid")
    return ncfg, spec, st, w


def runner_with(scene_dir, cfg: dict, seed: int):
    """The offline runner on the scene, the reference's weights installed."""
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    r.create_nerfs_from_dir()
    r._build_object_table()
    w = nerfacto.init_weights(torch.Generator().manual_seed(seed), cfg, r.objs_state.capacity)
    program.install(r.state, w, "hashgrid")
    return ncfg, r, w


def one_ray_set(n_rays: int = 32, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn((n_rays, 3), generator=g) * 0.1 + torch.tensor([0.0, 0.0, -2.0])
    d = torch.nn.functional.normalize(torch.randn((n_rays, 3), generator=g) * 0.1
                                      + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    tmin, tmax = 1.5 + 0.1 * torch.rand(n_rays, generator=g), 2.5 + 0.1 * torch.rand(
        n_rays, generator=g)
    return g, o, d, tmin, tmax


# --------------------------------------------------------------------------
# Configuration and parameters
# --------------------------------------------------------------------------


def test_config_checks_nerfactos_sizes():
    net = NetworkConfig(field="nerfacto", sh_degree=4, output_dims=16, appearance_frames=80)
    grid = EncodingConfig(kind="hashgrid", log2_hashmap_size=19)
    NerfConfig(encoding=grid, network=net, train=TrainConfig(samples_per_ray=48))
    with pytest.raises(ValueError):  # over the MX-grid
        NerfConfig(network=net)
    with pytest.raises(ValueError):  # one proposal level
        NerfConfig(encoding=grid, network=net, train=TrainConfig(proposal_samples=(256,)))
    with pytest.raises(ValueError):  # fewer jitter columns than stages
        NerfConfig(encoding=grid, network=net, train=TrainConfig(samples_per_ray=2))
    with pytest.raises(ValueError):
        NetworkConfig(field="nerfacto", sh_degree=4)  # no appearance rows
    with pytest.raises(ValueError):
        NetworkConfig(field="nerfacto", sh_degree=0, appearance_frames=80)
    with pytest.raises(ValueError):
        NetworkConfig(field="nerfacto", sh_degree=4, appearance_frames=80,
                      proposal_max_resolutions=(128,))
    enc = net.proposal_encoding(1)
    assert (enc.n_levels, enc.n_features_per_level, enc.log2_hashmap_size) == (5, 2, 17)
    assert (enc.base_resolution, enc.desired_resolution) == (16, 256.0)


def test_params_tree_and_install_take_the_references_leaves():
    """The params tree holds the two networks, both proposal fields and the
    appearance codes under `params["mlp"]`; `program.install` writes the
    reference's weights into params and EMA leaf for leaf (13 leaves, A1's
    one launch)."""
    cfg = tiny_cfg()
    _, _, st, w = state_with(cfg, 2, 1)
    mlp = st.params["mlp"]
    assert set(mlp) == {"density", "rgb", "prop0", "prop1", "appearance"}
    assert set(mlp["prop0"]) == {"table", "w0", "w1"}
    assert mlp["rgb"]["w0"].shape == (2, 15 + 16 + 32, 64)
    assert mlp["appearance"].shape == (2, 6, 32)
    assert len(w) == 13 and list(nerfacto.leaf_shapes(cfg))[-1] == "appearance"
    for tree in (st.params, st.ema):
        got = program.leaves(tree, "hashgrid")
        assert set(got) == set(w)
        for k, v in w.items():
            assert torch.equal(got[k], v), k


# --------------------------------------------------------------------------
# The sampler
# --------------------------------------------------------------------------


def test_uniform_edges_equal_the_references():
    g, o, *_ = one_ray_set()
    jitter = torch.rand(o.shape[0], generator=g)
    got = sampler.uniform_edges(jitter, 16, jitter)
    close(got, nerfacto.uniform_edges(16, jitter, "cpu"), 1e-6)
    assert (got[:, 1:] >= got[:, :-1]).all() and (got >= 0).all() and (got <= 1).all()
    plain = sampler.uniform_edges(None, 16, jitter)
    assert torch.equal(plain[3], torch.linspace(0, 1, 17))


def test_pdf_edges_equal_the_references_at_each_anneal():
    """`PDFSampler`'s draw, with one jitter a ray and without, at anneal
    exponents 0 (every weight 1: the uniform PDF), a step's and 1; a ray
    of zero weights draws from the padding's uniform PDF too."""
    g, o, *_ = one_ray_set()
    s = sampler.uniform_edges(torch.rand(32, generator=g), 16, o[:, 0])
    w = torch.rand((32, 16), generator=g) ** 4
    w[0] = 0.0
    jitter = torch.rand(32, generator=g)
    for a in (0.0, float(sampler.anneal(torch.tensor([7]))), 1.0):
        aw = torch.pow(w, a)
        for jit in (jitter, None):
            got = sampler.pdf_edges(s, aw, jit, 8)
            want = nerfacto.pdf_edges(s, aw, 8, jit)
            close(got, want, 1e-6)
            assert (got[:, 1:] >= got[:, :-1]).all()
    # anneal 0 and a zero-weight ray: the uniform PDF over the given edges
    u = torch.linspace(0, 1 - 1 / 9, 9) + 1 / 18
    lin = torch.linspace(0, 1, 17).expand(32, 17)
    for ws in (torch.pow(w, 0.0), torch.zeros_like(w)):
        close(sampler.pdf_edges(lin, ws, None, 8), u.expand(32, 9), 1e-6)


def test_anneal_follows_nerfactos_bias():
    steps = torch.tensor([0, 1, 100, 500, 999, 1000, 5000])
    x = np.minimum(steps.numpy() / 1000.0, 1.0)
    close(sampler.anneal(steps), 10 * x / (9 * x + 1), 1e-6)
    for s in steps.tolist():
        close(sampler.anneal(torch.tensor([s])), nerfacto.anneal(s), 1e-7)


def test_proposal_stages_equal_the_references_sampler():
    """The port's three stages against `reference.nerfacto.sample` on one
    slot's rays: the field's edges and each level's edges and weights."""
    cfg = tiny_cfg()
    ncfg, _, st, w = state_with(cfg, 2, 3)
    g, o, d, tmin, tmax = one_ray_set()
    jitter = torch.rand((32, 8), generator=g)
    box = (torch.full((3,), -0.5), torch.full((3,), 0.5))
    obj = {"aabb_min": box[0], "aabb_max": box[1]}
    for a in (0.0, 0.5):
        one = pytree.tree_map(lambda t: t[:1], st.params)
        _, _, _, edges, levels = nerf._proposal_stages(
            one["mlp"], o[None], d[None], tmin[None], tmax[None], *box, jitter[None], a, ncfg,
            torch.float32)
        want, want_levels = nerfacto.sample({k: v[0] for k, v in w.items()}, o, d, tmin, tmax,
                                            obj, jitter, torch.tensor(a), cfg, FP32)
        close(edges[0], want, 1e-5)
        for (e, wt), (we, ww) in zip(levels, want_levels):
            close(e[0], we, 1e-5)
            close(wt[0], ww, 1e-5)


# --------------------------------------------------------------------------
# Field, losses, one step and three
# --------------------------------------------------------------------------


def test_field_equals_the_reference_with_frames_and_the_mean_code():
    cfg = tiny_cfg()
    ncfg, spec, st, w = state_with(cfg, 2, 3)
    g = torch.Generator().manual_seed(4)
    pts = torch.rand((2, 16, 8, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((2, 16, 3), generator=g), dim=-1)
    frame = torch.randint(0, 9, (2, 16), generator=g)  # rows past 6 wrap
    raw = nerf.field_apply(st.params, pts, dirs, ncfg, spec, frame=frame)
    mean = nerf.field_apply(st.params, pts, dirs, ncfg, spec)
    assert raw.shape == (2, 16, 8, 4) and raw.dtype == torch.float32
    for i in range(2):
        wi = {k: v[i] for k, v in w.items()}
        close(raw[i], nerfacto.forward(wi, pts[i], dirs[i], frame[i], cfg, FP32), 1e-5)
        close(mean[i], nerfacto.forward(wi, pts[i], dirs[i], None, cfg, FP32), 1e-5)
    assert torch.equal(raw[..., 3], mean[..., 3])  # the code moves the colour alone
    assert (raw[..., :3] - mean[..., :3]).abs().max() > 1e-3


def test_each_loss_term_equals_the_references():
    """RGB (with its mask and background terms), interlevel per level and
    distortion, each alone, against the reference's on the same bins."""
    g = torch.Generator().manual_seed(5)
    r, s = 64, 8
    raw = torch.randn((r, s, 4), generator=g)
    lengths = torch.rand((r, s), generator=g) * 0.1
    t = torch.cumsum(lengths, -1)
    target, bg = torch.rand((r, 3), generator=g), torch.rand((r, 3), generator=g)
    is_obj = torch.rand(r, generator=g) > 0.5
    tr = dict(TrainConfig().__dict__)
    edges = torch.sort(torch.rand((r, s + 1), generator=g), -1).values
    batch = losses.ProposalBatch(
        points=torch.zeros(r, s, 3), t=t, rgb_target=target, depth_target=torch.zeros(r),
        is_object=is_obj, bg_color=bg, valid=torch.tensor(True), dirs=torch.zeros(r, 3),
        tmin=torch.zeros(r), tmax=torch.ones(r), frame=torch.zeros(r, dtype=torch.long),
        lengths=lengths, edges=edges, edges0=edges, weights0=torch.zeros(r, s),
        edges1=edges, weights1=torch.zeros(r, s))
    cfg = TrainConfig(interlevel_lambda=0.0, distortion_lambda=0.0)
    loss, aux = losses.composite_loss(raw, batch, cfg)
    want, logged, weights = nerfacto.loss_of(raw, lengths, target, is_obj, bg, tr)
    close(loss, want, 1e-6)
    close(aux["logged_loss"], logged, 1e-6)
    out = render.volume_render(raw, t, bg, lengths=lengths)
    close(out.weights, weights, 1e-6)
    for k in range(2):
        ne = 17 if k == 0 else 9
        cp = torch.sort(torch.rand((r, ne), generator=g), -1).values
        wp = torch.rand((r, ne - 1), generator=g)
        got = losses.interlevel_loss(edges, weights, [(cp, wp)])
        close(got, nerfacto.interlevel_loss(edges, weights, [(cp, wp)]), 1e-6)
        close(losses.outer(edges, cp, wp), nerfacto.outer(edges[:, :-1], edges[:, 1:],
                                                           cp[:, :-1], cp[:, 1:], wp), 1e-6)
    close(losses.distortion_loss(edges, weights), nerfacto.distortion_loss(edges, weights),
          1e-5)


def test_one_step_and_three_equal_the_reference(scene_dir):
    """Three `train_objects` steps of the offline runner's state against
    `reference.nerfacto.step` on the same weights, draws, frames and object
    table: each step's logged loss, the first step's gradient of every leaf
    as Adam holds it, and the params and EMA after the third. The slot the
    table leaves inactive keeps every leaf bit for bit."""
    cfg = tiny_cfg()
    ncfg, r, w = runner_with(scene_dir, cfg, 7)
    n = r.objs_state.capacity
    active = r.objs_state.active.clone()
    active[-1] = False  # a slot the table holds but does not train
    objs = r.objs_state._replace(active=active)
    frames, objects = dataset.read(scene_dir, "cpu")
    draws = check.draws(torch.Generator().manual_seed(8), n, cfg["train"], 3)
    g = torch.Generator().manual_seed(8)
    st = r.state
    ref = {o["slot"]: nerfacto.fresh_state({k: v[o["slot"]] for k, v in w.items()})
           for o in objects}
    b1 = ncfg.optimizer.beta1
    for k in range(3):
        st = nerf.train_objects(st, objs, r.store.arrays(), ncfg, r.spec, 1, generator=g)
        for obj in objects:
            i = obj["slot"]
            if not active[i]:
                continue
            ref[i], logged, seen = nerfacto.step(ref[i], frames, obj,
                                                 tuple(x[i] for x in draws[k]), cfg)
            close(st.loss[i], logged, 1e-5)
            if k == 0:
                grads = program.leaves(st.opt.mu, "hashgrid")
                for name in w:
                    close(grads[name][i] / (1 - b1), seen[name], 1e-4)
    params, ema = program.leaves(st.params, "hashgrid"), program.leaves(st.ema, "hashgrid")
    for i in range(n - 1):
        for name in w:
            close_norm(params[name][i] - w[name][i], ref[i]["params"][name] - w[name][i], 1e-3)
            close_norm(ema[name][i] - w[name][i], ref[i]["ema"][name] - w[name][i], 1e-3)
    assert all(torch.equal(v[-1], w[k][-1]) for k, v in params.items())
    assert int(st.step[-1]) == 0 and int(st.step[0]) == 3


# --------------------------------------------------------------------------
# The runner, renders, meshes, spans
# --------------------------------------------------------------------------


def test_offline_runner_trains_renders_meshes_and_checkpoints(scene_dir, tmp_path):
    cfg = tiny_cfg()
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    assert r.create_nerfs_from_dir() == 3
    out = str(tmp_path / "out")
    r.train(waves=2, steps_per_wave=3, mesh_every=1, out_dir=out)
    assert r.state.step.tolist() == [6, 6, 6]
    assert torch.isfinite(r.state.loss).all()
    for mesh in r.meshes.values():
        if len(mesh.verts):
            assert mesh.colors.shape == mesh.verts.shape and np.isfinite(mesh.colors).all()
    r.render_test_artifacts(out, video=False)
    assert any(f.endswith(".png") for _, _, fs in os.walk(out) for f in fs)

    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(path, r.state, r.objs_state)
    fresh = nerf.init_train_state(torch.Generator().manual_seed(9), r.objs_state.capacity, ncfg,
                                  r.spec)
    back = checkpoint.restore_train_state(checkpoint.load_checkpoint(path)["state"], fresh)
    a, b = pytree.tree_leaves(r.state), pytree.tree_leaves(back)
    assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))


def test_online_manager_trains_grows_reinits_and_meshes():
    """The online manager on a nerfacto field: a slot table that grows from
    1 to 2 slots (fresh proposal fields and codes for the new one), a wave
    of both, a volume update that re-initialises one slot's row, and the
    final retrain and meshes."""
    cfg = program.nerf_config(tiny_cfg())
    res = 32
    cam = Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = make_scene(2)
    frames = make_sequence(cam, objects, 14, radius=5.5)
    mgr = NerfManagerOnline(cfg, train_step_iterations=2, capacity=1, device="cpu")
    mgr.dataset_init(cam.fx, cam.fy, cam.cx, cam.cy, cam.h, cam.w, 16)
    for fi, f in enumerate(frames):
        mgr.new_frame_to_dataset(fi, f["stamp"], f["rgb"], f["instance"], pose=f["twc"])
    vols = []
    for cls, obj in zip((1, 41), objects):
        tow = np.eye(4, dtype=np.float32)
        tow[:3, 3] = -obj.center
        half = obj.aabb_half_extents()
        mgr.create_nerf(cls, tow, -half, half)
        vols.append((tow, -half * 1.3, half * 1.3))
    assert mgr.capacity == 2
    assert mgr.state.params["mlp"]["prop1"]["table"].shape[0] == 2
    for idx, obj in enumerate(objects):
        rows = [(fi, *f["bboxes"][obj.instance_id]) for fi, f in enumerate(frames)
                if f["bboxes"][obj.instance_id] is not None][:12]
        mgr.update_nerf_bbox(idx, rows, 1)
    assert mgr.pump(1) == 1
    assert mgr.state.step.tolist() == [2, 2] and np.isfinite(mgr.losses()).all()
    codes = mgr.state.params["mlp"]["appearance"].clone()
    mgr.update_nerf_volume(1, *vols[1])
    after = mgr.state.params["mlp"]["appearance"]
    assert int(mgr.state.step[1]) == 0 and int(mgr.state.step[0]) == 2
    assert torch.equal(after[0], codes[0]) and not torch.equal(after[1], codes[1])
    mgr.pump()
    mgr.wait_threads_end()
    assert np.isfinite(mgr.losses()).all()


def test_render_samples_through_the_sampler_without_jitter():
    """`render_rays` of a nerfacto field: the proposal stages at the bins'
    midpoints (the jitter given is not read), the mean code, fp32; its
    colour is the reference's render of the same bins."""
    cfg = tiny_cfg()
    ncfg, spec, st, w = state_with(cfg, 1, 12)
    one = pytree.tree_map(lambda a: a[0], st.params)
    g, o, d, tmin, tmax = one_ray_set(24, 3)
    box = (torch.full((3,), -0.5), torch.full((3,), 0.5))
    hit = torch.ones(24, dtype=torch.bool)
    args = (one, o, d, torch.ones(24), tmin, tmax, hit)
    rgb, depth, mask = nerf.render_rays(*args, torch.rand(24, 64, generator=g), *box, ncfg, spec)
    again = nerf.render_rays(*args, torch.rand(24, 64, generator=g), *box, ncfg, spec)
    assert torch.equal(rgb, again[0]) and torch.equal(depth, again[1])
    w0 = {k: v[0] for k, v in w.items()}
    obj = {"aabb_min": box[0], "aabb_max": box[1]}
    edges, _ = nerfacto.sample(w0, o, d, tmin, tmax, obj, None, torch.tensor(1.0), cfg, FP32)
    pts, t, lengths = nerfacto.bins_in_space(edges, o, d, tmin, tmax, obj)
    raw = nerfacto.forward(w0, pts, d, None, cfg, FP32)
    out = render.volume_render(raw, t, torch.full((3,), 1.0), lengths=lengths)
    visible = out.mask > 0.5
    close(rgb[visible], out.rgb[visible], 1e-5)
    close(mask, visible.float(), 0.0)


def test_spans_and_counters_of_a_traced_step(scene_dir):
    """The proposal fields and draws nest the step's spans (`proposal.fwd`
    holds `encode.fwd` and `mlp.fwd`, `batch` holds `sample.pdf`,
    `loss.fwd` the two terms); the counters give the points of each."""
    cfg = tiny_cfg()
    ncfg, r, _ = runner_with(scene_dir, cfg, 2)
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        nerf.train_objects(r.state, r.objs_state, r.store.arrays(), ncfg, r.spec, 2,
                           generator=torch.Generator().manual_seed(1))
    finally:
        tracing.disable()
    summary = tracing.summary(tracing.drain())
    spans, counters = summary["spans"], summary["counters"]
    for key in ("train.step/proposal.fwd", "proposal.fwd/encode.fwd", "proposal.fwd/mlp.fwd",
                "batch/sample.pdf", "loss.fwd/loss.interlevel", "loss.fwd/loss.distortion",
                "train.step/encode.bwd", "train.step/mlp.bwd"):
        assert key in spans, key
    assert spans["proposal.fwd/encode.fwd"]["count"] == 4
    assert spans["batch/sample.pdf"]["count"] == 4
    o = r.objs_state.capacity
    assert counters["sampler.proposal_points"]["total"] == 2 * o * 64 * (16 + 8)
    assert counters["sampler.field_points"]["total"] == 2 * o * 64 * 8


def test_pose_refinement_raises_plainly():
    cfg = tiny_cfg()
    ncfg, spec, st, _ = state_with(cfg, 1, 11)
    one = pytree.tree_map(lambda a: a[0], st.params)
    with pytest.raises(NotImplementedError, match="proposal fields"):
        pose_refine.make_view_loss(one, torch.tensor([40.0, 40.0, 24.0, 24.0]),
                                   torch.eye(4)[None], torch.eye(4), torch.full((3,), -0.5),
                                   torch.full((3,), 0.5), torch.zeros((1, 4, 2)),
                                   torch.zeros((1, 4, 3)), torch.ones((1, 4)),
                                   torch.ones((1, 4)), torch.ones(1, dtype=torch.bool), ncfg,
                                   spec, 1)


# --------------------------------------------------------------------------
# The cell's comparison: control and faults
# --------------------------------------------------------------------------


def overrides(dtype: str) -> dict:
    cfg = tiny_cfg()
    return {"config": {p: dict(cfg[p], compute_dtype=dtype) if p == "train" else cfg[p]
                       for p in TINY}, "traffic": TINY_TRAFFIC}


def test_the_cell_follows_the_reference_and_its_control_departs():
    """The benchmark's own comparison on the cell's traffic at tiny sizes:
    fp32 on the CPU reads fp32 rounding (loss and gradient under 1e-5,
    changes under 1e-3) and is correct; the control one precision down
    (bf16 forward values) reads a gradient and first-update signs a hundred
    times farther off. (At these sizes the bf16 control stays under the
    cell's limits, which separate the card's bf16 program from its fp8
    control at full size: PERF.md, the limits.)"""
    rows = calibrate.readings(WORKLOAD, [5], control=True, device="cpu",
                              overrides=overrides("float32"))
    prog, ctl = rows[0]["program"], rows[0]["control"]
    assert rows[0]["correct"] is True
    assert prog["loss_gap"] < 1e-5 and prog["grad_gap"] < 1e-5
    assert prog["change_gap"] < 1e-3 and prog["ema_gap"] < 1e-3
    assert ctl["grad_gap"] > 100 * max(prog["grad_gap"], 1e-6)
    assert ctl["flip_share"] > 100 * max(prog["flip_share"], 1e-6)


@contextlib.contextmanager
def no_interlevel():
    real = losses.interlevel_loss
    # zero, with the proposal fields still in the graph (their gradient 0)
    losses.interlevel_loss = lambda edges, weights, levels: sum(
        0.0 * wp.sum(dim=(-2, -1)) for _, wp in levels)
    try:
        yield
    finally:
        losses.interlevel_loss = real


@contextlib.contextmanager
def anneal_at_zero():
    real = sampler.anneal
    sampler.anneal = lambda step: torch.zeros_like(step, dtype=torch.float32)
    try:
        yield
    finally:
        sampler.anneal = real


NERFACTO_FAULTS = {"interlevel_dropped": no_interlevel, "anneal_at_zero": anneal_at_zero}


@pytest.mark.parametrize("fault", sorted(FAULTS) + sorted(NERFACTO_FAULTS))
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    """Each fault of `portbench/faults.py`, and nerfacto's own two (the
    interlevel term dropped, the anneal held at 0), planted in the timed
    path, judged by the cell's own limits."""
    if fault in NERFACTO_FAULTS:
        monkeypatch.setitem(FAULTS, fault, NERFACTO_FAULTS[fault])
    rows = calibrate.readings(WORKLOAD, [2**31 + 3], fault=fault, device="cpu",
                              overrides=overrides("float32"))
    assert rows[0]["correct"] is False


def test_the_configuration_file_keeps_nerfactos_widths():
    """`portbench/configs/nerfacto.json` builds the port's config at every
    published width (no key reduced) and the reference's leaves are
    nerfacto's: 2^19 x 2 x 16 field rows, 5 x 2 proposal grids at 2^17,
    the 10 -> 16 -> 1 proposal nets, 63 -> 64 -> 64 -> 3 colour; its
    optimizer is nerfacto's (Adam's betas 0.9 and 0.999, eps 1e-15, no
    weight decay, the rate 1e-2 at step 0 down to 1e-4 at step 200,000)."""
    with open(os.path.join(REPO, "portbench", "configs", "nerfacto.json")) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    ncfg = program.nerf_config(cfg)
    assert ncfg.network.field == "nerfacto" and ncfg.train.proposal_samples == (256, 96)
    assert dataclasses.asdict(ncfg.network)["proposal_max_resolutions"] == (128, 256)
    shapes = nerfacto.leaf_shapes(cfg)
    assert shapes["prop0.w0"] == (10, 16) and shapes["prop1.w1"] == (16, 1)
    assert shapes["rgb.w0"] == (63, 64) and shapes["appearance"] == (80, 32)
    assert shapes["density.w0"] == (32, 64) and shapes["density.w1"] == (64, 16)
    o = ncfg.optimizer
    assert (o.beta1, o.beta2, o.epsilon, o.l2_reg) == (0.9, 0.999, 1e-15, 0.0)
    rate = optimizer_cuda.learning_rate(ncfg, torch.tensor([0, 1, 200000]))
    close(rate[:2], [1e-2, 1e-2 * 0.01 ** (1 / 200000)], 1e-7)
    # the base in fp32 (1.8e-8 above its double) raised to 200,000: 0.4 %
    assert abs(float(rate[2]) / 1e-4 - 1.0) < 5e-3


def test_the_cells_rooflines_count_each_part_at_its_points():
    """The cell's three roofline readers: nothing without their spans
    (as on a program that lacks them), and otherwise the frozen least time
    a step over the spans' device time a step, the networks counted at
    their own points: the field's at 4096 x 48, proposal net k at 4096 x
    proposal_samples[k] (more work than at 48)."""
    from portbench.frozen import network, proposal
    from portbench.metrics import (nerfacto_encode_bwd_roofline, nerfacto_encode_fwd_roofline,
                                   nerfacto_mlp_roofline)

    with open(os.path.join(REPO, "portbench", "configs", "nerfacto.json")) as f:
        cfg = json.load(f)
    readers = {nerfacto_mlp_roofline: ("mlp.fwd", "mlp.bwd"),
               nerfacto_encode_fwd_roofline: ("encode.fwd",),
               nerfacto_encode_bwd_roofline: ("encode.bwd",)}
    for reader, spans in readers.items():
        assert reader.read({}) is None
        assert reader.read({"profile": {"span_s": {"batch": 1.0}}, "slots": 10,
                            "profiled_steps": 5}) is None
    least = proposal.network_least_seconds(cfg, 10)
    shapes = nerfacto.leaf_shapes(cfg)
    at = lambda prefixes, p: network.least_seconds(
        {k: v for k, v in shapes.items() if k.split(".")[0] in prefixes}, "bfloat16", 10, p)
    close(least, at({"density", "rgb"}, 4096 * 48) + at({"prop0"}, 4096 * 256)
          + at({"prop1"}, 4096 * 96), 1e-12)
    assert least > at({"density", "rgb", "prop0", "prop1"}, 4096 * 48)
    ctx = {"profile": {"span_s": {"mlp.fwd": 0.03, "mlp.bwd": 0.02}}, "slots": 10,
           "profiled_steps": 5}
    close(nerfacto_mlp_roofline.read(ctx), 100.0 * least / 0.01, 1e-12)
