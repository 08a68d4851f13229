"""instant-ngp's NeRF on the port (`NetworkConfig(sh_degree=4)`): the
density network, the degree-4 SH of the view direction and the colour
network, held to the benchmark's plain reference of that field
(`portbench/reference/ngp.py`) on the CPU in fp32 at tiny sizes: 4 levels
of 2^10 rows, 64 rays x 8 samples.

Tolerances: the port and the reference run the same fp32 arithmetic in
another order (batched products, the table's gradient summed by scatter),
so values agree to a few fp32 roundings of the largest entry: 1e-5
relative for forward values and losses, 1e-4 for gradients and one
Adam step (whose update divides by the gradient's own size)."""

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
from portbench.reference import dataset, encodings, ngp
from portbench.reference.precision import FP32
from romap_tpu_torch.config import load_network_config
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops.render import density_activation
from romap_tpu_torch.ops.sh import sh_encode
from romap_tpu_torch.runtime import pose_refine
from romap_tpu_torch.runtime.offline import OfflineRunner
from romap_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "ngp.offline.room10"
TINY = {"encoding": dict(n_levels=4, log2_hashmap_size=10),
        "train": dict(rays_per_batch=64, samples_per_ray=8, mc_resolution=17,
                      compute_dtype="float32")}
TINY_TRAFFIC = {"scene": dict(res=48, frames=12, objects=4), "steps_per_wave": 2}

NGP_JSON = {  # the schema of instant-ngp's configs/nerf/base.json
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 20000, "decay_interval": 10000,
        "decay_base": 0.33, "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9,
                                       "beta2": 0.99, "epsilon": 1e-15, "l2_reg": 1e-6}}},
    "encoding": {"otype": "HashGrid", "n_levels": 16, "n_features_per_level": 2,
                 "log2_hashmap_size": 19, "base_resolution": 16},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                "n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]},
    "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                    "n_neurons": 64, "n_hidden_layers": 2},
}


def tiny_cfg() -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "ngp.json")) as f:
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


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A 48 x 48, 6-frame room of 2 spheres from the benchmark's scene."""
    root = str(tmp_path_factory.mktemp("ngp_scene"))
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
    w = ngp.init_weights(torch.Generator().manual_seed(seed), cfg, n)
    program.install(st, w, "hashgrid")
    return ncfg, spec, st, w


def test_params_tree_is_two_networks():
    cfg = tiny_cfg()
    _, _, st, w = state_with(cfg, 2, 1)
    assert set(st.params["mlp"]) == {"density", "rgb"}
    assert set(st.params["mlp"]["density"]) == {"w0", "w1"}
    assert set(st.params["mlp"]["rgb"]) == {"w0", "w1", "w2"}
    assert list(ngp.leaf_shapes(cfg))[1:] == ["density.w0", "density.w1", "rgb.w0", "rgb.w1",
                                              "rgb.w2"]
    got = program.leaves(st.params, "hashgrid")
    for k, v in w.items():
        assert torch.equal(got[k], v), k
    assert nerf.params_device(st.params) == torch.device("cpu")


def test_field_equals_the_reference():
    """The port's field on seeded weights against the reference's
    `forward`, object by object (rtol 1e-5 of the largest output)."""
    cfg = tiny_cfg()
    ncfg, spec, st, w = state_with(cfg, 2, 3)
    g = torch.Generator().manual_seed(4)
    pts = torch.rand((2, 16, 8, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((2, 16, 3), generator=g), dim=-1)
    raw = nerf.field_apply(st.params, pts, dirs, ncfg, spec)
    assert raw.shape == (2, 16, 8, 4) and raw.dtype == torch.float32
    c = encodings.folding(cfg["encoding"], "cpu")
    for i in range(2):
        want = ngp.forward({k: v[i] for k, v in w.items()}, pts[i], dirs[i], cfg, FP32, c)
        close(raw[i], want, 1e-5)
    # the colour depends on the direction, the density does not
    other = nerf.field_apply(st.params, pts, -dirs, ncfg, spec)
    assert torch.equal(other[..., 3], raw[..., 3])
    assert (other[..., :3] - raw[..., :3]).abs().max() > 1e-3


def test_one_train_step_equals_the_reference(scene_dir):
    """One `train_objects` step of the offline runner's state against
    `reference.ngp.step` on the same weights, draws, frames and object
    table: the logged loss, every leaf's gradient as Adam holds it, and
    the updated params and EMA."""
    cfg = tiny_cfg()
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    r.create_nerfs_from_dir()
    r._build_object_table()
    n = r.objs_state.capacity
    w = ngp.init_weights(torch.Generator().manual_seed(7), cfg, n)
    program.install(r.state, w, "hashgrid")
    st = nerf.train_objects(r.state, r.objs_state, r.store.arrays(), ncfg, r.spec, 1,
                            generator=torch.Generator().manual_seed(8))
    frames, objects = dataset.read(scene_dir, "cpu")
    draws = check.draws(torch.Generator().manual_seed(8), n, cfg["train"], 1)[0]
    b1 = ncfg.optimizer.beta1
    grads = {k: v / (1 - b1) for k, v in program.leaves(st.opt.mu, "hashgrid").items()}
    params, ema = program.leaves(st.params, "hashgrid"), program.leaves(st.ema, "hashgrid")
    followed = 0
    for obj in objects:
        if not obj["active"]:
            continue
        i = obj["slot"]
        new, logged, seen = ngp.step(ngp.fresh_state({k: v[i] for k, v in w.items()}), frames,
                                     obj, tuple(x[i] for x in draws), cfg)
        close(st.loss[i], logged, 1e-5)
        for k in w:
            close(grads[k][i], seen[k], 1e-4)
            close(params[k][i] - w[k][i], new["params"][k] - w[k][i], 1e-4)
            close(ema[k][i] - w[k][i], new["ema"][k] - w[k][i], 1e-4)
        followed += 1
    assert followed == 2


def test_density_grid_is_the_fields_density():
    """`density_on_grid` runs the density network alone: bit for bit the
    density channel of the whole field, whatever the direction."""
    cfg = tiny_cfg()
    ncfg, spec, st, _ = state_with(cfg, 1, 5)
    one = pytree.tree_map(lambda a: a[0], st.params)
    res = 9
    grid = nerf.density_on_grid(one, ncfg, spec, res)
    lin = torch.arange(res, dtype=torch.float32) / (res - 1)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1).reshape(1, -1, 1, 3)
    dirs = torch.nn.functional.normalize(torch.randn((1, res**3, 3)), dim=-1)
    raw = nerf.field_apply(st.params, pts, dirs, ncfg, spec, dtype=torch.float32)
    assert torch.equal(grid, density_activation(raw[0, :, 0, 3]))


def test_sh_is_orthonormal_and_equals_the_reference():
    """The 16 functions integrate to the identity over the sphere (Gauss-
    Legendre in cos theta, uniform in phi: exact for these degrees, to
    1e-6 in fp64), and the port's equal the reference's (1e-6)."""
    nodes, weights = np.polynomial.legendre.leggauss(8)
    phi = np.arange(16) * 2 * np.pi / 16
    ct, ph = np.meshgrid(nodes, phi, indexing="ij")
    st = np.sqrt(1 - ct**2)
    d = torch.tensor(np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1).reshape(-1, 3))
    wq = torch.tensor(np.repeat(weights, 16) * 2 * np.pi / 16)
    for y in (sh_encode(d), ngp.sh4(d)):
        assert y.shape == (128, 16)
        gram = (y * wq[:, None]).T @ y
        assert (gram - torch.eye(16, dtype=gram.dtype)).abs().max() < 1e-6
    u = torch.nn.functional.normalize(torch.randn(500, 3), dim=-1)
    close(sh_encode(u), ngp.sh4(u), 1e-6)


def test_offline_runner_trains_renders_meshes_and_checkpoints(scene_dir, tmp_path):
    cfg = tiny_cfg()
    ncfg = program.nerf_config(cfg)
    r = OfflineRunner(scene_dir, ncfg, device="cpu")
    assert r.create_nerfs_from_dir() == 2
    out = str(tmp_path / "out")
    r.train(waves=2, steps_per_wave=3, mesh_every=1, out_dir=out)
    assert r.state.step.tolist() == [6, 6]
    assert torch.isfinite(r.state.loss).all()
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
    assert set(back.params["mlp"]["rgb"]) == {"w0", "w1", "w2"}


def test_pose_refinement_gradient_flows_through_the_directions():
    """`pose_refine`'s loss differentiated by autograd against central
    differences along a direction of the SE(3) delta, on a field that
    varies with the direction alone (a zero table), so the loss is smooth
    in the pose: it moves through the rays' directions and the box's
    chords. Autograd is within 1 % of the difference quotient; with the
    directions' gradient cut it is off by more than five times that."""
    cfg = tiny_cfg()
    ncfg, spec, st, _ = state_with(cfg, 1, 11)
    with torch.no_grad():
        st.params["table"].zero_()
    one = pytree.tree_map(lambda a: a[0], st.params)
    g = torch.Generator().manual_seed(13)
    r = 96
    xy = 14 + 20 * torch.rand((1, r, 2), generator=g)
    twc = torch.eye(4)[None].clone()
    twc[0, 2, 3] = -2.0  # 2 in front of the unit box, looking at it
    args = (one, torch.tensor([40.0, 40.0, 24.0, 24.0]), twc, torch.eye(4),
            torch.full((3,), -0.5), torch.full((3,), 0.5), xy,
            torch.rand((1, r, 3), generator=g), torch.ones((1, r)), torch.ones((1, r)),
            torch.ones(1, dtype=torch.bool), ncfg, spec, 1)
    delta = 0.01 * torch.randn((1, 6), generator=g)
    u = torch.nn.functional.normalize(torch.randn((1, 6), generator=g), dim=-1)

    def directional(view_loss):
        pv, leaf = view_loss(delta)
        (grad,) = torch.autograd.grad(pv.sum(), leaf)
        return float((grad * u).sum())

    loss = pose_refine.make_view_loss(*args)
    eps = 1e-3
    at = lambda d: float(loss(d)[0].detach().sum())
    fd = (at(delta + eps * u) - at(delta - eps * u)) / (2 * eps)
    full = directional(loss)
    real = pose_refine.field_apply
    pose_refine.field_apply = lambda p, pts, d, *a, **k: real(p, pts, d.detach(), *a, **k)
    try:
        cut = directional(pose_refine.make_view_loss(*args))
    finally:
        pose_refine.field_apply = real
    assert abs(full - fd) <= 0.01 * abs(fd), (full, fd)
    assert abs(cut - fd) > 5 * abs(full - fd), (cut, full, fd)


def test_load_network_config_reads_instant_ngps_schema(tmp_path):
    path = tmp_path / "base.json"
    path.write_text(json.dumps(NGP_JSON))
    cfg = load_network_config(str(path))
    net = cfg.network
    assert (net.sh_degree, net.n_neurons, net.n_hidden_layers) == (4, 64, 1)
    assert (net.rgb_n_neurons, net.rgb_n_hidden_layers, net.output_dims) == (64, 2, 16)
    assert cfg.encoding.log2_hashmap_size == 19 and cfg.optimizer.ema_decay == 0.95
    alone = dict(NGP_JSON, dir_encoding={"otype": "SphericalHarmonics", "degree": 4},
                 rgb_network={"n_neurons": 32, "n_hidden_layers": 1})
    path.write_text(json.dumps(alone))
    net = load_network_config(str(path)).network
    assert (net.sh_degree, net.rgb_n_neurons, net.rgb_n_hidden_layers) == (4, 32, 1)
    with pytest.raises(ValueError):
        path.write_text(json.dumps(dict(NGP_JSON, dir_encoding={
            "otype": "SphericalHarmonics", "degree": 3})))
        load_network_config(str(path))


def overrides(dtype: str) -> dict:
    cfg = tiny_cfg()
    return {"config": {p: dict(cfg[p], compute_dtype=dtype) if p == "train" else cfg[p]
                       for p in TINY}, "traffic": TINY_TRAFFIC}


def test_the_cell_follows_the_reference_and_its_control_departs():
    """The benchmark's own comparison on the cell's traffic at tiny sizes:
    fp32 on the CPU reads fp32 rounding (loss and gradient under 1e-5,
    changes under 1e-4) and is correct; the control one precision down
    (bf16 forward values) is not."""
    rows = calibrate.readings(WORKLOAD, [5], control=True, device="cpu",
                              overrides=overrides("float32"))
    prog = rows[0]["program"]
    assert rows[0]["correct"] is True and rows[0]["control_correct"] is False
    assert prog["loss_gap"] < 1e-5 and prog["grad_gap"] < 1e-5
    assert prog["change_gap"] < 1e-4 and prog["ema_gap"] < 1e-4


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    """Each fault of `portbench/faults.py` planted in the timed path, judged
    by the cell's own limits."""
    rows = calibrate.readings(WORKLOAD, [2**31 + 3], fault=fault, device="cpu",
                              overrides=overrides("float32"))
    assert rows[0]["correct"] is False
