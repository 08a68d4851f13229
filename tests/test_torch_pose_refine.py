"""The port's photometric pose refinement vs romap_tpu on the CPU: `se3_exp`
values and gradients, `refine_poses` on bridged params with JAX's start
jitters, and a perturbed view pose pulled back toward the truth by the
port's own refinement against a field the port trained."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from romap_tpu import config as jcfg
from romap_tpu.data.world import build_synthetic_world as jworld
from romap_tpu.models import nerf as jnerf
from romap_tpu.ops import geometry as jgeo
from romap_tpu.runtime import pose_refine as jpr
from romap_tpu_torch import config as tcfg
from romap_tpu_torch.data.world import build_synthetic_world as tworld
from romap_tpu_torch.models import nerf as tnerf
from romap_tpu_torch.ops import geometry as tgeo
from romap_tpu_torch.runtime import pose_refine as tpr
from romap_tpu_torch.utils import jax_bridge

torch.set_num_threads(2)


@pytest.mark.parametrize("angle", [0.0, 1e-7, 1e-3, 0.3, 2.5])
def test_se3_exp_values_and_grads_equal_jax(angle):
    """Forward and d(sum(W * exp(delta)))/d delta at zero (the Taylor branch,
    where the untaken branch must not put a NaN into the gradient), tiny,
    small and large angles; fp32, rtol/atol 1e-5 (values), 1e-4 (grads)."""
    rng = np.random.default_rng(3)
    axes = rng.normal(size=(5, 3))
    w = (angle * axes / np.linalg.norm(axes, axis=1, keepdims=True)).astype(np.float32)
    delta = np.concatenate([w, rng.normal(0, 0.5, (5, 3)).astype(np.float32)], axis=1)
    weight = rng.normal(size=(5, 4, 4)).astype(np.float32)
    want = jgeo.se3_exp(jnp.asarray(delta))
    want_g = jax.grad(lambda d: jnp.sum(jgeo.se3_exp(d) * weight))(jnp.asarray(delta))
    td = torch.tensor(delta, requires_grad=True)
    got = tgeo.se3_exp(td)
    (got_g,) = torch.autograd.grad(torch.sum(got * torch.tensor(weight)), td)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got_g).all()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)
    r = got.detach().numpy()[:, :3, :3]
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-5)


def tiny_configs():
    enc = dict(kind="mxgrid", mx_levels=2, mx_max_resolution=32, mx_features=8,
               mx_plane_res=16, mx_plane_features=4, mx_impl="xla")
    train = dict(rays_per_batch=64, samples_per_ray=4)
    return (jcfg.NerfConfig(encoding=jcfg.EncodingConfig(**enc), train=jcfg.TrainConfig(**train)),
            tcfg.NerfConfig(encoding=tcfg.EncodingConfig(**enc), train=tcfg.TrainConfig(**train)))


def crops_of(frame, instance_id):
    x, y, h, w = frame["bboxes"][instance_id]
    mask = (frame["instance"][y : y + h, x : x + w] == instance_id).astype(np.uint8) * 255
    return (x, y, h, w), (frame["rgb"][y : y + h, x : x + w], mask)


def test_refine_poses_equals_jax():
    """Bridged params of a JAX state trained 20 steps, the same pixel batch
    (the reference's own `build_refine_batch`, 4 padded views, two valid)
    and JAX's start jitters (PRNGKey(17)), 3 starts, 4 Adam steps, 8
    samples a ray: `loss0` within rtol 1e-5, the final losses within 1e-4
    and the refined poses within 2e-4 (fp32 sums in another order, through
    four Adam steps, whose first moves every component by the step size
    whatever the gradient's size)."""
    jc, tc = tiny_configs()
    jspec, tspec = jnerf.make_field_spec(jc), tnerf.make_field_spec(tc)
    _, objects, seq, store, objs = jworld(n_objects=1, n_frames=3, res=32)
    jstate = jnerf.init_train_state(jax.random.PRNGKey(0), 1, jc, jspec)
    jstate = jnerf.train_objects(jstate, objs, store.arrays(), jc, jspec, 20, False)
    jparams = jax.tree.map(lambda a: a[0], jstate.ema)
    tparams = pytree.tree_map(lambda a: a[0], jax_bridge.train_state_from_jax(
        jax.device_get(jstate)).ema)

    boxes, crops = zip(*(crops_of(seq[i], objects[0].instance_id) for i in (0, 2)))
    batch = jpr.build_refine_batch(list(boxes), list(crops), n_px=96)
    assert batch["valid"].tolist() == [True, True, False, False]
    rng = np.random.default_rng(1)
    twc0 = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for i, fi in enumerate((0, 2)):
        twc0[i] = seq[fi]["twc"] @ np.asarray(jgeo.se3_exp(jnp.asarray(
            rng.normal(0, 0.01, 6).astype(np.float32))))
    args = [store._intrinsics, twc0, np.asarray(objs.tow[0]), np.asarray(objs.aabb_min[0]),
            np.asarray(objs.aabb_max[0]), batch["xy"], batch["rgb"], batch["w_rgb"],
            batch["mask"], batch["valid"]]
    want = jpr.refine_poses(jparams, *map(jnp.asarray, args), jc, jspec, n_steps=4,
                            n_samples=8, n_starts=3)
    noise = jax.random.normal(jax.random.PRNGKey(17), (4, 3, 6), jnp.float32)
    got = tpr.refine_poses(tparams, *(torch.as_tensor(np.array(a)) for a in args), tc, tspec,
                           torch.as_tensor(np.array(noise)), n_steps=4, n_samples=8)
    twc_w, loss0_w, loss_w = (np.asarray(a) for a in want)
    twc_g, loss0_g, loss_g = (t.numpy() for t in got)
    np.testing.assert_allclose(loss0_g, loss0_w, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(loss_g, loss_w, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(twc_g, twc_w, atol=2e-4)
    assert (loss0_g[:2] > 0).all() and (loss_g[:2] <= loss0_g[:2]).all()
    np.testing.assert_array_equal(twc_g[2:], twc0[2:])  # invalid views keep their pose


def _pose_err(twc_a, twc_b):
    dt = float(np.linalg.norm(twc_a[:3, 3] - twc_b[:3, 3]))
    dr = np.clip((np.trace(twc_a[:3, :3].T @ twc_b[:3, :3]) - 1) / 2, -1, 1)
    return dt, float(np.degrees(np.arccos(dr)))


def test_refine_recovers_perturbed_pose(monkeypatch):
    """As tests/test_pose_refine.py: the field that test trains (JAX, 400
    steps, bridged to the port), two views rotated by 0.02 rad and shifted
    by N(0, 0.02) per axis, refined by the port from 2 starts for 40 steps
    at 384 pixels and 16 samples (cut from 4 x 300 at 1536 x 32 to keep the
    CPU test short): the mean loss falls and at least one view comes
    strictly closer in both rotation and translation."""
    monkeypatch.setattr(tpr, "N_PIXELS", 384)
    monkeypatch.setattr(tpr, "N_SAMPLES", 16)
    enc = dict(kind="mxgrid", mx_levels=3, mx_max_resolution=64, mx_features=16,
               mx_plane_res=32, mx_plane_features=8)
    jc = jcfg.NerfConfig(encoding=jcfg.EncodingConfig(**enc),
                         train=jcfg.TrainConfig(rays_per_batch=1024, samples_per_ray=16))
    cfg = tcfg.NerfConfig(encoding=tcfg.EncodingConfig(**enc),
                          train=tcfg.TrainConfig(rays_per_batch=1024, samples_per_ray=16))
    jspec, spec = jnerf.make_field_spec(jc), tnerf.make_field_spec(cfg)
    _, objects, seq, store, objs = jworld(n_objects=1, n_frames=24, res=96)
    jstate = jnerf.init_train_state(jax.random.PRNGKey(0), 1, jc, jspec)
    jstate = jnerf.train_objects(jstate, objs, store.arrays(), jc, jspec, 400, False)
    assert float(jstate.loss[0]) < 0.3  # converged enough to align to
    params = pytree.tree_map(lambda a: a[0], jax_bridge.train_state_from_jax(
        jax.device_get(jstate)).ema)

    rng = np.random.default_rng(0)
    boxes, crops, twcs_true, twcs_pert = [], [], [], []
    for fi in (5, 15):
        box, crop = crops_of(seq[fi], objects[0].instance_id)
        boxes.append(box)
        crops.append(crop)
        twc = np.asarray(seq[fi]["twc"], np.float32)
        pert = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.02), np.sin(0.02)
        pert[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        pert[:3, 3] = rng.normal(0, 0.02, 3)
        twcs_true.append(twc)
        twcs_pert.append(twc @ pert)
    refined, stats = tpr.refine_view_poses_host(
        params, store._intrinsics, twcs_pert, np.asarray(objs.tow[0]),
        np.asarray(objs.aabb_min[0]), np.asarray(objs.aabb_max[0]), boxes, crops, cfg, spec,
        n_steps=40, n_starts=2)
    assert stats["refined"] >= 1
    assert stats["mean_loss_after"] < stats["mean_loss_before"]
    improved = 0
    for twc_t, twc_p, twc_r in zip(twcs_true, twcs_pert, refined):
        dt0, dr0 = _pose_err(twc_t, twc_p)
        dt1, dr1 = _pose_err(twc_t, twc_r)
        improved += dt1 < dt0 and dr1 < dr0
    assert improved >= 1


def test_refine_noop_without_object_pixels():
    _, tc = tiny_configs()
    spec = tnerf.make_field_spec(tc)
    _, _, seq, store, objs = tworld(1, 3, 32)
    state = tnerf.init_train_state(torch.Generator().manual_seed(0), 1, tc, spec)
    params = pytree.tree_map(lambda a: a[0], state.ema)
    twc = np.asarray(seq[0]["twc"], np.float32)
    refined, stats = tpr.refine_view_poses_host(
        params, store._intrinsics, [twc], objs.tow[0].numpy(), objs.aabb_min[0].numpy(),
        objs.aabb_max[0].numpy(), [(0, 0, 8, 8)],
        [(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8), np.uint8))], tc, spec)
    assert stats["refined"] == 0
    np.testing.assert_array_equal(refined[0], twc)
