"""Port geometry, MLP, volume render and composite loss vs the JAX reference
on the CPU: forward values and gradients (jax.grad vs torch.autograd) on
the same numpy inputs, fp32, rtol/atol 1e-5 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romap_tpu.config import NetworkConfig, TrainConfig
from romap_tpu.ops import geometry as jgeo
from romap_tpu.ops import losses as jloss
from romap_tpu.ops import mlp as jmlp
from romap_tpu.ops import render as jren
from romap_tpu_torch.config import NetworkConfig as TNetworkConfig
from romap_tpu_torch.ops import geometry as tgeo
from romap_tpu_torch.ops import losses as tloss
from romap_tpu_torch.ops import mlp as tmlp
from romap_tpu_torch.ops import render as tren

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def t_(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def check(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


def random_rays(rng, n):
    o = rng.normal(0, 2, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:5, 0] = 0.0  # exactly-zero components take the safe-division branch
    d[5:8, 1] = -0.0
    return o, d


def test_ray_aabb_intersect_forward_and_grad():
    rng = np.random.default_rng(0)
    o, d = random_rays(rng, 64)
    bmin, bmax = np.array([-0.5, -0.4, -0.6], np.float32), np.array([0.5, 0.7, 0.3], np.float32)
    jt = jgeo.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), bmin, bmax)
    to, td = t_(o, True), t_(d, True)
    tt = tgeo.ray_aabb_intersect(to, td, t_(bmin), t_(bmax))
    for g, w in zip(tt, jt):
        check(g, w)

    def jf(o, d):
        tmin, tmax, hit = jgeo.ray_aabb_intersect(o, d, bmin, bmax)
        return jnp.sum(jnp.where(hit, jnp.tanh(tmin) + 0.5 * jnp.tanh(tmax), 0.0))

    jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    tmin, tmax, hit = tt
    loss = torch.sum(torch.where(hit, torch.tanh(tmin) + 0.5 * torch.tanh(tmax),
                                 torch.zeros_like(tmin)))
    tg = torch.autograd.grad(loss, (to, td))
    for g, w in zip(tg, jg):
        assert np.isfinite(g.numpy()).all()
        check(g, w, rtol=1e-4, atol=1e-5)


def test_camera_rays_and_samples_forward_and_grad():
    rng = np.random.default_rng(1)
    n, s = 40, 8
    x = rng.integers(0, 64, n).astype(np.int32)
    y = rng.integers(0, 48, n).astype(np.int32)
    intr = np.array([50.0, 52.0, 32.0, 24.0], np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = q, rng.normal(size=3)
    tow = np.eye(4, dtype=np.float32)
    tow[:3, 3] = rng.normal(size=3)
    jitter = rng.uniform(0, 1, (n, s)).astype(np.float32)
    bmin, bmax = -np.ones(3, np.float32), 2 * np.ones(3, np.float32)

    def jf(pose, tow):
        o, d, dn = jgeo.camera_rays(x, y, jnp.asarray(intr), pose, tow)
        tmin, tmax, _ = jgeo.ray_aabb_intersect(o, d, bmin, bmax)
        t = jgeo.stratified_distances(jnp.maximum(tmin, 0.0), jnp.abs(tmax) + 1.0, jitter, s)
        pts = jgeo.warp_point(o[:, None] + t[..., None] * d[:, None], bmin, bmax)
        return o, d, dn, t, pts

    def tf(pose, tow):
        o, d, dn = tgeo.camera_rays(t_(x), t_(y), t_(intr), pose, tow)
        tmin, tmax, _ = tgeo.ray_aabb_intersect(o, d, t_(bmin), t_(bmax))
        t = tgeo.stratified_distances(torch.clamp(tmin, min=0.0), torch.abs(tmax) + 1.0,
                                      t_(jitter), s)
        pts = tgeo.warp_point(o[:, None] + t[..., None] * d[:, None], t_(bmin), t_(bmax))
        return o, d, dn, t, pts

    jout = jf(jnp.asarray(pose), jnp.asarray(tow))
    tp, tt = t_(pose, True), t_(tow, True)
    tout = tf(tp, tt)
    for g, w in zip(tout, jout):
        check(g, w)
    jg = jax.grad(lambda p, w: jnp.sum(jnp.sin(jf(p, w)[-1])), argnums=(0, 1))(
        jnp.asarray(pose), jnp.asarray(tow))
    tg = torch.autograd.grad(torch.sum(torch.sin(tout[-1])), (tp, tt))
    for g, w in zip(tg, jg):
        check(g, w, rtol=1e-4, atol=1e-4)


def test_mlp_matches_jax():
    rng = np.random.default_rng(2)
    net = NetworkConfig()
    w0 = rng.normal(0, 0.3, (3, 20, 64)).astype(np.float32)
    w1 = rng.normal(0, 0.3, (3, 64, 4)).astype(np.float32)
    x = rng.normal(size=(3, 50, 20)).astype(np.float32)
    want = jax.vmap(lambda a, b, xx: jmlp.apply_mlp({"w0": a, "w1": b}, xx, net))(w0, w1, x)
    params = {"w0": t_(w0, True), "w1": t_(w1, True)}
    got = tmlp.apply_mlp(params, t_(x), TNetworkConfig())
    check(got, want)
    jg = jax.grad(lambda p: jnp.sum(jnp.tanh(jax.vmap(
        lambda a, b, xx: jmlp.apply_mlp({"w0": a, "w1": b}, xx, net))(p["w0"], p["w1"], x))))(
        {"w0": jnp.asarray(w0), "w1": jnp.asarray(w1)})
    tg = torch.autograd.grad(torch.sum(torch.tanh(got)), (params["w0"], params["w1"]))
    check(tg[0], jg["w0"], rtol=1e-4, atol=1e-5)
    check(tg[1], jg["w1"], rtol=1e-4, atol=1e-5)
    # init: He-uniform bounds and shapes as the JAX init
    g = torch.Generator().manual_seed(0)
    p = tmlp.init_mlp(g, 60, TNetworkConfig(), n_objects=2)
    assert p["w0"].shape == (2, 60, 64) and p["w1"].shape == (2, 64, 4)
    assert p["w0"].abs().max() <= (6 / 60) ** 0.5 and p["w1"].abs().max() <= (6 / 64) ** 0.5


def fixed_render_inputs(seed):
    rng = np.random.default_rng(seed)
    r, s = 48, 12
    raw = rng.normal(0, 3, (r, s, 4)).astype(np.float32)
    raw[0, :, 3] = 40.0  # beyond the +-15 clamp
    raw[1, :, 3] = -40.0
    t = np.sort(rng.uniform(0.5, 4.0, (r, s)), axis=-1).astype(np.float32)
    bg = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    return raw, t, bg


def test_volume_render_forward_and_grad():
    raw, t, bg = fixed_render_inputs(3)
    jo = jren.volume_render(jnp.asarray(raw), jnp.asarray(t), jnp.asarray(bg))
    traw = t_(raw, True)
    to = tren.volume_render(traw, t_(t), t_(bg))
    for g, w in zip(to, jo):
        check(g, w)

    def jf(r):
        o = jren.volume_render(r, jnp.asarray(t), jnp.asarray(bg))
        return jnp.sum(o.rgb * 0.3) + jnp.sum(o.depth * 0.1) + jnp.sum(o.mask)

    jg = jax.grad(jf)(jnp.asarray(raw))
    tg, = torch.autograd.grad(torch.sum(to.rgb * 0.3) + torch.sum(to.depth * 0.1)
                              + torch.sum(to.mask), traw)
    check(tg, jg, rtol=1e-4, atol=1e-5)

    d_norm = np.random.default_rng(4).uniform(1, 1.5, raw.shape[0]).astype(np.float32)
    in_bbox = np.arange(raw.shape[0]) % 3 != 0
    jc = jren.render_composite(jo, d_norm, in_bbox, 0.5)
    tc = tren.render_composite(to, t_(d_norm), t_(in_bbox), 0.5)
    for g, w in zip(tc, jc):
        check(g, w)


@pytest.mark.parametrize("valid", [True, False])
def test_composite_loss_forward_and_grad(valid):
    raw, t, bg = fixed_render_inputs(5)
    r = raw.shape[0]
    rng = np.random.default_rng(6)
    is_obj = rng.uniform(size=r) < 0.5
    depth_t = np.where(rng.uniform(size=r) < 0.7, rng.uniform(0.5, 3, r), 0.0).astype(np.float32)
    rgb_t = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    pts = rng.uniform(0, 1, raw.shape[:2] + (3,)).astype(np.float32)
    cfg = TrainConfig()
    jb = jloss.RayBatch(points=pts, t=t, rgb_target=rgb_t, depth_target=depth_t,
                        is_object=is_obj, bg_color=bg, valid=np.bool_(valid))
    tb = tloss.RayBatch(points=t_(pts), t=t_(t), rgb_target=t_(rgb_t),
                        depth_target=t_(depth_t), is_object=t_(is_obj),
                        bg_color=t_(bg), valid=torch.tensor(valid))
    (jl, jaux), jg = jax.value_and_grad(
        lambda x: jloss.composite_loss(x, jb, cfg), has_aux=True)(jnp.asarray(raw))
    traw = t_(raw, True)
    tl, taux = tloss.composite_loss(traw, tb, cfg)
    tg, = torch.autograd.grad(tl, traw)
    check(tl, jl)
    for k in ("logged_loss", "rgb", "depth", "mask"):
        check(taux[k], jaux[k])
    check(tg, jg, rtol=1e-4, atol=1e-6)
