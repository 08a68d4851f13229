"""The port's train slice vs romap_tpu on the CPU: batch generation, one
train step, a 3-step wave, slot masking, the state bridge, and that the
port runs without jax.

Both sides start from the same weights (JAX's init, moved with
`romap_tpu_torch.utils.jax_bridge`) and consume the same uniforms: the
port replays the draws JAX makes from its per-object keys. JAX runs its
CPU path (XLA encode); the port its plain encode.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from romap_tpu.config import EncodingConfig, NerfConfig, TrainConfig
from romap_tpu.data.world import build_synthetic_world as jworld
from romap_tpu.models import nerf as jnerf
from romap_tpu.ops import losses as jloss
from romap_tpu_torch import config as tconfig
from romap_tpu_torch.data.world import build_synthetic_world as tworld
from romap_tpu_torch.models import nerf as tnerf
from romap_tpu_torch.ops import losses as tloss
from romap_tpu_torch.utils import jax_bridge

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJ, CAP = 2, 3  # slot 2 stays inactive


def tiny_cfg():
    return NerfConfig(
        encoding=EncodingConfig(kind="mxgrid", mx_levels=2, mx_max_resolution=32,
                                mx_features=8, mx_plane_res=16, mx_plane_features=4,
                                mx_impl="xla"),
        train=TrainConfig(rays_per_batch=64, samples_per_ray=4),
    )


def port_config(cfg):
    """The port's NerfConfig with the fields of a JAX one; the port's own
    fields (instant-ngp's view branch) keep their defaults, RO-MAP's head."""
    part = lambda cls, c: cls(**dataclasses.asdict(c))
    return tconfig.NerfConfig(encoding=part(tconfig.EncodingConfig, cfg.encoding),
                              network=part(tconfig.NetworkConfig, cfg.network),
                              optimizer=part(tconfig.OptimizerConfig, cfg.optimizer),
                              train=part(tconfig.TrainConfig, cfg.train), seed=cfg.seed)


@pytest.fixture(scope="module")
def worlds():
    cfg = tiny_cfg()
    _, _, _, jstore, jobjs = jworld(N_OBJ, 3, 32, capacity=CAP)
    _, _, _, tstore, tobjs = tworld(N_OBJ, 3, 32, capacity=CAP)
    return cfg, (jstore.arrays(), jobjs), (tstore.arrays(), tobjs)


def jax_uniforms(keys, cfg):
    """The uniforms JAX's _object_train_step draws for one step (split the
    slot key, then split k_batch in three as nerf.py:247), per object."""
    r, s = cfg.train.rays_per_batch, cfg.train.samples_per_ray

    def one(key):
        key, k_batch = jax.random.split(key)
        k_xy, k_color, k_jitter = jax.random.split(k_batch, 3)
        return key, (jax.random.uniform(k_xy, (r, 2)), jax.random.uniform(k_color, (r, 3)),
                     jax.random.uniform(k_jitter, (r, s)))

    return jax.vmap(one)(keys)


def replay(keys, cfg):
    """A port `uniforms` source that replays JAX's per-step draws."""
    box = [keys]

    def draw():
        box[0], u = jax_uniforms(box[0], cfg)
        return tuple(torch.from_numpy(np.array(a)) for a in u)

    return draw


def jax_state(cfg, seed=0):
    spec = jnerf.make_field_spec(cfg)
    return spec, jax.device_get(jnerf.init_train_state(jax.random.PRNGKey(seed), CAP, cfg, spec))


def test_generate_batch_matches_jax(worlds):
    cfg, (jframes, jobjs), (tframes, tobjs) = worlds
    keys = jax.random.split(jax.random.PRNGKey(4), CAP)
    _, u = jax_uniforms(keys, cfg)
    k_batch = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    want = jax.jit(jax.vmap(
        lambda kb, *ob: jnerf.generate_batch(kb, jframes, *ob, cfg, use_depth=False)))(
        k_batch, *tuple(jobjs)[:6])
    got = tnerf.generate_batch(tframes, *tobjs[:6], port_config(cfg),
                               tuple(torch.from_numpy(np.array(a)) for a in u),
                               use_depth=False)
    # the background colours are distinct uniforms per ray, so equal
    # bg_color rows mean the same compaction and rollover order
    np.testing.assert_array_equal(got.bg_color.numpy(), np.asarray(want.bg_color))
    np.testing.assert_array_equal(got.is_object.numpy(), np.asarray(want.is_object))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    # XLA's jit folds the /255 into a multiply: targets agree to 1 ulp
    np.testing.assert_allclose(got.rgb_target.numpy(), np.asarray(want.rgb_target),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.depth_target.numpy(), np.asarray(want.depth_target),
                               rtol=1e-6, atol=0)
    assert np.asarray(want.valid)[:N_OBJ].all() and not np.asarray(want.valid)[N_OBJ]


def test_loss_and_gradients_match_jax(worlds):
    """One batch through field + loss: loss, logged loss and every
    parameter gradient (rtol 1e-4, atol 1e-4 x the leaf's largest entry)."""
    cfg, (jframes, jobjs), (tframes, tobjs) = worlds
    tcfg = port_config(cfg)
    spec, js = jax_state(cfg, seed=1)
    tspec = tnerf.make_field_spec(tcfg)
    ts = jax_bridge.train_state_from_jax(js)
    _, u = jax_uniforms(js.key, cfg)
    batch = tnerf.generate_batch(tframes, *tobjs[:6], tcfg,
                                 tuple(torch.from_numpy(np.array(a)) for a in u),
                                 use_depth=False)
    jb = jloss.RayBatch(*[jnp.asarray(getattr(batch, f).numpy()) for f in jloss.RayBatch._fields])

    def jloss_fn(p, b):
        raw = jnerf.field_apply(p, b.points, cfg, spec)
        return jloss.composite_loss(raw, b, cfg.train)

    (jl, jaux), jg = jax.jit(jax.vmap(jax.value_and_grad(jloss_fn, has_aux=True)))(
        js.params, jb)
    params = jax.tree.map(lambda a: a.requires_grad_(True), ts.params)
    raw = tnerf.field_apply(params, batch.points, batch.dirs, tcfg, tspec)
    tl, taux = tloss.composite_loss(raw, batch, tcfg.train)
    leaves = jax.tree.leaves(params)
    tg = torch.autograd.grad(tl.sum(), leaves)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux["logged_loss"].detach().numpy(),
                               np.asarray(jaux["logged_loss"]), rtol=1e-5, atol=1e-6)
    for g, w in zip(tg, jax.tree.leaves(jg)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def rebuild_jax_state(like, arrays):
    """The JAX TrainState for numpy leaves from jax_bridge.train_state_to_numpy."""
    found_nan, count, mu, nu = arrays["opt_state"]
    opt = (optax.ZeroNansState(found_nan=found_nan), optax.EmptyState(),
           optax.ScaleByAdamState(count=count, mu=mu, nu=nu))
    return like._replace(params=arrays["params"], ema=arrays["ema"], opt_state=opt,
                         step=arrays["step"], loss=arrays["loss"])


def test_bridge_round_trips_exactly():
    cfg = tiny_cfg()
    _, js = jax_state(cfg, seed=2)
    js = js._replace(step=js.step + 7, loss=np.linspace(0, 1, CAP).astype(np.float32))
    back = rebuild_jax_state(js, jax_bridge.train_state_to_numpy(
        jax_bridge.train_state_from_jax(js)))
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def close_share(a, b, atol, rtol):
    return float(np.mean(np.abs(a - b) <= atol + rtol * np.abs(b)))


@pytest.mark.parametrize("n_iters", [1, 3])
def test_train_objects_matches_jax(worlds, n_iters):
    """One step and a 3-step wave from the same weights and uniforms.

    Loss, step and Adam count must agree outright. Adam with eps=1e-15
    makes its update ~sign(g), so a gradient entry that is rounding noise
    on both sides may take a full +-lr step of opposite sign; params, EMA
    and the moments are therefore compared by the share of entries within
    tolerance (>= 99.9%), the moments' gradients by the test above.
    """
    cfg, (jframes, jobjs), (tframes, tobjs) = worlds
    tcfg = port_config(cfg)
    spec, js = jax_state(cfg, seed=3)
    tspec = tnerf.make_field_spec(tcfg)
    ts = jax_bridge.train_state_from_jax(js)
    ts = tnerf.train_objects(ts, tobjs, tframes, tcfg, tspec, n_iters,
                             uniforms=replay(js.key, cfg))
    jout = jax.device_get(jnerf.train_objects(jax.tree.map(jnp.asarray, js), jobjs,
                                              jframes, cfg, spec, n_iters))
    got = jax_bridge.train_state_to_numpy(ts)
    np.testing.assert_array_equal(got["step"], jout.step)
    np.testing.assert_array_equal(got["opt_state"][1], jout.opt_state[2].count)
    np.testing.assert_allclose(got["loss"], jout.loss, rtol=1e-4, atol=1e-6)
    assert (got["step"][:N_OBJ] == n_iters).all() and got["step"][N_OBJ] == 0
    pairs = [("params", got["params"], jout.params), ("ema", got["ema"], jout.ema),
             ("mu", got["opt_state"][2], jout.opt_state[2].mu),
             ("nu", got["opt_state"][3], jout.opt_state[2].nu)]
    for name, a, b in pairs:
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            y = np.asarray(y)
            scale = np.abs(y).max() + 1e-30
            share = close_share(x, y, atol=1e-5 * scale, rtol=1e-4)
            assert share >= 0.999, (name, x.shape, share)


def test_inactive_slot_and_empty_batch_keep_state(worlds):
    jcfg, _, (tframes, tobjs) = worlds
    cfg = port_config(jcfg)
    spec = tnerf.make_field_spec(cfg)
    far = tobjs.aabb_min.clone()
    far[1] += 1e4  # slot 1 is active, but every ray misses its box
    objs = tobjs._replace(aabb_min=far, aabb_max=far + 1.0)
    g = torch.Generator().manual_seed(0)
    s0 = tnerf.init_train_state(g, CAP, cfg, spec)
    s1 = tnerf.train_objects(s0, objs, tframes, cfg, spec, 2, generator=g)
    for a, b in zip(jax.tree.leaves(jax_bridge.train_state_to_numpy(s0)),
                    jax.tree.leaves(jax_bridge.train_state_to_numpy(s1))):
        np.testing.assert_array_equal(a[1:], b[1:])
    assert s1.step.tolist() == [2, 0, 0]
    assert s1.loss[1:].tolist() == [0.0, 0.0]
    assert (s1.params["table"]["lines"][0] != s0.params["table"]["lines"][0]).any()


def test_port_runs_without_jax():
    """A train wave, the online manager, a dataset writer and the evaluator
    run (and the quality gate imports) in a process that has imported
    neither jax nor any module of romap_tpu."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from romap_tpu_torch.config import EncodingConfig, NerfConfig, TrainConfig\n"
        "from romap_tpu_torch.data.world import build_synthetic_world\n"
        "from romap_tpu_torch.models import nerf\n"
        "from romap_tpu_torch.runtime.manager import NerfManagerOnline\n"
        "import romap_tpu_torch.ops.cuda_lib, romap_tpu_torch.ops.mxgrid_cuda\n"
        "import romap_tpu_torch.utils.jax_bridge\n"
        "import romap_tpu_torch.runtime.server, romap_tpu_torch.runtime.offline\n"
        "cfg = NerfConfig(encoding=EncodingConfig(mx_levels=2, mx_max_resolution=32,"
        " mx_features=8, mx_plane_res=16, mx_plane_features=4),"
        " train=TrainConfig(rays_per_batch=64, samples_per_ray=4, mc_resolution=9))\n"
        "spec = nerf.make_field_spec(cfg)\n"
        "cam, objects, frames, store, objs = build_synthetic_world(2, 3, 32)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "s = nerf.init_train_state(g, objs.capacity, cfg, spec)\n"
        "s = nerf.train_objects(s, objs, store.arrays(), cfg, spec, 2, generator=g)\n"
        "assert torch.isfinite(s.loss).all() and s.step.tolist() == [2, 2]\n"
        "m = NerfManagerOnline(cfg, train_step_iterations=2, capacity=2, device='cpu')\n"
        "m.dataset_init(cam.fx, cam.fy, cam.cx, cam.cy, cam.h, cam.w, 16)\n"
        "for i, f in enumerate(frames):\n"
        "    m.new_frame_to_dataset(i, f['stamp'], f['rgb'], f['instance'], pose=f['twc'])\n"
        "idx = m.create_nerf(int(objects[0].instance_id), objs.tow[0].numpy(),"
        " objs.aabb_min[0].numpy() / 1.1, objs.aabb_max[0].numpy() / 1.1)\n"
        "m.update_nerf_bbox(idx, [(i % 3, 0, 0, 32, 32) for i in range(11)], 1)\n"
        "assert m.pump() == 1 and m.state.step.tolist() == [2, 0]\n"
        "import tempfile, romap_tpu_torch.tools.quality_gate\n"
        "from romap_tpu_torch.data import world\n"
        "from romap_tpu_torch.utils import eval_psnr\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    world.write_room_dataset(d + '/ds', n_frames=2, res=32)\n"
        "    assert eval_psnr.evaluate_tree(d, d + '/ds') == {'objects': {}, 'aggregate': {}}\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'romap_tpu.'))"
        " or k == 'romap_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
