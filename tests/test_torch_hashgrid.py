"""The port's hash-grid encoding (`romap_tpu_torch/ops/hashgrid.py`) vs
romap_tpu on the CPU: its layout, the per-point oracle of
tests/oracles.py, trilinearity, finite differences, values and gradients
equal to JAX's (table and points, points outside the cube included), and a
train step of a hash-grid config equal to JAX's from the same weights and
uniforms."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from romap_tpu import config as jcfg
from romap_tpu.data.world import build_synthetic_world as jworld
from romap_tpu.models import nerf as jnerf
from romap_tpu.ops import hashgrid as jhash
from romap_tpu_torch import config as tcfg
from romap_tpu_torch.data.world import build_synthetic_world as tworld
from romap_tpu_torch.models import nerf as tnerf
from romap_tpu_torch.ops import hashgrid as thash
from romap_tpu_torch.ops import cuda_lib, hashgrid_cuda, mlp_cuda, mxgrid_cuda
from romap_tpu_torch.utils import checkpoint, jax_bridge
from tests.oracles import hashgrid_encode_ref
from tests.test_torch_train import close_share, replay

torch.set_num_threads(2)

SMALL = dict(kind="hashgrid", n_levels=4, n_features_per_level=2, log2_hashmap_size=9,
             base_resolution=4, desired_resolution=64.0)


def specs(**enc):
    return (jhash.make_spec(jcfg.EncodingConfig(**enc)),
            thash.make_spec(tcfg.EncodingConfig(**enc)))


@pytest.mark.parametrize("enc", [{}, SMALL], ids=["reference", "small"])
def test_spec_equals_jax(enc):
    jspec, tspec = specs(**enc)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.n_output_dims == jspec.n_output_dims


def test_encode_matches_oracle():
    _, spec = specs(**SMALL)
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (spec.total_params, spec.n_features)).astype(np.float32)
    x = rng.uniform(0, 1, size=(64, 3)).astype(np.float32)
    got = thash.encode(torch.tensor(table)[None], torch.tensor(x)[None], spec)[0]
    np.testing.assert_allclose(got.numpy(), hashgrid_encode_ref(table, x, spec),
                               rtol=2e-4, atol=2e-5)


def test_encode_interpolation_is_trilinear():
    """Features vary linearly between two lattice points of the one level."""
    _, spec = specs(n_levels=1, n_features_per_level=1, log2_hashmap_size=12,
                    base_resolution=4, desired_resolution=4.0)
    table = torch.tensor(np.random.default_rng(2).normal(size=(1, spec.total_params, 1)),
                         dtype=torch.float32)
    x0, x1 = (1.0 - 0.5) / spec.scales[0], (2.0 - 0.5) / spec.scales[0]
    lam = np.linspace(0, 1, 11)
    pts = np.stack([x0 + lam * (x1 - x0), np.full_like(lam, x0), np.full_like(lam, x0)], -1)
    f = thash.encode(table, torch.tensor(pts, dtype=torch.float32)[None], spec)[0, :, 0].numpy()
    np.testing.assert_allclose(f, f[0] + (f[-1] - f[0]) * lam, rtol=1e-4, atol=1e-5)


def test_encode_gradient_matches_finite_differences():
    _, spec = specs(n_levels=2, n_features_per_level=1, log2_hashmap_size=6,
                    base_resolution=3, desired_resolution=8.0)
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.normal(size=(1, spec.total_params, 1)), dtype=torch.float64)
    x = torch.tensor(rng.uniform(0.1, 0.9, size=(1, 4, 3)), dtype=torch.float32)
    f = lambda t: torch.sum(torch.sin(thash.encode(t, x, spec)))
    t = table.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(t), t)
    eps = 1e-3
    for i in rng.integers(0, spec.total_params, size=12):
        tp, tm = table.clone(), table.clone()
        tp[0, i, 0] += eps
        tm[0, i, 0] -= eps
        fd = (float(f(tp)) - float(f(tm))) / (2 * eps)
        np.testing.assert_allclose(float(g[0, i, 0]), fd, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("enc", [SMALL, {}], ids=["small", "reference"])
def test_encode_values_and_grads_equal_jax(enc):
    """Two objects, points inside and up to 0.3 outside the unit cube (the
    uint32 wrap of negative cells, and hashed levels with the reference's
    layout): values within rtol 1e-5, table and points gradients of
    sum(sin(3 f)) within rtol 1e-5 / 1e-4 (fp32 sums in another order)."""
    jspec, tspec = specs(**enc)
    rng = np.random.default_rng(4)
    table = rng.normal(size=(2, tspec.total_params, tspec.n_features)).astype(np.float32)
    x = rng.uniform(-0.3, 1.3, size=(2, 5, 40, 3)).astype(np.float32)
    loss = lambda t, p: jnp.sum(jnp.sin(3 * jax.vmap(
        lambda a, b: jhash.encode(a, b, jspec))(t, p)))
    want = jax.vmap(lambda a, b: jhash.encode(a, b, jspec))(table, x)
    want_gt, want_gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tt, tx = torch.tensor(table, requires_grad=True), torch.tensor(x, requires_grad=True)
    got = thash.encode(tt, tx, tspec)
    got_gt, got_gx = torch.autograd.grad(torch.sum(torch.sin(3 * got)), (tt, tx))
    assert got.shape == (2, 5, 40, tspec.n_output_dims)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_gt.numpy(), np.asarray(want_gt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), rtol=1e-4, atol=1e-4)


def test_tcnn_preset_builds_a_hash_grid_and_sorted_raises():
    spec = tnerf.make_field_spec(tcfg.NerfConfig(encoding=tcfg.EncodingConfig.preset("tcnn")))
    want = jnerf.make_field_spec(jcfg.NerfConfig(encoding=jcfg.EncodingConfig.preset("tcnn")))
    assert dataclasses.asdict(spec) == dataclasses.asdict(want)
    with pytest.raises(NotImplementedError, match="sorted"):
        tnerf.make_field_spec(tcfg.NerfConfig(
            encoding=tcfg.EncodingConfig(kind="hashgrid", hash_impl="sorted")))


@pytest.mark.parametrize("n_iters", [1, 2])
def test_hash_grid_train_step_equals_jax(tmp_path, n_iters):
    """JAX's weights (moved with jax_bridge) and JAX's uniforms, 2 objects,
    a small hash-grid config: loss and steps agree, and the Adam moments by
    the share of entries within tolerance (>= 99.9 %) as in
    tests/test_torch_train.py. The params are held so after one step only:
    Adam with eps 1e-15 moves every entry by about the step size whatever
    its gradient's size, and a hash-table entry that only a far corner's
    weight reaches gets a gradient at rounding level; after two steps the
    ratio of two such gradients sets the step, and 0.7 % of the entries
    then differ. Then the state round-trips through the checkpoint exactly."""
    cap = 2
    enc = dict(SMALL, mx_impl="xla")
    train = dict(rays_per_batch=64, samples_per_ray=4)
    jc = jcfg.NerfConfig(encoding=jcfg.EncodingConfig(**enc), train=jcfg.TrainConfig(**train))
    tc = tcfg.NerfConfig(encoding=tcfg.EncodingConfig(**enc), train=tcfg.TrainConfig(**train))
    jspec, tspec = jnerf.make_field_spec(jc), tnerf.make_field_spec(tc)
    _, _, _, jstore, jobjs = jworld(cap, 3, 32)
    _, _, _, tstore, tobjs = tworld(cap, 3, 32)
    js = jax.device_get(jnerf.init_train_state(jax.random.PRNGKey(5), cap, jc, jspec))
    ts = jax_bridge.train_state_from_jax(js)
    assert ts.params["table"].shape == (cap, tspec.total_params, tspec.n_features)
    ts = tnerf.train_objects(ts, tobjs, tstore.arrays(), tc, tspec, n_iters,
                             uniforms=replay(js.key, jc))
    jout = jax.device_get(jnerf.train_objects(jax.tree.map(jnp.asarray, js), jobjs,
                                              jstore.arrays(), jc, jspec, n_iters))
    got = jax_bridge.train_state_to_numpy(ts)
    np.testing.assert_array_equal(got["step"], jout.step)
    np.testing.assert_allclose(got["loss"], jout.loss, rtol=1e-4, atol=1e-6)
    pairs = [("mu", got["opt_state"][2], jout.opt_state[2].mu),
             ("nu", got["opt_state"][3], jout.opt_state[2].nu)]
    if n_iters == 1:
        pairs.append(("params", got["params"], jout.params))
    for name, a, b in pairs:
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            y = np.asarray(y)
            share = close_share(x, y, atol=1e-5 * (np.abs(y).max() + 1e-30), rtol=1e-4)
            assert share >= 0.999, (name, x.shape, share)
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_checkpoint(path, ts)
    back = checkpoint.restore_train_state(checkpoint.load_checkpoint(path)["state"],
                                          tnerf.init_train_state(torch.Generator(), cap, tc,
                                                                 tspec))
    torch.testing.assert_close(back.params["table"], ts.params["table"], rtol=0, atol=0)


# --------------------------------------------------------------------------
# The kernels' wrappers and twins on the CPU (ops/hashgrid_cuda.py)
# --------------------------------------------------------------------------


def test_cpu_encode_takes_the_twins_and_never_loads_the_library(monkeypatch):
    """`hashgrid.encode` on CPU tensors: the forward and both gradients come
    from the plain twins; nothing builds or loads the kernel library, and
    no H0-H2 launch is counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(cuda_lib, "build_library", refuse)
    monkeypatch.setattr(cuda_lib, "library", refuse)
    _, spec = specs(**SMALL)
    rng = np.random.default_rng(7)
    table = torch.tensor(rng.normal(size=(2, spec.total_params, spec.n_features)),
                         dtype=torch.float32, requires_grad=True)
    x = torch.tensor(rng.uniform(-0.2, 1.2, size=(2, 6, 5, 3)), dtype=torch.float32,
                     requires_grad=True)
    before = {k: fn.launches for k, fn in hashgrid_cuda.KERNELS.items()}
    out = thash.encode(table, x, spec)
    gt, gx = torch.autograd.grad(torch.sum(out**2), (table, x))
    assert {k: fn.launches for k, fn in hashgrid_cuda.KERNELS.items()} == before
    assert out.shape == (2, 6, 5, spec.n_output_dims) and gx.shape == x.shape
    pts = x.detach().reshape(2, -1, 3)
    want = hashgrid_cuda.forward_plain(pts, table.detach(), spec)
    torch.testing.assert_close(out.detach().reshape(2, 30, -1), want, rtol=0, atol=0)
    g = 2 * want
    torch.testing.assert_close(gt, hashgrid_cuda.table_gradient_plain(pts, g, spec),
                               rtol=0, atol=0)
    torch.testing.assert_close(gx.reshape(2, 30, 3), hashgrid_cuda.points_gradient_plain(
        pts, table.detach(), g, spec), rtol=0, atol=0)


@pytest.mark.parametrize("enc", [{}, SMALL], ids=["reference", "small"])
def test_level_constants_equal_the_specs(enc):
    """The per-level constants the wrapper packs for the kernels: scales as
    fp32 (as the twin and JAX multiply by them), resolutions, sizes,
    offsets and the dense flags, against the port's spec and JAX's; and the
    host arrays the C entry points take."""
    jspec, tspec = specs(**enc)
    lc = hashgrid_cuda.level_constants(tspec)
    for spec in (tspec, jspec):
        assert lc.scales == tuple(float(np.float32(s)) for s in spec.scales)
        assert lc.resolutions == tuple(spec.resolutions)
        assert lc.sizes == tuple(spec.sizes)
        assert lc.offsets == tuple(spec.offsets)
        assert lc.dense == tuple(r**3 <= n for r, n in zip(spec.resolutions, spec.sizes))
    assert any(lc.dense) and not all(lc.dense)  # both kinds of level
    scales, ints, n, f = hashgrid_cuda._level_args(tspec)
    assert (n, f) == (tspec.n_levels, tspec.n_features)
    np.testing.assert_array_equal(np.asarray(list(scales), np.float32),
                                  np.asarray(jspec.scales, np.float32))
    assert list(ints) == [*lc.resolutions, *lc.sizes, *lc.offsets, *map(int, lc.dense)]


def test_launch_counts_list_the_hash_grid_kernels():
    """`cuda_lib.launch_counts()` (what the CLIs write into `--trace`)
    lists H0-H2 after K0-K10, then the optimizer's A1 and the last
    product's M1-M2, and `reset_launch_counts()` zeroes them."""
    hashgrid_cuda.forward.launches = 3
    assert list(cuda_lib.launch_counts()) == [*mxgrid_cuda.KERNELS, "H0", "H1", "H2", "H3",
                                              "A1", *mlp_cuda.KERNELS]
    assert cuda_lib.launch_counts()["H1"] == 3
    cuda_lib.reset_launch_counts()
    assert not any(cuda_lib.launch_counts().values())


@pytest.mark.parametrize("enc", [SMALL, {}], ids=["small", "reference"])
def test_twin_gradients_equal_autograd_of_the_twin_forward(enc):
    """The arithmetic H2 and H0 repeat, in their twins (an index_add_ into
    an fp32 buffer; the explicit derivative of the trilinear weights times
    the level's scale), against autograd through H1's twin, fp32, points in
    the cube and up to 0.3 past it: within 1e-5 of the largest entry (the
    same products, summed in another order)."""
    _, spec = specs(**enc)
    rng = np.random.default_rng(11)
    table = torch.tensor(rng.normal(size=(2, spec.total_params, spec.n_features)),
                         dtype=torch.float32)
    x = torch.tensor(rng.uniform(-0.3, 1.3, size=(2, 300, 3)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(2, 300, spec.n_output_dims)), dtype=torch.float32)
    t, p = table.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want_t, want_x = torch.autograd.grad(
        torch.sum(hashgrid_cuda.forward_plain(p, t, spec) * g), (t, p))
    got_t = hashgrid_cuda.table_gradient_plain(x, g, spec)
    got_x = hashgrid_cuda.points_gradient_plain(x, table, g, spec)
    for got, want in ((got_t, want_t), (got_x, want_x)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("enc", [SMALL, {}], ids=["small", "reference"])
def test_h3_twin_equals_autograd_of_the_h0_twin(enc):
    """H3's twin (H0's backward: u_c from the weights' slopes, dg and the
    table's gradient by `index_add_`) against autograd through H0's twin in
    the table and in g, fp32, points in the cube and up to 0.3 past it:
    within 1e-5 of the largest entry (the same products, summed in another
    order)."""
    _, spec = specs(**enc)
    rng = np.random.default_rng(17)
    table = torch.tensor(rng.normal(size=(2, spec.total_params, spec.n_features)),
                         dtype=torch.float32)
    x = torch.tensor(rng.uniform(-0.3, 1.3, size=(2, 300, 3)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(2, 300, spec.n_output_dims)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 300, 3)), dtype=torch.float32)
    t, gg = table.clone().requires_grad_(True), g.clone().requires_grad_(True)
    want_g, want_t = torch.autograd.grad(
        torch.sum(hashgrid_cuda.points_gradient_plain(x, t, gg, spec) * v), (gg, t))
    got_g, got_t = hashgrid_cuda.normal_backward_plain(x, table, g, v, spec)
    for got, want in ((got_g, want_g), (got_t, want_t)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_points_gradient_node_is_autograd_of_the_h0_twin():
    """`encode_points_gradient` on the CPU (H0's and H3's twins in one
    node): its value is H0's twin, its gradients in the table and g are
    autograd's through that twin (1e-5), and the points take none."""
    _, spec = specs(**SMALL)
    rng = np.random.default_rng(19)
    table = torch.tensor(rng.normal(size=(2, spec.total_params, spec.n_features)),
                         dtype=torch.float32)
    x = torch.tensor(rng.uniform(0, 1, size=(2, 5, 40, 3)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(2, 5, 40, spec.n_output_dims)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(2, 5, 40, 3)), dtype=torch.float32)

    def run(fn):
        t, gg = table.clone().requires_grad_(True), g.clone().requires_grad_(True)
        out = fn(t, gg)
        return [out, *torch.autograd.grad(torch.sum(out * v), (t, gg))]

    got = run(lambda t, gg: hashgrid_cuda.encode_points_gradient(t, x, gg, spec))
    want = run(lambda t, gg: hashgrid_cuda.points_gradient_plain(
        x.reshape(2, -1, 3), t, gg.reshape(2, 200, -1), spec).reshape(2, 5, 40, 3))
    assert got[0].shape == (2, 5, 40, 3)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    p = x.clone().requires_grad_(True)
    out = hashgrid_cuda.encode_points_gradient(table, p, g, spec)
    with pytest.raises(NotImplementedError, match="points"):
        torch.autograd.grad(out.sum(), p)


def test_bf16_twins_round_once():
    """H1's and H2's twins in bf16 blend and sum in fp32 and round once at
    the end, as the kernels do: equal, bit for bit, to the fp32 twins on
    the same bf16 table and cotangent, rounded to bf16."""
    _, spec = specs(**SMALL)
    rng = np.random.default_rng(13)
    table = torch.tensor(rng.normal(size=(2, spec.total_params, spec.n_features)),
                         dtype=torch.bfloat16)
    x = torch.tensor(rng.uniform(0, 1, size=(2, 200, 3)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(2, 200, spec.n_output_dims)), dtype=torch.bfloat16)
    out = hashgrid_cuda.forward_plain(x, table, spec)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, hashgrid_cuda.forward_plain(x, table.float(), spec).bfloat16(), rtol=0, atol=0)
    dt = hashgrid_cuda.table_gradient_plain(x, g, spec)
    assert dt.dtype == torch.bfloat16
    torch.testing.assert_close(
        dt, hashgrid_cuda.table_gradient_plain(x, g.float(), spec).bfloat16(), rtol=0, atol=0)
