"""The optimizer's update (`romap_tpu_torch/ops/optimizer_cuda.py`): its
plain twin on the CPU against the eager chain the train step ran, written
out here; NaN gradients, kept slots and the `optimizer.fused_params`
counter; and, on a CUDA device, kernel A1 against the twin bit for bit.

The card tests skip without a CUDA device (decided inside the fixture, at
run time). Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_optimizer.py -q` (the repo
conftest imports jax, which a GPU machine need not have; this file does
not).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import EncodingConfig, NerfConfig, NetworkConfig, TrainConfig
from romap_tpu_torch.data.world import build_synthetic_world
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import cuda_lib, optimizer_cuda
from romap_tpu_torch.utils import tracing

N_OBJ = 3


def tree_config(name: str, log2_rows: int | None = None) -> NerfConfig:
    """The parameter trees of the presets the cells and the flagship run:
    `tcnn` (hash table, head w0, w1), `ngp` (hash table, density w0, w1,
    colour w0-w2) and `flagship` (lines, planes, plane lines, head).
    `log2_rows` shrinks a hash table (the CPU tests); the tree keeps its
    leaves."""
    if name == "flagship":
        return NerfConfig()
    enc = EncodingConfig.preset("tcnn")
    if name == "ngp":
        enc = EncodingConfig(kind="hashgrid", log2_hashmap_size=19)
    if log2_rows is not None:
        enc = dataclasses.replace(enc, log2_hashmap_size=log2_rows)
    net = NetworkConfig(output_dims=16, sh_degree=4) if name == "ngp" else NetworkConfig()
    return NerfConfig(encoding=enc, network=net)


def random_case(cfg: NerfConfig, seed: int, device="cpu", ragged: bool = False):
    """(state, grads) at O=3: params from the init, EMA, moments, counts,
    steps and found flags drawn so that every branch of the chain acts (the
    rate decayed twice for slot 2, a zero gradient entry in four, tiny
    second moments); `ragged` adds leaves of 15 and 9,003 values an object,
    whose rows start off a multiple of 4."""
    g = torch.Generator().manual_seed(seed)
    spec = nerf.make_field_spec(cfg)
    st = nerf.init_train_state(torch.Generator().manual_seed(seed), N_OBJ, cfg, spec)
    params = st.params
    if ragged:
        params = {**params, "ragged": {"a": torch.randn((N_OBJ, 5, 3), generator=g),
                                       "b": torch.randn((N_OBJ, 3001, 3), generator=g)}}
    rnd = lambda a: torch.randn(a.shape, generator=g)
    tree = lambda f: pytree.tree_map(f, params)
    grads = tree(lambda a: 1e-3 * rnd(a) * (torch.rand(a.shape, generator=g) > 0.25))
    state = nerf.TrainState(
        params=params,
        ema=tree(lambda a: a + 1e-2 * rnd(a)),
        opt=nerf.AdamState(
            found_nan=tree(lambda a: torch.rand(N_OBJ, generator=g) < 0.5),
            count=torch.tensor([0, 7, 24999], dtype=torch.int32),
            mu=tree(lambda a: 1e-3 * rnd(a)),
            nu=tree(lambda a: 1e-6 * rnd(a).square() * (torch.rand(a.shape, generator=g) > 0.1)),
        ),
        step=torch.tensor([0, 7, 40000], dtype=torch.int32),
        loss=torch.zeros(N_OBJ),
    )
    to = lambda t: pytree.tree_map(lambda a: a.to(device), t)
    return to(state), to(grads)


def eager_chain(grads, state, ok, cfg):
    """The optimizer part of the train step as it ran before A1, op by op:
    zero_nans, add_decayed_weights, scale_by_adam, the decayed rate, the
    EMA and the per-slot keep. Returns (params, ema, opt)."""
    o = cfg.optimizer
    per_object = lambda v, like: v.reshape((-1,) + (1,) * (like.ndim - 1))
    count = state.opt.count + 1
    c1 = 1 - torch.pow(o.beta1, count.float())
    c2 = 1 - torch.pow(o.beta2, count.float())
    n = torch.clamp(torch.div(state.step - o.decay_start, o.decay_interval,
                              rounding_mode="floor") + 1, min=0)
    lr = o.learning_rate * torch.pow(o.decay_base, n.float())
    flat_g, treedef = pytree.tree_flatten(grads)
    cols = zip(flat_g, *(pytree.tree_leaves(t) for t in (state.params, state.opt.mu,
                                                         state.opt.nu, state.ema)))
    outs = {k: [] for k in ("found", "p", "mu", "nu", "e")}
    for g, p, mu, nu, e in cols:
        nan = torch.isnan(g)
        outs["found"].append(nan.reshape(nan.shape[0], -1).any(dim=1))
        g = torch.where(nan, torch.zeros_like(g), g)
        g = g + o.l2_reg * p
        mu = (1 - o.beta1) * g + o.beta1 * mu
        nu = (1 - o.beta2) * g**2 + o.beta2 * nu
        u = (mu / per_object(c1, mu)) / (torch.sqrt(nu / per_object(c2, nu)) + o.epsilon)
        p = p - per_object(lr, u) * u
        outs["p"].append(p)
        outs["mu"].append(mu)
        outs["nu"].append(nu)
        outs["e"].append(o.ema_decay * e + (1.0 - o.ema_decay) * p)
    new = {k: pytree.tree_unflatten(v, treedef) for k, v in outs.items()}
    keep = lambda old, nw: pytree.tree_map(
        lambda a, b: torch.where(per_object(ok, b), b, a), old, nw)
    opt = nerf.AdamState(found_nan=new["found"], count=count, mu=new["mu"], nu=new["nu"])
    return keep(state.params, new["p"]), keep(state.ema, new["e"]), keep(state.opt, opt)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want) -> None:
    """Every leaf of two trees equal bit for bit (fp32 by its bits: -0 is
    not 0, and a NaN equals the same NaN)."""
    a, ta = pytree.tree_flatten(got)
    b, tb = pytree.tree_flatten(want)
    assert ta == tb
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(bits(x), bits(y)), i


# --------------------------------------------------------------------------
# The plain twin (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tcnn", "ngp", "flagship"])
def test_twin_equals_the_eager_chain(name):
    """The twin (`update` on CPU tensors) updates each tree as the train
    step's eager chain did, bit for bit, over three chained steps with one
    slot kept; A1 never launches."""
    cfg = tree_config(name, log2_rows=12)
    state, grads = random_case(cfg, seed=1)
    ok = torch.tensor([True, False, True])
    optimizer_cuda.update.launches = 0
    for i in range(3):
        got = optimizer_cuda.update(grads, state, ok, cfg)
        assert_same(got, eager_chain(grads, state, ok, cfg))
        state = state._replace(params=got[0], ema=got[1], opt=got[2])
        grads = pytree.tree_map(lambda a: 0.5 * a.flip(0), grads)
    assert optimizer_cuda.update.launches == 0


def test_a_nan_gradient_marks_its_leaf_and_slot_and_is_zeroed():
    """A NaN in slot 1's table gradient sets found_nan of the table in slot
    1 alone; the update is the one of a zero in its place; a NaN in a kept
    slot (2) leaves that slot's flags as they were."""
    cfg = tree_config("tcnn", log2_rows=12)
    state, grads = random_case(cfg, seed=2)
    state = state._replace(opt=state.opt._replace(
        found_nan=pytree.tree_map(torch.zeros_like, state.opt.found_nan)))
    ok = torch.tensor([True, True, False])
    zeroed = pytree.tree_map(torch.clone, grads)
    zeroed["table"][1, 100, 1] = 0.0
    grads["table"][1, 100, 1] = float("nan")
    grads["table"][2, 7, 0] = float("nan")
    params, ema, opt = optimizer_cuda.update(grads, state, ok, cfg)
    want = optimizer_cuda.update(zeroed, state, ok, cfg)
    assert_same((params, ema, opt.count, opt.mu, opt.nu), (*want[:2], *want[2][1:]))
    assert opt.found_nan["table"].tolist() == [False, True, False]
    assert not any(f.any() for f in pytree.tree_leaves(opt.found_nan["mlp"]))
    assert torch.isfinite(params["table"]).all()


def test_an_inactive_and_an_empty_slot_keep_every_leaf():
    """Through `train_objects`: slot 1 active with every ray off its box
    (an empty batch), slot 2 inactive; both keep every leaf of the state
    bit for bit over two steps, slot 0 trains."""
    cfg = NerfConfig(encoding=EncodingConfig(kind="mxgrid", mx_levels=2, mx_max_resolution=32,
                                             mx_features=8, mx_plane_res=16,
                                             mx_plane_features=4),
                     train=TrainConfig(rays_per_batch=64, samples_per_ray=4))
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_synthetic_world(2, 3, 32, capacity=N_OBJ)
    far = objs.aabb_min.clone()
    far[1] += 1e4
    objs = objs._replace(aabb_min=far, aabb_max=far + 1.0)
    g = torch.Generator().manual_seed(0)
    s0 = nerf.init_train_state(g, N_OBJ, cfg, spec)
    s1 = nerf.train_objects(s0, objs, store.arrays(), cfg, spec, 2, generator=g)
    assert_same(pytree.tree_map(lambda a: a[1:], s1), pytree.tree_map(lambda a: a[1:], s0))
    assert s1.step.tolist() == [2, 0, 0]
    assert not torch.equal(s1.params["table"]["lines"][0], s0.params["table"]["lines"][0])


def test_every_step_counts_its_parameters():
    """`optimizer.fused_params` (tracing on) is the tree's parameter count
    at each step of a wave, in the step's span."""
    cfg = tree_config("tcnn", log2_rows=10)
    spec = nerf.make_field_spec(cfg)
    cfg = dataclasses.replace(cfg, train=TrainConfig(rays_per_batch=32, samples_per_ray=4))
    _, _, _, store, objs = build_synthetic_world(2, 3, 32, capacity=N_OBJ)
    g = torch.Generator().manual_seed(0)
    state = nerf.init_train_state(g, N_OBJ, cfg, spec)
    n_params = sum(a.numel() for a in pytree.tree_leaves(state.params))
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        nerf.train_objects(state, objs, store.arrays(), cfg, spec, 3, generator=g)
    finally:
        tracing.disable()
    counted = [c for c in tracing.drain()["counters"] if c["name"] == "optimizer.fused_params"]
    assert [c["n"] for c in counted] == [n_params] * 3
    assert [c["ids"]["step"] for c in counted] == [0, 1, 2]


# --------------------------------------------------------------------------
# A1 on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (A1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["tcnn", "ngp", "flagship"])
def test_a1_equals_the_twin(cuda, name):
    """A1 against the twin on the card, bit for bit, at each tree's full
    size with two ragged leaves: three chained steps, slot 1 kept, a NaN in
    slot 0's table gradient past its first tile and one in slot 1's; one
    launch a call."""
    cfg = tree_config(name)
    state, grads = random_case(cfg, seed=3, device=cuda, ragged=True)
    table = pytree.tree_leaves(grads["table"])[0]
    table.view(N_OBJ, -1)[0, -5] = float("nan")
    table.view(N_OBJ, -1)[1, 3] = float("nan")
    ok = torch.tensor([True, False, True], device=cuda)
    for i in range(3):
        cuda_lib.reset_launch_counts()
        got = optimizer_cuda.update(grads, state, ok, cfg)
        torch.cuda.synchronize()
        assert {k: n for k, n in cuda_lib.launch_counts().items() if n} == {"A1": 1}
        assert_same(got, optimizer_cuda.update_plain(grads, state, ok, cfg))
        assert pytree.tree_leaves(got[2].found_nan)[0].tolist()[0] is (i == 0)
        state = state._replace(params=got[0], ema=got[1], opt=got[2], step=state.step + ok)
        grads = pytree.tree_map(lambda a: torch.nan_to_num(a).flip(0), grads)


def test_a1_launches_once_for_each_sixteen_leaves(cuda):
    """A tree of 20 leaves of ragged sizes takes two launches, and equals
    the twin."""
    cfg = NerfConfig()
    g = torch.Generator().manual_seed(4)
    params = {f"w{i:02d}": torch.randn((N_OBJ, 1 + 37 * i), generator=g) for i in range(20)}
    tree = lambda f: pytree.tree_map(f, params)
    state = nerf.TrainState(
        params=params, ema=tree(lambda a: a + 1e-2), loss=torch.zeros(N_OBJ),
        opt=nerf.AdamState(found_nan=tree(lambda a: torch.zeros(N_OBJ, dtype=torch.bool)),
                           count=torch.zeros(N_OBJ, dtype=torch.int32),
                           mu=tree(torch.zeros_like), nu=tree(torch.zeros_like)),
        step=torch.zeros(N_OBJ, dtype=torch.int32))
    grads = tree(lambda a: torch.randn(a.shape, generator=g))
    state, grads = (pytree.tree_map(lambda a: a.to(cuda), t) for t in (state, grads))
    ok = torch.tensor([True, True, False], device=cuda)
    cuda_lib.reset_launch_counts()
    got = optimizer_cuda.update(grads, state, ok, cfg)
    torch.cuda.synchronize()
    assert optimizer_cuda.update.launches == 2
    assert_same(got, optimizer_cuda.update_plain(grads, state, ok, cfg))


def test_a1_refuses_a_leaf_it_does_not_take(cuda):
    """A CUDA leaf launches A1 or raises: a bf16 gradient, a non-contiguous
    moment, a misaligned EMA; nothing is launched."""
    cfg = tree_config("tcnn", log2_rows=10)
    state, grads = random_case(cfg, seed=5, device=cuda)
    ok = torch.ones(N_OBJ, dtype=torch.bool, device=cuda)
    w0 = state.opt.mu["mlp"]["w0"]
    shifted = torch.zeros(w0.numel() + 1, device=cuda)[1:].view(w0.shape)
    cuda_lib.reset_launch_counts()
    with pytest.raises(ValueError, match="dtype"):
        optimizer_cuda.update({**grads, "table": grads["table"].bfloat16()}, state, ok, cfg)
    mu = {**state.opt.mu, "mlp": {**state.opt.mu["mlp"],
                                  "w0": w0.transpose(1, 2).contiguous().transpose(1, 2)}}
    with pytest.raises(ValueError, match="contiguous"):
        optimizer_cuda.update(grads, state._replace(opt=state.opt._replace(mu=mu)), ok, cfg)
    ema = {**state.ema, "mlp": {**state.ema["mlp"], "w0": shifted}}
    with pytest.raises(ValueError, match="aligned"):
        optimizer_cuda.update(grads, state._replace(ema=ema), ok, cfg)
    assert optimizer_cuda.update.launches == 0


TINY_MXGRID = EncodingConfig(mx_levels=2, mx_max_resolution=32, mx_features=8,
                             mx_plane_res=(16, 8), mx_plane_features=4)


@pytest.mark.parametrize("field,dtype", [("tcnn", "auto"), ("mxgrid", "auto"),
                                         ("mxgrid", "float32")])
def test_a1_runs_once_a_train_step(cuda, field, dtype):
    """`train_objects` on the card launches A1 once a step, and each step's
    update equals the twin's from the same gradients and state: a hash
    grid, and an MX-grid (K1/K2), whose lines' gradient autograd hands back
    transposed, in bf16 and fp32. The steps compared run eagerly (drawn
    through a replay source: a CUDA graph's capture cannot compare); then
    3 steps through the graph count A1 once a step too."""
    train = TrainConfig(rays_per_batch=256, samples_per_ray=8, compute_dtype=dtype)
    cfg = (dataclasses.replace(tree_config("tcnn", log2_rows=12), train=train)
           if field == "tcnn" else NerfConfig(encoding=TINY_MXGRID, train=train))
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_synthetic_world(2, 3, 32, capacity=N_OBJ, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = nerf.init_train_state(gen, N_OBJ, cfg, spec, device=cuda)
    real = optimizer_cuda.update

    def both(grads, st, ok, c, out=None):
        got = real(grads, st, ok, c, out=out)
        assert_same(got, optimizer_cuda.update_plain(grads, st, ok, c))
        return got

    cuda_lib.reset_launch_counts()
    optimizer_cuda.update = both
    try:
        state = nerf.train_objects(state, objs, store.arrays(), cfg, spec, 3,
                                   uniforms=lambda: nerf.draw_uniforms(gen, N_OBJ, cfg))
    finally:
        optimizer_cuda.update = real
    torch.cuda.synchronize()
    assert real.launches == 3
    assert state.step.tolist() == [3, 3, 0]
    state = nerf.train_objects(state, objs, store.arrays(), cfg, spec, 3, generator=gen)
    torch.cuda.synchronize()
    assert real.launches == 6
    assert state.step.tolist() == [6, 6, 0]
