"""The train step as a CUDA graph (`romap_tpu_torch/models/nerf.py`:
`train_objects`, `_StepGraph`).

On the CPU: which path a call takes (CPU tensors, a `uniforms=` replay
source and tracing on each run every step eagerly and capture nothing), the
three counters, the graph's key, the step's `out=` and
`cuda_lib.recorded_launches`. On a CUDA device, at the cells'
configurations (`portbench/configs/{tcnn,ngp,neus2,nerfacto}.json`: O = 10,
4096 rays x 32 samples an object, or nerfacto's 256 + 96 proposal and 48
field samples through its sampler) and the flagship's (`flagship.json`, the
MX-grid's K1/K2): 20 graphed steps against 20 eager ones from one state and
seed (the draws bit for bit; losses and parameters as near the eager runs
as those are to one another, H2's and H3's atomics making none bitwise),
the tensors given and a state returned left as they were, frame arrays put
anew captured anew, and the counters.

The card tests skip without a CUDA device (decided inside the fixture, at
run time). Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_train_graph.py -q`. No JAX.
"""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils import _pytree as pytree

from portbench.program import nerf_config
from romap_tpu_torch.config import EncodingConfig, NerfConfig, TrainConfig
from romap_tpu_torch.data.frame_store import FrameArrays
from romap_tpu_torch.data.world import build_synthetic_world
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import cuda_lib, optimizer_cuda
from romap_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cells' configurations, and the flagship's (MX-grid K1/K2, no cell)
CELLS = ("tcnn", "ngp", "neus2", "nerfacto", "flagship")
N_OBJ = 10  # room10's slots
N_STEPS = 20
ZERO = {"train_graph_captures": 0, "train_graph_replays": 0, "train_eager_steps": 0}


def tiny_cfg(kind: str) -> NerfConfig:
    enc = (dict(kind="mxgrid", mx_levels=2, mx_max_resolution=32, mx_features=8,
                mx_plane_res=16, mx_plane_features=4, mx_impl="xla") if kind == "mxgrid"
           else dict(kind="hashgrid", n_levels=4, log2_hashmap_size=10, desired_resolution=64.0))
    return NerfConfig(encoding=EncodingConfig(**enc),
                      train=TrainConfig(rays_per_batch=64, samples_per_ray=4))


def clone(tree):
    return pytree.tree_map(torch.clone, tree)


def assert_same(a, b) -> None:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.drain()
    nerf.reset_train_graph_counts()
    yield
    tracing.disable()
    tracing.drain()
    nerf._graph = None


@pytest.fixture(scope="module")
def world():
    _, _, _, store, objs = build_synthetic_world(2, 3, 32)
    return store.arrays(), objs


def cpu_case(world, kind="hashgrid"):
    frames, objs = world
    cfg = tiny_cfg(kind)
    spec = nerf.make_field_spec(cfg)
    state = nerf.init_train_state(torch.Generator().manual_seed(0), objs.capacity, cfg, spec)
    return state, objs, frames, cfg, spec


# --------------------------------------------------------------------------
# CPU: the dispatch, the counters, the key, out=, the launch record
# --------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["cpu_tensors", "uniforms_source", "tracing_on"])
def test_each_eager_case_runs_every_step_eagerly(world, how):
    """A CPU state, a replay source and tracing on each take the eager
    path: every step counted eager, nothing captured or replayed, and the
    same numbers as the generator's own draws."""
    state, objs, frames, cfg, spec = cpu_case(world)
    n = 3
    ref = nerf.train_objects(state, objs, frames, cfg, spec, n,
                             generator=torch.Generator().manual_seed(5))
    nerf.reset_train_graph_counts()
    before = nerf._graph
    g = torch.Generator().manual_seed(5)
    draw = dict(generator=g)
    if how == "uniforms_source":
        draw = dict(uniforms=lambda: nerf.draw_uniforms(g, objs.capacity, cfg))
    if how == "tracing_on":
        tracing.enable()
    got = nerf.train_objects(state, objs, frames, cfg, spec, n, **draw)
    tracing.disable()
    assert nerf.train_graph_counts() == {**ZERO, "train_eager_steps": n}
    assert nerf._graph is before
    assert_same(got, ref)
    if how == "tracing_on":
        counted = {c["name"]: c["n"] for c in tracing.drain()["counters"]
                   if c["name"].startswith("train.graph")}
        assert counted == {"train.graph_captures": 0, "train.graph_replays": 0}


def test_train_graph_counts_read_back_and_zero(world):
    state, objs, frames, cfg, spec = cpu_case(world)
    nerf.train_objects(state, objs, frames, cfg, spec, 2, generator=torch.Generator())
    got = nerf.train_graph_counts()
    got["train_eager_steps"] = 99  # a copy
    assert nerf.train_graph_counts() == {**ZERO, "train_eager_steps": 2}
    nerf.train_objects(state, objs, frames, cfg, spec, 0, generator=torch.Generator())
    assert nerf.train_graph_counts()["train_eager_steps"] == 2
    nerf.reset_train_graph_counts()
    assert nerf.train_graph_counts() == ZERO


@pytest.mark.parametrize("kind", ["mxgrid", "hashgrid"])
def test_step_out_writes_the_new_state_into_out(world, kind):
    """`_object_train_step(..., out=buf)` gives the out-of-place step's
    state bit for bit in `buf`'s own tensors, and leaves `state` as it
    was."""
    state, objs, frames, cfg, spec = cpu_case(world, kind)
    state = nerf.train_objects(state, objs, frames, cfg, spec, 2,
                               generator=torch.Generator().manual_seed(1))
    u = nerf.draw_uniforms(torch.Generator().manual_seed(2), objs.capacity, cfg)
    before = clone(state)
    want = nerf._object_train_step(state, frames, objs, cfg, spec, u, False)
    buf = pytree.tree_map(torch.empty_like, state)
    got = nerf._object_train_step(state, frames, objs, cfg, spec, u, False, out=buf)
    assert_same(got, want)
    assert [t.data_ptr() for t in pytree.tree_leaves(got)] == \
        [t.data_ptr() for t in pytree.tree_leaves(buf)]
    assert_same(state, before)


KEY_CHANGES = {
    "values_changed": False,
    "frames_put_anew": True,
    "another_generator": True,
    "more_slots": True,
    "use_depth": True,
    "another_config": True,
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_graph_key_holds_what_a_graph_bakes_in(world, change):
    """The key changes with the frame arrays' addresses, the generator, the
    slot count, `use_depth` and the config, and not with the values of the
    state or of the object table (those are copied in at each call)."""
    state, objs, frames, cfg, spec = cpu_case(world)
    g = torch.Generator()
    args = dict(state=state, objects=objs, frames=frames, cfg=cfg, spec=spec, use_depth=False,
                generator=g)
    key_of = lambda state, **kw: nerf._graph_key(*pytree.tree_flatten(state), **kw)
    key = key_of(**args)
    if change == "values_changed":
        args["state"] = pytree.tree_map(torch.ones_like, state)
        args["objects"] = objs._replace(active=~objs.active, n_bbox=objs.n_bbox + 1)
    elif change == "frames_put_anew":
        args["frames"] = FrameArrays(*map(torch.clone, frames))
    elif change == "another_generator":
        args["generator"] = torch.Generator()
    elif change == "more_slots":
        args["state"] = nerf.init_train_state(torch.Generator(), objs.capacity + 1, cfg, spec)
    elif change == "use_depth":
        args["use_depth"] = True
    else:
        args["cfg"] = tiny_cfg("mxgrid")
    assert (key_of(**args) != key) == KEY_CHANGES[change]


def test_flat_layout_starts_each_leaf_on_its_boundary():
    """A flat state set: one buffer a dtype, each leaf a contiguous view of
    its shape starting on a 256-byte boundary, no two overlapping."""
    ts = [torch.zeros(3, 5), torch.zeros(7, dtype=torch.bool), torch.zeros(2, 3, dtype=torch.int32),
          torch.zeros(1), torch.zeros(64), torch.zeros(4, dtype=torch.bool)]
    layout, sizes = nerf._flat_layout(ts)
    bufs = {dt: torch.empty(n, dtype=dt) for dt, n in sizes.items()}
    views = nerf._flat_views(bufs, layout)
    assert sizes == {torch.float32: 128 + 64, torch.bool: 256 + 4, torch.int32: 6}
    seen = {dt: [] for dt in bufs}
    for t, v in zip(ts, views):
        assert v.shape == t.shape and v.dtype == t.dtype and v.is_contiguous()
        start = v.data_ptr() - bufs[v.dtype].data_ptr()
        assert start % 256 == 0
        seen[v.dtype].append((start, start + v.numel() * v.element_size()))
    for spans in seen.values():
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_recorded_launches_take_a_capture_off_and_count_each_replay():
    fn = optimizer_cuda.update
    cuda_lib.reset_launch_counts()
    fn.launches_by_dtype["float32"] += 1
    fn.launches += 1
    with cuda_lib.recorded_launches() as rec:
        fn.launches += 2
        fn.launches_by_dtype["float32"] += 2
    assert fn.launches == 1 and dict(fn.launches_by_dtype) == {"float32": 1}
    rec.add()
    rec.add(3)
    assert cuda_lib.launch_counts()["A1"] == 1 + 2 * 4
    assert dict(fn.launches_by_dtype) == {"float32": 9}
    cuda_lib.reset_launch_counts()
    with cuda_lib.recorded_launches() as rec:
        fn.launches += 1
        fn.launches_by_dtype["bfloat16"] += 1
    assert fn.launches == 0 and dict(fn.launches_by_dtype) == {}
    cuda_lib.reset_launch_counts()


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    _, _, _, store, objs = build_synthetic_world(N_OBJ, 16, 128, device="cuda")
    return store.arrays(), objs


def cell(name: str):
    with open(os.path.join(REPO, "portbench", "configs", f"{name}.json")) as f:
        cfg = nerf_config(json.load(f))
    return cfg, nerf.make_field_spec(cfg)


def init_state(cfg, spec):
    g = torch.Generator(device="cuda").manual_seed(cfg.seed)
    return nerf.init_train_state(g, N_OBJ, cfg, spec, device="cuda")


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def recording(monkeypatch, cfg, n: int):
    """Wrap `_object_train_step` (both paths call it by its module name) to
    write each step's draws and new loss to row k of two buffers, k a
    device counter the step itself advances, so that a graph's replays
    write their own rows. Returns (draws, losses)."""
    per_step = N_OBJ * cfg.train.rays_per_batch * (5 + cfg.train.samples_per_ray)
    draws = torch.full((n, per_step), -1.0, device="cuda")
    losses = torch.full((n, N_OBJ), -1.0, device="cuda")
    row = torch.zeros(1, dtype=torch.long, device="cuda")
    real = nerf._object_train_step

    def step(state, frames, objects, cfg, spec, uniforms, use_depth, out=None):
        new = real(state, frames, objects, cfg, spec, uniforms, use_depth, out=out)
        draws.index_copy_(0, row, torch.cat([u.reshape(-1) for u in uniforms])[None])
        losses.index_copy_(0, row, new.loss[None])
        row.add_(1)
        return new

    monkeypatch.setattr(nerf, "_object_train_step", step)
    return draws, losses


def eager(state, frames, objs, cfg, spec, g, n: int):
    for _ in range(n):
        u = nerf.draw_uniforms(g, N_OBJ, cfg)
        state = nerf._object_train_step(state, frames, objs, cfg, spec, u, False)
    return state


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


@pytest.mark.parametrize("name", CELLS)
def test_graph_draws_and_trains_as_eager_steps(card, monkeypatch, name):
    """20 steps through `train_objects` (1 eager, a capture, 19 replays)
    against 20 eager steps three times, from one state and seed: the draws
    of every step bit for bit; the losses of every step, and each parameter
    and EMA leaf after the last, no farther from any eager run than 3x the
    eager runs are from one another (1e-6 where they agree)."""
    frames, objs = card
    cfg, spec = cell(name)
    state0 = init_state(cfg, spec)
    runs = []
    for path in ("eager", "eager", "eager", "graph"):
        draws, losses = recording(monkeypatch, cfg, N_STEPS)
        if path == "eager":
            out = eager(state0, frames, objs, cfg, spec, gen(7), N_STEPS)
        else:
            nerf.reset_train_graph_counts()
            out = nerf.train_objects(state0, objs, frames, cfg, spec, N_STEPS, generator=gen(7))
            assert nerf.train_graph_counts() == {"train_graph_captures": 1,
                                                 "train_graph_replays": N_STEPS - 1,
                                                 "train_eager_steps": 1}
        monkeypatch.undo()
        torch.cuda.synchronize()
        runs.append((out, draws.cpu(), losses.cpu()))
    *eagers, (g, dg, lg) = runs
    d1 = eagers[0][1]
    assert (d1 >= 0).all() and all(torch.equal(d, d1) for _, d, _ in runs)
    active = objs.active.cpu()
    assert torch.isfinite(lg[:, active]).all()
    assert_same(g.step, eagers[0][0].step)

    def agrees(graph, eager_runs, what):
        apart = max([gap(a, b) for i, a in enumerate(eager_runs) for b in eager_runs[:i]])
        off = max(gap(graph, e) for e in eager_runs)
        assert off <= 3 * max(apart, 1e-6), (name, what, off, apart)

    agrees(lg[:, active], [lo[:, active] for _, _, lo in eagers], "losses")
    for tree in ("params", "ema"):
        leaves = [pytree.tree_leaves(getattr(s, tree)) for s, _, _ in runs]
        for i, leaf in enumerate(leaves[-1]):
            agrees(leaf, [e[i] for e in leaves[:-1]], f"{tree} leaf {i}")


@pytest.mark.parametrize("name", CELLS)
def test_given_and_returned_states_keep_their_values(card, name):
    """The tensors given to `train_objects` and a state it returned keep
    their values through later calls that replay the same graph."""
    frames, objs = card
    cfg, spec = cell(name)
    g = gen(3)
    s0 = init_state(cfg, spec)
    snap0 = clone(s0)
    s1 = nerf.train_objects(s0, objs, frames, cfg, spec, 3, generator=g)
    snap1 = clone(s1)
    s2 = nerf.train_objects(s1, objs, frames, cfg, spec, 4, generator=g)
    s3 = nerf.train_objects(s0, objs, frames, cfg, spec, 2, generator=g)
    torch.cuda.synchronize()
    assert nerf.train_graph_counts() == {"train_graph_captures": 1, "train_graph_replays": 8,
                                         "train_eager_steps": 1}
    assert_same(s0, snap0)
    assert_same(s1, snap1)
    on = objs.active.int()
    assert torch.equal(s2.step, s1.step + 4 * on) and torch.equal(s3.step, s0.step + 2 * on)
    assert not torch.equal(pytree.tree_leaves(s2.params)[0], pytree.tree_leaves(s1.params)[0])


@pytest.mark.parametrize("name", CELLS)
def test_frames_put_anew_capture_anew_and_train_on_them(card, name):
    """Frame arrays put anew (new addresses; here the pixels inverted) give
    a new key: the call's first step runs eagerly, the step is captured
    again, and the steps read the new frames: three steps land next to
    three eager steps on the new frames, far from the old frames'."""
    frames, objs = card
    cfg, spec = cell(name)
    s0 = init_state(cfg, spec)
    g = gen(11)
    s1 = nerf.train_objects(s0, objs, frames, cfg, spec, 3, generator=g)
    moved = frames._replace(pixels=255 - frames.pixels)
    state = g.get_state()
    nerf.reset_train_graph_counts()
    got = nerf.train_objects(s1, objs, moved, cfg, spec, 3, generator=g)
    assert nerf.train_graph_counts() == {"train_graph_captures": 1, "train_graph_replays": 2,
                                         "train_eager_steps": 1}
    want, old = (eager(s1, f, objs, cfg, spec, torch.Generator(device="cuda").set_state(state),
                       3) for f in (moved, frames))
    active = objs.active
    near, far = (gap(got.loss[active], w.loss[active]) for w in (want, old))
    assert torch.isfinite(got.loss).all() and near < 0.1 * far


@pytest.mark.parametrize("name", CELLS)
def test_counters_and_launches_of_a_first_call(card, name):
    """A first call of n steps: 1 eager step, 1 capture, n - 1 replays; a
    second call n more replays. The launch counts say what ran: A1 once a
    step, each kernel a whole number of times a step (the capture's
    launches taken off, each replay's counted)."""
    frames, objs = card
    cfg, spec = cell(name)
    s = init_state(cfg, spec)
    g = gen(5)
    cuda_lib.reset_launch_counts()
    s = nerf.train_objects(s, objs, frames, cfg, spec, 5, generator=g)
    assert nerf.train_graph_counts() == {"train_graph_captures": 1, "train_graph_replays": 4,
                                         "train_eager_steps": 1}
    nerf.train_objects(s, objs, frames, cfg, spec, 3, generator=g)
    assert nerf.train_graph_counts() == {"train_graph_captures": 1, "train_graph_replays": 7,
                                         "train_eager_steps": 1}
    counts = {k: n for k, n in cuda_lib.launch_counts().items() if n}
    assert counts["A1"] == 8 and all(n % 8 == 0 for n in counts.values()), counts
    cuda_lib.reset_launch_counts()
