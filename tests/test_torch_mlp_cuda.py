"""Each network's last product (`romap_tpu_torch/ops/mlp_cuda.py`): on the
CPU, `last_product` is bit for bit the plain `torch.bmm(h.float(),
w.float())` with autograd's backward, the twins of M1/M2 are autograd's
arithmetic, and the wrappers refuse what the kernels do not take; on a CUDA
device, M1 and M2 against the twins at the cells' shapes, their determinism,
the gradients asked for, and one train step's launches.

The card tests skip without a CUDA device (decided inside the fixture, at
run time). Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_mlp_cuda.py -q` (the repo
conftest imports jax, which a GPU machine need not have; this file does
not).

Tolerances on the card, against an fp64 sum of the same (exact) products:
the kernels add in fp32 in another order than the twin, in chains of at
most D additions (M1: K, as KC in a lane and log2 G in the butterfly; dh:
the padded N; dw: 128 points in a thread, 8 slots and 128 blocks of a
131,072-point object, under 512), so each sum lies within D fp32 ulps of
sum |terms| of the exact one; a value stored in bf16 is then rounded once,
one more bf16 ulp of the value. The share of values whose bits differ
from the twin's is printed beside.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from romap_tpu_torch.config import EncodingConfig, NerfConfig, NetworkConfig, TrainConfig
from romap_tpu_torch.data.world import build_synthetic_world
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import cuda_lib, mlp, mlp_cuda
from romap_tpu_torch.utils import tracing

DTYPES = [torch.bfloat16, torch.float32]


def case(o, p, k, n, dtype, device="cpu", seed=0):
    """h (a ReLU's output), w and dy as the train step has them."""
    g = torch.Generator().manual_seed(seed)
    h = torch.relu(torch.randn((o, p, k), generator=g)).to(dtype)
    w = (torch.randn((o, k, n), generator=g) * k**-0.5).to(dtype)
    dy = torch.randn((o, p, n), generator=g) * 1e-3
    return h.to(device), w.to(device), dy.to(device)


def grads(fn, h, w, dy, need=(True, True)):
    """fn(h, w) and the gradients of <fn(h, w), dy> for the inputs in
    `need` (None for the others)."""
    h = h.detach().requires_grad_(need[0])
    w = w.detach().requires_grad_(need[1])
    out = fn(h, w)
    leaves = [t for t in (h, w) if t.requires_grad]
    got = iter(torch.autograd.grad(out, leaves, dy))
    return out, *(next(got) if t.requires_grad else None for t in (h, w))


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
        b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [(64, 4), (64, 16), (64, 3), (32, 16)])
def test_last_product_on_the_cpu_is_the_plain_bmm(dtype, k, n):
    """`last_product` on CPU tensors gives the bits of `torch.bmm(h.float(),
    w.float())`, its value and both gradients, and launches nothing."""
    h, w, dy = case(3, 1037, k, n, dtype)
    cuda_lib.reset_launch_counts()
    got = grads(mlp_cuda.last_product, h, w, dy)
    want = grads(lambda a, b: torch.bmm(a.float(), b.float()), h, w, dy)
    assert all(same_bits(a, b) for a, b in zip(got, want))
    assert got[1].dtype == dtype and got[2].dtype == dtype
    assert not any(cuda_lib.launch_counts().values())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "h_only", "w_only"])
def test_the_function_with_the_twins_is_autograd(dtype, need):
    """The autograd node (`_LastProduct`) on CPU tensors, where M1 and M2
    take their twins, gives autograd's bits of the plain product for the
    gradients asked for and None for the other; `backward_plain` alone
    gives the same."""
    h, w, dy = case(2, 517, 64, 16, dtype, seed=1)
    got = grads(mlp_cuda._LastProduct.apply, h, w, dy, need)
    want = grads(mlp_cuda.forward_plain, h, w, dy, need)
    for a, b in zip(got, want):
        assert (a is None and b is None) or same_bits(a, b)
    dh, dw = mlp_cuda.backward_plain(h, w, dy, *need)
    assert (dh is None) is not need[0] and (dw is None) is not need[1]
    for a, b in zip((dh, dw), want[1:]):
        assert a is None or same_bits(a, b)


def test_apply_mlp_runs_last_product_for_each_network(monkeypatch):
    """RO-MAP's head and instant-ngp's two networks each end in one
    `last_product` of their last matrix, with the activations in the
    compute dtype."""
    seen = []
    real = mlp_cuda.last_product
    monkeypatch.setattr(mlp, "last_product",
                        lambda h, w: seen.append((h.dtype, tuple(w.shape))) or real(h, w))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 40, 32)).bfloat16()
    head = mlp.init_mlp(g, 32, NetworkConfig(), 2)
    mlp.apply_mlp({k: v.bfloat16() for k, v in head.items()}, x, NetworkConfig())
    ngp = NetworkConfig(output_dims=16, sh_degree=4)
    nets = mlp.init_mlp(g, 32, ngp, 2)
    mlp.apply_mlp({k: v.bfloat16() for k, v in nets["density"].items()}, x, ngp)
    mlp.apply_rgb({k: v.bfloat16() for k, v in nets["rgb"].items()}, x, ngp)
    assert seen == [(torch.bfloat16, (2, 64, 4)), (torch.bfloat16, (2, 64, 16)),
                    (torch.bfloat16, (2, 64, 3))]


BAD = {
    "in_width_12": (lambda h, w, dy: (h[..., :12].contiguous(), w[:, :12].contiguous(), dy),
                    NotImplementedError, "input width 12"),
    "in_width_136": (lambda h, w, dy: (torch.zeros((2, 9, 136), dtype=h.dtype),
                                       torch.zeros((2, 136, 4), dtype=h.dtype), dy[:, :9]),
                     NotImplementedError, "input width 136"),
    "out_width_33": (lambda h, w, dy: (h, torch.zeros((2, 64, 33), dtype=h.dtype),
                                       torch.zeros((2, 9, 33))),
                     NotImplementedError, "output width 33"),
    "w_dtype": (lambda h, w, dy: (h, w.float(), dy), ValueError, "w: dtype"),
    "w_rows": (lambda h, w, dy: (h, w[:, :56].contiguous(), dy), ValueError, "w: shape"),
    "h_layout": (lambda h, w, dy: (h.transpose(0, 1).contiguous().transpose(0, 1), w, dy),
                 ValueError, "h: must be contiguous"),
    "h_aligned": (lambda h, w, dy: (torch.zeros(h.numel() + 2, dtype=h.dtype)[2:].view(h.shape),
                                    w, dy), ValueError, "h: data pointer .* not 16-byte"),
    "h_rank": (lambda h, w, dy: (h[0], w, dy), ValueError, "must be \\[O, P, K\\]"),
    "dy_dtype": (lambda h, w, dy: (h, w, dy.bfloat16()), ValueError, "dy: dtype"),
    "dy_shape": (lambda h, w, dy: (h, w, dy[:, :-1].contiguous()), ValueError, "dy: shape"),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, bad):
    """With the card's path taken for CPU tensors, M1 and M2 refuse a width
    out of range, h and w of two dtypes or of unmatched shapes, a
    non-contiguous or misaligned h, and a dy not fp32 or of another shape,
    before anything launches."""
    monkeypatch.setattr(cuda_lib, "on_card", lambda t, dt: True)
    monkeypatch.setattr(cuda_lib, "launch", lambda *a, **k: pytest.fail("launched"))
    make, error, match = BAD[bad]
    h, w, dy = make(*case(2, 9, 64, 4, torch.bfloat16))
    if not bad.startswith("dy"):
        with pytest.raises(error, match=match):
            mlp_cuda.forward(h, w)
    with pytest.raises(error, match=match):
        mlp_cuda.backward(h, w, dy)


# --------------------------------------------------------------------------
# M1 and M2 on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (M1 and M2 have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


U32 = 2.0**-24  # fp32's unit roundoff


def ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of |x| in `dtype` (fp64)."""
    mant = 8 if dtype == torch.bfloat16 else 24
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - (mant - 1))


def within(got, exact, scale, chain, what):
    """|got - exact| <= chain fp32 ulps of `scale` (the sum of |terms|) +
    one ulp of `exact` in got's dtype; returns the largest excess ratio."""
    err = (got.double() - exact).abs()
    tol = chain * U32 * scale + ulp(exact, got.dtype)
    ratio = float((err / tol).max())
    assert ratio <= 1.0, f"{what}: error {ratio:.3g} of its tolerance"
    return ratio


SHAPES = {  # O, P, K, N
    "tcnn_head": (10, 131072, 64, 4),
    "ngp_density": (10, 131072, 64, 16),
    "ngp_rgb": (10, 131072, 64, 3),
    "ragged": (3, 1000 + 37, 64, 5),
    "narrow": (2, 3001, 32, 16),
    "wide": (2, 2049, 128, 32),
    "k8_n1": (2, 777, 8, 1),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_m1_m2_match_the_twin(cuda, shape, dtype):
    """M1 and M2 against an fp64 sum of the same products (the module's
    tolerances), one M1 and two M2 launches; the share of values whose
    bits differ from the twin's is printed."""
    o, p, k, n = SHAPES[shape]
    h, w, dy = case(o, p, k, n, dtype, cuda, seed=3)
    cuda_lib.reset_launch_counts()
    out = mlp_cuda.forward(h, w)
    dh, dw = mlp_cuda.backward(h, w, dy)
    torch.cuda.synchronize()
    assert {k_: c for k_, c in cuda_lib.launch_counts().items() if c} == {"M1": 1, "M2": 2}
    assert out.dtype == torch.float32 and dh.dtype == dtype and dw.dtype == dtype
    hd, wd, dyd = h.double(), w.double(), dy.double()
    within(out, torch.bmm(hd, wd), torch.bmm(hd.abs(), wd.abs()), k, "M1")
    pad = 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32
    within(dh, torch.bmm(dyd, wd.transpose(1, 2)), torch.bmm(dyd.abs(), wd.abs().transpose(1, 2)),
           pad, "M2 dh")
    within(dw, torch.bmm(hd.transpose(1, 2), dyd), torch.bmm(hd.abs().transpose(1, 2), dyd.abs()),
           512, "M2 dw")
    twin = (mlp_cuda.forward_plain(h, w), *mlp_cuda.backward_plain(h, w, dy))
    shares = {name: float((a != b).float().mean())
              for name, a, b in zip(("out", "dh", "dw"), (out, dh, dw), twin)}
    print(f"{shape} {dtype}: share of values that differ from the twin {shares}")


def test_m2_gives_the_same_bits_twice(cuda):
    """Two runs of M1 and M2 at `ngp`'s density shape, bf16: the same bits
    (no float atomics)."""
    h, w, dy = case(*SHAPES["ngp_density"], torch.bfloat16, cuda, seed=5)
    first = (mlp_cuda.forward(h, w), *mlp_cuda.backward(h, w, dy))
    second = (mlp_cuda.forward(h, w), *mlp_cuda.backward(h, w, dy))
    assert all(same_bits(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "h_only", "w_only"])
def test_last_product_runs_the_gradients_asked_for(cuda, dtype, need):
    """Through autograd on the card: h alone needing a gradient (pose
    refinement) launches M2 without its sum, w alone M2 and its sum; the
    gradients equal a direct `backward` call's bits."""
    h, w, dy = case(2, 5000, 64, 16, dtype, cuda, seed=7)
    cuda_lib.reset_launch_counts()
    out, dh, dw = grads(mlp_cuda.last_product, h, w, dy, need)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["M1"] == 1
    assert cuda_lib.launch_counts()["M2"] == 1 + need[1]
    want = mlp_cuda.backward(h, w, dy, *need)
    assert same_bits(out, mlp_cuda.forward(h, w))
    for a, b in zip((dh, dw), want):
        assert (a is None and b is None) or same_bits(a, b)


@pytest.mark.parametrize("field,networks", [("tcnn", 1), ("ngp", 2)])
def test_a_train_step_runs_m1_and_m2_once_a_network(cuda, field, networks):
    """`train_objects` on the card launches M1 once and M2 (with its sum)
    once a network a step, and counts O x points a network under
    `mlp.fused_points`: RO-MAP's head, instant-ngp's density and colour
    networks."""
    net = NetworkConfig(output_dims=16, sh_degree=4) if field == "ngp" else NetworkConfig()
    cfg = NerfConfig(encoding=dataclasses.replace(EncodingConfig.preset("tcnn"),
                                                  log2_hashmap_size=12),
                     network=net, train=TrainConfig(rays_per_batch=256, samples_per_ray=8))
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_synthetic_world(2, 3, 32, capacity=3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = nerf.init_train_state(gen, 3, cfg, spec, device=cuda)
    cuda_lib.reset_launch_counts()
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        nerf.train_objects(state, objs, store.arrays(), cfg, spec, 3, generator=gen)
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    counts = cuda_lib.launch_counts()
    assert (counts["M1"], counts["M2"]) == (3 * networks, 2 * 3 * networks)
    counted = [c["n"] for c in tracing.drain()["counters"] if c["name"] == "mlp.fused_points"]
    assert counted == [3 * 256 * 8] * (3 * networks)
