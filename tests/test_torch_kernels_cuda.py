"""K0-K10 and the hash grid's H0-H3 (romap_tpu_torch/csrc) against their
plain PyTorch twins on the card. Every test needs a CUDA device and skips without one (decided
inside the fixture, at run time). Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q`
(the repo conftest imports jax, which a GPU machine need not have).

Tolerances: in fp32 the kernels and the twins differ only in summation
order (two-tap lerps vs dense products; K2's atomics add in an order that
changes from run to run), so 1e-4 relative to each tensor's largest
entry. In bf16 both round the same fp32 value once at the store, so a
stored value may differ by one bf16 step (2^-8 relative): 1e-2 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from romap_tpu_torch.config import EncodingConfig, NetworkConfig
from romap_tpu_torch.ops import cuda_lib, hashgrid, hashgrid_cuda, mxgrid, mxgrid_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def small_spec(snap=True, planes=True):
    return mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32,
                              features=16, plane_specs=((24, 16, 8),) if planes else (),
                              plane_axes="balanced", snap_levels=snap)


def inputs(spec, n_obj, n_pts, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    (ru, rv, kp), = spec.plane_specs
    rf, rfp = spec.fold_res
    pts = torch.rand((n_obj, n_pts, 3), generator=g) * (1 + 4e-3) - 2e-3
    lines = 0.3 * torch.randn((n_obj, 3, spec.total_res, spec.features), generator=g)
    planes = 0.3 * torch.randn((n_obj, 3, ru, rv, kp), generator=g)
    plines = 0.3 * torch.randn((n_obj, 3, max(ru, rv), kp), generator=g)
    w_eff = mxgrid.fold_lines(lines, spec)
    gout = torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g)
    to = lambda t: t.to(device=device, dtype=dtype).contiguous()
    return pts.to(device), to(w_eff), to(planes), to(plines), to(gout)


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k1_matches_plain(cuda, dtype, tol):
    spec = small_spec()
    pts, w_eff, planes, plines, _ = inputs(spec, 3, 1000, dtype, cuda)
    n0 = mxgrid_cuda.folded_fused_forward.launches
    got = mxgrid_cuda.folded_fused_forward(pts, w_eff, planes, plines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.folded_fused_forward.launches == n0 + 1
    want = mxgrid_cuda.folded_fused_forward_plain(pts, w_eff, planes, plines, spec)
    for name, a, b in zip(("out", "afac", "fpl", "fli"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k2_matches_plain(cuda, dtype, tol):
    spec = small_spec()
    pts, w_eff, planes, plines, gout = inputs(spec, 3, 1000, dtype, cuda)
    _, afac, fpl, fli = mxgrid_cuda.folded_fused_forward_plain(pts, w_eff, planes, plines, spec)
    n0 = mxgrid_cuda.folded_fused_backward.launches
    got = mxgrid_cuda.folded_fused_backward(pts, afac, fpl, fli, gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.folded_fused_backward.launches == n0 + 1
    want = mxgrid_cuda.folded_fused_backward_plain(pts, afac, fpl, fli, gout, spec)
    for name, a, b in zip(("dW_eff", "dplanes", "dplines"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_err(a, b) < tol, name


def test_encode_folded_matches_plain_encode(cuda):
    """The autograd path (fold, K1, K2, unfold) vs autograd through the
    plain encode, fp32."""
    spec = small_spec()
    g = torch.Generator().manual_seed(1)
    p = torch.rand((2, 700, 3), generator=g)
    f = mxgrid.init_mxgrid(g, spec, 2)
    tgt = torch.randn((2, 700, spec.n_output_dims), generator=g)

    def run(dev, enc):
        ff = {"lines": f["lines"].to(dev).requires_grad_(True),
              "planes": (f["planes"][0].to(dev).requires_grad_(True),),
              "plane_lines": (f["plane_lines"][0].to(dev).requires_grad_(True),)}
        out = enc(ff, p.to(dev), spec)
        loss = torch.sum((out - tgt.to(dev)) ** 2)
        leaves = [ff["lines"], ff["planes"][0], ff["plane_lines"][0]]
        return [out] + list(torch.autograd.grad(loss, leaves))

    got = run(cuda, mxgrid_cuda.encode)
    want = run(cuda, mxgrid.encode)
    for a, b in zip(got, want):
        assert rel_err(a, b) < 1e-4


def test_cuda_encode_refuses_point_gradients(cuda):
    """The kernel encode no longer refuses a gradient of the points: the
    forward kernel and K0 (no table kernel: the tables are frozen) give the
    gradient of autograd through the plain encode, fp32, 1e-4."""
    spec = small_spec()
    f = {k: (v.to(cuda) if torch.is_tensor(v) else tuple(x.to(cuda) for x in v))
         for k, v in mxgrid.init_mxgrid(torch.Generator().manual_seed(2), spec, 1).items()}
    g = torch.Generator().manual_seed(3)
    pts = torch.rand((1, 640, 3), generator=g).to(cuda)
    gout = torch.randn((1, 640, spec.n_output_dims), generator=g).to(cuda)
    assert not mxgrid_cuda.on_a_knot(pts, spec).any()  # where the tent has a derivative
    grads = []
    for enc in (mxgrid_cuda.encode, mxgrid.encode):
        p = pts.clone().requires_grad_(True)
        cuda_lib.reset_launch_counts()
        grads.append(torch.autograd.grad(torch.sum(enc(f, p, spec) * gout), p)[0])
        if enc is mxgrid_cuda.encode:
            launched = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if fn.launches}
    assert launched == {"K0": 1, "K1": 1}
    assert rel_err(*grads) < 1e-4


K0_CASES = [("folded", True, 1, "1"), ("unsnapped", False, 1, "1"),
            ("folded_cp", True, 0, "1"), ("unsnapped_cp", False, 0, "1"),
            ("folded_split", True, 2, "0"), ("unsnapped_split", False, 2, "0")]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("path,snap,n_planes,fused", K0_CASES)
def test_k0_matches_plain(cuda, monkeypatch, path, snap, n_planes, fused, dtype, tol):
    """K0 on each kernel path against its plain twin, from the same
    residuals (the split paths with two plane levels); 3 objects x 4097
    points, some just outside the cube. Both sum the same rounded inputs in
    fp32, so the tolerances are the forward kernels'."""
    monkeypatch.setenv("MX_FUSED", fused)
    spec = mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32, features=16,
                              plane_specs=((24, 16, 8), (8, 8, 4))[:n_planes],
                              plane_axes="balanced", snap_levels=snap)
    assert mxgrid_cuda.kernel_path(spec) == path
    g = torch.Generator().manual_seed(31)
    f = mxgrid.init_mxgrid(g, spec, 3)
    lines = f["lines"] if n_planes else f
    table = mxgrid.fold_lines(lines, spec) if snap else lines
    planes = tuple(f["planes"]) if n_planes else ()
    plines = tuple(f["plane_lines"]) if n_planes else ()
    pts = torch.rand((3, 4097, 3), generator=g) * (1 + 4e-3) - 2e-3
    to = lambda t: t.to(device=cuda, dtype=dtype).contiguous()
    table, planes, plines = to(table), tuple(map(to, planes)), tuple(map(to, plines))
    pts = pts.to(cuda)
    fwd_basis = (mxgrid_cuda._folded_basis if snap else mxgrid_cuda._ladder_basis)(spec)
    afac = mxgrid_cuda._cp_factors_plain(pts, table, fwd_basis).to(dtype).transpose(2, 3)
    afac = afac.contiguous()
    fpl = fli = None
    if n_planes:
        _, fpl, fli = mxgrid_cuda._planes_plain(pts, planes, plines, spec, dtype)
    gout = to(torch.randn((3, 4097, spec.n_output_dims), generator=g))
    n0 = mxgrid_cuda.points_gradient.launches
    got = mxgrid_cuda.points_gradient(pts, table, afac, planes, plines, fpl, fli, gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.points_gradient.launches == n0 + 1
    want = mxgrid_cuda.points_gradient_plain(pts, table, afac, planes, plines, fpl, fli, gout,
                                             spec)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert rel_err(got, want) < tol


def test_wrappers_reject_bad_inputs(cuda):
    spec = small_spec()
    pts, w_eff, planes, plines, _ = inputs(spec, 1, 100, torch.float32, cuda)
    with pytest.raises(ValueError):  # table on the CPU
        mxgrid_cuda.folded_fused_forward(pts, w_eff.cpu(), planes, plines, spec)
    with pytest.raises(ValueError):  # mixed dtypes
        mxgrid_cuda.folded_fused_forward(pts, w_eff, planes.bfloat16(), plines, spec)
    with pytest.raises(ValueError):  # not contiguous
        strided = torch.cat([pts, pts], dim=-1)[..., :3]
        mxgrid_cuda.folded_fused_forward(strided, w_eff, planes, plines, spec)
    assert np.isfinite(mxgrid_cuda.folded_fused_forward(
        pts, w_eff, planes, plines, spec)[0].cpu().numpy()).all()


def ladder_inputs(spec, n_obj, n_pts, dtype, device, seed=0):
    """Points, raw (unfolded) tables and a cotangent; planes None for a
    CP-only spec."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pts = torch.rand((n_obj, n_pts, 3), generator=g) * (1 + 4e-3) - 2e-3
    tables = mxgrid.init_mxgrid(g, spec, n_obj)
    gout = torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g)
    to = lambda t: t.to(device=device, dtype=dtype).contiguous()
    if not spec.plane_specs:
        return pts.to(device), to(tables), None, None, to(gout)
    return (pts.to(device), to(tables["lines"]), to(tables["planes"][0]),
            to(tables["plane_lines"][0]), to(gout))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k3_k4_match_plain(cuda, dtype, tol):
    spec = small_spec(snap=False)
    pts, lines, planes, plines, gout = ladder_inputs(spec, 3, 1000, dtype, cuda)
    n3 = mxgrid_cuda.unsnapped_fused_forward.launches
    got = mxgrid_cuda.unsnapped_fused_forward(pts, lines, planes, plines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_fused_forward.launches == n3 + 1
    want = mxgrid_cuda.unsnapped_fused_forward_plain(pts, lines, planes, plines, spec)
    for name, a, b in zip(("out", "afac", "fpl", "fli"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name
    _, afac, fpl, fli = want
    n4 = mxgrid_cuda.unsnapped_fused_backward.launches
    got = mxgrid_cuda.unsnapped_fused_backward(pts, afac, fpl, fli, gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_fused_backward.launches == n4 + 1
    want = mxgrid_cuda.unsnapped_fused_backward_plain(pts, afac, fpl, fli, gout, spec)
    for name, a, b in zip(("dlines", "dplanes", "dplines"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_err(a, b) < tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k5_k6_match_plain(cuda, dtype, tol):
    spec = small_spec(planes=False)
    pts, lines, _, _, gout = ladder_inputs(spec, 3, 1000, dtype, cuda)
    w_eff = mxgrid.fold_lines(lines, spec).contiguous()
    n5 = mxgrid_cuda.folded_cp_forward.launches
    got = mxgrid_cuda.folded_cp_forward(pts, w_eff, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.folded_cp_forward.launches == n5 + 1
    want = mxgrid_cuda.folded_cp_forward_plain(pts, w_eff, spec)
    for name, a, b in zip(("out", "afac"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name
    n6 = mxgrid_cuda.folded_cp_backward.launches
    got = mxgrid_cuda.folded_cp_backward(pts, want[1], gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.folded_cp_backward.launches == n6 + 1
    ref = mxgrid_cuda.folded_cp_backward_plain(pts, want[1], gout, spec)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_err(got, ref) < tol


@pytest.mark.parametrize("snap,planes", [(False, True), (True, False)])
def test_kernel_encode_matches_plain_encode(cuda, snap, planes):
    """The autograd path through K3/K4 (unsnapped) and K5/K6 (CP-only) vs
    autograd through the plain encode, fp32."""
    spec = small_spec(snap=snap, planes=planes)
    pts, lines, pl, pli, _ = ladder_inputs(spec, 2, 700, torch.float32, cuda, seed=1)
    tgt = torch.randn((2, 700, spec.n_output_dims), generator=torch.Generator().manual_seed(4))

    def run(enc):
        leaves = [t.clone().requires_grad_(True) for t in (lines, pl, pli) if t is not None]
        f = leaves[0] if not planes else {"lines": leaves[0], "planes": (leaves[1],),
                                          "plane_lines": (leaves[2],)}
        out = enc(f, pts, spec)
        loss = torch.sum((out - tgt.to(cuda)) ** 2)
        return [out] + list(torch.autograd.grad(loss, leaves))

    for a, b in zip(run(mxgrid_cuda.encode), run(mxgrid.encode)):
        assert rel_err(a, b) < 1e-4


def test_uncovered_specs_raise_on_cuda(cuda, monkeypatch):
    """Unsnapped CP-only now runs K7/K8; several plane levels run only on
    the split path (MX_FUSED=0, K9/K10): the fused path raises for them,
    and so does the split path past K9/K10's level limit, instead of taking
    the plain encode."""
    spec = small_spec(snap=False, planes=False)
    pts, lines, *_ = ladder_inputs(spec, 1, 64, torch.float32, cuda)
    n7 = mxgrid_cuda.unsnapped_cp_forward.launches
    assert torch.isfinite(mxgrid_cuda.encode(lines, pts, spec)).all()
    assert mxgrid_cuda.unsnapped_cp_forward.launches == n7 + 1
    two = mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32, features=16,
                             plane_specs=((16, 16, 4), (8, 8, 4)), snap_levels=True)
    f = mxgrid.init_mxgrid(torch.Generator().manual_seed(0), two, 1)
    f = {k: (v.to(cuda) if torch.is_tensor(v) else tuple(x.to(cuda) for x in v))
         for k, v in f.items()}
    with pytest.raises(NotImplementedError, match="plane level"):
        mxgrid_cuda.encode(f, pts, two)
    monkeypatch.setenv("MX_FUSED", "0")
    five = mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32, features=16,
                              plane_specs=((8, 8, 2),) * 5, snap_levels=True)
    with pytest.raises(NotImplementedError, match="plane levels"):
        mxgrid_cuda.kernel_path(five)


def level_specs(n_levels, snap=False):
    """A spec with `n_levels` plane levels (rectangular, then square)."""
    levels = ((24, 16, 8), (12, 12, 4))[:n_levels]
    return mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32, features=16,
                              plane_specs=levels, plane_axes="balanced", snap_levels=snap)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k7_k8_match_plain(cuda, dtype, tol):
    spec = small_spec(snap=False, planes=False)
    pts, lines, _, _, gout = ladder_inputs(spec, 3, 1000, dtype, cuda)
    n7 = mxgrid_cuda.unsnapped_cp_forward.launches
    got = mxgrid_cuda.unsnapped_cp_forward(pts, lines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_cp_forward.launches == n7 + 1
    want = mxgrid_cuda.unsnapped_cp_forward_plain(pts, lines, spec)
    for name, a, b in zip(("out", "afac"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name
    afac = want[1]
    n8 = mxgrid_cuda.unsnapped_cp_backward.launches
    got = mxgrid_cuda.unsnapped_cp_backward(pts, afac, gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_cp_backward.launches == n8 + 1
    ref = mxgrid_cuda.unsnapped_cp_backward_plain(pts, afac, gout, spec)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_err(got, ref) < tol


@pytest.mark.parametrize("n_levels", [1, 2])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k9_k10_match_plain(cuda, dtype, tol, n_levels):
    spec = level_specs(n_levels)
    g = torch.Generator(device="cpu").manual_seed(3)
    tables = mxgrid.init_mxgrid(g, spec, 3)
    to = lambda t: t.to(device=cuda, dtype=dtype).contiguous()
    planes = tuple(to(t) for t in tables["planes"])
    plines = tuple(to(t) for t in tables["plane_lines"])
    pts = (torch.rand((3, 1000, 3), generator=g) * (1 + 4e-3) - 2e-3).to(cuda)
    gpl = to(torch.randn((3, 1000, spec.plane_out_dims), generator=g))
    n9 = mxgrid_cuda.planes_forward.launches
    got = mxgrid_cuda.planes_forward(pts, planes, plines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.planes_forward.launches == n9 + 1
    want = mxgrid_cuda.planes_forward_plain(pts, planes, plines, spec)
    for name, a, b in zip(("out", "fpl", "fli"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name
    assert torch.equal(got[0], mxgrid_cuda.plane_product(*got[1:]))
    want = want[1:]
    n10 = mxgrid_cuda.planes_backward.launches
    got = mxgrid_cuda.planes_backward(pts, *want, gpl, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.planes_backward.launches == n10 + 1
    ref = mxgrid_cuda.planes_backward_plain(pts, *want, gpl, spec)
    for name, a, b in zip(("dplanes", "dplines"), got, ref):
        assert len(a) == len(b) == n_levels
        for x, y in zip(a, b):
            assert x.dtype == torch.float32 and x.shape == y.shape
            assert rel_err(x, y) < tol, name


@pytest.mark.parametrize("snap,n_levels", [(False, 1), (True, 2), (False, 2)])
def test_split_encode_matches_plain_encode(cuda, monkeypatch, snap, n_levels):
    """MX_FUSED=0: the autograd path through K5/K7, K9, K6/K8 and K10 vs
    autograd through the plain encode, fp32."""
    monkeypatch.setenv("MX_FUSED", "0")
    spec = level_specs(n_levels, snap)
    assert mxgrid_cuda.kernel_path(spec) == ("folded_split" if snap else "unsnapped_split")
    g = torch.Generator().manual_seed(5)
    f = mxgrid.init_mxgrid(g, spec, 2)
    pts = (torch.rand((2, 700, 3), generator=g) * (1 + 4e-3) - 2e-3).to(cuda)
    tgt = torch.randn((2, 700, spec.n_output_dims), generator=g).to(cuda)

    def run(enc):
        ff = {"lines": f["lines"].to(cuda).requires_grad_(True),
              "planes": tuple(t.to(cuda).requires_grad_(True) for t in f["planes"]),
              "plane_lines": tuple(t.to(cuda).requires_grad_(True) for t in f["plane_lines"])}
        out = enc(ff, pts, spec)
        leaves = [ff["lines"], *ff["planes"], *ff["plane_lines"]]
        return [out] + list(torch.autograd.grad(torch.sum((out - tgt) ** 2), leaves))

    n9, n10 = mxgrid_cuda.planes_forward.launches, mxgrid_cuda.planes_backward.launches
    got = run(mxgrid_cuda.encode)
    assert (mxgrid_cuda.planes_forward.launches, mxgrid_cuda.planes_backward.launches) == (
        n9 + 1, n10 + 1)
    for a, b in zip(got, run(mxgrid.encode)):
        assert rel_err(a, b) < 1e-4


# --------------------------------------------------------------------------
# The folded kernels' variants at the widths of the shipped presets
# --------------------------------------------------------------------------


def preset_spec(name):
    """"flagship": 6 levels to 192 x 48 with the (128, 64, 4) plane level;
    "fast": CP only, 6 levels to 256 x 64; "quality": 256 x 64 with a
    (128, 128, 8) plane level (the EncodingConfig defaults and its `fast`
    and `quality` presets)."""
    planes = {"flagship": ((128, 64, 4),), "quality": ((128, 128, 8),)}.get(name, ())
    res, k = (192, 48) if name == "flagship" else (256, 64)
    return mxgrid.make_mxspec(n_levels=6, base_resolution=16, max_resolution=res, features=k,
                              plane_specs=planes, plane_axes="balanced", snap_levels=True)


def preset_points(kind, n_obj, n_pts, g):
    """uniform: the unit cube with its faces and a rim outside; cell: every
    point inside one knot cell of every axis and plane (all sums meet on two
    rows a table: the worst case for atomics); outside: half the points up
    to 0.3 outside the cube (no knot in reach: they add nothing)."""
    u = torch.rand((n_obj, n_pts, 3), generator=g)
    if kind == "uniform":
        pts = u * (1 + 4e-3) - 2e-3
        pts[:, :3] = torch.tensor([[0.0, 1.0, 0.5], [1.0, 0.0, 1.0], [0.0, 0.0, 0.0]])[:n_pts]
        return pts
    if kind == "cell":
        return 0.4 + u * 2e-3
    return u * 1.6 - 0.3


TC_SHAPES = [(1, 1), (1, 63), (10, 65), (2, 4097), (10, 4096)]


@pytest.mark.parametrize("kind", ["uniform", "cell", "outside"])
@pytest.mark.parametrize("n_obj,n_pts", TC_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("preset", ["flagship", "quality"])
def test_k1_k2_flagship_widths(cuda, preset, dtype, tol, n_obj, n_pts, kind):
    """K1 and K2 at the flagship spec and at `quality`'s (the staged forward,
    `quality` in fp32 the direct one; the tensor-core backward with 4 and 8
    plane channels, in fp32 on operands split into bf16 hi and lo parts) for
    point counts around the 64-point tile, one and ten objects: against the
    plain twins, and K2 against autograd through K1's twin."""
    spec = preset_spec(preset)
    bf16 = dtype == torch.bfloat16
    assert mxgrid_cuda.folded_variant(spec, dtype) == mxgrid_cuda.TC_VARIANT[dtype]
    direct = preset == "quality" and not bf16  # its fp32 table leaves no room for staged rows
    assert mxgrid_cuda.forward_variant(spec, dtype) == ("direct" if direct else "staged")
    g = torch.Generator().manual_seed(11)
    pts = preset_points(kind, n_obj, n_pts, g).to(cuda)
    tables = mxgrid.init_mxgrid(g, spec, n_obj)
    to = lambda t: t.to(device=cuda, dtype=dtype).contiguous()
    args = [to(mxgrid.fold_lines(tables["lines"], spec)), to(tables["planes"][0]),
            to(tables["plane_lines"][0])]
    gout = to(torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g))

    got = mxgrid_cuda.folded_fused_forward(pts, *args, spec)
    torch.cuda.synchronize()
    want = mxgrid_cuda.folded_fused_forward_plain(pts, *args, spec)
    for name, a, b in zip(("out", "afac", "fpl", "fli"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) < tol, name

    res = want[1:]
    got_b = mxgrid_cuda.folded_fused_backward(pts, *res, gout, spec)
    torch.cuda.synchronize()
    ref = mxgrid_cuda.folded_fused_backward_plain(pts, *res, gout, spec)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = mxgrid_cuda.folded_fused_forward_plain(pts, *leaves, spec)[0]
    auto = torch.autograd.grad(out, leaves, grad_outputs=gout)
    for name, a, b, c in zip(("dW_eff", "dplanes", "dplines"), got_b, ref, auto):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_err(a, b) < tol, name + " vs plain"
        assert rel_err(a, c) < tol, name + " vs autograd"


@pytest.mark.parametrize("preset", ["flagship", "fast"])
@pytest.mark.parametrize("n_obj,n_pts", [(1, 63), (3, 4097), (10, 4096)])
def test_k6_tensor_core_matches_plain(cuda, preset, n_obj, n_pts):
    """K5/K6 in bf16 at both instantiated CP shapes (K6 on the flagship spec
    is the split path's CP backward)."""
    spec = preset_spec(preset)
    dtype, tol = torch.bfloat16, 1e-2
    assert mxgrid_cuda.folded_variant(spec, dtype, planes=False) == "tensor_core"
    g = torch.Generator().manual_seed(12)
    pts = preset_points("uniform", n_obj, n_pts, g).to(cuda)
    tables = mxgrid.init_mxgrid(g, spec, n_obj)
    lines = tables["lines"] if spec.plane_specs else tables
    w_eff = mxgrid.fold_lines(lines, spec).to(device=cuda, dtype=dtype).contiguous()
    gout = torch.randn((n_obj, n_pts, spec.features), generator=g).to(device=cuda, dtype=dtype)
    got = mxgrid_cuda.folded_cp_forward(pts, w_eff, spec)
    torch.cuda.synchronize()
    want = mxgrid_cuda.folded_cp_forward_plain(pts, w_eff, spec)
    for name, a, b in zip(("out", "afac"), got, want):
        assert rel_err(a, b) < tol, name
    got_b = mxgrid_cuda.folded_cp_backward(pts, want[1], gout, spec)
    torch.cuda.synchronize()
    assert rel_err(got_b, mxgrid_cuda.folded_cp_backward_plain(pts, want[1], gout, spec)) < tol


FOLDED_SPLIT_CASES = [("flagship", True), ("quality", True), ("flagship", False), ("fast", False)]


def folded_case(spec, planes, n_obj, n_pts, kind, cuda, seed):
    """fp32 points, K1's (planes) or K5's residuals from the plain forward
    twin, and a cotangent of the block the backward reads."""
    g = torch.Generator().manual_seed(seed)
    pts = preset_points(kind, n_obj, n_pts, g).to(cuda)
    tables = mxgrid.init_mxgrid(g, spec, n_obj)
    w_eff = mxgrid.fold_lines(tables["lines"] if spec.plane_specs else tables, spec).to(cuda)
    cols = spec.n_output_dims if planes else spec.features
    gout = torch.randn((n_obj, n_pts, cols), generator=g).to(cuda)
    if planes:
        res = mxgrid_cuda.folded_fused_forward_plain(
            pts, w_eff, tables["planes"][0].to(cuda), tables["plane_lines"][0].to(cuda), spec)[1:]
    else:
        res = mxgrid_cuda.folded_cp_forward_plain(pts, w_eff, spec)[1:]
    return pts, res, gout


def folded_backward(planes):
    """(K2 or K6's wrapper, its plain twin), each returning a tuple."""
    if planes:
        return mxgrid_cuda.folded_fused_backward, mxgrid_cuda.folded_fused_backward_plain
    return (lambda *a: (mxgrid_cuda.folded_cp_backward(*a),),
            lambda *a: (mxgrid_cuda.folded_cp_backward_plain(*a),))


@pytest.mark.parametrize("kind", ["uniform", "cell", "outside"])
@pytest.mark.parametrize("n_obj,n_pts", TC_SHAPES)
@pytest.mark.parametrize("preset,planes", FOLDED_SPLIT_CASES)
def test_k2_k6_split_matches_plain_and_scalar(cuda, monkeypatch, preset, planes, n_obj, n_pts,
                                              kind):
    """K2 (the flagship with its (128, 64, 4) plane level, `quality` with
    its (128, 128, 8) level) and K6 (the flagship's ladder as the split path
    runs it, `fast`'s) in fp32 on the tensor cores, operands split into bf16
    hi and lo parts ("tensor_core_split"): against the plain twin and
    against the scalar kernel (forced) at fp32's 1e-4 of each tensor's
    largest entry."""
    spec = preset_spec(preset)
    assert mxgrid_cuda.folded_variant(spec, torch.float32, planes) == "tensor_core_split"
    pts, res, gout = folded_case(spec, planes, n_obj, n_pts, kind, cuda, seed=41)
    bwd, plain = folded_backward(planes)
    counter = mxgrid_cuda.folded_fused_backward if planes else mxgrid_cuda.folded_cp_backward
    n = counter.launches_by_variant["float32 tensor_core_split"]
    got = bwd(pts, *res, gout, spec)
    torch.cuda.synchronize()
    assert counter.launches_by_variant["float32 tensor_core_split"] == n + 1
    ref = plain(pts, *res, gout, spec)
    monkeypatch.setattr(mxgrid_cuda, "folded_variant", lambda *a, **k: "scalar")
    scalar = bwd(pts, *res, gout, spec)
    for name, a, b, c in zip(("dW_eff", "dplanes", "dplines"), got, ref, scalar):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        assert rel_err(a, b) < 1e-4, name + " vs plain"
        assert rel_err(a, c) < 1e-4, name + " vs scalar"


@pytest.mark.parametrize("preset,planes", FOLDED_SPLIT_CASES)
def test_k2_k6_split_at_the_train_step_shape(cuda, preset, planes):
    """The fp32 K2 / K6 at 10 objects x 131072 points, the train step's
    shape, where a block walks some 158 tiles of 64 points: against the
    plain twin at 1e-4 (the sums are added to the gradient every
    kFlushTiles tiles: the tensor cores' fp32 accumulation drifts with the
    steps a sum takes)."""
    spec = preset_spec(preset)
    pts, res, gout = folded_case(spec, planes, 10, 131072, "uniform", cuda, seed=42)
    bwd, plain = folded_backward(planes)
    for name, a, b in zip(("dW_eff", "dplanes", "dplines"), bwd(pts, *res, gout, spec),
                          plain(pts, *res, gout, spec)):
        assert rel_err(a, b) < 1e-4, name


@pytest.mark.parametrize("n_pts", [4096, 4100])
def test_k2_split_takes_unaligned_bases(cuda, n_pts):
    """fp32 inputs at `quality` (one stage) and at the flagship (two): P a
    multiple of 4 (whole 16-byte fp32 chunks: the vector loader) but every
    input four bytes off a 16-byte boundary (the element-wise loader), same
    sums as the vector loader and within 1e-4 of the plain twin."""

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    for preset in ("quality", "flagship"):
        spec = preset_spec(preset)
        pts, res, gout = folded_case(spec, True, 2, n_pts, "uniform", cuda, seed=43)
        want = mxgrid_cuda.folded_fused_backward(pts, *res, gout, spec)
        got = mxgrid_cuda.folded_fused_backward(shifted(pts), *map(shifted, res), shifted(gout),
                                                spec)
        torch.cuda.synchronize()
        ref = mxgrid_cuda.folded_fused_backward_plain(pts, *res, gout, spec)
        for name, a, b, c in zip(("dW_eff", "dplanes", "dplines"), got, want, ref):
            assert rel_err(a, c) < 1e-4, f"{preset} {name} vs plain"
            assert rel_err(a, b) < 1e-4, f"{preset} {name} vs the vector loader"


def test_folded_split_variant_refuses_what_it_does_not_instantiate(cuda, monkeypatch):
    """"tensor_core_split" forced on bf16 residuals at an instantiated shape,
    or on fp32 ones at a spec no instantiation covers (K = 16), is refused by
    the C entries of K2 and K6, and the wrappers raise and count nothing."""
    monkeypatch.setattr(mxgrid_cuda, "folded_variant", lambda *a, **k: "tensor_core_split")
    for spec, dtype in ((preset_spec("flagship"), torch.bfloat16), (small_spec(), torch.float32)):
        pts, res, gout = folded_case(spec, True, 1, 64, "uniform", cuda, seed=44)
        res, gout = [t.to(dtype) for t in res], gout.to(dtype)
        n2, n6 = (mxgrid_cuda.folded_fused_backward.launches,
                  mxgrid_cuda.folded_cp_backward.launches)
        with pytest.raises(RuntimeError, match="CUDA error"):
            mxgrid_cuda.folded_fused_backward(pts, *res, gout, spec)
        cp = dataclasses.replace(spec, plane_specs=())
        with pytest.raises(RuntimeError, match="CUDA error"):
            mxgrid_cuda.folded_cp_backward(pts, res[0], gout[..., : spec.features].contiguous(),
                                           cp)
        assert (mxgrid_cuda.folded_fused_backward.launches,
                mxgrid_cuda.folded_cp_backward.launches) == (n2, n6)


def test_folded_flagship_encode_matches_plain_encode_fp32(cuda):
    """`encode` and its backward at the flagship spec in fp32 (fold, K1
    staged, K2 split, unfold) against autograd through the plain
    `ops.mxgrid.encode` on the same tables: 1e-4 of each tensor's largest
    entry."""
    spec = preset_spec("flagship")
    g = torch.Generator().manual_seed(45)
    f = mxgrid.init_mxgrid(g, spec, 2)
    pts = preset_points("uniform", 2, 5000, g).to(cuda)
    tgt = torch.randn((2, 5000, spec.n_output_dims), generator=g).to(cuda)

    def run(enc):
        leaves = [t.to(cuda).requires_grad_(True)
                  for t in (f["lines"], f["planes"][0], f["plane_lines"][0])]
        ff = {"lines": leaves[0], "planes": (leaves[1],), "plane_lines": (leaves[2],)}
        out = enc(ff, pts, spec)
        return [out] + list(torch.autograd.grad(torch.sum(out * tgt), leaves))

    bwd = mxgrid_cuda.folded_fused_backward
    n = bwd.launches_by_variant["float32 tensor_core_split"]
    got = run(mxgrid_cuda.encode)
    assert bwd.launches_by_variant["float32 tensor_core_split"] == n + 1
    for name, a, b in zip(("out", "dlines", "dplanes", "dplines"), got, run(mxgrid.encode)):
        assert rel_err(a, b) < 1e-4, name


def test_flagship_encode_matches_plain_encode(cuda):
    """`encode` and its backward at the flagship spec in bf16 (fold, K1
    staged, K2 on the tensor cores, unfold) against autograd through the
    plain `ops.mxgrid.encode` in fp32 on the same bf16 tables: 1e-2 of each
    tensor's largest entry (bf16 roundings of the stored features, the
    residuals, `hat` and `u`, and of the returned gradients)."""
    spec = preset_spec("flagship")
    g = torch.Generator().manual_seed(13)
    f = mxgrid.init_mxgrid(g, spec, 2)
    pts = preset_points("uniform", 2, 5000, g).to(cuda)
    tgt = torch.randn((2, 5000, spec.n_output_dims), generator=g).to(cuda)

    def run(enc, dtype):
        leaves = [t.to(cuda).bfloat16().to(dtype).requires_grad_(True)
                  for t in (f["lines"], f["planes"][0], f["plane_lines"][0])]
        ff = {"lines": leaves[0], "planes": (leaves[1],), "plane_lines": (leaves[2],)}
        out = enc(ff, pts, spec)
        grads = torch.autograd.grad(torch.sum(out.float() * tgt), leaves)
        return [out] + list(grads)

    n1, n2 = mxgrid_cuda.folded_fused_forward.launches, mxgrid_cuda.folded_fused_backward.launches
    got = run(mxgrid_cuda.encode, torch.bfloat16)
    assert (mxgrid_cuda.folded_fused_forward.launches,
            mxgrid_cuda.folded_fused_backward.launches) == (n1 + 1, n2 + 1)
    for name, a, b in zip(("out", "dlines", "dplanes", "dplines"), got,
                          run(mxgrid.encode, torch.float32)):
        assert rel_err(a, b) < 1e-2, name


# --------------------------------------------------------------------------
# The unsnapped backward on the tensor cores (K4, K8)
# --------------------------------------------------------------------------


def unsnapped_preset(name, planes=True):
    """The preset's spec with the ladder unsnapped; `planes=False` drops the
    flagship's plane level (K8 on the split path runs that ladder)."""
    spec = preset_spec(name)
    return mxgrid.make_mxspec(n_levels=6, base_resolution=16,
                              max_resolution=max(spec.resolutions), features=spec.features,
                              plane_specs=spec.plane_specs if planes else (),
                              plane_axes="balanced", snap_levels=False)


def unsnapped_case(spec, n_obj, n_pts, kind, cuda, seed, dtype=torch.bfloat16):
    """Points, the forward twin's residuals and a cotangent in `dtype`."""
    g = torch.Generator().manual_seed(seed)
    pts = preset_points(kind, n_obj, n_pts, g).to(cuda)
    tables = mxgrid.init_mxgrid(g, spec, n_obj)
    to = lambda t: t.to(device=cuda, dtype=dtype).contiguous()
    gout = to(torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g))
    if spec.plane_specs:
        args = [to(tables["lines"]), to(tables["planes"][0]), to(tables["plane_lines"][0])]
        res = mxgrid_cuda.unsnapped_fused_forward_plain(pts, *args, spec)[1:]
    else:
        args = [to(tables)]
        res = mxgrid_cuda.unsnapped_cp_forward_plain(pts, *args, spec)[1:]
    return pts, args, res, gout


@pytest.mark.parametrize("kind", ["uniform", "cell", "outside"])
@pytest.mark.parametrize("n_obj,n_pts", TC_SHAPES)
@pytest.mark.parametrize("preset", ["flagship", "quality"])
def test_k4_tensor_core_flagship_widths(cuda, preset, n_obj, n_pts, kind):
    """K4 in bf16 at the flagship ladder with its (128, 64, 4) plane level
    and at `quality`'s with its (128, 128, 8) level, for point counts around
    the 64-point tile (4097: the element-wise loader), one, two and ten
    objects: against the plain twin and against autograd through K3's
    twin."""
    spec = unsnapped_preset(preset)
    assert mxgrid_cuda.unsnapped_variant(spec, torch.bfloat16) == "tensor_core"
    pts, args, res, gout = unsnapped_case(spec, n_obj, n_pts, kind, cuda, seed=21)
    n4 = mxgrid_cuda.unsnapped_fused_backward.launches
    got = mxgrid_cuda.unsnapped_fused_backward(pts, *res, gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_fused_backward.launches == n4 + 1
    ref = mxgrid_cuda.unsnapped_fused_backward_plain(pts, *res, gout, spec)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = mxgrid_cuda.unsnapped_fused_forward_plain(pts, *leaves, spec)[0]
    auto = torch.autograd.grad(out, leaves, grad_outputs=gout)
    for name, a, b, c in zip(("dlines", "dplanes", "dplines"), got, ref, auto):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        assert rel_err(a, b) < 1e-2, name + " vs plain"
        assert rel_err(a, c) < 1e-2, name + " vs autograd"


@pytest.mark.parametrize("preset", ["flagship", "fast"])
@pytest.mark.parametrize("kind", ["uniform", "cell", "outside"])
@pytest.mark.parametrize("n_obj,n_pts", TC_SHAPES)
def test_k8_tensor_core_matches_plain(cuda, preset, n_obj, n_pts, kind):
    """K8 in bf16 at both instantiated ladders (the flagship's, as the split
    path runs it, and `fast`'s)."""
    spec = unsnapped_preset(preset, planes=False)
    assert mxgrid_cuda.unsnapped_variant(spec, torch.bfloat16) == "tensor_core"
    pts, _, (afac,), gout = unsnapped_case(spec, n_obj, n_pts, kind, cuda, seed=22)
    n8 = mxgrid_cuda.unsnapped_cp_backward.launches
    got = mxgrid_cuda.unsnapped_cp_backward(pts, afac, gout, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_cp_backward.launches == n8 + 1
    ref = mxgrid_cuda.unsnapped_cp_backward_plain(pts, afac, gout, spec)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all() and rel_err(got, ref) < 1e-2


SPLIT_CASES = [("flagship", True), ("quality", True), ("flagship", False), ("fast", False)]


@pytest.mark.parametrize("kind", ["uniform", "cell", "outside"])
@pytest.mark.parametrize("n_obj,n_pts", TC_SHAPES)
@pytest.mark.parametrize("preset,planes", SPLIT_CASES)
def test_k4_k8_split_matches_plain_and_scalar(cuda, monkeypatch, preset, planes, n_obj, n_pts,
                                              kind):
    """K4 (the flagship ladder with its (128, 64, 4) plane level, `quality`'s
    with its (128, 128, 8) level) and K8 (the flagship ladder as the split
    path runs it, `fast`'s) in fp32 on the tensor cores, operands split into
    bf16 hi and lo parts ("tensor_core_split"): against the plain twin and
    against the scalar kernel (forced) at fp32's 1e-4 of each tensor's
    largest entry."""
    spec = unsnapped_preset(preset, planes)
    assert mxgrid_cuda.unsnapped_variant(spec, torch.float32) == "tensor_core_split"
    pts, _, res, gout = unsnapped_case(spec, n_obj, n_pts, kind, cuda, seed=31,
                                       dtype=torch.float32)
    if planes:
        bwd, plain = mxgrid_cuda.unsnapped_fused_backward, mxgrid_cuda.unsnapped_fused_backward_plain
    else:
        bwd, plain = mxgrid_cuda.unsnapped_cp_backward, mxgrid_cuda.unsnapped_cp_backward_plain
    n = bwd.launches_by_variant["float32 tensor_core_split"]
    got = bwd(pts, *res, gout, spec)
    torch.cuda.synchronize()
    assert bwd.launches_by_variant["float32 tensor_core_split"] == n + 1
    got = got if planes else (got,)
    ref = plain(pts, *res, gout, spec)
    ref = ref if planes else (ref,)
    monkeypatch.setattr(mxgrid_cuda, "unsnapped_variant", lambda *a, **k: "scalar")
    scalar = bwd(pts, *res, gout, spec)
    scalar = scalar if planes else (scalar,)
    for name, a, b, c in zip(("dlines", "dplanes", "dplines"), got, ref, scalar):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        assert rel_err(a, b) < 1e-4, name + " vs plain"
        assert rel_err(a, c) < 1e-4, name + " vs scalar"


@pytest.mark.parametrize("preset,planes", SPLIT_CASES)
def test_k4_k8_split_at_the_train_step_shape(cuda, preset, planes):
    """The fp32 K4 / K8 at 10 objects x 131072 points, the train step's
    shape, where each block walks 32768 points (2048 steps of 16), against
    the plain twin at 1e-4: the tensor cores' own fp32 accumulation drifts
    with the steps a sum takes (1.03e-4 of the largest entry when a block
    kept its sums over its whole range), so the kernel adds its sums to the
    gradient every kFlushTiles tiles of 64 points."""
    spec = unsnapped_preset(preset, planes)
    pts, _, res, gout = unsnapped_case(spec, 10, 131072, "uniform", cuda, seed=34,
                                       dtype=torch.float32)
    if planes:
        got = mxgrid_cuda.unsnapped_fused_backward(pts, *res, gout, spec)
        ref = mxgrid_cuda.unsnapped_fused_backward_plain(pts, *res, gout, spec)
    else:
        got = (mxgrid_cuda.unsnapped_cp_backward(pts, *res, gout, spec),)
        ref = (mxgrid_cuda.unsnapped_cp_backward_plain(pts, *res, gout, spec),)
    for name, a, b in zip(("dlines", "dplanes", "dplines"), got, ref):
        assert rel_err(a, b) < 1e-4, name


def test_split_variant_refuses_what_it_does_not_instantiate(cuda, monkeypatch):
    """"tensor_core_split" forced on bf16 residuals at an instantiated
    shape, or on fp32 ones at a spec no instantiation covers (K = 16), is
    refused by the C entry, and the wrapper raises and counts nothing."""
    monkeypatch.setattr(mxgrid_cuda, "unsnapped_variant", lambda *a, **k: "tensor_core_split")
    flagship = unsnapped_preset("flagship")
    for spec, dtype in ((flagship, torch.bfloat16), (small_spec(snap=False), torch.float32)):
        pts, _, res, gout = unsnapped_case(spec, 1, 64, "uniform", cuda, seed=32, dtype=dtype)
        n4 = mxgrid_cuda.unsnapped_fused_backward.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            mxgrid_cuda.unsnapped_fused_backward(pts, *res, gout, spec)
        cp = dataclasses.replace(spec, plane_specs=())
        with pytest.raises(RuntimeError, match="CUDA error"):
            mxgrid_cuda.unsnapped_cp_backward(pts, res[0], gout[..., : spec.features].contiguous(),
                                              cp)
        assert mxgrid_cuda.unsnapped_fused_backward.launches == n4


@pytest.mark.parametrize("fused", ["1", "0"])
def test_unsnapped_flagship_encode_matches_plain_encode_fp32(cuda, monkeypatch, fused):
    """`encode` and its backward at the flagship spec unsnapped in fp32, on
    the fused path (K3, K4 split) and on the split path (MX_FUSED=0: K7 +
    K9, K8 split + K10), against autograd through the plain
    `ops.mxgrid.encode` on the same tables: 1e-4 of each tensor's largest
    entry."""
    monkeypatch.setenv("MX_FUSED", fused)
    spec = unsnapped_preset("flagship")
    g = torch.Generator().manual_seed(33)
    f = mxgrid.init_mxgrid(g, spec, 2)
    pts = preset_points("uniform", 2, 5000, g).to(cuda)
    tgt = torch.randn((2, 5000, spec.n_output_dims), generator=g).to(cuda)

    def run(enc):
        leaves = [t.to(cuda).requires_grad_(True)
                  for t in (f["lines"], f["planes"][0], f["plane_lines"][0])]
        ff = {"lines": leaves[0], "planes": (leaves[1],), "plane_lines": (leaves[2],)}
        out = enc(ff, pts, spec)
        return [out] + list(torch.autograd.grad(torch.sum(out * tgt), leaves))

    bwd = (mxgrid_cuda.unsnapped_fused_backward if fused == "1"
           else mxgrid_cuda.unsnapped_cp_backward)
    n = bwd.launches_by_variant["float32 tensor_core_split"]
    got = run(mxgrid_cuda.encode)
    assert bwd.launches_by_variant["float32 tensor_core_split"] == n + 1
    for name, a, b in zip(("out", "dlines", "dplanes", "dplines"), got, run(mxgrid.encode)):
        assert rel_err(a, b) < 1e-4, name


def test_k4_tensor_core_takes_unaligned_bases(cuda):
    """P a multiple of 8 but every input two or four bytes off a 16-byte
    boundary: the kernel's element-wise loader, same sums."""
    spec = unsnapped_preset("flagship")
    pts, _, res, gout = unsnapped_case(spec, 2, 4096, "uniform", cuda, seed=23)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    want = mxgrid_cuda.unsnapped_fused_backward(pts, *res, gout, spec)
    got = mxgrid_cuda.unsnapped_fused_backward(shifted(pts), *map(shifted, res),
                                               shifted(gout), spec)
    torch.cuda.synchronize()
    ref = mxgrid_cuda.unsnapped_fused_backward_plain(pts, *res, gout, spec)
    for name, a, b, c in zip(("dlines", "dplanes", "dplines"), got, want, ref):
        assert rel_err(a, c) < 1e-2, name + " vs plain"
        assert rel_err(a, b) < 1e-4, name + " vs the vector loader (atomic order only)"


@pytest.mark.parametrize("fused", ["1", "0"])
def test_unsnapped_flagship_encode_matches_plain_encode(cuda, monkeypatch, fused):
    """`encode` and its backward at the flagship spec unsnapped in bf16, on
    the fused path (K3, K4 on the tensor cores) and on the split path
    (MX_FUSED=0: K7 + K9, K8 on the tensor cores + K10), against autograd
    through the plain `ops.mxgrid.encode` in fp32 on the same bf16 tables:
    1e-2 of each tensor's largest entry."""
    monkeypatch.setenv("MX_FUSED", fused)
    spec = unsnapped_preset("flagship")
    assert mxgrid_cuda.kernel_path(spec) == ("unsnapped" if fused == "1" else "unsnapped_split")
    g = torch.Generator().manual_seed(14)
    f = mxgrid.init_mxgrid(g, spec, 2)
    pts = preset_points("uniform", 2, 5000, g).to(cuda)
    tgt = torch.randn((2, 5000, spec.n_output_dims), generator=g).to(cuda)

    def run(enc, dtype):
        leaves = [t.to(cuda).bfloat16().to(dtype).requires_grad_(True)
                  for t in (f["lines"], f["planes"][0], f["plane_lines"][0])]
        ff = {"lines": leaves[0], "planes": (leaves[1],), "plane_lines": (leaves[2],)}
        out = enc(ff, pts, spec)
        return [out] + list(torch.autograd.grad(torch.sum(out.float() * tgt), leaves))

    bwd = (mxgrid_cuda.unsnapped_fused_backward if fused == "1"
           else mxgrid_cuda.unsnapped_cp_backward)
    n = bwd.launches
    got = run(mxgrid_cuda.encode, torch.bfloat16)
    assert bwd.launches == n + 1
    for name, a, b in zip(("out", "dlines", "dplanes", "dplines"), got,
                          run(mxgrid.encode, torch.float32)):
        assert rel_err(a, b) < 1e-2, name


def kp16_spec(snap):
    """`quality`'s 256 x 64 ladder with a (128, 128, 16) plane level
    (scripts/bench_variants.py's k64_p16): a plane level no tensor-core
    backward instantiates."""
    return mxgrid.make_mxspec(n_levels=6, base_resolution=16, max_resolution=256,
                              features=64, plane_specs=((128, 128, 16),),
                              plane_axes="balanced", snap_levels=snap)


def test_unsnapped_specs_outside_the_instantiations(cuda, monkeypatch):
    """A bf16 spec the tensor-core tile does not cover (K = 16; a plane
    level of 16 channels) takes the scalar kernel and agrees with the
    plain twin; forcing the tensor-core variant on it is refused by the C
    entry, and the wrapper raises."""
    for spec in (small_spec(snap=False), kp16_spec(snap=False)):
        assert mxgrid_cuda.unsnapped_variant(spec, torch.bfloat16) == "scalar"
        pts, _, res, gout = unsnapped_case(spec, 2, 1000, "uniform", cuda, seed=24)
        got = mxgrid_cuda.unsnapped_fused_backward(pts, *res, gout, spec)
        torch.cuda.synchronize()
        ref = mxgrid_cuda.unsnapped_fused_backward_plain(pts, *res, gout, spec)
        for name, a, b in zip(("dlines", "dplanes", "dplines"), got, ref):
            assert rel_err(a, b) < 1e-2, name
        monkeypatch.setattr(mxgrid_cuda, "unsnapped_variant", lambda *a, **k: "tensor_core")
        n4 = mxgrid_cuda.unsnapped_fused_backward.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            mxgrid_cuda.unsnapped_fused_backward(pts, *res, gout, spec)
        if spec.features != 64:  # the 256 x 64 ladder is K8's `fast` instantiation
            with pytest.raises(RuntimeError, match="CUDA error"):
                mxgrid_cuda.unsnapped_cp_backward(
                    pts, res[0], gout[..., : spec.features].contiguous(),
                    dataclasses.replace(spec, plane_specs=()))
        assert mxgrid_cuda.unsnapped_fused_backward.launches == n4
        monkeypatch.undo()
    # fp32 at an instantiated shape: refused too
    flagship = unsnapped_preset("flagship")
    pts, _, res, gout = unsnapped_case(flagship, 1, 64, "uniform", cuda, seed=25)
    monkeypatch.setattr(mxgrid_cuda, "unsnapped_variant", lambda *a, **k: "tensor_core")
    with pytest.raises(RuntimeError, match="CUDA error"):
        mxgrid_cuda.unsnapped_fused_backward(pts, *(t.float() for t in res), gout.float(),
                                             flagship)


def test_folded_specs_outside_the_instantiations(cuda, monkeypatch):
    """The folded twin of the test above: a bf16 spec no tensor-core K2
    covers (K = 16; a plane level of 16 channels) takes the scalar kernel
    and agrees with the plain twin; forcing the tensor-core variant on it is
    refused by the C entry, and the wrapper raises; so is fp32 at an
    instantiated shape (`quality`'s)."""
    for spec in (small_spec(), kp16_spec(snap=True)):
        assert mxgrid_cuda.folded_variant(spec, torch.bfloat16) == "scalar"
        g = torch.Generator().manual_seed(26)
        pts = preset_points("uniform", 2, 1000, g).to(cuda)
        tables = mxgrid.init_mxgrid(g, spec, 2)
        to = lambda t: t.to(device=cuda, dtype=torch.bfloat16).contiguous()
        args = [to(mxgrid.fold_lines(tables["lines"], spec)), to(tables["planes"][0]),
                to(tables["plane_lines"][0])]
        gout = to(torch.randn((2, 1000, spec.n_output_dims), generator=g))
        res = mxgrid_cuda.folded_fused_forward_plain(pts, *args, spec)[1:]
        got = mxgrid_cuda.folded_fused_backward(pts, *res, gout, spec)
        torch.cuda.synchronize()
        ref = mxgrid_cuda.folded_fused_backward_plain(pts, *res, gout, spec)
        for name, a, b in zip(("dW_eff", "dplanes", "dplines"), got, ref):
            assert rel_err(a, b) < 1e-2, name
        monkeypatch.setattr(mxgrid_cuda, "folded_variant", lambda *a, **k: "tensor_core")
        n2 = mxgrid_cuda.folded_fused_backward.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            mxgrid_cuda.folded_fused_backward(pts, *res, gout, spec)
        assert mxgrid_cuda.folded_fused_backward.launches == n2
        monkeypatch.undo()
    quality = preset_spec("quality")
    g = torch.Generator().manual_seed(27)
    pts = preset_points("uniform", 1, 64, g).to(cuda)
    tables = mxgrid.init_mxgrid(g, quality, 1)
    args = [mxgrid.fold_lines(tables["lines"], quality).to(cuda),
            tables["planes"][0].to(cuda), tables["plane_lines"][0].to(cuda)]
    res = mxgrid_cuda.folded_fused_forward_plain(pts, *args, quality)[1:]
    gout = torch.randn((1, 64, quality.n_output_dims), generator=g).to(cuda)
    monkeypatch.setattr(mxgrid_cuda, "folded_variant", lambda *a, **k: "tensor_core")
    with pytest.raises(RuntimeError, match="CUDA error"):
        mxgrid_cuda.folded_fused_backward(pts, *res, gout, quality)


# --------------------------------------------------------------------------
# The unsnapped forward's variants (K3, K7)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", mxgrid_cuda.UNSNAPPED_FORWARD_VARIANTS)
@pytest.mark.parametrize("n_obj,n_pts", [(1, 1), (1, 63), (10, 65), (3, 4097), (10, 4096)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k3_variants_match_plain(cuda, monkeypatch, dtype, tol, n_obj, n_pts, variant):
    """Each forward variant of K3, forced, at the small ladder with its plane
    level (every variant's tables fit there), against the plain twin; the
    per-axis variant launches its product pass, the others do not. Point
    counts around a warp's 32 rows, and ranges that cross objects."""
    spec = small_spec(snap=False)
    monkeypatch.setattr(mxgrid_cuda, "unsnapped_forward_variant", lambda *a, **k: variant)
    pts, lines, planes, plines, _ = ladder_inputs(spec, n_obj, n_pts, dtype, cuda, seed=5)
    n3, n_pass = (mxgrid_cuda.unsnapped_fused_forward.launches,
                  mxgrid_cuda.cp_product_pass.launches)
    got = mxgrid_cuda.unsnapped_fused_forward(pts, lines, planes, plines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.unsnapped_fused_forward.launches == n3 + 1
    assert mxgrid_cuda.cp_product_pass.launches == n_pass + (variant == "per_axis")
    want = mxgrid_cuda.unsnapped_fused_forward_plain(pts, lines, planes, plines, spec)
    for name, a, b in zip(("out", "afac", "fpl", "fli"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name


@pytest.mark.parametrize("variant", mxgrid_cuda.UNSNAPPED_FORWARD_VARIANTS)
@pytest.mark.parametrize("n_obj,n_pts", [(1, 63), (3, 4097), (10, 4096)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k7_variants_match_plain(cuda, monkeypatch, dtype, tol, n_obj, n_pts, variant):
    """Each forward variant of K7, forced, at the small CP-only ladder: out
    and afac against the plain twin; the three-axis variants form the
    product in the kernel, rounded after each factor, so their out equals
    `cp_product` of their own afac exactly."""
    spec = small_spec(snap=False, planes=False)
    monkeypatch.setattr(mxgrid_cuda, "unsnapped_forward_variant", lambda *a, **k: variant)
    pts, lines, _, _, _ = ladder_inputs(spec, n_obj, n_pts, dtype, cuda, seed=6)
    n_prod = mxgrid_cuda.cp_product.launches
    out, afac = mxgrid_cuda.unsnapped_cp_forward(pts, lines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.cp_product.launches == n_prod + (variant == "per_axis")
    want = mxgrid_cuda.unsnapped_cp_forward_plain(pts, lines, spec)
    for name, a, b in zip(("out", "afac"), (out, afac), want):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) < tol, name
    assert torch.equal(out, mxgrid_cuda.cp_product(afac))


@pytest.mark.parametrize("kind", ["uniform", "cell", "outside"])
@pytest.mark.parametrize("n_obj,n_pts", TC_SHAPES)
@pytest.mark.parametrize("path", ["K3 flagship", "K7 flagship", "K7 fast"])
def test_unsnapped_forward_at_preset_widths(cuda, path, n_obj, n_pts, kind):
    """K3 and K7 in bf16 at the widths their paths run, with the variant the
    spec selects (K3 and K7 at the flagship ladder: three_axis_staged; K7
    at `fast`'s: three_axis_direct), against the plain twins; no product
    pass is launched."""
    kf, preset = path.split()
    spec = unsnapped_preset(preset, planes=kf == "K3")
    want_variant = "three_axis_direct" if preset == "fast" else "three_axis_staged"
    assert mxgrid_cuda.unsnapped_forward_variant(spec, torch.bfloat16) == want_variant
    pts, args, _, _ = unsnapped_case(spec, n_obj, n_pts, kind, cuda, seed=23)
    cuda_lib.reset_launch_counts()
    got = mxgrid_cuda.KERNELS[kf](pts, *args, spec)
    torch.cuda.synchronize()
    plain = (mxgrid_cuda.unsnapped_fused_forward_plain if kf == "K3"
             else mxgrid_cuda.unsnapped_cp_forward_plain)
    for a, b in zip(got, plain(pts, *args, spec)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert rel_err(a, b) < 1e-2
    assert mxgrid_cuda.KERNELS[kf].launches == 1
    assert all(fn.launches == 0 for fn in mxgrid_cuda.PRODUCT_PASSES.values())


# --------------------------------------------------------------------------
# The split path's plane kernels at the presets' plane levels: K9, and K10
# in each variant, on the plane block of the full cotangent
# --------------------------------------------------------------------------


def plane_level_spec(levels):
    """The flagship's (128, 64, 4) plane level, `quality`'s (128, 128, 8), or
    two levels, beside a small CP ladder (K9 and K10 read only the planes)."""
    plane_specs = {"flagship": ((128, 64, 4),), "quality": ((128, 128, 8),),
                   "two": ((128, 64, 4), (64, 64, 4))}[levels]
    return mxgrid.make_mxspec(n_levels=2, base_resolution=4, max_resolution=8, features=8,
                              plane_specs=plane_specs, plane_axes="balanced", snap_levels=False)


def plane_case(spec, n_obj, n_pts, kind, dtype, cuda, seed):
    """Points, plane tables and the full encode cotangent [O, P, K + 3 sum(kp)]."""
    g = torch.Generator().manual_seed(seed)
    pts = preset_points(kind, n_obj, n_pts, g).to(cuda)
    tables = mxgrid.init_mxgrid(g, spec, n_obj)
    to = lambda t: t.to(device=cuda, dtype=dtype).contiguous()
    planes = tuple(map(to, tables["planes"]))
    plines = tuple(map(to, tables["plane_lines"]))
    gfull = to(torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g))
    return pts, planes, plines, gfull


# (plane levels, dtype, tolerance, K10 variant): every variant the spec and
# dtype can name, and the scalar kernel where the tensor cores are chosen
K10_CASES = [
    ("flagship", torch.bfloat16, 1e-2, "tensor_core"),
    ("flagship", torch.bfloat16, 1e-2, "scalar"),
    ("flagship", torch.float32, 1e-4, "scalar"),
    ("quality", torch.bfloat16, 1e-2, "tensor_core"),
    ("quality", torch.bfloat16, 1e-2, "scalar"),
    ("quality", torch.float32, 1e-4, "scalar"),
    ("two", torch.bfloat16, 1e-2, "scalar"),
    ("two", torch.float32, 1e-4, "scalar"),
]


@pytest.mark.parametrize("g_layout", ["view", "contiguous"])
@pytest.mark.parametrize("n_obj,n_pts,kind", [(1, 63, "uniform"), (2, 4097, "cell"),
                                              (3, 8192, "uniform"), (2, 8192, "outside")])
@pytest.mark.parametrize("levels,dtype,tol,variant", K10_CASES)
def test_k9_k10_plane_levels_match_plain(cuda, monkeypatch, levels, dtype, tol, variant,
                                         n_obj, n_pts, kind, g_layout):
    """K9 (vector table loads; its plane features bit-equal to
    `plane_product` of its own residuals) and K10 in `variant` against their
    plain twins, 1e-4 (fp32) / 1e-2 (bf16) of each tensor's largest entry.
    K10 reads the plane block of the full cotangent as a view (the split
    step's layout: rows of K + 3 sum(kp)) or as a contiguous block; 4097
    points take the tensor-core kernel's element-wise loader."""
    spec = plane_level_spec(levels)
    pts, planes, plines, gfull = plane_case(spec, n_obj, n_pts, kind, dtype, cuda, seed=n_pts)
    n9 = mxgrid_cuda.planes_forward.launches
    got = mxgrid_cuda.planes_forward(pts, planes, plines, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.planes_forward.launches == n9 + 1
    want = mxgrid_cuda.planes_forward_plain(pts, planes, plines, spec)
    for name, a, b in zip(("out", "fpl", "fli"), got, want):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        assert rel_err(a, b) < tol, name
    assert torch.equal(got[0], mxgrid_cuda.plane_product(*got[1:]))

    gpl = gfull[..., spec.features:]
    if g_layout == "contiguous":
        gpl = gpl.contiguous()
    monkeypatch.setattr(mxgrid_cuda, "planes_variant", lambda *a, **k: variant)
    n10 = mxgrid_cuda.planes_backward.launches
    dgot = mxgrid_cuda.planes_backward(pts, *want[1:], gpl, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.planes_backward.launches == n10 + 1
    dwant = mxgrid_cuda.planes_backward_plain(pts, *want[1:], gpl, spec)
    for name, a, b in zip(("dplanes", "dplines"), dgot, dwant):
        assert len(a) == len(b) == len(spec.plane_specs)
        for x, y in zip(a, b):
            assert x.dtype == torch.float32 and x.shape == y.shape
            assert rel_err(x, y) < tol, name


def test_k10_tensor_core_refuses_other_levels(cuda, monkeypatch):
    """The tensor-core K10 is instantiated for one level of 128 line rows
    and 4 or 8 channels, in bf16; named for any other spec or dtype, the
    launch is refused and the wrapper raises (no fallback)."""
    monkeypatch.setattr(mxgrid_cuda, "planes_variant", lambda *a, **k: "tensor_core")
    for levels, dtype in (("two", torch.bfloat16), ("flagship", torch.float32)):
        spec = plane_level_spec(levels)
        pts, planes, plines, gfull = plane_case(spec, 1, 256, "uniform", dtype, cuda, seed=1)
        _, fpl, fli = mxgrid_cuda.planes_forward(pts, planes, plines, spec)
        with pytest.raises(RuntimeError, match="K10"):
            mxgrid_cuda.planes_backward(pts, fpl, fli, gfull[..., spec.features:], spec)


@pytest.mark.parametrize("preset", ["flagship", "quality"])
def test_split_encode_takes_k9_features_and_k10_in_place(cuda, monkeypatch, preset):
    """MX_FUSED=0 at a preset's widths unsnapped, bf16: one step of `encode`
    and its backward launches K9 once and K10 once (its tensor-core
    variant), forms no separate `plane_product`, and hands K10 the plane
    block of the cotangent as a view of the full one (no copy); the result
    agrees with autograd through the plain encode in fp32 on the same bf16
    tables within 1e-2 of each tensor's largest entry."""
    monkeypatch.setenv("MX_FUSED", "0")
    spec = unsnapped_preset(preset)
    assert mxgrid_cuda.kernel_path(spec) == "unsnapped_split"
    assert mxgrid_cuda.planes_variant(spec, torch.bfloat16) == "tensor_core"

    def no_product(*args):
        raise AssertionError("the split step formed plane_product")

    monkeypatch.setattr(mxgrid_cuda, "plane_product", no_product)
    seen = []  # the cotangent rows K10's wrapper is handed
    check, k10 = cuda_lib.check, mxgrid_cuda.planes_backward

    def watch(name, t, *args, rows=False, **kw):
        if rows:
            seen.append((t.is_contiguous(), t.stride(1)))
        return check(name, t, *args, rows=rows, **kw)

    monkeypatch.setattr(cuda_lib, "check", watch)
    g = torch.Generator().manual_seed(15)
    f = mxgrid.init_mxgrid(g, spec, 2)
    pts = preset_points("uniform", 2, 4096, g).to(cuda)
    tgt = torch.randn((2, 4096, spec.n_output_dims), generator=g).to(cuda)

    def run(enc, dtype):
        leaves = [t.to(cuda).bfloat16().to(dtype).requires_grad_(True)
                  for t in (f["lines"], f["planes"][0], f["plane_lines"][0])]
        ff = {"lines": leaves[0], "planes": (leaves[1],), "plane_lines": (leaves[2],)}
        out = enc(ff, pts, spec)
        return [out] + list(torch.autograd.grad(torch.sum(out.float() * tgt), leaves))

    n9, n10 = mxgrid_cuda.planes_forward.launches, k10.launches
    got = run(mxgrid_cuda.encode, torch.bfloat16)
    assert (mxgrid_cuda.planes_forward.launches, k10.launches) == (n9 + 1, n10 + 1)
    assert seen == [(False, spec.n_output_dims)]
    for name, a, b in zip(("out", "dlines", "dplanes", "dplines"), got,
                          run(mxgrid.encode, torch.float32)):
        assert rel_err(a, b) < 1e-2, name


# --------------------------------------------------------------------------
# K0 in each variant, and the channel-split forward of K3/K7
# --------------------------------------------------------------------------


def k0_case(spec, n_obj, n_pts, dtype, cuda, seed):
    """Points, the path's table, its planes and plane lines, the plain
    forwards' residuals in `dtype` and a cotangent: K0's arguments."""
    g = torch.Generator().manual_seed(seed)
    f = mxgrid.init_mxgrid(g, spec, n_obj)
    n_planes = len(spec.plane_specs)
    lines = f["lines"] if n_planes else f
    table = mxgrid.fold_lines(lines, spec) if spec.snap_levels else lines
    to = lambda t: t.to(device=cuda, dtype=dtype).contiguous()
    table = to(table)
    planes = tuple(map(to, f["planes"])) if n_planes else ()
    plines = tuple(map(to, f["plane_lines"])) if n_planes else ()
    pts = (torch.rand((n_obj, n_pts, 3), generator=g) * (1 + 4e-3) - 2e-3).to(cuda)
    basis = (mxgrid_cuda._folded_basis if spec.snap_levels else mxgrid_cuda._ladder_basis)(spec)
    afac = mxgrid_cuda._cp_factors_plain(pts, table, basis).to(dtype).transpose(2, 3)
    fpl = fli = None
    if n_planes:
        _, fpl, fli = mxgrid_cuda._planes_plain(pts, planes, plines, spec, dtype)
    gout = to(torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g))
    return pts, table, afac.contiguous(), planes, plines, fpl, fli, gout


@pytest.mark.parametrize("variant", mxgrid_cuda.POINTS_VARIANTS)
@pytest.mark.parametrize("n_obj,n_pts", [(1, 1), (1, 63), (3, 4097), (10, 4096), (1, 65537)])
@pytest.mark.parametrize("path", ["folded", "unsnapped_cp", "unsnapped_split"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_k0_variants_match_plain(cuda, monkeypatch, dtype, tol, path, n_obj, n_pts, variant):
    """Each variant of K0, forced, against its plain twin on the same
    residuals: the flagship folded spec with its plane level, the `fast`
    ladder unsnapped (CP only, K = 64: a channel quad a lane), and the
    flagship ladder on the split path with two plane levels; point counts
    around the 64-point tile and objects side by side. One launch, no
    other kernel."""
    monkeypatch.setattr(mxgrid_cuda, "points_variant", lambda *a, **k: variant)
    if path == "folded":
        spec = preset_spec("flagship")
    elif path == "unsnapped_cp":
        spec = unsnapped_preset("fast", planes=False)
    else:
        base = unsnapped_preset("flagship")
        spec = mxgrid.make_mxspec(n_levels=6, base_resolution=16, max_resolution=192,
                                  features=48, plane_specs=((128, 64, 4), (64, 64, 8)),
                                  plane_axes="balanced", snap_levels=False)
        assert spec.resolutions == base.resolutions
    args = k0_case(spec, n_obj, n_pts, dtype, cuda, seed=41)
    cuda_lib.reset_launch_counts()
    got = mxgrid_cuda.points_gradient(*args, spec)
    torch.cuda.synchronize()
    launched = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if fn.launches}
    assert launched == {"K0": 1}
    want = mxgrid_cuda.points_gradient_plain(*args, spec)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert rel_err(got, want) < tol


def test_k0_variants_agree_on_unaligned_tables(cuda):
    """The lanes-over-channels K0 reads a table or plane that is not 16-byte
    aligned (a view one element into its storage) four channels a scalar
    load, and agrees with its plain twin."""
    spec = preset_spec("flagship")
    pts, table, afac, planes, plines, fpl, fli, gout = k0_case(spec, 2, 1000, torch.float32,
                                                               cuda, seed=43)
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    table, planes = shift(table), (shift(planes[0]),)
    assert table.data_ptr() % 16 and planes[0].data_ptr() % 16
    args = (pts, table, afac, planes, plines, fpl, fli, gout, spec)
    got = mxgrid_cuda.points_gradient(*args)
    want = mxgrid_cuda.points_gradient_plain(*args)
    torch.cuda.synchronize()
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("kc", [4, 8, 16])
@pytest.mark.parametrize("n_obj,n_pts", [(1, 1), (1, 63), (10, 65), (3, 4097), (10, 4096)])
@pytest.mark.parametrize("kernel", ["K3", "K7"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_channel_split_slices_match_plain(cuda, monkeypatch, dtype, tol, kernel, n_obj, n_pts,
                                          kc):
    """The channel-split forward, forced, in slices of kc of the small
    ladder's 16 channels (4, 2 or 1 slices; K3's three plane pairs spread
    over the slices), against the plain twins; no product pass."""
    planes = kernel == "K3"
    spec = small_spec(snap=False, planes=planes)
    monkeypatch.setattr(mxgrid_cuda, "unsnapped_forward_variant",
                        lambda *a, **k: "channel_split")
    monkeypatch.setattr(mxgrid_cuda, "channel_split_width", lambda *a, **k: kc)
    pts, lines, pl, pli, _ = ladder_inputs(spec, n_obj, n_pts, dtype, cuda, seed=7)
    args = [lines, pl, pli] if planes else [lines]
    cuda_lib.reset_launch_counts()
    got = mxgrid_cuda.KERNELS[kernel](pts, *args, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.KERNELS[kernel].launches == 1
    assert all(fn.launches == 0 for fn in mxgrid_cuda.PRODUCT_PASSES.values())
    plain = (mxgrid_cuda.unsnapped_fused_forward_plain if planes
             else mxgrid_cuda.unsnapped_cp_forward_plain)
    for a, b in zip(got, plain(pts, *args, spec)):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a).all()
        assert rel_err(a, b) < tol
    if not planes:  # the product, rounded after each factor, from its own factors
        assert torch.equal(got[0], mxgrid_cuda.cp_product(got[1]))


@pytest.mark.parametrize("n_obj,n_pts", [(1, 63), (2, 4097), (10, 4096), (1, 196608)])
@pytest.mark.parametrize("path", ["K3 flagship", "K7 flagship", "K7 fast", "K3 quality"])
def test_fp32_unsnapped_forward_at_preset_widths(cuda, path, n_obj, n_pts):
    """K3 and K7 in fp32 at the presets' ladders (renders, meshes and pose
    refinement run them so), with the variant the spec selects,
    channel_split, against the plain twins within 1e-4; one launch and no
    product pass (the per-axis design launched `cp_product_pass` after K3
    and `cp_product` after K7)."""
    kf, preset = path.split()
    spec = unsnapped_preset(preset, planes=kf == "K3")
    assert mxgrid_cuda.unsnapped_forward_variant(spec, torch.float32) == "channel_split"
    pts, lines, pl, pli, _ = ladder_inputs(spec, n_obj, n_pts, torch.float32, cuda, seed=29)
    args = [lines, pl, pli] if kf == "K3" else [lines]
    cuda_lib.reset_launch_counts()
    got = mxgrid_cuda.KERNELS[kf](pts, *args, spec)
    torch.cuda.synchronize()
    assert mxgrid_cuda.KERNELS[kf].launches == 1
    assert all(fn.launches == 0 for fn in mxgrid_cuda.PRODUCT_PASSES.values())
    plain = (mxgrid_cuda.unsnapped_fused_forward_plain if kf == "K3"
             else mxgrid_cuda.unsnapped_cp_forward_plain)
    for a, b in zip(got, plain(pts, *args, spec)):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert rel_err(a, b) < 1e-4


# --------------------------------------------------------------------------
# H0-H3: the hash grid (csrc/hashgrid.cu)
# --------------------------------------------------------------------------
# Tolerances, relative to each tensor's largest entry: H1 in fp32 differs
# from its twin only in the order of its 8-term fp32 sum (and an FMA), 1e-5;
# in bf16 both round the same fp32 blend once at the store, so a stored
# value may differ by one bf16 step (2^-8 relative), 1e-2. H2 sums with
# atomics in an order that changes from run to run, against the twin's
# index_add_ (hundreds of terms a coarse row), 1e-4 in fp32 and one bf16
# step after its one cast, 1e-2. H0 sums the same fp32 products (of the
# same bf16 inputs in bf16) in another order, 1e-4.

HASH_SMALL = dict(kind="hashgrid", n_levels=4, n_features_per_level=2, log2_hashmap_size=9,
                  base_resolution=4, desired_resolution=64.0)
HASH_TOL = {"H1": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
            "H2": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
            "H0": {torch.float32: 1e-4, torch.bfloat16: 1e-4}}


def hash_spec(name):
    """`small`: 4 levels of 2 features, the first dense (4^3 = 64 rows), the
    others (resolutions 11, 26, 64) hashed into 512 rows; `small_f<n>`: the
    same with n features a level (the other counts the kernels take);
    `tcnn`: RO-MAP's 16 x 2, three dense levels, then 2^16 rows a level."""
    if name == "tcnn":
        return hashgrid.make_spec(EncodingConfig.preset("tcnn"))
    f = int(name.split("_f")[1]) if "_f" in name else 2
    return hashgrid.make_spec(EncodingConfig(**dict(HASH_SMALL, n_features_per_level=f)))


def hash_points(n_obj, n_pts, kind, g):
    """`uniform`: in the cube and 2e-3 past it; `faces`: one coordinate of
    each point exactly 0 or 1 (and the cube's corners); `outside`: up to
    0.3 past the cube, where cells are negative (the uint32 wrap); `rays`:
    32 ordered samples a chord of the cube, as a train step draws them (runs
    of neighbouring points in one coarse cell)."""
    if kind == "outside":
        return torch.rand((n_obj, n_pts, 3), generator=g) * 1.6 - 0.3
    if kind == "rays":
        n_rays = -(-n_pts // 32)
        a, b = (torch.rand((n_obj, n_rays, 1, 3), generator=g) for _ in range(2))
        t = torch.linspace(0, 1, 32)[None, None, :, None]
        return (a + t * (b - a)).reshape(n_obj, -1, 3)[:, :n_pts].contiguous()
    pts = torch.rand((n_obj, n_pts, 3), generator=g) * (1 + 4e-3) - 2e-3
    if kind == "faces":
        axis = torch.randint(0, 3, (n_obj, n_pts), generator=g)
        side = torch.randint(0, 2, (n_obj, n_pts), generator=g).float()
        pts.scatter_(2, axis[..., None], side[..., None])
        pts[:, :8] = torch.tensor(hashgrid.CORNERS, dtype=torch.float32)[: min(8, n_pts)]
    return pts


def hash_case(spec, n_obj, n_pts, kind, dtype, cuda, seed):
    """Points, a table N(0, 1) and a cotangent N(0, 1) on the card."""
    g = torch.Generator().manual_seed(seed)
    pts = hash_points(n_obj, n_pts, kind, g).to(cuda)
    table = torch.randn((n_obj, spec.total_params, spec.n_features), generator=g)
    gout = torch.randn((n_obj, n_pts, spec.n_output_dims), generator=g)
    return pts, table.to(cuda, dtype), gout.to(cuda, dtype)


HASH_CASES = [("small", 3, 4097), ("small", 2, 45), ("small", 1, 1), ("small_f1", 2, 4097),
              ("small_f4", 2, 4097), ("small_f8", 2, 4097), ("tcnn", 4, 131072)]


@pytest.mark.parametrize("kind", ["uniform", "faces", "outside", "rays"])
@pytest.mark.parametrize("name,n_obj,n_pts", HASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_kernels_match_plain(cuda, dtype, name, n_obj, n_pts, kind):
    """H1, H2 and H0 each against its plain twin from the same inputs, one
    launch each: a small spec with dense and hashed levels and the tcnn spec
    at room4's O=4 x 131,072, points in the cube, on its faces and outside
    it."""
    spec = hash_spec(name)
    pts, table, gout = hash_case(spec, n_obj, n_pts, kind, dtype, cuda, seed=53)
    cuda_lib.reset_launch_counts()
    got = {"H1": hashgrid_cuda.forward(pts, table, spec),
           "H2": hashgrid_cuda.table_gradient(pts, gout, spec),
           "H0": hashgrid_cuda.points_gradient(pts, table, gout, spec)}
    torch.cuda.synchronize()
    assert {k: n for k, n in cuda_lib.launch_counts().items() if n} == {
        "H0": 1, "H1": 1, "H2": 1}
    want = {"H1": hashgrid_cuda.forward_plain(pts, table, spec),
            "H2": hashgrid_cuda.table_gradient_plain(pts, gout, spec),
            "H0": hashgrid_cuda.points_gradient_plain(pts, table, gout, spec)}
    for k in got:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a).all(), k
        assert rel_err(a, b) < HASH_TOL[k][dtype], k


# nerfacto's proposal grids (5 levels x 2 features, 2^17 rows a level, base
# 16, max 128 and 256): small dense coarse levels (16^3 rows at level 0)
# that a step's 256 samples a ray hit in runs, H2's heaviest contention
NERFACTO_NET = NetworkConfig(field="nerfacto", sh_degree=4, output_dims=16,
                             appearance_frames=80)


@pytest.mark.parametrize("kind", ["uniform", "rays"])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hash_kernels_match_plain_at_the_proposal_specs(cuda, dtype, level, kind):
    """H1 and H2 at each proposal field's spec, O=2 x 262,144 points,
    against their plain twins, one launch each, with `test_hash_kernels_
    match_plain`'s tolerances."""
    spec = hashgrid.make_spec(NERFACTO_NET.proposal_encoding(level))
    assert spec.n_levels == 5 and max(spec.sizes) == 2**17
    pts, table, gout = hash_case(spec, 2, 262144, kind, dtype, cuda, seed=61)
    cuda_lib.reset_launch_counts()
    got = {"H1": hashgrid_cuda.forward(pts, table, spec),
           "H2": hashgrid_cuda.table_gradient(pts, gout, spec)}
    torch.cuda.synchronize()
    assert {k: n for k, n in cuda_lib.launch_counts().items() if n} == {"H1": 1, "H2": 1}
    want = {"H1": hashgrid_cuda.forward_plain(pts, table, spec),
            "H2": hashgrid_cuda.table_gradient_plain(pts, gout, spec)}
    for k in got:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape and torch.isfinite(a).all(), k
        assert rel_err(a, b) < HASH_TOL[k][dtype], k


@pytest.mark.parametrize("name", ["small", "tcnn"])
def test_hash_encode_autograd_matches_plain(cuda, name):
    """`hashgrid.encode` on the card (H1, then H2 and H0 in its backward)
    against autograd through H1's twin (index_select's backward and the
    derivative of the trilinear weights), fp32: the values within 1e-5,
    the table's and the points' gradients within 1e-4; and the table's
    gradient against a central difference along a random direction, which
    is exact but for rounding (the encode is linear in the table). The
    points are uniform: none lies on a cell's face, where the weights'
    derivative jumps."""
    spec = hash_spec(name)
    pts, table, gout = hash_case(spec, 2, 3000, "uniform", torch.float32, cuda, seed=59)

    def run(enc):
        t, p = table.clone().requires_grad_(True), pts.clone().requires_grad_(True)
        out = enc(t, p)
        return [out, *torch.autograd.grad(torch.sum(out * gout), (t, p))]

    cuda_lib.reset_launch_counts()
    got = run(lambda t, p: hashgrid.encode(t, p, spec))
    torch.cuda.synchronize()
    assert {k: n for k, n in cuda_lib.launch_counts().items() if n} == {
        "H0": 1, "H1": 1, "H2": 1}
    want = run(lambda t, p: hashgrid_cuda.forward_plain(p, t, spec))
    for a, b, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert a.shape == b.shape and rel_err(a, b) < tol
    d = torch.randn(table.shape, generator=torch.Generator().manual_seed(61)).to(cuda)
    f = lambda t: float(torch.sum(hashgrid.encode(t, pts, spec).double() * gout.double()))
    fd = f(table + 0.5 * d) - f(table - 0.5 * d)
    terms = got[1].double() * d.double()
    assert abs(fd - float(terms.sum())) < 1e-4 * float(terms.abs().sum())


def test_hash_encode_backward_runs_the_gradients_asked_for(cuda):
    """A table that needs a gradient runs H2 only; points that need one
    (pose refinement: the table frozen) run H0 only."""
    spec = hash_spec("small")
    pts, table, gout = hash_case(spec, 1, 500, "uniform", torch.float32, cuda, seed=67)
    for leaf in ("table", "points"):
        t = table.clone().requires_grad_(leaf == "table")
        p = pts.clone().requires_grad_(leaf == "points")
        cuda_lib.reset_launch_counts()
        out = hashgrid.encode(t, p, spec)
        torch.autograd.grad(torch.sum(out * gout), t if leaf == "table" else p)
        launched = {k: n for k, n in cuda_lib.launch_counts().items() if n}
        assert launched == {"H1": 1, "H2" if leaf == "table" else "H0": 1}, leaf


# H3, H0's backward: dg sums 8 corner products in fp32 (the twin in another
# order) and rounds once, 1e-4 in fp32 and one bf16 step, 1e-2, in bf16; the
# table's gradient sums with H2's atomics, H2's tolerances.
H3_TOL = {"dg": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
          "dtable": {torch.float32: 1e-4, torch.bfloat16: 1e-2}}


@pytest.mark.parametrize("kind", ["uniform", "faces", "outside", "rays"])
@pytest.mark.parametrize("name,n_obj,n_pts", HASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_h3_matches_plain(cuda, dtype, name, n_obj, n_pts, kind):
    """H3 against its twin from the same points, table, g and v (fp32), one
    launch: dg and the table's gradient, on the cases of H0-H2."""
    spec = hash_spec(name)
    pts, table, gout = hash_case(spec, n_obj, n_pts, kind, dtype, cuda, seed=73)
    v = torch.randn((n_obj, n_pts, 3), generator=torch.Generator().manual_seed(79)).to(cuda)
    cuda_lib.reset_launch_counts()
    got = hashgrid_cuda.normal_backward(pts, table, gout, v, spec)
    torch.cuda.synchronize()
    assert {k: n for k, n in cuda_lib.launch_counts().items() if n} == {"H3": 1}
    want = hashgrid_cuda.normal_backward_plain(pts, table, gout, v, spec)
    for k, a, b in zip(("dg", "dtable"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape and torch.isfinite(a).all(), k
        assert rel_err(a, b) < H3_TOL[k][dtype], k


@pytest.mark.parametrize("name", ["small", "tcnn"])
def test_points_gradient_node_matches_autograd_of_the_h0_twin(cuda, name):
    """`encode_points_gradient` on the card (H0, then H3 in its backward)
    against autograd through H0's twin in the table and in g, fp32: the
    value within 1e-4, both gradients within 1e-4."""
    spec = hash_spec(name)
    pts, table, gout = hash_case(spec, 2, 3000, "uniform", torch.float32, cuda, seed=83)
    v = torch.randn((2, 3000, 3), generator=torch.Generator().manual_seed(89)).to(cuda)

    def run(fn):
        t, g = table.clone().requires_grad_(True), gout.clone().requires_grad_(True)
        out = fn(t, g)
        return [out, *torch.autograd.grad(torch.sum(out * v), (t, g))]

    cuda_lib.reset_launch_counts()
    got = run(lambda t, g: hashgrid_cuda.encode_points_gradient(t, pts, g, spec))
    torch.cuda.synchronize()
    assert {k: n for k, n in cuda_lib.launch_counts().items() if n} == {"H0": 1, "H3": 1}
    want = run(lambda t, g: hashgrid_cuda.points_gradient_plain(pts, t, g, spec))
    for a, b in zip(got, want):
        assert a.shape == b.shape and rel_err(a, b) < 1e-4


def test_hash_wrappers_refuse_bad_inputs(cuda):
    """A CUDA tensor launches the kernel or raises: a table on another
    device, a dtype the kernels do not take, a wrong shape, a non-contiguous
    or misaligned table, points not fp32, a spec of 3 features a level."""
    spec = hash_spec("small")
    pts, table, gout = hash_case(spec, 2, 100, "uniform", torch.float32, cuda, seed=71)
    o, t, f = table.shape
    cuda_lib.reset_launch_counts()
    with pytest.raises(ValueError, match="on cpu"):
        hashgrid_cuda.forward(pts, table.cpu(), spec)
    with pytest.raises(ValueError, match="not supported"):
        hashgrid_cuda.forward(pts, table.half(), spec)
    with pytest.raises(ValueError, match="shape"):
        hashgrid_cuda.forward(pts, table[:, :-8].contiguous(), spec)
    with pytest.raises(ValueError, match="contiguous"):
        hashgrid_cuda.forward(pts, table.transpose(1, 2).contiguous().transpose(1, 2), spec)
    with pytest.raises(ValueError, match="aligned"):
        hashgrid_cuda.forward(pts, torch.zeros(o * t * f + 1, device=cuda)[1:].view(o, t, f),
                              spec)
    with pytest.raises(ValueError, match="dtype"):
        hashgrid_cuda.forward(pts.double(), table, spec)
    with pytest.raises(ValueError, match="shape"):
        hashgrid_cuda.table_gradient(pts, gout[..., :-2].contiguous(), spec)
    with pytest.raises(ValueError, match="dtype"):
        hashgrid_cuda.points_gradient(pts, table, gout.bfloat16(), spec)
    spec3 = hashgrid.make_spec(EncodingConfig(**dict(HASH_SMALL, n_features_per_level=3)))
    with pytest.raises(NotImplementedError, match="features"):
        hashgrid_cuda.forward(pts, torch.zeros((o, spec3.total_params, 3), device=cuda), spec3)
    assert not any(cuda_lib.launch_counts().values())
