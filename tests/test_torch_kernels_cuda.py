"""K1-K6 (romap_tpu_torch/csrc) against their plain PyTorch twins on
the card. Every test needs a CUDA device and skips without one (decided
inside the fixture, at run time). Run them on a GPU machine with
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q`
(the repo conftest imports jax, which a GPU machine need not have).

Tolerances: in fp32 the kernels and the twins differ only in summation
order (two-tap lerps vs dense products; K2's atomics add in an order that
changes from run to run), so 1e-4 relative to each tensor's largest
entry. In bf16 both round the same fp32 value once at the store, so a
stored value may differ by one bf16 step (2^-8 relative): 1e-2 relative.
"""

import numpy as np
import pytest
import torch

from romap_tpu_torch.ops import mxgrid, mxgrid_cuda


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
    spec = small_spec()
    f = {k: (v.to(cuda) if torch.is_tensor(v) else tuple(x.to(cuda) for x in v))
         for k, v in mxgrid.init_mxgrid(torch.Generator().manual_seed(2), spec, 1).items()}
    pts = torch.rand((1, 64, 3), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        mxgrid_cuda.encode(f, pts, spec)


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


def test_uncovered_specs_raise_on_cuda(cuda):
    """Unsnapped CP-only needs K7/K8 and several plane levels are not
    ported: both raise instead of taking the plain encode."""
    spec = small_spec(snap=False, planes=False)
    pts, lines, *_ = ladder_inputs(spec, 1, 64, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="K7/K8"):
        mxgrid_cuda.encode(lines, pts, spec)
    two = mxgrid.make_mxspec(n_levels=3, base_resolution=4, max_resolution=32, features=16,
                             plane_specs=((16, 16, 4), (8, 8, 4)), snap_levels=True)
    f = mxgrid.init_mxgrid(torch.Generator().manual_seed(0), two, 1)
    f = {k: (v.to(cuda) if torch.is_tensor(v) else tuple(x.to(cuda) for x in v))
         for k, v in f.items()}
    with pytest.raises(NotImplementedError, match="plane level"):
        mxgrid_cuda.encode(f, pts, two)
