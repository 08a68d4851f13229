"""Device time of K0 (the points gradient) in each of its variants, in turns.

At one view's refinement points (pose_refine's 4 starts x 1536 pixels x 32
samples = 196,608 points, one object), on the paths of --paths: by default
the two refinement runs, the flagship folded spec (K1's residuals, `[9b]`)
and the split path's unsnapped ladder with its plane level (K7's and K9's
residuals, `[9]`); `quality` is the `quality` preset folded (K1's
residuals); in the dtypes of --dtypes, by default fp32 (as refinement
runs) and bf16. The points are `uniform` in the cube
(as chip_smoke's K0 check draws them) or along `rays` (32 consecutive
samples a ray, as refinement's batches lie: a ray's samples meet on the
same table rows). Each variant of `mxgrid_cuda.POINTS_VARIANTS` is forced
in turn, in the order given and then reversed, checked against the plain
twin and timed (median of 7 device times behind a sleep kernel,
`chip_smoke.median_ms`), beside K0's bound (`chip_smoke.points_work`).

  python3 -m romap_tpu_torch.tools.time_points [--kinds uniform,rays]
  python3 -m romap_tpu_torch.tools.time_points --paths quality --dtypes float32 \
      --variants per_point     (`quality` in fp32: lanes_over_channels does not fit)

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
from torch.utils import _pytree as pytree

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from romap_tpu_torch.ops import mxgrid, mxgrid_cuda  # noqa: E402
from romap_tpu_torch.tools.time_encode import ray_points  # noqa: E402


def k0_args(spec, dtype, kind, dev):
    """K0's arguments from the forward kernels of the spec's path (folded: K1;
    unsnapped: K7 and K9) at one view's points."""
    g = torch.Generator(device="cpu").manual_seed(7)
    if kind == "uniform":
        pts = torch.rand((1, cs.REFINE_P, 3), generator=g) * (1 + 4e-3) - 2e-3
    else:
        pts = ray_points(torch, g, 1, cs.REFINE_P)
    pts = pts.to(dev)
    f = pytree.tree_map(lambda a: a.to(dev, dtype), mxgrid.init_mxgrid(g, spec, 1))
    gout = torch.randn((1, cs.REFINE_P, spec.n_output_dims), generator=g).to(dev, dtype)
    table = (mxgrid.fold_lines(f["lines"], spec) if spec.snap_levels else f["lines"]).contiguous()
    planes, plines = tuple(f["planes"]), tuple(f["plane_lines"])
    if spec.snap_levels:
        _, afac, fpl, fli = mxgrid_cuda.folded_fused_forward(pts, table, planes[0], plines[0],
                                                             spec)
    else:
        _, afac = mxgrid_cuda.unsnapped_cp_forward(pts, table, spec)
        _, fpl, fli = mxgrid_cuda.planes_forward(pts, planes, plines, spec)
    return pts, table, afac, planes, plines, fpl, fli, gout, spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", default="uniform,rays")
    ap.add_argument("--variants", default=",".join(mxgrid_cuda.POINTS_VARIANTS))
    ap.add_argument("--paths", default="folded,unsnapped_split",
                    help="comma list of folded, unsnapped_split, quality")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args(argv)
    cs.phase_device()
    specs = cs.kernel_specs()
    order = args.variants.split(",")
    order += order[::-1]
    for kind in args.kinds.split(","):
        for path in args.paths.split(","):
            spec = specs[path]
            for dtype in (getattr(torch, d) for d in args.dtypes.split(",")):
                with cs.environ(MX_FUSED="0" if path.endswith("split") else "1"):
                    k0 = k0_args(spec, dtype, kind, "cuda")
                    want = mxgrid_cuda.points_gradient_plain(*k0)
                    times, errs = {}, {}
                    for v in order:
                        with cs.forced("points_variant", v):
                            errs[v] = cs.errors([mxgrid_cuda.points_gradient(*k0)], [want])[1]
                            times.setdefault(v, []).append(
                                cs.median_ms(lambda: mxgrid_cuda.points_gradient(*k0)))
                nbytes, ops = cs.points_work(spec, dtype, 1, cs.REFINE_P)
                bound = 1e3 * max(nbytes / cs.PEAK_BYTES_PER_S, ops / cs.PEAK_FP32_PER_S)
                cs.say("K0", points=kind, spec=path, shape=f"1x{cs.REFINE_P}",
                       dtype=str(dtype).split(".")[1], bound_ms=f"{bound:.4f}",
                       **{f"{v}_ms": [f"{t:.4f}" for t in ts] for v, ts in times.items()},
                       **{f"{v}_max_rel_err": f"{e:.2e}" for v, e in errs.items()})
                if max(errs.values()) > cs.REL_TOL[dtype]:
                    raise AssertionError(f"K0 {kind} {path} {dtype}: errors {errs}")
                del k0, want
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
