"""Times of the encode kernels alone, on one GPU, at a chosen batch shape.

For each kernel pair asked for (K1/K2 flagship, K3/K4 flagship unsnapped,
K5/K6 `fast`, K7/K8 flagship unsnapped ladder, K9/K10 the split path's
flagship plane level (128, 64, 4); `K1q`, `K3q` and `K9q` the same kernels
at the `quality` preset: 256 x 64 with the (128, 128, 8) plane level,
folded, unsnapped and on the split path), in bf16 unless --dtype says
otherwise: the forward kernel's residuals feed the backward kernel, and each
is timed with CUDA events around single launches (median and minimum of
--reps, after a warm-up); `host_us` is the median time a call takes to
return on the host (the wrapper's work and the enqueue), which the device
time leaves out (a sleep kernel holds the card while the call is queued).
Only the wrappers of `ops.mxgrid_cuda` are called,
so the script also runs against another checkout of the package:

  python3 romap_tpu_torch/tools/time_encode.py --objects 10
  python3 romap_tpu_torch/tools/time_encode.py --roots build/parent,.,.,build/parent

`--forward-variant` and `--backward-variant` force a variant (K1/K5: direct,
staged; K3/K7: per_axis, three_axis_direct, three_axis_staged, channel_split; K2/K6 and
K4/K8 and K10: scalar, tensor_core; K4/K8 in fp32: scalar, tensor_core_split)
that the spec and dtype would not pick, to time both on one card. K10 takes
the plane block of the full encode cotangent as a strided view, as the split step passes it (a checkout from
before `planes_variant` takes a contiguous block, as its step copied it).
K3's and K7's times include the product pass their per-axis variant needs.
`--points-kind rays` draws the points
along rays through the unit cube, 32 consecutive samples a ray, as the train
step's batches lie (its samples of a ray meet on the same table rows);
`uniform` (the default) draws them independently.
`--roots` runs the script once per listed checkout, in that order, each in a
process of its own that imports `romap_tpu_torch` from that checkout (and
builds its kernels there): the way to compare two versions on one card in
one run. `--sass` prints, for each kernel of the built library, how its
shared and global atomics were compiled (counts of ATOMS.*, ATOMG.*, RED.*
opcodes in `cuobjdump -sass`). Needs a CUDA device; prints the card's name
and power limit first and one JSON line per run last.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

SLEEP_CYCLES = 2_000_000  # ~1.1 ms at the H100's 1.755 GHz: longer than a call's host work
PAIRS = {"K1": ("folded", "K1", "K2"), "K3": ("unsnapped", "K3", "K4"),
         "K5": ("folded_cp", "K5", "K6"), "K7": ("unsnapped_cp", "K7", "K8"),
         "K9": ("unsnapped_split", "K9", "K10"), "K1q": ("quality", "K1", "K2"),
         "K3q": ("quality_unsnapped", "K3", "K4"), "K9q": ("quality_split", "K9", "K10")}


def run_roots(args) -> None:
    """One child process per root; each prints its own lines."""
    for root in args.roots.split(","):
        root = os.path.abspath(root)
        cmd = [sys.executable, os.path.abspath(__file__), "--objects", str(args.objects),
               "--points", str(args.points), "--pairs", args.pairs, "--dtype", args.dtype,
               "--reps", str(args.reps)] + (["--sass"] if args.sass else [])
        theirs = os.path.join(root, "romap_tpu_torch", "tools", "time_encode.py")
        if os.path.exists(theirs):
            # a checkout that has this script knows the kernels' variants
            cmd += ["--forward-variant", args.forward_variant,
                    "--backward-variant", args.backward_variant]
            if "--points-kind" in open(theirs).read():
                cmd += ["--points-kind", args.points_kind]
        env = dict(os.environ, PYTHONPATH=root)
        print(f"== root {root}", flush=True)
        subprocess.run(cmd, env=env, cwd=root, check=True)


def sass_atomics(lib) -> dict:
    """{kernel function: {opcode: count}} of the atomics in the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED)(?:\.[A-Z0-9_]+)*)", line)
        if m and fn:
            out.setdefault(fn, collections.Counter())[m.group(1)] += 1
    return {k: dict(v) for k, v in out.items()}


def ray_points(torch, g, o: int, p: int, per_ray: int = 32):
    """[o, p, 3] points: p // per_ray rays through the unit cube (the chord
    through two uniform points of it, from face to face), per_ray jittered
    samples along each, consecutive in memory."""
    n = p // per_ray
    a, b = torch.rand((2, o, n, 1, 3), generator=g)
    d = b - a
    d = torch.where(d.abs() < 1e-6, torch.full_like(d, 1e-6), d)
    t0, t1 = (0 - a) / d, (1 - a) / d
    near = torch.minimum(t0, t1).amax(-1, keepdim=True)
    far = torch.maximum(t0, t1).amin(-1, keepdim=True)
    u = (torch.arange(per_ray).view(1, 1, per_ray, 1)
         + torch.rand((o, n, per_ray, 1), generator=g)) / per_ray
    pts = (a + (near + (far - near) * u) * d).reshape(o, n * per_ray, 3)
    fill = torch.rand((o, p - n * per_ray, 3), generator=g)
    return torch.cat([pts, fill], dim=1).contiguous()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=10)
    ap.add_argument("--points", type=int, default=4096 * 32)
    ap.add_argument("--pairs", default="K1", help="comma list of K1, K3, K5, K7, K9, K1q, K3q, K9q")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--forward-variant", default="auto",
                    choices=("auto", "direct", "staged", "per_axis", "three_axis_direct",
                             "three_axis_staged", "channel_split"),
                    help="force K1/K5's (direct, staged) or K3/K7's variant instead of "
                         "mxgrid_cuda.forward_variant / unsnapped_forward_variant")
    ap.add_argument("--backward-variant", default="auto",
                    choices=("auto", "scalar", "tensor_core", "tensor_core_split"),
                    help="force K2/K6's, K4/K8's and K10's variant instead of the choice "
                         "of mxgrid_cuda.folded_variant / unsnapped_variant / planes_variant")
    ap.add_argument("--points-kind", default="uniform", choices=("uniform", "rays"))
    ap.add_argument("--roots", default=None)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if args.roots:
        return run_roots(args)

    import torch

    # run by path, the repo root is not on sys.path; a root on PYTHONPATH wins
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from romap_tpu_torch.config import EncodingConfig, NerfConfig
    from romap_tpu_torch.models import nerf
    from romap_tpu_torch.ops import mxgrid, mxgrid_cuda

    if not torch.cuda.is_available():
        raise SystemExit("time_encode: no CUDA device")
    strided_g = hasattr(mxgrid_cuda, "planes_variant")  # K10 reads the cotangent in place
    if args.forward_variant in ("direct", "staged"):
        mxgrid_cuda.forward_variant = lambda *a, **k: args.forward_variant
    elif args.forward_variant != "auto":
        mxgrid_cuda.unsnapped_forward_variant = lambda *a, **k: args.forward_variant
    if args.backward_variant != "auto":
        mxgrid_cuda.folded_variant = lambda *a, **k: args.backward_variant
        mxgrid_cuda.unsnapped_variant = lambda *a, **k: args.backward_variant
        mxgrid_cuda.planes_variant = lambda *a, **k: args.backward_variant
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dtype = getattr(torch, args.dtype)
    o, p, dev = args.objects, args.points, "cuda"
    flagship, fast = EncodingConfig(), EncodingConfig.preset("fast")
    quality = EncodingConfig.preset("quality")
    unsnap = lambda e: dataclasses.replace(e, mx_snap_levels=False)
    cp_only = lambda e: dataclasses.replace(e, mx_plane_features=0)
    encodings = {"folded": flagship, "unsnapped": unsnap(flagship), "folded_cp": fast,
                 "unsnapped_cp": unsnap(cp_only(flagship)), "unsnapped_split": unsnap(flagship),
                 "quality": quality, "quality_unsnapped": unsnap(quality),
                 "quality_split": unsnap(quality)}

    def ms(fn):
        """(median, min) device ms of one call, and the median host us the
        call took to return (the wrapper's work and the enqueue alone). A
        sleep kernel holds the card while the host queues the events and the
        call, so the events time the device alone: without it, a call whose
        host work outlasts nothing on the card would count that work too."""
        fn()
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(args.reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            t0 = time.perf_counter()
            fn()
            host.append(1e6 * (time.perf_counter() - t0))
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times), min(times), statistics.median(host)

    results = {}
    for pair in args.pairs.split(","):
        path, kf, kb = PAIRS[pair]
        tag = pair[len(kf):]  # "q": the pair at the `quality` preset
        spec = nerf.make_field_spec(NerfConfig(encoding=encodings[path]))
        g = torch.Generator().manual_seed(3)
        if args.points_kind == "rays":
            pts = ray_points(torch, g, o, p).to(dev)
        else:
            pts = (torch.rand((o, p, 3), generator=g) * (1 + 4e-3) - 2e-3).to(dev)
        tables = mxgrid.init_mxgrid(g, spec, o)
        lines = tables["lines"] if spec.plane_specs else tables
        to = lambda t: t.to(device=dev, dtype=dtype).contiguous()
        if kf == "K9":
            tabs = [tuple(map(to, tables["planes"])), tuple(map(to, tables["plane_lines"]))]
        else:
            tabs = [to(mxgrid.fold_lines(lines, spec) if spec.snap_levels else lines)]
            if spec.plane_specs:
                tabs += [to(tables["planes"][0]), to(tables["plane_lines"][0])]
        gout = to(torch.randn((o, p, spec.n_output_dims), generator=g))
        if kf == "K9":  # the plane block of the cotangent
            gout = gout[..., spec.features:]
            gout = gout if strided_g else gout.contiguous()
        fwd, bwd = mxgrid_cuda.KERNELS[kf], mxgrid_cuda.KERNELS[kb]
        got = fwd(pts, *tabs, spec)
        res = (got,) if torch.is_tensor(got) else got[1:]  # K7 of an older checkout: afac
        if kf == "K9" and len(got) == 2:  # K9 of an older checkout: fpl, fli
            res = got
        results[kf + tag] = ms(lambda: fwd(pts, *tabs, spec))
        results[kb + tag] = ms(lambda: bwd(pts, *res, gout, spec))
        for k in (kf + tag, kb + tag):
            print(f"[time_encode] kernel={k} spec={path} dtype={args.dtype} O={o} P={p} "
                  f"points={args.points_kind} "
                  f"forward_variant={args.forward_variant} "
                  f"backward_variant={args.backward_variant} "
                  f"median_ms={results[k][0]:.4f} min_ms={results[k][1]:.4f} "
                  f"host_us={results[k][2]:.1f}", flush=True)
        del got, res, gout, tabs, pts
        torch.cuda.empty_cache()
    out = dict(device=torch.cuda.get_device_name(0), smi=smi, objects=o, points=p,
               dtype=args.dtype, points_kind=args.points_kind, root=os.getcwd(),
               ms={k: dict(median=v[0], min=v[1], host_us=v[2]) for k, v in results.items()})
    if args.sass:
        out["sass_atomics"] = sass_atomics(mxgrid_cuda.build_library())
        for fn, ops in out["sass_atomics"].items():
            print(f"[sass] {fn[:100]} {ops}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
