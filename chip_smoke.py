"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version at the shapes of its path, then
drives the main paths through the port's public entry points: a 10-object
train wave with held-out renders, the offline runner with the CP-only
`fast` preset, the offline CLI with the unsnapped ladder, the online
socket server on the split kernels with a pose-refined test render, pose
refinement of perturbed views against a converged field, a hash-grid
(`tcnn`) train wave, the flagship-parity quality gate at its full
budget (3 seeds x 5000 steps), the `quality` preset's train waves,
folded and unsnapped, and fp32 train waves of the unsnapped and split paths.

Usage: python3 chip_smoke.py     (needs one CUDA device; exits non-zero on
any failure and prints no result line then)

Phases, one or more lines each, each closed by its seconds:
  1 device     card name and power limit (nvidia-smi), TF32 switched off
  2 build      nvcc build of romap_tpu_torch/csrc into build/romap_tpu_torch
  3 kernels    K1/K2 (flagship), K3/K4 (flagship unsnapped), K5/K6 (`fast`),
               K7/K8 (`fast` unsnapped, then flagship unsnapped as phase 9
               runs them) and K9/K10 (the flagship plane level on the split
               path, then `quality`'s (128, 128, 8); K10 reads the plane
               block of the full cotangent in place), K1/K2 and K3/K4 at
               the `quality` preset (256 x 64, (128, 128, 8)) vs their
               plain versions, and each backward
               vs autograd through its forward's plain version, O=2 x
               P=131072, bf16 and fp32, then K1/K2, K3/K4 and K7/K8 (and
               `quality`'s K1/K2 and K3/K4) in bf16 at O=10 x P=131072, the
               shape their train steps launch them at: max abs / relative error beside the tolerance, the median
               kernel and plain times, the bound (the least time the card
               could take: bytes over its memory rate or operations over its
               peak, the larger), the peak memory of the check and, where a
               kernel has variants, the one the spec and dtype select (the
               flagship and `fast` bf16 backwards, folded and unsnapped,
               and K10 at the flagship and `quality` plane levels must take
               the tensor cores, `quality`'s K2 and K4 too; the bf16
               unsnapped forwards the three-axis kernel, the fp32 ones
               channel_split; the fp32 K4/K8 the tensor cores on operands
               split into bf16 hi and lo parts, tensor_core_split); K3/K4
               (flagship and `quality`), K7/K8 and K9/K10 also in fp32 at
               O=10; `quality`'s bf16 K2 and K4, and the fp32 K4 (flagship,
               `quality`) and K8 at O=10 beside their bound, the scalar
               kernel (forced) timed in turns with them and its sums held to
               theirs; K9 and K10 beside
               their library yardstick (F.grid_sample's plane and line
               calls, and their backward); then K3 and
               K7 in the per-axis design with its product pass (forced) and
               in the selected variant, in turns: bf16 at O=10 (and each
               product pass alone), fp32 (channel_split, held against the
               plain twin) at O=10, O=2 and one view's refinement points;
               then K0 (the points gradient) at one view's refinement points
               (1 x 4 x 1536 x 32) on the folded and split paths, bf16 and
               fp32, against its plain twin and (fp32) autograd over the
               points through the plain encode, lanes_over_channels and the
               first design (per_point, forced) timed in turns
  4 parity     one tiny train step, fp32, kernels on the card vs the plain
               path on the CPU, from the same state and uniforms
  5 train      build_synthetic_world(10, 16, 128) + NerfConfig(): init, 1
               step, then a timed 50-step wave (obj-iters/s; host_enqueue_s is
               the part of wave_s the host needed to queue the launches)
  6 render     one held-out bbox view per object through render_rays (fp32):
               PSNR on object pixels and mask IoU; launch counts of K1/K2
               over phases 5-6
  7 offline    the same scene written as a dataset; OfflineRunner with the
               `fast` preset, 2 waves x 25 steps (cut from 10 x 500), a mesh
               at wave 2 (mc 64), then every artifact with the orbit video:
               losses, obj-iters/s, mesh sizes, test_img PSNR, K5/K6 counts
  8 unsnapped  `romap_tpu_torch.runtime.offline.main` with MX_SNAP=0 on that
               dataset, flagship, 1 wave x 20 steps, no video: K3 (bf16 in
               training, fp32 in render and mesh) and K4 counts; no product
               pass (fp32 K3 is channel_split)
  9 online     `romap_tpu_torch.runtime.server.main` on a thread with
               MX_FUSED=0 MX_SNAP=0 (flagship width: K7 + K9 forward, K8 +
               K10 backward) and a client speaking its wire protocol: the
               same 16 frames, a NeRF per object past 10 bboxes, 25-step
               waves (cut from 500), a volume update, the background pump,
               WAIT_END (final retrain), losses, meshes, one test render
               with pixel crops (the reply, and the `pose refine` line the
               server prints; the refinement runs K7 + K9 forward and K0):
               waves, wave seconds, online obj-iters/s, K0 and K7-K10
               counts, product passes (none: fp32 K7 is channel_split)
 9b refine    pose refinement against a converged field: one object trained
               400 steps at the flagship width (as the reference's
               tests/test_pose_refine.py), two views moved by a known SE(3)
               delta, refined at the reference's 4 starts x 300 steps x 1536
               pixels x 32 samples through K1 and K0: losses, pose errors
               before and after, seconds, launches
 10 tcnn      EncodingConfig.preset("tcnn") (hash grid) on the scene of
               phase 5: 1 + 20 steps of train_objects, obj-iters/s, the
               losses falling, peak memory
 11 quality   romap_tpu_torch.tools.quality_gate (scripts/quality_gate.py's
               gate): the bf16 flagship trained 5000 steps (K1/K2) on
               build_synthetic_world(1, 24, 192, seed) for seeds 0-2, the
               held-out middle frame's PSNR on object pixels (K1 fp32); the
               3-seed mean must be within 0.5 dB of the hash-grid anchors'
               mean (QUALITY.json): per-seed PSNR beside the JAX flagship's
               and the anchor's, seconds, K1/K2 launches; the record goes to
               build/quality_torch.json
 12 quality   EncodingConfig.preset("quality") on the scene of phase 5,
               bf16: 1 step and a timed 50-step wave folded (K1/K2, K2 on
               the tensor cores), obj-iters/s, host_enqueue_s, peak memory,
               losses falling on every active slot, launches by dtype, one
               held-out view per object (K1 fp32: PSNR and mask IoU); then
               MX_SNAP=0, 1 + 20 steps (K3/K4, K4 on the tensor cores)
 13 fp32      TrainConfig(compute_dtype="float32") at the flagship width on
               the scene of phase 5, 1 + 20 steps with MX_SNAP=0 (K3/K4) and
               with MX_FUSED=0 MX_SNAP=0 (K7-K10): losses falling, step ms,
               host enqueue ms, launches by dtype and, for the backwards, by
               variant: K4 / K8 once a step as tensor_core_split, never
               scalar
then the total seconds, a JSON line with each kernel's record, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import cv2
import numpy as np
import torch
from torch.utils import _pytree as pytree

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from romap_tpu_torch.config import EncodingConfig, NerfConfig, TrainConfig  # noqa: E402
from romap_tpu_torch.data import synthetic  # noqa: E402
from romap_tpu_torch.data.formats import write_dataset  # noqa: E402
from romap_tpu_torch.data.world import build_synthetic_world  # noqa: E402
from romap_tpu_torch.models import nerf  # noqa: E402
from romap_tpu_torch.ops import mxgrid, mxgrid_cuda  # noqa: E402
from romap_tpu_torch.ops.geometry import camera_rays, ray_aabb_intersect  # noqa: E402
from romap_tpu_torch.runtime import offline, pose_refine, server  # noqa: E402
from romap_tpu_torch.runtime.offline import OfflineRunner  # noqa: E402
from romap_tpu_torch.tools import quality_gate  # noqa: E402

N_OBJECTS, WAVE = 10, 50
KERNEL_O, KERNEL_P = 2, 4096 * 32
# Kernel vs plain: fp32 differs only in summation order (and K2's atomic
# order), bf16 additionally by one rounding step of a stored value; the
# tensor-core backward also rounds its two operands (`hat`, u) to bf16,
# 2^-9 a term and unbiased, which the sums in fp32 average out.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
CSRC = "romap_tpu_torch/csrc/"
FOLDED, UNSNAPPED, PLANES, POINTS = (CSRC + f for f in (
    "mxgrid_folded.cu", "mxgrid_unsnapped.cu", "mxgrid_planes.cu", "mxgrid_points.cu"))
SOURCES = {"K0": POINTS, "K1": FOLDED, "K2": FOLDED, "K3": UNSNAPPED, "K4": UNSNAPPED,
           "K5": FOLDED, "K6": FOLDED, "K7": UNSNAPPED, "K8": UNSNAPPED, "K9": PLANES,
           "K10": PLANES}
PALLAS = "romap_tpu/ops/mxgrid_pallas.py"
# line of each Pallas kernel's factory (or kernel function); K0 has none: it
# replaces the autodiff over the points of the reference's XLA encode
REPLACES = {"K0": "romap_tpu/ops/mxgrid.py:242", **{
    k: f"{PALLAS}:{line}" for k, line in {
        "K1": 448, "K2": 468, "K3": 281, "K4": 352, "K5": 583, "K6": 591, "K7": 205,
        "K8": 255, "K9": 268, "K10": 622}.items()}}
# The card's published peaks (NVIDIA H100 SXM data sheet, at a 700 W limit):
# HBM bytes per second, and fp32 operations per second outside the tensor
# cores. The bound counts the operations the function needs (a two-tap lerp
# or scatter per axis), which are fp32 whatever a kernel does with them: the
# tensor-core backward multiplies 93 % zeros on top of them.
PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
ONLINE_ITERS = 25  # steps per online wave (the reference's 500, cut)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


SLEEP_CYCLES = 2_000_000  # ~1.1 ms at 1.755 GHz: longer than a call's host work


def median_ms(fn, reps: int = 7) -> float:
    """Median device time of one call, CUDA events around each, after a
    warm-up. A sleep kernel holds the card while the host queues the events
    and the call, so a call's host work (60-200 us for a kernel wrapper) is
    not counted as device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def errors(got, want):
    """(max abs error, max abs error / max |want|) over paired tensors."""
    abs_err, rel_err = 0.0, 0.0
    for g, w in zip(got, want):
        e = float((g.float() - w.float()).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(float(w.float().abs().max()), 1e-30))
    return abs_err, rel_err


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("1 device", name=json.dumps(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = mxgrid_cuda.build_library()
    mxgrid_cuda._library()
    dt = time.perf_counter() - t0
    log = lib.with_suffix(".so.log").read_text() if lib.with_suffix(".so.log").exists() else ""
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip(), flush=True)
    say("2 build", seconds=f"{dt:.3f}", lib=os.path.relpath(lib))


# (spec of kernel_specs(), forward kernel, backward kernel, objects, dtypes),
# each pair at the spec its path in chip_smoke runs. K7/K8 run twice: at the
# `fast` ladder unsnapped (580 rows x K = 64, their largest shared-memory
# tables) and at the flagship unsnapped ladder that phase 9 runs (465 rows x
# K = 48); K1/K2, K3/K4 and K7/K8 also at their train steps' O=10, in bf16
# (there the plain twins hold dense [10, 131072, 465] fp32 bases, 2.4 GB an
# axis); the `quality` preset's K1/K2 and K3/K4 at O=2 and at the O=10 of
# `[12]`'s train step (580-row ladder x K = 64: 3.0 GB an axis; K3/K4 in
# fp32 too). A kernel's record in the JSON line is its last bf16 check here:
# its main path's; the `quality` checks go into the record's "quality"
# entry, K4's and K8's fp32 checks at O=10 into its "fp32" entry.
BOTH = (torch.bfloat16, torch.float32)
CHECKS = (
    ("folded", "K1", "K2", KERNEL_O, BOTH),
    ("folded", "K1", "K2", N_OBJECTS, (torch.bfloat16,)),
    ("unsnapped", "K3", "K4", KERNEL_O, BOTH),
    ("folded_cp", "K5", "K6", KERNEL_O, BOTH),
    ("unsnapped_cp", "K7", "K8", KERNEL_O, BOTH),
    ("unsnapped_split", "K7", "K8", KERNEL_O, BOTH),
    ("unsnapped_split", "K9", "K10", KERNEL_O, BOTH),
    ("quality_split", "K9", "K10", KERNEL_O, BOTH),
    ("quality", "K1", "K2", KERNEL_O, BOTH),
    ("quality_unsnapped", "K3", "K4", KERNEL_O, BOTH),
    ("quality", "K1", "K2", N_OBJECTS, (torch.bfloat16,)),
    ("quality_unsnapped", "K3", "K4", N_OBJECTS, (torch.float32, torch.bfloat16)),
    ("unsnapped", "K3", "K4", N_OBJECTS, (torch.float32, torch.bfloat16)),
    ("unsnapped_split", "K7", "K8", N_OBJECTS, (torch.float32, torch.bfloat16)),
    ("unsnapped_split", "K9", "K10", N_OBJECTS, (torch.float32, torch.bfloat16)),
)
FUSED = ("K1", "K3")  # forward kernels that also take the plane level
PRODUCTS = ("K1", "K3", "K9")  # ... and those that write the plane features


def kernel_inputs(spec, dtype, dev, seed, kf, o, p=KERNEL_P):
    """Points (edges included), the forward kernel `kf`'s table arguments in
    `dtype` (folded W_eff or raw ladder lines, then for K1/K3 the planes and
    plane lines; for K9 the tuples of planes and of plane lines) and a
    cotangent of its encode block, at `o` objects x `p` points (for K9 the
    plane block of a full encode cotangent, as a view: K10 reads it so on
    the split step)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    pts = torch.rand((o, p, 3), generator=g) * (1 + 4e-3) - 2e-3  # edges included
    tables = mxgrid.init_mxgrid(g, spec, o)
    if kf == "K9":
        args, cols = [tuple(tables["planes"]), tuple(tables["plane_lines"])], spec.n_output_dims
    else:
        lines = tables["lines"] if spec.plane_specs else tables
        args = [mxgrid.fold_lines(lines, spec) if spec.snap_levels else lines]
        cols = spec.features
        if kf in FUSED:
            args += [tables["planes"][0], tables["plane_lines"][0]]
            cols = spec.n_output_dims
    gout = torch.randn((o, p, cols), generator=g)
    to = lambda t: t.to(device=dev, dtype=dtype).contiguous()
    gout = to(gout)[..., spec.features:] if kf == "K9" else to(gout)
    return pts.to(dev), pytree.tree_map(to, args), gout


def work(kernel, spec, dtype, o, p):
    """(bytes, fp32 operations) of one call of `kernel`'s function on O x P
    points: each input read once and each output written once; a multiply
    and an add count as two operations (two per tap of a lerp, twelve per
    plane pair and channel forward, a thirteenth where the kernel writes
    their product, eighteen backward)."""
    t = torch.tensor([], dtype=dtype).element_size()
    k, kpl, n = spec.features, spec.plane_out_dims, o * p
    folded = kernel in ("K1", "K2", "K5", "K6")
    taps = 2 if folded else 2 * len(spec.resolutions)
    cp = kernel not in ("K9", "K10")
    pl = kernel in ("K1", "K2", "K3", "K4", "K9", "K10")
    cp_tab = 3 * (spec.fold_res[1] if folded else spec.total_res) * k if cp else 0
    pl_tab = sum(3 * (ru * rv + max(ru, rv)) * kp for ru, rv, kp in spec.plane_specs) if pl else 0
    pts = 12 * n
    if kernel in ("K1", "K3", "K5", "K7", "K9"):
        out_cols = (k if kernel in ("K1", "K3", "K5") else 0) + (kpl if kernel in PRODUCTS else 0)
        res_cols = (3 * k if cp else 0) + (2 * kpl if pl else 0)
        nbytes = pts + o * t * (cp_tab + pl_tab) + n * t * (out_cols + res_cols)
        ops = ((6 * k * taps if cp else 0) + (2 * k if kernel in ("K1", "K3", "K5") else 0)
               + (kpl * (12 + (kernel in PRODUCTS)) if pl else 0))
    else:
        in_cols = (4 * k if cp else 0) + (3 * kpl if pl else 0)  # residuals + cotangent
        nbytes = pts + n * t * in_cols + o * 4 * (cp_tab + pl_tab)
        ops = (k * (6 + 6 * taps) if cp else 0) + (18 * kpl if pl else 0)
    return nbytes, ops * n


def bound(kernel, spec, dtype, o, p=KERNEL_P):
    """(least ms the card could take for the call, "bytes" or "operations")."""
    nbytes, ops = work(kernel, spec, dtype, o, p)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def variants(kf, spec, dtype) -> tuple[dict, dict]:
    """The `variant=` field of a forward kernel's line and of its backward's:
    what the spec and dtype select (K5/K6 and K7/K8 never take planes; the
    unsnapped forwards have one variant)."""
    if kf in ("K1", "K5"):
        planes = kf == "K1"
        return (dict(variant=mxgrid_cuda.forward_variant(spec, dtype, planes)),
                dict(variant=mxgrid_cuda.folded_variant(spec, dtype, planes)))
    if kf in ("K3", "K7"):
        planes = kf == "K3"
        return (dict(variant=mxgrid_cuda.unsnapped_forward_variant(spec, dtype, planes)),
                dict(variant=mxgrid_cuda.unsnapped_variant(spec, dtype, planes)))
    return dict(variant=None), dict(variant=mxgrid_cuda.planes_variant(spec, dtype))


def grid_sample_planes(pts, planes, plines, gout, fpl, fli, spec):
    """The library yardstick of K9 and K10 (one plane level): closures that
    compute K9's plane and line samples with two F.grid_sample calls
    (bilinear, zeros padding, align_corners=True: coordinate 2x - 1 lands
    on knot x (r - 1), and knots outside [0, r - 1] drop out, as in
    `tent_taps`), and K10's two scatters with their backward
    (aten.grid_sampler_2d_backward) on the cotangents g f_li and g f_pl.
    The tables are passed as views in grid_sample's [N, C, H, W] order, no
    copy; the sampling grids (one dtype with the table, as grid_sample
    requires: bf16 coordinates in bf16) and the cotangents are formed
    before, outside the timed calls."""
    (ru, rv, kp), = spec.plane_specs
    o, p = pts.shape[:2]
    dt = planes[0].dtype
    u, v, w = (list(a) for a in zip(*spec.plane_axes))
    c = 2 * pts - 1
    grid_pl = torch.stack([c[..., v], c[..., u]], -1).transpose(1, 2).reshape(o * 3, 1, p, 2)
    grid_li = torch.stack([c[..., w], torch.zeros_like(c[..., w])], -1).transpose(1, 2)
    grid_pl = grid_pl.to(dt).contiguous()
    grid_li = grid_li.reshape(o * 3, 1, p, 2).to(dt).contiguous()
    inp_pl = planes[0].reshape(o * 3, ru, rv, kp).permute(0, 3, 1, 2)
    inp_li = plines[0].reshape(o * 3, 1, max(ru, rv), kp).permute(0, 3, 1, 2)
    gt = gout.transpose(1, 2).float()
    g_pl = (gt * fli.float()).to(dt).reshape(o * 3, kp, 1, p)
    g_li = (gt * fpl.float()).to(dt).reshape(o * 3, kp, 1, p)
    kw = dict(mode="bilinear", padding_mode="zeros", align_corners=True)
    bwd = torch.ops.aten.grid_sampler_2d_backward

    def forward():
        return (torch.nn.functional.grid_sample(inp_pl, grid_pl, **kw),
                torch.nn.functional.grid_sample(inp_li, grid_li, **kw))

    def backward():
        return (bwd(g_pl, inp_pl, grid_pl, 0, 0, True, [True, False])[0],
                bwd(g_li, inp_li, grid_li, 0, 0, True, [True, False])[0])

    return forward, backward


def phase_kernels(specs: dict, dev) -> dict:
    """Each forward kernel vs its plain twin, and each backward kernel vs
    its plain twin and vs autograd through the forward twin, on the
    kernels' own residuals; bf16 and fp32. Returns the bf16 (train dtype)
    records for the JSON line."""
    # the train paths' backward is on the tensor cores
    chosen = {path: mxgrid_cuda.folded_variant(specs[path], torch.bfloat16)
              for path in ("folded", "folded_cp", "quality")}
    chosen.update({path: mxgrid_cuda.unsnapped_variant(specs[path], torch.bfloat16, planes)
                   for path, planes in (("unsnapped", True), ("unsnapped_cp", False),
                                        ("unsnapped_split", False), ("quality_unsnapped", True))})
    chosen.update({f"{path} K10": mxgrid_cuda.planes_variant(specs[path], torch.bfloat16)
                   for path in ("unsnapped_split", "quality_split")})
    if set(chosen.values()) != {"tensor_core"}:
        raise AssertionError(f"bf16 backward variants: {chosen}")
    split = {path: mxgrid_cuda.unsnapped_variant(specs[path], torch.float32, planes)
             for path, planes in (("unsnapped", True), ("unsnapped_cp", False),
                                  ("unsnapped_split", False), ("quality_unsnapped", True))}
    if set(split.values()) != {"tensor_core_split"}:  # fp32 K4/K8 on the tensor cores
        raise AssertionError(f"fp32 K4/K8 variants: {split}")
    records, fp32, quality, fp32_bwd = {}, {}, {}, {}
    for path, kf, kb, o, dtypes in CHECKS:
        spec = specs[path]
        fwd, bwd = mxgrid_cuda.KERNELS[kf], mxgrid_cuda.KERNELS[kb]
        fwd_plain = getattr(mxgrid_cuda, fwd.__name__ + "_plain")
        bwd_plain = getattr(mxgrid_cuda, bwd.__name__ + "_plain")
        shape = f"{o}x{KERNEL_P}"
        plain_reps = 7 if o == KERNEL_O else 3
        for dtype in dtypes:
            tol, dname = REL_TOL[dtype], str(dtype).split(".")[1]
            f_var, b_var = variants(kf, spec, dtype)
            if kf in ("K3", "K7"):  # three axes a block where they fit, else channel slices
                want_var = "channel_split" if dtype == torch.float32 else "three_axis_staged"
                if path in ("unsnapped_cp", "quality_unsnapped"):  # tables too wide to stage rows
                    want_var = "channel_split" if dtype == torch.float32 else "three_axis_direct"
                if f_var["variant"] != want_var:
                    raise AssertionError(f"{kf} {path} {dtype}: variant {f_var}")
            torch.cuda.reset_peak_memory_stats()
            pts, args, gout = kernel_inputs(spec, dtype, dev, seed=3, kf=kf, o=o)
            got = fwd(pts, *args, spec)
            want = fwd_plain(pts, *args, spec)
            torch.cuda.synchronize()
            f_abs, f_rel = errors(pytree.tree_leaves(got), pytree.tree_leaves(want))
            f_ms = median_ms(lambda: fwd(pts, *args, spec))
            f_plain_ms = median_ms(lambda: fwd_plain(pts, *args, spec), plain_reps)
            f_bound, f_by = bound(kf, spec, dtype, o)
            say("3 kernels", kernel=kf, spec=path, shape=shape, dtype=dname,
                **{k: v for k, v in f_var.items() if v},
                max_abs_err=f"{f_abs:.3e}",
                max_rel_err=f"{f_rel:.3e}", rel_tol=tol, ms=f"{f_ms:.4f}",
                plain_ms=f"{f_plain_ms:.4f}", bound_ms=f"{f_bound:.4f}", bound_by=f_by)
            if not f_rel <= tol or not all(torch.isfinite(t.float()).all()
                                           for t in pytree.tree_leaves(got)):
                raise AssertionError(f"{kf} {dtype}: relative error {f_rel} above {tol}")

            res = got[1:]  # the backward kernel's residuals
            leaves, tree = pytree.tree_flatten(args)
            leaves = [a.clone().requires_grad_(True) for a in leaves]
            block = fwd_plain(pts, *pytree.tree_unflatten(leaves, tree), spec)[0]
            want_ad = torch.autograd.grad(block, leaves, grad_outputs=gout)
            del block, want
            got_b = pytree.tree_leaves(bwd(pts, *res, gout, spec))
            torch.cuda.synchronize()
            b_abs, b_rel = errors(got_b, want_ad)
            b_abs_p, b_rel_p = errors(got_b, pytree.tree_leaves(bwd_plain(pts, *res, gout, spec)))
            b_ms = median_ms(lambda: bwd(pts, *res, gout, spec))
            b_plain_ms = median_ms(lambda: bwd_plain(pts, *res, gout, spec), plain_reps)
            b_bound, b_by = bound(kb, spec, dtype, o)
            say("3 kernels", kernel=kb, spec=path, shape=shape, dtype=dname,
                **{k: v for k, v in b_var.items() if v},
                max_abs_err_vs_autograd=f"{b_abs:.3e}", max_rel_err_vs_autograd=f"{b_rel:.3e}",
                max_rel_err_vs_plain=f"{b_rel_p:.3e}", rel_tol=tol, ms=f"{b_ms:.4f}",
                plain_ms=f"{b_plain_ms:.4f}", bound_ms=f"{b_bound:.4f}", bound_by=b_by,
                peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
            if not (b_rel <= tol and b_rel_p <= tol):
                raise AssertionError(f"{kb} {dtype}: relative error {b_rel}/{b_rel_p} above {tol}")
            if kf == "K9":  # its features are its residuals' product, bit for bit
                if not torch.equal(got[0], mxgrid_cuda.plane_product(*got[1:])):
                    raise AssertionError(f"K9 {path} {dtype}: features != plane_product")
            lib_f_ms = lib_b_ms = None
            if kf == "K9" and o == N_OBJECTS:  # the library yardstick, timed only
                lib_fwd, lib_bwd = grid_sample_planes(pts, *args, gout, *res, spec)
                lib_out = lib_fwd()
                _, lib_rel = errors([t.reshape(r.shape) for t, r in zip(lib_out, res)],
                                          fwd_plain(pts, *args, spec)[1:])
                lib_f_ms, lib_b_ms = median_ms(lib_fwd), median_ms(lib_bwd)
                say("3 kernels", kernel="K9+K10 library", spec=path, shape=shape, dtype=dname,
                    call="F.grid_sample (plane, line) / aten.grid_sampler_2d_backward",
                    fwd_ms=f"{lib_f_ms:.4f}", bwd_ms=f"{lib_b_ms:.4f}",
                    fwd_max_rel_err_vs_plain=f"{lib_rel:.3e}",
                    kernel_ms=f"{f_ms:.4f} / {b_ms:.4f}")
                del lib_out
            if kf in ("K3", "K7") and dtype == torch.float32 and o == N_OBJECTS:
                if path != "quality_unsnapped":
                    fp32[kf] = dict(fp32_variant=f_var["variant"], fp32_ms=f_ms)
                fp32_bwd[(path, kb)] = dict(variant=b_var["variant"],
                                            max_abs_err=max(b_abs, b_abs_p), plain_ms=b_plain_ms)
            if dtype == torch.bfloat16 and path in ("quality", "quality_unsnapped"):
                rec = quality.setdefault(kb, dict(spec=path, variant=b_var["variant"]))
                if o == KERNEL_O:
                    rec.update(max_abs_err_o2=max(b_abs, b_abs_p), ms_o2=b_ms,
                               plain_ms_o2=b_plain_ms)
                else:  # the train step's shape: its errors and plain time
                    rec.update(max_abs_err=max(b_abs, b_abs_p), plain_ms=b_plain_ms)
            elif dtype == torch.bfloat16:
                # no single PyTorch call computes the CP functions (a K-channel
                # two-tap lerp per axis times a product, and its scatter
                # transpose): library_ms is null but for K9/K10 (grid_sample)
                records[kf] = dict(variant=f_var["variant"], max_abs_err=f_abs, ms=f_ms,
                                   plain_ms=f_plain_ms, bound_ms=f_bound, bound_by=f_by,
                                   library_ms=lib_f_ms)
                records[kb] = dict(variant=b_var["variant"], max_abs_err=max(b_abs, b_abs_p),
                                   ms=b_ms, plain_ms=b_plain_ms, bound_ms=b_bound,
                                   bound_by=b_by, library_ms=lib_b_ms)
            del got, got_b, want_ad, res, leaves, args, gout, pts
            torch.cuda.empty_cache()
    for kf, extra in fp32.items():  # the fp32 design beside the bf16 record
        records[kf].update(extra)
    for kb, rec in quality.items():  # `quality`'s check beside the main path's record
        records[kb]["quality"] = rec
    for (path, kb), rec in fp32_bwd.items():  # the fp32 K4/K8 beside the bf16 record
        (records[kb]["quality"] if path == "quality_unsnapped" else records[kb])["fp32"] = rec
    return records


@contextlib.contextmanager
def forced(selector: str, variant: str):
    """Run the kernels that `mxgrid_cuda.<selector>` picks a variant for
    (`unsnapped_forward_variant`: K3/K7; `points_variant`: K0;
    `folded_variant`: K2/K6; `unsnapped_variant`: K4/K8) in `variant`
    instead of the one the spec and dtype select."""
    chosen = getattr(mxgrid_cuda, selector)
    setattr(mxgrid_cuda, selector, lambda *a, **k: variant)
    try:
        yield
    finally:
        setattr(mxgrid_cuda, selector, chosen)


REFINE_P = (pose_refine.N_STARTS * pose_refine.N_PIXELS * pose_refine.N_SAMPLES)
# (objects, points) of the unsnapped forwards' timings in turns: the train
# step's, chip_smoke's kernel checks', and one view's refinement points
FORWARD_SHAPES = ((N_OBJECTS, KERNEL_P), (KERNEL_O, KERNEL_P), (1, REFINE_P))


def time_unsnapped_forwards(specs: dict, dev) -> None:
    """K3 (flagship unsnapped) and K7 (the split path's ladder): in bf16 at
    O=10 x 131072, the per-axis design with its product pass (forced) and
    the variant the spec selects, in turns (per_axis, new, new, per_axis),
    then each product pass alone: `cp_product_pass` (K3's second kernel)
    and `cp_product` (the PyTorch product after K7); in fp32 at
    FORWARD_SHAPES, the per-axis design with its pass against
    channel_split, in turns, the selected variant first held against the
    plain twin there (fp32 tolerance)."""
    for path, kf in (("unsnapped", "K3"), ("unsnapped_split", "K7")):
        spec = specs[path]
        fwd = mxgrid_cuda.KERNELS[kf]
        for dtype, shapes in ((torch.bfloat16, FORWARD_SHAPES[:1]), (torch.float32, FORWARD_SHAPES)):
            dname = str(dtype).split(".")[1]
            new = mxgrid_cuda.unsnapped_forward_variant(spec, dtype, planes=kf == "K3")
            want = "three_axis_staged" if dtype == torch.bfloat16 else "channel_split"
            if new != want:
                raise AssertionError(f"{kf} {path} {dname}: variant {new}, want {want}")
            for o, p in shapes:
                pts, args, _ = kernel_inputs(spec, dtype, dev, seed=3, kf=kf, o=o, p=p)
                extra = {}
                if dtype == torch.float32:
                    mxgrid_cuda.reset_launch_counts()
                    got = fwd(pts, *args, spec)
                    passes = sum(fn.launches for fn in mxgrid_cuda.PRODUCT_PASSES.values())
                    plain = getattr(mxgrid_cuda, fwd.__name__ + "_plain")
                    _, rel = errors(got, plain(pts, *args, spec))
                    extra = dict(max_rel_err=f"{rel:.3e}", rel_tol=REL_TOL[dtype])
                    if not rel <= REL_TOL[dtype] or passes:
                        raise AssertionError(f"{kf} fp32 {o}x{p}: error {rel}, passes {passes}")
                    del got
                times = {"per_axis": [], new: []}
                for variant in ("per_axis", new, new, "per_axis"):
                    with forced("unsnapped_forward_variant", variant):
                        times[variant].append(median_ms(lambda: fwd(pts, *args, spec)))
                if dtype == torch.bfloat16:
                    out, afac = fwd(pts, *args, spec)[:2]
                    if kf == "K3":
                        pass_ms = median_ms(lambda: mxgrid_cuda.cp_product_pass(afac, out))
                        extra["cp_product_pass_alone_ms"] = f"{pass_ms:.4f}"
                    else:
                        pass_ms = median_ms(lambda: mxgrid_cuda.cp_product(afac))
                        extra["cp_product_alone_ms"] = f"{pass_ms:.4f}"
                    del out, afac
                b_ms, b_by = bound(kf, spec, dtype, o, p)
                say("3 kernels", kernel=kf, spec=path, shape=f"{o}x{p}", dtype=dname,
                    per_axis_with_pass_ms=[f"{t:.4f}" for t in times["per_axis"]],
                    **{f"{new}_ms": [f"{t:.4f}" for t in times[new]]},
                    bound_ms=f"{b_ms:.4f}", bound_by=b_by, **extra)
                del pts, args
                torch.cuda.empty_cache()


# (path, forward, backward, selector, dtype, the record's entry) of the
# backwards timed in turns against the scalar kernel at O=10: `quality`'s
# bf16 K2 and K4, then the fp32 K4 (flagship unsnapped), K8 (the
# split path's ladder) and `quality`'s K4 on the tensor cores split
TURNS = (("quality", "K1", "K2", "folded_variant", torch.bfloat16, ("quality",)),
         ("quality_unsnapped", "K3", "K4", "unsnapped_variant", torch.bfloat16, ("quality",)),
         ("unsnapped", "K3", "K4", "unsnapped_variant", torch.float32, ("fp32",)),
         ("unsnapped_split", "K7", "K8", "unsnapped_variant", torch.float32, ("fp32",)),
         ("quality_unsnapped", "K3", "K4", "unsnapped_variant", torch.float32,
          ("quality", "fp32")))


def time_backwards_in_turns(specs: dict, records: dict, dev) -> None:
    """Each backward of TURNS at O=10 x 131072, the train step's shape: the
    variant the spec and dtype select (the tensor cores; fp32 split into
    bf16 hi and lo parts) and the scalar kernel (forced) timed in turns
    (scalar, new, new, scalar) beside the bound; the scalar kernel's sums
    are held to the new kernel's as timing context (phase_kernels holds the
    new kernel to the plain twin and autograd at this shape). The times go
    into the record's entry that TURNS names."""
    for path, kf, kb, selector, dtype, entry in TURNS:
        spec, dname = specs[path], str(dtype).split(".")[1]
        fwd, bwd = mxgrid_cuda.KERNELS[kf], mxgrid_cuda.KERNELS[kb]
        new = getattr(mxgrid_cuda, selector)(spec, dtype, planes=kb != "K8")
        want = "tensor_core_split" if dtype == torch.float32 else "tensor_core"
        if new != want:
            raise AssertionError(f"{kb} {path} {dname}: variant {new}")
        pts, args, gout = kernel_inputs(spec, dtype, dev, seed=3, kf=kf, o=N_OBJECTS)
        res = fwd(pts, *args, spec)[1:]
        got = pytree.tree_leaves(bwd(pts, *res, gout, spec))
        with forced(selector, "scalar"):
            scalar = pytree.tree_leaves(bwd(pts, *res, gout, spec))
        torch.cuda.synchronize()
        _, rel = errors(got, scalar)
        times = {"scalar": [], new: []}
        for variant in ("scalar", new, new, "scalar"):
            with forced(selector, variant):
                times[variant].append(median_ms(lambda: bwd(pts, *res, gout, spec)))
        b_ms, b_by = bound(kb, spec, dtype, N_OBJECTS)
        say("3 kernels", kernel=kb, spec=path, shape=f"{N_OBJECTS}x{KERNEL_P}", dtype=dname,
            variant=new, scalar_ms=[f"{t:.4f}" for t in times["scalar"]],
            **{f"{new}_ms": [f"{t:.4f}" for t in times[new]]},
            max_rel_err_vs_scalar=f"{rel:.3e}", rel_tol=REL_TOL[dtype],
            bound_ms=f"{b_ms:.4f}", bound_by=b_by)
        if not rel <= REL_TOL[dtype] or not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"{kb} {path} {dname} O={N_OBJECTS}: {rel} against the scalar "
                                 f"kernel")
        rec = records[kb]
        for key in entry:
            rec = rec[key]
        rec.update(ms=min(times[new]), scalar_ms=min(times["scalar"]), bound_ms=b_ms,
                   bound_by=b_by)
        del pts, args, gout, res, got, scalar
        torch.cuda.empty_cache()


# (spec of kernel_specs(), dtypes) of K0's checks: the crop RENDER_TEST's
# refinement (split unsnapped, phase 9) and the perturbed views' (flagship
# folded, phase 9b), one object x one view's points a step, fp32 as
# refinement runs; then bf16. K0's record is the split path's fp32 check.
K0_CHECKS = (("folded", BOTH), ("unsnapped_split", (torch.bfloat16, torch.float32)))


def points_work(spec, dtype, o, p):
    """(bytes, fp32 operations) of K0 on O x P points: the point, the
    factors, the cotangent and the plane residuals read once, the gradient
    written once, the tables once an object; per axis and channel 2 taps x
    levels multiply-adds and 4 operations, 30 a plane pair and channel (the
    u and v slopes of the bilinear sample, the w slope of the line, and
    three products with the cotangent)."""
    t = torch.tensor([], dtype=dtype).element_size()
    k, kpl, n = spec.features, spec.plane_out_dims, o * p
    folded = spec.snap_levels
    taps = 2 if folded else 2 * len(spec.resolutions)
    cp_tab = 3 * (spec.fold_res[1] if folded else spec.total_res) * k
    pl_tab = sum(3 * (ru * rv + max(ru, rv)) * kp for ru, rv, kp in spec.plane_specs)
    nbytes = 24 * n + n * t * (3 * k + k + kpl + 2 * kpl) + o * t * (cp_tab + pl_tab)
    return nbytes, n * (3 * (2 * taps * k + 4 * k) + 30 * kpl)


def check_points_gradient(specs: dict, dev) -> dict:
    """K0 against its plain twin on the residuals of the path's forward
    kernels, and (fp32) against autograd over the points through the plain
    encode `mxgrid.encode`, off the knots (`mxgrid_cuda.on_a_knot`: the
    tent has no derivative there); times and bound. Returns K0's record."""
    record = None
    for path, dtypes in K0_CHECKS:
        spec = specs[path]
        for dtype in dtypes:
            tol, dname = REL_TOL[dtype], str(dtype).split(".")[1]
            g = torch.Generator(device="cpu").manual_seed(7)
            pts = (torch.rand((1, REFINE_P, 3), generator=g) * (1 + 4e-3) - 2e-3).to(dev)
            f = pytree.tree_map(lambda a: a.to(dev, dtype), mxgrid.init_mxgrid(g, spec, 1))
            gout = torch.randn((1, REFINE_P, spec.n_output_dims), generator=g).to(dev, dtype)
            table = (mxgrid.fold_lines(f["lines"], spec) if spec.snap_levels
                     else f["lines"]).contiguous()
            planes, plines = tuple(f["planes"]), tuple(f["plane_lines"])
            with environ(MX_FUSED="0" if path.endswith("split") else "1"):
                assert mxgrid_cuda.kernel_path(spec) == path
                if path == "folded":
                    _, afac, fpl, fli = mxgrid_cuda.folded_fused_forward(
                        pts, table, planes[0], plines[0], spec)
                else:
                    _, afac = mxgrid_cuda.unsnapped_cp_forward(pts, table, spec)
                    _, fpl, fli = mxgrid_cuda.planes_forward(pts, planes, plines, spec)
                args = (pts, table, afac, planes, plines, fpl, fli, gout, spec)
                got = mxgrid_cuda.points_gradient(*args)
                want = mxgrid_cuda.points_gradient_plain(*args)
                torch.cuda.synchronize()
                abs_err, rel_err = errors([got], [want])
                extra = {}
                if dtype == torch.float32:
                    p = pts.clone().requires_grad_(True)
                    (want_ad,) = torch.autograd.grad(mxgrid.encode(f, p, spec), p,
                                                     grad_outputs=gout)
                    off = ~mxgrid_cuda.on_a_knot(pts, spec)  # no derivative on a knot
                    ad_abs, ad_rel = errors([got[off]], [want_ad[off]])
                    extra = dict(max_rel_err_vs_autograd=f"{ad_rel:.3e}",
                                 points_on_a_knot=int((~off).sum()))
                    rel_err, abs_err = max(rel_err, ad_rel), max(abs_err, ad_abs)
                variant = mxgrid_cuda.points_variant(spec, dtype)
                if variant != "lanes_over_channels":
                    raise AssertionError(f"K0 {path} {dname}: variant {variant}")
                times = {"per_point": [], variant: []}  # in turns, the first design forced
                for v in ("per_point", variant, variant, "per_point"):
                    with forced("points_variant", v):
                        times[v].append(median_ms(lambda: mxgrid_cuda.points_gradient(*args)))
                ms, old_ms = min(times[variant]), min(times["per_point"])
                plain_ms = median_ms(lambda: mxgrid_cuda.points_gradient_plain(*args), 3)
            nbytes, ops = points_work(spec, dtype, 1, REFINE_P)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
            bound_ms, bound_by = 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                              else "operations")
            say("3 kernels", kernel="K0", spec=path, shape=f"1x{REFINE_P}", dtype=dname,
                variant=variant, max_abs_err=f"{abs_err:.3e}", max_rel_err=f"{rel_err:.3e}",
                rel_tol=tol, **extra, ms=f"{ms:.4f}",
                **{f"{variant}_ms": [f"{t:.4f}" for t in times[variant]],
                   "per_point_ms": [f"{t:.4f}" for t in times["per_point"]]},
                plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
            if not rel_err <= tol or not torch.isfinite(got).all():
                raise AssertionError(f"K0 {path} {dtype}: relative error {rel_err} above {tol}")
            if path == "unsnapped_split" and dtype == torch.float32:
                record = dict(variant=variant, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                              per_point_ms=old_ms)
            del got, want, args, afac, fpl, fli, pts, f, gout
            torch.cuda.empty_cache()
    return record


def phase_parity(dev) -> None:
    """One fp32 step of a tiny config: kernels on the card vs the plain
    encode on the CPU, same initial state and uniforms."""
    cfg = NerfConfig(
        encoding=EncodingConfig(mx_levels=2, mx_max_resolution=32, mx_features=8,
                                mx_plane_res=(16, 8), mx_plane_features=4),
        train=TrainConfig(rays_per_batch=256, samples_per_ray=8, compute_dtype="float32"))
    spec = nerf.make_field_spec(cfg)
    g = torch.Generator().manual_seed(5)
    state = nerf.init_train_state(g, 2, cfg, spec)
    uniforms = nerf.draw_uniforms(g, 2, cfg)
    results = {}
    for device in ("cpu", dev):
        _, _, _, store, objs = build_synthetic_world(2, 3, 32, device=device)
        st = pytree.tree_map(lambda a: a.to(device), state)
        u = tuple(a.to(device) for a in uniforms)
        out = nerf.train_objects(st, objs, store.arrays(), cfg, spec, 1,
                                 uniforms=lambda u=u: u)
        results[str(device)] = pytree.tree_map(lambda a: a.cpu(), out)
    cpu, gpu = results["cpu"], results[str(dev)]
    loss_err = float((cpu.loss - gpu.loss).abs().max())
    mu_c = pytree.tree_leaves(cpu.opt.mu)
    mu_g = pytree.tree_leaves(gpu.opt.mu)
    mu_rel = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                 for a, b in zip(mu_c, mu_g))
    say("4 parity", loss_cpu=cpu.loss.tolist(), loss_gpu=gpu.loss.tolist(),
        max_abs_loss_err=f"{loss_err:.3e}", first_moment_max_rel_err=f"{mu_rel:.3e}")
    if not (loss_err <= 1e-4 and mu_rel <= 1e-3 and (gpu.step == 1).all()):
        raise AssertionError("tiny train step on the card disagrees with the CPU path")


def held_out_views(cam, objects, n_frames=16, min_pixels=64):
    """For each object, the first view halfway between two training frames
    of the bench orbit (synthetic.make_sequence) that shows it with at
    least `min_pixels` pixels: (twc, rgb, instance mask, bbox) or None."""
    center = np.mean([o.center for o in objects], axis=0)
    views = [None] * len(objects)
    for k in range(n_frames):
        theta = 2 * np.pi * (k + 0.5) / n_frames
        eye = synthetic.orbit_eye(center, 5.5, theta, 0.45 + 0.15 * np.sin(3 * theta))
        twc = synthetic.look_at_pose(eye, center)
        rgb, _, inst = synthetic.render_frame(cam, twc, objects)
        for oi, obj in enumerate(objects):
            if views[oi] is None and np.sum(inst == obj.instance_id) >= min_pixels:
                views[oi] = (twc, rgb, inst, synthetic.instance_bbox(inst, obj.instance_id))
        if all(v is not None for v in views):
            break
    return views


def phase_train_and_render(dev) -> tuple[dict, float]:
    cfg = NerfConfig()
    spec = nerf.make_field_spec(cfg)
    torch.cuda.reset_peak_memory_stats()  # this phase's peak, not the kernel checks'
    t0 = time.perf_counter()
    cam, objects, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
    torch.cuda.synchronize()
    say("5 train", setup_s=f"{time.perf_counter() - t0:.3f}", spec_out=spec.n_output_dims,
        dtype=str(nerf.compute_dtype(cfg, torch.device(dev))).split(".")[1])

    mxgrid_cuda.reset_launch_counts()
    state = nerf.train_objects(state, objs, frames, cfg, spec, 1, generator=gen)
    loss1 = state.loss.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = nerf.train_objects(state, objs, frames, cfg, spec, WAVE, generator=gen)
    enqueue_s = time.perf_counter() - t0  # the host alone: the wave's launches queued
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    loss2 = state.loss.cpu()
    active = objs.active.cpu()
    rate = N_OBJECTS * WAVE / wave_s
    say("5 train", loss_step1=[round(x, 5) for x in loss1.tolist()],
        loss_wave=[round(x, 5) for x in loss2.tolist()], wave_s=f"{wave_s:.4f}",
        host_enqueue_s=f"{enqueue_s:.4f}",
        obj_iters_per_s=f"{rate:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if not (torch.isfinite(loss1[active]).all() and torch.isfinite(loss2[active]).all()):
        raise AssertionError("non-finite loss on an active slot")
    if not (loss2[active] < loss1[active]).all():
        raise AssertionError("loss did not fall over the wave")
    if not (state.step[objs.active] == WAVE + 1).all():
        raise AssertionError("an active slot skipped steps")

    psnrs, ious = render_held_out("6 render", cam, objects, frames, objs, state, cfg, spec,
                                  gen, dev)
    launches = {"K1": mxgrid_cuda.folded_fused_forward.launches,
                "K2": mxgrid_cuda.folded_fused_backward.launches}
    say("6 render", mean_psnr_db=f"{np.mean(psnrs):.3f}", mean_mask_iou=f"{np.mean(ious):.4f}",
        views=len(psnrs), launches=launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    return launches, rate


def render_held_out(label, cam, objects, frames, objs, state, cfg, spec, gen, dev):
    """One held-out bbox view per object rendered from the EMA through
    `render_rays` (fp32): PSNR on the object's pixels and mask IoU, a line
    each. Returns (psnrs, ious); fails unless every object renders finite."""
    psnrs, ious = [], []
    for oi, (obj, view) in enumerate(zip(objects, held_out_views(cam, objects))):
        if view is None:
            raise AssertionError(f"object {oi}: no held-out view shows it")
        twc, gt_rgb, gt_inst, (x0, y0, h, w) = view
        ys, xs = np.mgrid[y0 : y0 + h, x0 : x0 + w]
        xt = torch.as_tensor(xs.ravel(), dtype=torch.float32, device=dev)
        yt = torch.as_tensor(ys.ravel(), dtype=torch.float32, device=dev)
        o, d, dn = camera_rays(xt, yt, frames.intrinsics,
                               torch.as_tensor(twc, device=dev), objs.tow[oi])
        tmin, tmax, hit = ray_aabb_intersect(o, d, objs.aabb_min[oi], objs.aabb_max[oi])
        jitter = torch.rand((o.shape[0], cfg.train.render_samples_per_ray), generator=gen,
                            device=dev)
        params = pytree.tree_map(lambda a: a[oi], state.ema)
        rgb, _, mask = nerf.render_rays(
            params, o, d, dn, torch.clamp(tmin, min=0.0), tmax, hit, jitter,
            objs.aabb_min[oi], objs.aabb_max[oi], cfg, spec,
            n_samples=cfg.train.render_samples_per_ray)
        rgb = rgb.cpu().numpy().reshape(h, w, 3)
        mask = mask.cpu().numpy().reshape(h, w)
        if not np.isfinite(rgb).all():
            raise AssertionError(f"object {oi}: non-finite render")
        gt = gt_rgb[y0 : y0 + h, x0 : x0 + w].astype(np.float32) / 255.0
        inst = gt_inst[y0 : y0 + h, x0 : x0 + w] == obj.instance_id
        mse = float(np.mean((rgb[inst] - gt[inst]) ** 2))
        psnrs.append(-10 * math.log10(mse) if mse > 0 else float("inf"))
        ious.append(float(np.sum((mask > 0.5) & inst) / max(np.sum((mask > 0.5) | inst), 1)))
        say(label, object=oi, psnr_db=f"{psnrs[-1]:.3f}", mask_iou=f"{ious[-1]:.4f}",
            rays=h * w)
    torch.cuda.synchronize()
    if len(psnrs) != len(objects) or not all(np.isfinite(psnrs)):
        raise AssertionError("held-out render failed")
    return psnrs, ious


def write_world_dataset(root: str):
    """The scene of build_synthetic_world(10, 16, 128) (bench.py:112) written
    in the reference's on-disk format, GT depth on. Returns the frames."""
    res = 128
    cam = synthetic.Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = synthetic.make_scene(N_OBJECTS, seed=0)
    frames = synthetic.make_sequence(cam, objects, 16, radius=5.5, seed=0)
    write_dataset(root, cam, frames, objects=objects, use_depth=True)
    return frames


def check_artifacts(out: str, n_objects: int, video: bool) -> int:
    """Every object's artifact tree is complete; returns the file count."""
    n_files = 0
    for oi in range(n_objects):
        base = os.path.join(out, str(oi))
        need = [os.path.join(out, f"{oi}.ply")] + [
            os.path.join(base, f) for f in ("test.txt", "train.txt", "obj.ply")]
        missing = [f for f in need if not os.path.isfile(f)]
        imgs = sorted(os.listdir(os.path.join(base, "test_img")))
        for sub in ("test_depth", "test_mask"):
            if sorted(os.listdir(os.path.join(base, sub))) != imgs:
                missing.append(os.path.join(base, sub))
        if not imgs:
            missing.append(os.path.join(base, "test_img"))
        if video:
            for sub in ("video_img", "video_depth"):
                if len(os.listdir(os.path.join(base, sub))) != 60:
                    missing.append(os.path.join(base, sub))
        if missing:
            raise AssertionError(f"object {oi}: artifacts missing: {missing}")
        n_files += sum(len(f) for _, _, f in os.walk(base)) + 1
    return n_files


def psnr_of_test_imgs(out: str, runner, frames) -> list[float]:
    """PSNR (dB) of each object's test_img renders against the GT frames,
    on the object's pixels of the bbox."""
    by_stamp = {f["stamp"]: f for f in frames}
    psnrs = []
    for oi, o in enumerate(runner.objects):
        d = o["data"]
        boxes = dict(zip(d.stamps, (tuple(int(v) for v in b) for b in d.bboxes)))
        err, n = 0.0, 0
        for name in sorted(os.listdir(os.path.join(out, str(oi), "test_img"))):
            stamp = name[: -len(".png")]
            x, y, h, w = boxes[stamp]
            img = cv2.imread(os.path.join(out, str(oi), "test_img", name))[..., ::-1]
            fr = by_stamp[stamp]
            inst = fr["instance"][y : y + h, x : x + w] == d.cls
            gt = fr["rgb"][y : y + h, x : x + w].astype(np.float64) / 255.0
            err += float(np.sum((img.astype(np.float64) / 255.0 - gt)[inst] ** 2))
            n += 3 * int(inst.sum())
        psnrs.append(-10 * math.log10(err / n) if err > 0 else float("inf"))
    return psnrs


def phase_offline(dev, root: str, frames) -> dict:
    """The offline entry point at full width with the CP-only `fast` preset
    (K5/K6): 10 objects, 4096 rays x 32 samples, 2 waves x 25 steps (the
    reference runs 10 x 500), a mesh at wave 2, then every artifact with
    the orbit video."""
    cfg = NerfConfig(encoding=EncodingConfig.preset("fast"))
    t0 = time.perf_counter()
    runner = OfflineRunner(root, cfg, use_depth=True, device=dev)
    n = runner.create_nerfs_from_dir()
    # the loss of one step from the initial weights, on a throwaway copy
    runner._build_object_table()
    loss0 = nerf.train_objects(runner.state, runner.objs_state, runner.store.arrays(), cfg,
                               runner.spec, 1, True,
                               generator=torch.Generator(device=dev).manual_seed(1)).loss.cpu()
    torch.cuda.synchronize()
    say("7 offline", preset="fast", objects=n, depth_cut="10x500 -> 2x25 steps",
        setup_s=f"{time.perf_counter() - t0:.3f}")

    out = os.path.join(root, "out_fast")
    mxgrid_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    runner.train(waves=2, steps_per_wave=25, mesh_every=2, out_dir=out)
    t_train = time.perf_counter() - t0
    runner.render_test_artifacts(out, video=True)
    torch.cuda.synchronize()
    t_art = time.perf_counter() - t0 - t_train
    launches = {k: mxgrid_cuda.KERNELS[k].launches for k in ("K5", "K6")}
    others = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if k not in launches}

    loss = runner.state.loss.cpu()
    rate = n * 25 / runner.wave_seconds[1]
    verts = [len(m.verts) for m in runner.meshes.values()]
    faces = [len(m.faces) for m in runner.meshes.values()]
    psnrs = psnr_of_test_imgs(out, runner, frames)
    n_files = check_artifacts(out, n, video=True)
    say("7 offline", loss_step1=[round(x, 5) for x in loss0.tolist()],
        loss_step50=[round(x, 5) for x in loss.tolist()],
        wave_s=[f"{t:.4f}" for t in runner.wave_seconds], obj_iters_per_s=f"{rate:.2f}",
        train_and_mesh_s=f"{t_train:.3f}", artifacts_s=f"{t_art:.3f}")
    say("7 offline", mesh_verts=verts, mesh_faces=faces,
        test_img_psnr_db=[f"{p:.3f}" for p in psnrs], mean_psnr_db=f"{np.mean(psnrs):.3f}",
        files=n_files, launches=launches, other_kernels=others)
    if not (torch.isfinite(loss).all() and (loss < loss0).all()):
        raise AssertionError("offline run: a loss is not finite or did not fall")
    if min(verts) < 1 or min(faces) < 1:
        raise AssertionError(f"offline run: an empty mesh ({verts}, {faces})")
    if not all(np.isfinite(psnrs)) or min(launches.values()) < 1 or any(others.values()):
        raise AssertionError(f"offline run: PSNR {psnrs} or launches {launches}/{others}")
    return launches


def phase_unsnapped_cli(dev, root: str) -> dict:
    """`python -m romap_tpu_torch.runtime.offline` with MX_SNAP=0: the
    flagship spec unsnapped (K3/K4), 1 wave x 20 steps, no video."""
    out = os.path.join(root, "out_unsnapped")
    with environ(MX_SNAP="0"):
        mxgrid_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        runner = offline.main(["-", root, "1", "--device", dev, "--waves", "1",
                               "--steps-per-wave", "20", "--no-video", "--out", out])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    k3 = dict(mxgrid_cuda.KERNELS["K3"].launches_by_dtype)
    passes = product_passes()
    launches = {k: mxgrid_cuda.KERNELS[k].launches for k in ("K3", "K4")}
    others = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if k not in launches}
    loss = runner.state.loss.cpu()
    n = len(runner.objects)
    n_files = check_artifacts(out, n, video=False)
    say("8 unsnapped", snap=runner.spec.snap_levels, loss_step20=[round(x, 5) for x in loss.tolist()],
        wave_s=f"{runner.wave_seconds[0]:.4f}", seconds=f"{dt:.3f}", files=n_files,
        k3_by_dtype=k3, launches=launches, other_kernels=others, product_passes=passes)
    if runner.spec.snap_levels or not torch.isfinite(loss).all():
        raise AssertionError("unsnapped CLI run: spec still snapped or a loss not finite")
    if (k3.get("bfloat16", 0) < 1 or k3.get("float32", 0) < 1 or launches["K4"] < 1
            or any(others.values())):
        raise AssertionError(f"unsnapped CLI run: launches {k3} {launches} {others}")
    if any(n.get("bfloat16", 0) for n in passes.values()):
        raise AssertionError(f"unsnapped CLI run: a bf16 product pass ran: {passes}")
    if (mxgrid_cuda.unsnapped_forward_variant(runner.spec, torch.float32) == "channel_split"
            and any(passes.values())):
        raise AssertionError(f"unsnapped CLI run: a product pass ran where fp32 K3 takes "
                             f"channel_split: {passes}")
    return launches


def product_passes() -> dict:
    """Launches of the product passes by dtype since the last reset: K3's
    per-axis variant launches `cp_product_pass`, K7's calls `cp_product`;
    the three-axis variants (every bf16 path) and channel_split (fp32 at
    the shipped ladders) launch neither."""
    return {k: dict(fn.launches_by_dtype) for k, fn in mxgrid_cuda.PRODUCT_PASSES.items()}


# the `quality` preset's paths and the kernel path each routes to
QUALITY_PATHS = {"quality": "folded", "quality_unsnapped": "unsnapped",
                 "quality_split": "unsnapped_split"}


def kernel_specs() -> dict:
    """The spec of each kernel pair's path: the flagship with snap on
    (K1/K2) and off (K3/K4), the CP-only `fast` preset with snap on (K5/K6)
    and off (K7/K8), the flagship unsnapped on the split path (MX_FUSED=0),
    whose ladder K7/K8 and plane level (128, 64, 4) K9/K10 run, and the
    `quality` preset (256 x 64 with a (128, 128, 8) plane level) folded
    ("quality": K1/K2), unsnapped ("quality_unsnapped": K3/K4) and on the
    split path ("quality_split": K9/K10)."""
    flagship, fast = EncodingConfig(), EncodingConfig.preset("fast")
    quality = EncodingConfig.preset("quality")
    unsnap = lambda e: dataclasses.replace(e, mx_snap_levels=False)
    encodings = {"folded": flagship, "unsnapped": unsnap(flagship), "folded_cp": fast,
                 "unsnapped_cp": unsnap(fast), "unsnapped_split": unsnap(flagship),
                 "quality": quality, "quality_unsnapped": unsnap(quality),
                 "quality_split": unsnap(quality)}
    specs = {k: nerf.make_field_spec(NerfConfig(encoding=e)) for k, e in encodings.items()}
    for path, spec in specs.items():
        with environ(MX_FUSED="0" if path.endswith("split") else "1"):
            route = QUALITY_PATHS.get(path, path)
            assert mxgrid_cuda.kernel_path(spec) == route, (path, spec)
    assert specs["unsnapped_split"].plane_specs == ((128, 64, 4),)
    assert all(specs[p].plane_specs == ((128, 128, 8),) for p in QUALITY_PATHS)
    return specs


# --------------------------------------------------------------------------
# Phase 9: the online server and a client of its wire protocol
# --------------------------------------------------------------------------


def pack_str(s: str) -> bytes:
    return struct.pack("<H", len(s)) + s.encode()


def f32(a) -> bytes:
    return np.asarray(a, np.float32).tobytes()


class Client:
    """One connection to romap_tpu_torch.runtime.server (its module
    docstring has the protocol); a reply with status != 0 raises."""

    def __init__(self, path: str, timeout: float = 600.0):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(path)

    def call(self, op: str, payload: bytes = b"") -> bytes:
        self.sock.sendall(struct.pack("<II", server.OPS[op], len(payload)) + payload)
        status, n = struct.unpack("<II", self._recv(8))
        data = self._recv(n)
        if status != 0:
            raise AssertionError(f"server: {op} failed: {data.decode(errors='replace')}")
        return data

    def losses(self) -> np.ndarray:
        data = self.call("GET_LOSSES")
        return np.frombuffer(data, np.float32, struct.unpack("<i", data[:4])[0], 4)

    def _recv(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf.extend(chunk)
        return bytes(buf)


def drive_frames(c: Client, cam, objects, frames) -> dict:
    """Keyframes and bboxes as the SLAM frontend sends them (LocalMapping):
    a NeRF per object once it has more than 10 bboxes, then its rows in
    batches of two, one wave credited per batch. Returns {instance: idx}."""
    ids, pending = {}, {o.instance_id: [] for o in objects}

    def flush(obj):
        rows = np.asarray(pending[obj.instance_id], np.int32)
        c.call("UPDATE_BBOX", struct.pack("<iii", ids[obj.instance_id], 1, len(rows))
               + rows.tobytes())
        pending[obj.instance_id] = []

    for fi, f in enumerate(frames):
        c.call("NEW_FRAME", struct.pack("<i", fi) + pack_str(f["stamp"]) + b"\0"
               + f["rgb"].tobytes() + f["instance"].tobytes() + f32(f["twc"]))
        for obj in objects:
            bb = f["bboxes"][obj.instance_id]
            if bb is None:
                continue
            pending[obj.instance_id].append((fi, *bb))
            if obj.instance_id not in ids and len(pending[obj.instance_id]) > 10:
                tow = np.eye(4)
                tow[:3, 3] = -obj.center
                half = obj.aabb_half_extents()
                reply = c.call("CREATE_NERF", struct.pack("<i", obj.instance_id) + f32(tow)
                               + f32(-half) + f32(half))
                ids[obj.instance_id] = struct.unpack("<i", reply[:4])[0]
                flush(obj)
            elif obj.instance_id in ids and len(pending[obj.instance_id]) >= 2:
                flush(obj)
    for obj in objects:
        if obj.instance_id in ids and pending[obj.instance_id]:
            flush(obj)
    return ids


def phase_online(root: str) -> dict:
    """The online entry point at full flagship width on the split kernels:
    `server.main` on a thread, MX_FUSED=0 MX_SNAP=0, driven over its socket."""
    res = 128
    cam = synthetic.Camera(fx=res * 0.9, fy=res * 0.9, cx=res / 2, cy=res / 2, h=res, w=res)
    objects = synthetic.make_scene(N_OBJECTS, seed=0)
    frames = synthetic.make_sequence(cam, objects, 16, radius=5.5, seed=0)
    sock, out = os.path.join(root, "online.sock"), os.path.join(root, "out_online")
    box = {}
    with environ(MX_FUSED="0", MX_SNAP="0"):
        mxgrid_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        th = threading.Thread(target=lambda: box.update(srv=server.main(["--socket", sock])),
                              daemon=True)
        th.start()
        while not os.path.exists(sock):
            if not th.is_alive() or time.perf_counter() - t0 > 120:
                raise AssertionError("online server did not start")
            time.sleep(0.05)
        c = Client(sock)
        c.call("INIT", struct.pack("<BiiB", 0, ONLINE_ITERS, N_OBJECTS, 1))
        c.call("DATASET_INIT", struct.pack("<ffffiii", cam.fx, cam.fy, cam.cx, cam.cy, res, res,
                                           len(frames)))
        ids = drive_frames(c, cam, objects, frames)
        waves = struct.unpack("<i", c.call("PUMP", struct.pack("<i", 1)))[0]
        first = c.losses().copy()
        waves += struct.unpack("<i", c.call("PUMP", struct.pack("<i", -1)))[0]
        obj = objects[0]
        tow = np.eye(4)
        tow[:3, 3] = -obj.center
        half = obj.aabb_half_extents() * 1.2
        new_half = np.frombuffer(c.call("UPDATE_VOLUME", struct.pack("<i", ids[obj.instance_id])
                                        + f32(tow) + f32(-half) + f32(half)), np.float32)
        c.call("START")
        c.call("WAIT_END")
        final = c.losses().copy()
        meshes = []
        for idx in ids.values():
            nv, nf = struct.unpack("<ii", c.call("GET_MESH", struct.pack("<i", idx))[:8])
            meshes.append((nv, nf))
        view = frames[-1]
        x, y, h, w = view["bboxes"][obj.instance_id]
        crop = (np.ascontiguousarray(view["rgb"][y : y + h, x : x + w]).tobytes()
                + ((view["instance"][y : y + h, x : x + w] == obj.instance_id) * 255)
                .astype(np.uint8).tobytes())
        printed = io.StringIO()
        t_render = time.perf_counter()
        with contextlib.redirect_stdout(printed):  # the server thread prints the refinement
            c.call("RENDER_TEST", struct.pack("<ifB", ids[obj.instance_id], 1.5, 0)
                   + pack_str(out) + struct.pack("<i", 1) + pack_str(view["stamp"])
                   + np.asarray([x, y, h, w], np.int32).tobytes() + f32(view["twc"]) + b"\1"
                   + crop)
        t_render = time.perf_counter() - t_render
        refine_lines = [ln for ln in printed.getvalue().splitlines() if ln.startswith("pose refine")]
        print(printed.getvalue(), end="", flush=True)
        c.call("SHUTDOWN")
        th.join(timeout=120)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    if th.is_alive():
        raise AssertionError("online server did not stop")
    mgr = box["srv"].mgr
    secs, slots = mgr.wave_seconds, mgr.wave_slots
    rate = sum(n * ONLINE_ITERS for n in slots[1:]) / sum(secs[1:])
    launches = {k: mxgrid_cuda.KERNELS[k].launches for k in ("K0", "K7", "K8", "K9", "K10")}
    by_dtype = {k: dict(mxgrid_cuda.KERNELS[k].launches_by_dtype) for k in launches}
    passes = product_passes()
    others = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if k not in launches}
    rendered = os.path.isfile(os.path.join(out, str(ids[obj.instance_id]), "test_img",
                                           f"{view['stamp']}.png"))
    say("9 online", objects=len(ids), iters_per_wave=f"{ONLINE_ITERS} (cut from 500)",
        waves_pumped=waves, waves_run=len(secs), wave_slots=slots,
        wave_s=[f"{t:.4f}" for t in secs], obj_iters_per_s_after_first=f"{rate:.2f}")
    say("9 online", loss_first_wave=[round(float(v), 5) for v in first],
        loss_final=[round(float(v), 5) for v in final],
        volume_half=[round(float(v), 5) for v in new_half],
        mesh_verts=[m[0] for m in meshes], mesh_faces=[m[1] for m in meshes],
        test_render=rendered, launches=launches, by_dtype=by_dtype, other_kernels=others,
        product_passes=passes, seconds=f"{dt:.3f}")
    say("9 online", render_test_with_crops_s=f"{t_render:.3f}", pose_refine_lines=len(refine_lines))
    if len(ids) != N_OBJECTS or not np.allclose(new_half, half * 1.1, rtol=1e-5):
        raise AssertionError(f"online run: {len(ids)} objects, volume half {new_half}")
    if not (np.isfinite(final).all() and (final < first).all()):
        raise AssertionError(f"online run: losses not finite or not below the first wave's")
    if min(m[0] for m in meshes) < 1 or min(m[1] for m in meshes) < 1 or not rendered:
        raise AssertionError(f"online run: an empty mesh {meshes} or no test render")
    k7, k10 = by_dtype["K7"], by_dtype["K10"]
    if mxgrid_cuda.planes_variant(mgr.spec, torch.bfloat16) != "tensor_core":
        raise AssertionError("online run: K10 in bf16 is not the tensor-core variant")
    if (min(launches.values()) < 1 or k7.get("bfloat16", 0) < 1 or k7.get("float32", 0) < 1
            or k10.get("bfloat16", 0) < 1 or any(others.values())):
        raise AssertionError(f"online run: launches {by_dtype}, other kernels {others}")
    if any(n.get("bfloat16", 0) for n in passes.values()):
        raise AssertionError(f"online run: a bf16 product pass ran: {passes}")
    if (mxgrid_cuda.unsnapped_forward_variant(mgr.spec, torch.float32, planes=False)
            == "channel_split" and any(passes.values())):
        raise AssertionError(f"online run: a product pass ran where fp32 K7 takes "
                             f"channel_split: {passes}")
    if len(refine_lines) != 1:
        raise AssertionError(f"online run: pose refinement printed {refine_lines}")
    return launches


REFINE_TRAIN_STEPS = 400  # the reference's tests/test_pose_refine.py trains 400


def phase_refine(dev) -> dict:
    """Pose refinement on the card against a converged field, as the
    reference's own test sets it up (tests/test_pose_refine.py), at the
    flagship's width: one object of build_synthetic_world(1, 24, 96) trained
    400 steps (bf16, K1/K2), two views (frames 5, 15) rotated by 0.02 rad
    about z and shifted by N(0, 0.02) m per axis, refined at the reference's
    4 starts x 300 steps x 1536 pixels x 32 samples through the kernel
    encode (fp32: K1 forward, K0 for the points, no table kernel). Fails
    unless the loss falls and a view comes strictly closer in both rotation
    and translation (the reference test's criterion), and prints every
    view's errors."""
    cfg = NerfConfig()
    spec = nerf.make_field_spec(cfg)
    _, objects, seq, store, objs = build_synthetic_world(1, 24, 96, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = nerf.init_train_state(gen, 1, cfg, spec, device=dev)
    t0 = time.perf_counter()
    state = nerf.train_objects(state, objs, store.arrays(), cfg, spec, REFINE_TRAIN_STEPS,
                               generator=gen)
    loss = float(state.loss[0])
    train_s = time.perf_counter() - t0
    params = pytree.tree_map(lambda a: a[0], state.ema)
    obj = objects[0]
    rng = np.random.default_rng(0)
    boxes, crops, twcs_true, twcs_pert = [], [], [], []
    for fi in (5, 15):
        x, y, h, w = seq[fi]["bboxes"][obj.instance_id]
        mask = (seq[fi]["instance"][y : y + h, x : x + w] == obj.instance_id)
        crops.append((seq[fi]["rgb"][y : y + h, x : x + w], mask.astype(np.uint8) * 255))
        boxes.append((x, y, h, w))
        twc = np.asarray(seq[fi]["twc"], np.float32)
        pert = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.02), np.sin(0.02)
        pert[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        pert[:3, 3] = rng.normal(0, 0.02, 3)
        twcs_true.append(twc)
        twcs_pert.append(twc @ pert)
    host = lambda a: a.cpu().numpy()
    mxgrid_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, stats = pose_refine.refine_view_poses_host(
        params, store._intrinsics, twcs_pert, host(objs.tow[0]), host(objs.aabb_min[0]),
        host(objs.aabb_max[0]), boxes, crops, cfg, spec)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if fn.launches}

    def err(a, b):
        cos = np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)
        return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(np.degrees(np.arccos(cos)))

    before = [err(t, p) for t, p in zip(twcs_true, twcs_pert)]
    after = [err(t, r) for t, r in zip(twcs_true, refined)]
    closer = sum(a[0] < b[0] and a[1] < b[1] for a, b in zip(after, before))
    say("9b refine", train_steps=REFINE_TRAIN_STEPS, train_s=f"{train_s:.3f}",
        train_loss=f"{loss:.5f}", views=len(boxes), refine_s=f"{secs:.3f}",
        steps_starts_pixels_samples=(f"{pose_refine.N_STEPS}x{pose_refine.N_STARTS}x"
                                     f"{pose_refine.N_PIXELS}x{pose_refine.N_SAMPLES}"),
        loss_before=f"{stats['mean_loss_before']:.5f}",
        loss_after=f"{stats['mean_loss_after']:.5f}", views_improved=stats["refined"])
    say("9b refine", pose_err_m_deg_before=[(round(t, 5), round(r, 4)) for t, r in before],
        pose_err_m_deg_after=[(round(t, 5), round(r, 4)) for t, r in after],
        views_closer_in_both=closer, launches=launches,
        by_dtype={k: dict(mxgrid_cuda.KERNELS[k].launches_by_dtype) for k in launches})
    if not loss < 0.3:
        raise AssertionError(f"refinement field: loss {loss} after {REFINE_TRAIN_STEPS} steps")
    if not (all(np.isfinite(r).all() for r in refined) and stats["refined"] >= 1
            and stats["mean_loss_after"] < stats["mean_loss_before"] and closer >= 1):
        raise AssertionError(f"pose refinement: {stats}, errors {before} -> {after}")
    if set(launches) != {"K0", "K1"}:
        raise AssertionError(f"pose refinement: launches {launches} (want K1 and K0 only)")
    return {"seconds": secs}


def phase_tcnn(dev) -> float:
    """EncodingConfig.preset("tcnn") (the hash grid: gather and index_add_,
    no kernel of this repo) through train_objects on the card: the scene of
    phase 5, 10 objects x 4096 x 32, 1 + 20 steps."""
    cfg = NerfConfig(encoding=EncodingConfig.preset("tcnn"))
    spec = nerf.make_field_spec(cfg)
    torch.cuda.reset_peak_memory_stats()
    _, _, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
    mxgrid_cuda.reset_launch_counts()
    state = nerf.train_objects(state, objs, frames, cfg, spec, 1, generator=gen)
    loss1 = state.loss.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = nerf.train_objects(state, objs, frames, cfg, spec, 20, generator=gen)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    loss2 = state.loss.cpu()
    active = objs.active.cpu()
    rate = N_OBJECTS * 20 / wave_s
    launches = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items()}
    say("10 tcnn", levels=spec.n_levels, table_rows=spec.total_params, features=spec.n_features,
        loss_step1=[round(x, 5) for x in loss1.tolist()],
        loss_step21=[round(x, 5) for x in loss2.tolist()], wave_s=f"{wave_s:.4f}",
        obj_iters_per_s=f"{rate:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}", kernels=launches)
    if not (torch.isfinite(loss2[active]).all() and (loss2[active] < loss1[active]).all()):
        raise AssertionError("tcnn: a loss is not finite or did not fall")
    if any(launches.values()):
        raise AssertionError(f"tcnn: an MX-grid kernel ran: {launches}")
    return rate


def phase_quality() -> None:
    """The flagship-parity gate (`romap_tpu_torch.tools.quality_gate`, the
    port's scripts/quality_gate.py) at its full budget: seeds 0-2, 5000 bf16
    steps each through K1/K2, the held-out PSNR of each (K1 in fp32), the
    3-seed mean within 0.5 dB of the hash-grid anchors' mean. The record goes
    to build/, not into the tree; a failed gate fails the script."""
    out = os.path.join(ROOT, "build", "quality_torch.json")
    mxgrid_cuda.reset_launch_counts()
    rc = quality_gate.main(["--out", out])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if fn.launches}
    by_dtype = {k: dict(mxgrid_cuda.KERNELS[k].launches_by_dtype) for k in launches}
    with open(out) as f:
        rec = json.load(f)
    say("11 quality", seeds=rec["seeds"], iters=rec["iters"],
        flagship_by_seed=rec["flagship_by_seed"],
        jax_flagship_by_seed=rec["jax_flagship_by_seed"], anchor_by_seed=rec["anchor_by_seed"],
        seconds_by_seed=rec["seconds_by_seed"])
    say("11 quality", flagship_mean_db=rec["flagship_psnr_db"],
        anchor_mean_db=rec["hashgrid_anchor_db"], gap_db=rec["gap_db"],
        threshold_db=rec["threshold_db"], passed=rec["pass"], launches=by_dtype,
        record=os.path.relpath(out, ROOT))
    if rc != 0 or not rec["pass"]:
        raise AssertionError(f"quality gate failed (exit {rc}): {rec}")
    steps, renders = rec["iters"] * len(rec["seeds"]), len(rec["seeds"])
    if by_dtype != {"K1": {"bfloat16": steps, "float32": renders}, "K2": {"bfloat16": steps}}:
        raise AssertionError(f"quality gate: launches {by_dtype} (want K1/K2 once a bf16 "
                             f"step, K1 once a fp32 render)")


QUALITY_UNSNAPPED_WAVE = 20


def phase_quality_preset(dev) -> dict:
    """`EncodingConfig.preset("quality")` (256 x 64 with a (128, 128, 8)
    plane level) through train_objects on the scene of phase 5, bf16: 1 step
    and a timed 50-step wave folded (K1/K2, K2 on the tensor cores), one
    held-out view per object rendered (K1 fp32), then with MX_SNAP=0 1 + 20
    steps (K3/K4, K4 on the tensor cores). Nothing is cut: these are the
    preset's own widths and the train step's batch. Returns the K2 and K4
    launches of the two runs."""
    cfg = NerfConfig(encoding=EncodingConfig.preset("quality"))
    cam, objects, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    active = objs.active.cpu()
    launches = {}
    for snap, n_steps in (("1", WAVE), ("0", QUALITY_UNSNAPPED_WAVE)):
        with environ(MX_SNAP=snap):
            spec = nerf.make_field_spec(cfg)
            kf, kb = ("K1", "K2") if spec.snap_levels else ("K3", "K4")
            selector = "folded_variant" if spec.snap_levels else "unsnapped_variant"
            variant = getattr(mxgrid_cuda, selector)(spec, torch.bfloat16)
            if variant != "tensor_core" or spec.snap_levels != (snap == "1"):
                raise AssertionError(f"quality {kb}: variant {variant}, snap {spec.snap_levels}")
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
            torch.cuda.reset_peak_memory_stats()
            mxgrid_cuda.reset_launch_counts()
            state = nerf.train_objects(state, objs, frames, cfg, spec, 1, generator=gen)
            loss1 = state.loss.cpu()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = nerf.train_objects(state, objs, frames, cfg, spec, n_steps, generator=gen)
            enqueue_s = time.perf_counter() - t0  # the host alone: the wave's launches queued
            torch.cuda.synchronize()
            wave_s = time.perf_counter() - t0
            loss2 = state.loss.cpu()
            by_dtype = {k: dict(mxgrid_cuda.KERNELS[k].launches_by_dtype) for k in (kf, kb)}
            others = {k: fn.launches for k, fn in mxgrid_cuda.KERNELS.items() if k not in (kf, kb)}
            say("12 quality", snap=spec.snap_levels, spec_out=spec.n_output_dims,
                plane_specs=spec.plane_specs, variant=f"{kb} {variant}", steps=f"1+{n_steps}",
                loss_step1=[round(x, 5) for x in loss1.tolist()],
                loss_wave=[round(x, 5) for x in loss2.tolist()], wave_s=f"{wave_s:.4f}",
                host_enqueue_s=f"{enqueue_s:.4f}",
                obj_iters_per_s=f"{N_OBJECTS * n_steps / wave_s:.2f}",
                peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                launches=by_dtype, other_kernels=others)
            if not (torch.isfinite(loss1[active]).all() and torch.isfinite(loss2[active]).all()
                    and (loss2[active] < loss1[active]).all()):
                raise AssertionError(f"quality {kb}: a loss is not finite or did not fall")
            if not (state.step[objs.active] == n_steps + 1).all():
                raise AssertionError(f"quality {kb}: an active slot skipped steps")
            want = {"bfloat16": n_steps + 1}
            if by_dtype != {kf: want, kb: want} or any(others.values()):
                raise AssertionError(f"quality {kb}: launches {by_dtype}, others {others}")
            launches[kb] = by_dtype[kb]["bfloat16"]
            if spec.snap_levels:
                psnrs, ious = render_held_out("12 quality", cam, objects, frames, objs, state,
                                              cfg, spec, gen, dev)
                k1 = dict(mxgrid_cuda.KERNELS["K1"].launches_by_dtype)
                say("12 quality", mean_psnr_db=f"{np.mean(psnrs):.3f}",
                    mean_mask_iou=f"{np.mean(ious):.4f}", views=len(psnrs), k1_by_dtype=k1)
                if k1.get("float32", 0) < 1:
                    raise AssertionError(f"quality render: K1 fp32 never launched: {k1}")
        del state
        torch.cuda.empty_cache()
    return launches


FP32_WAVE = 20
# (label, environment, backward): the fp32 train paths whose K4 / K8 run on
# the tensor cores split
FP32_PATHS = (("unsnapped", {"MX_SNAP": "0"}, "K4"),
              ("split", {"MX_SNAP": "0", "MX_FUSED": "0"}, "K8"))


def phase_fp32(dev) -> dict:
    """`TrainConfig(compute_dtype="float32")` at the flagship width through
    train_objects on the scene of phase 5, 1 + 20 steps on each of
    FP32_PATHS: the unsnapped ladder (K3/K4) and the split path (K7-K10).
    The losses must be finite and fall on every active slot; K4 / K8 must
    launch once a step, in fp32, as "tensor_core_split" and never as the
    scalar kernel (K10 stays scalar in fp32: its redesign is queued).
    Returns the K4 and K8 launches."""
    cfg = NerfConfig(train=TrainConfig(compute_dtype="float32"))
    _, _, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    active = objs.active.cpu()
    launches = {}
    for label, env, kb in FP32_PATHS:
        with environ(**env):
            spec = nerf.make_field_spec(cfg)
            route = mxgrid_cuda.kernel_path(spec)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
            mxgrid_cuda.reset_launch_counts()
            state = nerf.train_objects(state, objs, frames, cfg, spec, 1, generator=gen)
            loss1 = state.loss.cpu()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = nerf.train_objects(state, objs, frames, cfg, spec, FP32_WAVE, generator=gen)
            enqueue_s = time.perf_counter() - t0  # the host alone: the wave's launches queued
            torch.cuda.synchronize()
            wave_s = time.perf_counter() - t0
        loss2 = state.loss.cpu()
        by_variant = {k: dict(fn.launches_by_variant) for k, fn in mxgrid_cuda.KERNELS.items()
                      if fn.launches_by_variant}
        by_dtype = {k: dict(fn.launches_by_dtype) for k, fn in mxgrid_cuda.KERNELS.items()
                    if fn.launches}
        say("13 fp32", path=route, dtype="float32", steps=f"1+{FP32_WAVE}",
            loss_step1=[round(x, 5) for x in loss1.tolist()],
            loss_wave=[round(x, 5) for x in loss2.tolist()], wave_s=f"{wave_s:.4f}",
            step_ms=f"{1e3 * wave_s / FP32_WAVE:.4f}",
            host_enqueue_ms=f"{1e3 * enqueue_s / FP32_WAVE:.4f}",
            obj_iters_per_s=f"{N_OBJECTS * FP32_WAVE / wave_s:.2f}",
            launches_by_dtype=by_dtype, backward_launches_by_variant=by_variant)
        if not (torch.isfinite(loss1[active]).all() and torch.isfinite(loss2[active]).all()
                and (loss2[active] < loss1[active]).all()):
            raise AssertionError(f"fp32 {label}: a loss is not finite or did not fall")
        if not (state.step[objs.active] == FP32_WAVE + 1).all():
            raise AssertionError(f"fp32 {label}: an active slot skipped steps")
        want = {"float32 tensor_core_split": FP32_WAVE + 1}
        if by_variant.get(kb) != want or any(
                k in by_variant for k in ("K4", "K8") if k != kb):
            raise AssertionError(f"fp32 {label}: {kb} launches {by_variant} (want {want})")
        if any(n.get("bfloat16") for n in by_dtype.values()):
            raise AssertionError(f"fp32 {label}: a bf16 kernel ran: {by_dtype}")
        launches[kb] = by_variant[kb]["float32 tensor_core_split"]
        del state
        torch.cuda.empty_cache()
    return launches


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(label, phase_seconds=f"{time.perf_counter() - t0:.3f}")
    return out


def main() -> None:
    t_start = time.perf_counter()
    name, _ = phase_device()
    dev = "cuda"
    timed("2 build", phase_build)
    specs = kernel_specs()
    records = timed("3 kernels", phase_kernels, specs, dev)
    timed("3 kernels", time_backwards_in_turns, specs, records, dev)
    timed("3 kernels", time_unsnapped_forwards, specs, dev)
    records["K0"] = timed("3 kernels", check_points_gradient, specs, dev)
    timed("4 parity", phase_parity, dev)
    launches, _ = timed("5-6 train+render", phase_train_and_render, dev)
    root = tempfile.mkdtemp(prefix="romap_chip_smoke_")
    try:
        frames = write_world_dataset(root)
        launches.update(timed("7 offline", phase_offline, dev, root, frames))
        torch.cuda.empty_cache()
        launches.update(timed("8 unsnapped", phase_unsnapped_cli, dev, root))
        torch.cuda.empty_cache()
        launches.update(timed("9 online", phase_online, root))
        torch.cuda.empty_cache()
        timed("9b refine", phase_refine, dev)
        torch.cuda.empty_cache()
        timed("10 tcnn", phase_tcnn, dev)
        torch.cuda.empty_cache()
        timed("11 quality", phase_quality)
        torch.cuda.empty_cache()
        for kb, n in timed("12 quality", phase_quality_preset, dev).items():
            records[kb]["quality"]["launches"] = n
        torch.cuda.empty_cache()
        for kb, n in timed("13 fp32", phase_fp32, dev).items():
            records[kb]["fp32"]["launches"] = n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("total", seconds=f"{time.perf_counter() - t_start:.3f}")
    kernels = [
        dict(name=f"{k} {fn.__name__}", route="cuda", source=SOURCES[k],
             replaces=REPLACES[k], launches=launches[k], **records[k])
        for k, fn in mxgrid_cuda.KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
