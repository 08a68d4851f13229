"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version at the shapes of its path, then
drives the main paths through the port's public entry points: a 10-object
train wave with held-out renders, the offline runner with the CP-only
`fast` preset, the offline CLI with the unsnapped ladder, the online
socket server on the split kernels with a pose-refined test render, pose
refinement of perturbed views against a converged field, a hash-grid
(`tcnn`) train wave, the flagship-parity quality gate at its full
budget (3 seeds x 5000 steps), the `quality` preset's train waves,
folded and unsnapped, and fp32 train waves of the unsnapped, split and
folded paths (the flagship, `fast` and `quality`).

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
               P=131072, bf16 and fp32, then K1/K2, K3/K4, K5/K6 and K7/K8
               (and `quality`'s K1/K2 and K3/K4) in fp32 and bf16 at O=10 x
               P=131072, the shape their train steps launch them at: max
               abs / relative error beside the tolerance, the median
               kernel and plain times, the bound (the least time the card
               could take: bytes over its memory rate or operations over its
               peak, the larger), the peak memory of the check and, where a
               kernel has variants, the one the spec and dtype select (the
               flagship and `fast` bf16 backwards, folded and unsnapped,
               and K10 at the flagship and `quality` plane levels must take
               the tensor cores, `quality`'s K2 and K4 too; the bf16
               unsnapped forwards the three-axis kernel, the fp32 ones
               channel_split; the fp32 K2/K6 and K4/K8 the tensor cores on
               operands split into bf16 hi and lo parts, tensor_core_split);
               K9/K10 also in fp32 at O=10; `quality`'s bf16 K2 and K4, and
               the fp32 K4 (flagship, `quality`), K8, K2 (flagship,
               `quality`) and K6 (`fast`) at O=10 beside their bound, the
               scalar kernel (forced) timed in turns with them and its sums
               held to theirs; K9 and K10 beside
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
               first design (per_point, forced) timed in turns; then the
               hash grid's H1 and H2 (`tcnn`, room4's O=4 x 131,072, bf16
               and fp32) and H0 (1 x 196,608) against their twins, with
               their times, the twins' and the bound (`hash_work`); H1 and
               H2 again with the `ngp` spec (2^19 rows a level) at
               ngp.offline.room10's O=10 x 131,072, and with nerfacto's two
               proposal specs (5 x 2 levels at 2^17 rows) at its O=10 x
               1,048,576 and 393,216 (256 and 96 points a ray); H0 and H3
               at neus2.offline.room10's O=10 x 131,072; then the optimizer's
               update A1 on the `tcnn` and `ngp` trees at O=10 against the
               eager chain (its plain twin) on the card, bit for bit, with
               the times of both and A1's bound (36 B an element over the
               card's memory rate); then each network's last product, M1
               and M2 (`check_last_product`), at O=10 x 131,072 for out 3,
               4 and 16 (K = 64) and at nerfacto's proposal net (K = 16,
               out 1) at O=10 x 1,048,576, bf16 and fp32, against the
               plain twin and twice (M2's bits repeat), timed in turns
               with the twin, beside their bound and fp32 torch.bmm
               (`library_ms`)
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
               phase 5: 1 + 20 steps of train_objects through H1/H2,
               obj-iters/s, the losses falling, peak memory, H1/H2's
               launches (once a step each, no other kernel); then the same
               seed's 1 + 20 steps through the plain twins on the card: their
               losses beside the kernels', within LOSS_RTOL
 10 ngp       the same for instant-ngp's NeRF (NGP_CONFIG: density and colour
               networks over the rays' directions, 2^19 rows a level)
 10 nerfacto  the same for nerfstudio's nerfacto (NERFACTO_CONFIG: ngp's
               field at 4096 x 48 points behind two proposal fields at 4096
               x 256 and 96; H1/H2 three times a step, four networks)
 10b graph    the train step as a CUDA graph (`train_objects`) against eager
               steps, `tcnn` and `ngp`, 500-step waves at room10's sizes in
               turns (eager, graph, graph, eager): obj-iters/s, wave and host
               seconds, the graph's counters (every step of a graphed wave
               replayed), max_memory_allocated, losses
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
 13 fp32      TrainConfig(compute_dtype="float32") on the scene of phase
               5, 1 + 20 steps each, at the presets' full widths: the
               flagship with MX_SNAP=0 (K3/K4), with MX_FUSED=0 MX_SNAP=0
               (K7-K10) and folded (K1/K2), `fast` (K5/K6) and `quality`
               folded (K1/K2): losses falling, step ms, host enqueue ms,
               launches by dtype and, for the backwards, by variant: the
               path's K2, K4, K6 or K8 once a step as tensor_core_split,
               never scalar, and no bf16 kernel
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

from romap_tpu_torch.config import (  # noqa: E402
    EncodingConfig, NerfConfig, NetworkConfig, OptimizerConfig, TrainConfig)
from romap_tpu_torch.data import synthetic  # noqa: E402
from romap_tpu_torch.data.formats import write_dataset  # noqa: E402
from romap_tpu_torch.data.world import build_synthetic_world  # noqa: E402
from romap_tpu_torch.models import nerf  # noqa: E402
from romap_tpu_torch.ops import (  # noqa: E402
    cuda_lib, hashgrid_cuda, mlp, mlp_cuda, mxgrid, mxgrid_cuda, optimizer_cuda)
from romap_tpu_torch.ops.geometry import camera_rays, ray_aabb_intersect  # noqa: E402
from romap_tpu_torch.runtime import offline, pose_refine, server  # noqa: E402
from romap_tpu_torch.runtime.offline import OfflineRunner  # noqa: E402
from romap_tpu_torch.tools import quality_gate  # noqa: E402
from portbench.frozen import sdf as sdf_counts  # noqa: E402
from portbench.frozen.work import hash_work  # noqa: E402

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
    lib = cuda_lib.build_library()
    cuda_lib.library()
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
# K = 48); K1/K2, K3/K4, K5/K6 and K7/K8 also at their train steps' O=10,
# in fp32 and bf16 (there the plain twins hold dense [10, 131072, 465] fp32
# bases, 2.4 GB an axis); the `quality` preset's K1/K2 and K3/K4 at O=2 and
# at the O=10 of `[12]`'s train step (580-row ladder x K = 64: 3.0 GB an
# axis), both dtypes. A kernel's record in the JSON line is its last bf16
# check here: its main path's; the `quality` checks go into the record's
# "quality" entry, the fp32 checks at O=10 into its (or its "quality"
# entry's) "fp32" entry.
BOTH = (torch.bfloat16, torch.float32)
CHECKS = (
    ("folded", "K1", "K2", KERNEL_O, BOTH),
    ("folded", "K1", "K2", N_OBJECTS, (torch.float32, torch.bfloat16)),
    ("unsnapped", "K3", "K4", KERNEL_O, BOTH),
    ("folded_cp", "K5", "K6", KERNEL_O, BOTH),
    ("folded_cp", "K5", "K6", N_OBJECTS, (torch.float32, torch.bfloat16)),
    ("unsnapped_cp", "K7", "K8", KERNEL_O, BOTH),
    ("unsnapped_split", "K7", "K8", KERNEL_O, BOTH),
    ("unsnapped_split", "K9", "K10", KERNEL_O, BOTH),
    ("quality_split", "K9", "K10", KERNEL_O, BOTH),
    ("quality", "K1", "K2", KERNEL_O, BOTH),
    ("quality_unsnapped", "K3", "K4", KERNEL_O, BOTH),
    ("quality", "K1", "K2", N_OBJECTS, (torch.float32, torch.bfloat16)),
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
    split.update({f"{path} folded": mxgrid_cuda.folded_variant(specs[path], torch.float32)
                  for path in ("folded", "folded_cp", "quality")})
    if set(split.values()) != {"tensor_core_split"}:  # fp32 K2/K4/K6/K8 on the tensor cores
        raise AssertionError(f"fp32 K2/K4/K6/K8 variants: {split}")
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
            if dtype == torch.float32 and o == N_OBJECTS and kf != "K9":  # the table kernels
                if not path.startswith("quality"):
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
    for (path, kb), rec in fp32_bwd.items():  # the fp32 backwards beside the bf16 record
        (records[kb]["quality"] if path.startswith("quality") else records[kb])["fp32"] = rec
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
                    cuda_lib.reset_launch_counts()
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
# bf16 K2 and K4, then on the tensor cores split the fp32 K4 (flagship
# unsnapped), K8 (the split path's ladder), `quality`'s K4, K2 (flagship),
# `quality`'s K2 and K6 (`fast`)
TURNS = (("quality", "K1", "K2", "folded_variant", torch.bfloat16, ("quality",)),
         ("quality_unsnapped", "K3", "K4", "unsnapped_variant", torch.bfloat16, ("quality",)),
         ("unsnapped", "K3", "K4", "unsnapped_variant", torch.float32, ("fp32",)),
         ("unsnapped_split", "K7", "K8", "unsnapped_variant", torch.float32, ("fp32",)),
         ("quality_unsnapped", "K3", "K4", "unsnapped_variant", torch.float32,
          ("quality", "fp32")),
         ("folded", "K1", "K2", "folded_variant", torch.float32, ("fp32",)),
         ("quality", "K1", "K2", "folded_variant", torch.float32, ("quality", "fp32")),
         ("folded_cp", "K5", "K6", "folded_variant", torch.float32, ("fp32",)))


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
        new = getattr(mxgrid_cuda, selector)(spec, dtype, planes=kb not in ("K6", "K8"))
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


# H0-H2 (csrc/hashgrid.cu) against their twins, relative to each tensor's
# largest entry: H1 in fp32 differs only in the order of its 8-term sum;
# in bf16 both round the same fp32 blend once, one bf16 step (2^-8); H2's
# atomics add in a run-dependent order (hundreds of terms a coarse row),
# then one cast; H0 sums the same fp32 products in another order.
# H3's dg sums 8 corner products in fp32 and rounds once (one bf16 step),
# its table gradient adds with H2's atomics.
HASH_TOL = {"H1": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
            "H2": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
            "H0": {torch.float32: 1e-4, torch.bfloat16: 1e-4},
            "H3": {torch.float32: 1e-4, torch.bfloat16: 1e-2}}
HASH_O = 4  # room4's slots (portbench's tcnn.offline.room4), 4096 x 32 points each
# instant-ngp's NeRF, portbench/configs/ngp.json: 2^19 rows a level, five
# dense levels, the table's fp32 gradient 488 MB at O = 10 (far past L2)
NGP_CONFIG = NerfConfig(encoding=EncodingConfig(kind="hashgrid", log2_hashmap_size=19),
                        network=NetworkConfig(output_dims=16, sh_degree=4))
NGP_O = 10  # ngp.offline.room10's slots, 4096 x 32 points each
# nerfstudio's nerfacto, portbench/configs/nerfacto.json: ngp's grid and
# density network, two proposal fields (5 x 2 levels at 2^17 rows, to 128
# and 256, 10 -> 16 -> 1 nets) at 4096 x 256 and 4096 x 96 points an object
# a step, the field at 4096 x 48; the published optimizer (Adam's betas 0.9
# and 0.999, no weight decay, the rate to 1e-4 over 200k steps)
NERFACTO_CONFIG = NerfConfig(
    encoding=EncodingConfig(kind="hashgrid", log2_hashmap_size=19),
    network=NetworkConfig(output_dims=16, sh_degree=4, field="nerfacto", appearance_frames=80),
    optimizer=OptimizerConfig(beta2=0.999, l2_reg=0.0, decay_start=1, decay_interval=1,
                              decay_base=0.01 ** (1 / 200000)),
    train=TrainConfig(samples_per_ray=48))
PROPOSAL_P = tuple(4096 * n for n in NERFACTO_CONFIG.train.proposal_samples)


def ray_points(o: int, p: int, g: torch.Generator, per_ray: int = 32) -> torch.Tensor:
    """[O, P, 3]: `per_ray` ordered samples on each of P / per_ray chords
    of the unit cube, the order of a train step's points (rays x
    samples)."""
    a, b = (torch.rand((o, p // per_ray, 1, 3), generator=g) for _ in range(2))
    s = torch.linspace(0, 1, per_ray)[None, None, :, None]
    return (a + s * (b - a)).reshape(o, p, 3)


def check_hash_grid(dev) -> dict:
    """H1 and H2 with the `tcnn` spec at room4's shape, O=4 x 131,072
    points along rays, bf16 (the train step) and fp32 (renders and meshes),
    then H0 at one view's refinement points (1 x 196,608, fp32 and bf16),
    also along rays; then H1 and H2 with the `ngp` spec (instant-ngp's
    2^19 rows a level) at ngp.offline.room10's shape, O=10 x 131,072, bf16
    and fp32, and H0 and H3 (an SDF field's normal and its backward) at
    neus2.offline.room10's, the same; then H1 and H2 with each proposal
    spec of nerfacto's (5 levels x 2 features, 2^17 rows a level, dense
    coarse levels hit by 256 or 96 points a ray) at nerfacto.offline.room10's
    shape, O=10 x 1,048,576 and 393,216: the largest
    error against the plain twin beside its tolerance, the median device
    time of the wrapper (H2's and H3's: the buffer's zeroing, the kernel and
    the cast), of the twin, and the bound (`hash_work`, `frozen/sdf.py`'s
    counts: the benchmark's frozen bytes and operations for its encode
    rooflines). Returns {field: {kernel: {dtype: record}}}."""
    tcnn = nerf.make_field_spec(NerfConfig(encoding=EncodingConfig.preset("tcnn")))
    ngp = nerf.make_field_spec(NGP_CONFIG)
    props = mlp.proposal_specs(NERFACTO_CONFIG.network)
    records = {"tcnn": {"H0": {}, "H1": {}, "H2": {}}, "ngp": {"H1": {}, "H2": {}},
               "neus2": {"H0": {}, "H3": {}},
               **{f"nerfacto prop{k}": {"H1": {}, "H2": {}} for k in range(len(props))}}
    shapes = (("tcnn", tcnn, HASH_O, KERNEL_P, ("H1", "H2")),
              ("tcnn", tcnn, 1, REFINE_P, ("H0",)),
              ("ngp", ngp, NGP_O, KERNEL_P, ("H1", "H2")),
              ("neus2", ngp, NGP_O, KERNEL_P, ("H0", "H3")),
              *((f"nerfacto prop{k}", spec, NGP_O, p, ("H1", "H2"))
                for k, (spec, p) in enumerate(zip(props, PROPOSAL_P))))
    for field, spec, o, p, names in shapes:
        per_ray = p // 4096 if field.startswith("nerfacto") else 32
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            g = torch.Generator(device="cpu").manual_seed(5)
            pts = ray_points(o, p, g, per_ray).to(dev)
            table = torch.randn((o, spec.total_params, spec.n_features), generator=g)
            table = table.to(dev, dtype)
            gout = torch.randn((o, p, spec.n_output_dims), generator=g).to(dev, dtype)
            v = torch.randn((o, p, 3), generator=g).to(dev)
            calls = {"H1": ("forward", (pts, table)), "H2": ("backward", (pts, gout)),
                     "H0": (None, (pts, table, gout)), "H3": (None, (pts, table, gout, v))}
            sdf_work = {"H0": sdf_counts.points_work, "H3": sdf_counts.normal_backward_work}
            for name in names:
                direction, args = calls[name]
                fn = hashgrid_cuda.KERNELS[name]
                plain = getattr(hashgrid_cuda, fn.__name__ + "_plain")
                got, want = fn(*args, spec), plain(*args, spec)
                torch.cuda.synchronize()
                got, want = (list(x) if isinstance(x, tuple) else [x] for x in (got, want))
                abs_err, rel_err = errors(got, want)
                tol = HASH_TOL[name][dtype]
                ms = median_ms(lambda: fn(*args, spec))
                plain_ms = median_ms(lambda: plain(*args, spec), 3)
                rec = dict(shape=f"{o}x{p}", max_abs_err=abs_err, max_rel_err=rel_err,
                           rel_tol=tol, ms=ms, plain_ms=plain_ms)
                sizes = (spec.n_levels, spec.n_features, spec.total_params, dname, o, p)
                counted = (hash_work(direction, *sizes) if direction
                           else sdf_work[name](*sizes) if field == "neus2" else None)
                if counted:
                    nbytes, ops = counted
                    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
                    rec.update(bound_ms=1e3 * max(t_bytes, t_ops),
                               bound_by="bytes" if t_bytes >= t_ops else "operations")
                records[field][name][dname] = rec
                say("3 kernels", kernel=name, spec=field, dtype=dname,
                    **{k: (f"{v:.3e}" if "err" in k or k == "rel_tol" else f"{v:.4f}")
                       if isinstance(v, float) else v for k, v in rec.items()})
                if not rel_err <= tol or not all(torch.isfinite(t).all() for t in got):
                    raise AssertionError(f"{name} {dname}: relative error {rel_err} above {tol}")
                del got, want
            del pts, table, gout, v, args
            torch.cuda.empty_cache()
    return records


def check_optimizer(dev) -> dict:
    """A1 (`optimizer_cuda.update`: the optimizer's whole update in one pass
    over each leaf) with the `tcnn` and `ngp` trees at O=10, every slot
    active, a NaN planted in slot 0's table gradient: its outputs against
    the eager chain's (`update_plain` on the card) bit for bit, the median
    device time of each (A1's: the wrapper, with its [O] vectors and the
    zeroed flags), A1's launches a call and its bound (an element reads g,
    p, mu, nu and e and writes p, mu, nu and e: 36 B of fp32 over
    PEAK_BYTES_PER_S). Returns {field: record}."""
    records = {}
    for field, cfg in (("tcnn", NerfConfig(encoding=EncodingConfig.preset("tcnn"))),
                       ("ngp", NGP_CONFIG)):
        spec = nerf.make_field_spec(cfg)
        g = torch.Generator(device=dev).manual_seed(7)
        state = nerf.init_train_state(g, N_OBJECTS, cfg, spec, device=dev)
        rnd = lambda a, scale: scale * torch.randn(a.shape, generator=g, device=dev)
        state = state._replace(
            ema=pytree.tree_map(lambda a: a + rnd(a, 1e-2), state.params),
            opt=state.opt._replace(mu=pytree.tree_map(lambda a: rnd(a, 1e-3), state.params),
                                   nu=pytree.tree_map(lambda a: rnd(a, 1e-3) ** 2,
                                                      state.params)))
        grads = pytree.tree_map(lambda a: rnd(a, 1e-3), state.params)
        grads["table"][0, -1, 0] = float("nan")
        ok = torch.ones(N_OBJECTS, dtype=torch.bool, device=dev)
        cuda_lib.reset_launch_counts()
        got = optimizer_cuda.update(grads, state, ok, cfg)
        torch.cuda.synchronize()
        launches = optimizer_cuda.update.launches
        want = optimizer_cuda.update_plain(grads, state, ok, cfg)
        pairs = list(zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))
        unequal = sum(not torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                      b.view(torch.int32) if b.is_floating_point() else b)
                      for a, b in pairs)
        n = sum(a.numel() for a in pytree.tree_leaves(state.params))
        ms = median_ms(lambda: optimizer_cuda.update(grads, state, ok, cfg))
        plain_ms = median_ms(lambda: optimizer_cuda.update_plain(grads, state, ok, cfg), 3)
        rec = dict(objects=N_OBJECTS, leaves=len(pytree.tree_leaves(state.params)), params=n,
                   launches=launches, unequal_leaves=unequal, ms=ms, plain_ms=plain_ms,
                   bound_ms=1e3 * 36 * n / PEAK_BYTES_PER_S, bound_by="bytes",
                   found_nan=got[2].found_nan["table"].tolist())
        records[field] = rec
        say("3 kernels", kernel="A1", spec=field,
            **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in rec.items()})
        if unequal or launches != 1 or rec["found_nan"] != [True] + [False] * (N_OBJECTS - 1):
            raise AssertionError(f"A1 {field}: {unequal} leaves differ from the eager chain's, "
                                 f"{launches} launches, found_nan {rec['found_nan']}")
        del state, grads, got, want, pairs
        torch.cuda.empty_cache()
    return records


# (network, out width, K, points an object): the cells' last products at
# 4096 x 32 points, and nerfacto's first proposal net (16 -> 1) at its
# 4096 x 256
LAST_PRODUCTS = (("tcnn head", 4, 64, KERNEL_P), ("ngp rgb", 3, 64, KERNEL_P),
                 ("ngp density", 16, 64, KERNEL_P), ("nerfacto proposal", 1, 16, PROPOSAL_P[0]))


def check_last_product(dev) -> dict:
    """M1 and M2 (`mlp_cuda.forward`, `backward`: each network's last
    product and both its gradients) at O=10 x 131,072 points, K = 64, for
    the cells' output widths, and at nerfacto's proposal net (K = 16, out
    1) at O=10 x 1,048,576, bf16 and fp32: their outputs against the
    plain twin's (max error over the largest value: fp32 sums in another
    order, bf16 outputs rounded once after them), M2 twice (the same bits),
    and the median device time of each, in turns with the twin (kernel,
    twin, twin, kernel), beside its bound (h, dy and the outputs once over
    the card's memory rate, or 2 K N (M1) and 4 K N (M2) operations a point
    over its fp32 rate, the larger) and fp32 `torch.bmm` on fp32 operands
    (`library_ms`: the product, and the backward's two, the port no longer
    calls). Returns {"<net> <dtype>": record}."""
    records = {}
    o = N_OBJECTS
    for net, n, k, p in LAST_PRODUCTS:
        for dtype in BOTH:
            g = torch.Generator(device=dev).manual_seed(11 + n)
            h = torch.relu(torch.randn((o, p, k), generator=g, device=dev)).to(dtype)
            w = (torch.randn((o, k, n), generator=g, device=dev) / 8).to(dtype)
            dy = 1e-3 * torch.randn((o, p, n), generator=g, device=dev)
            cuda_lib.reset_launch_counts()
            got = (mlp_cuda.forward(h, w), *mlp_cuda.backward(h, w, dy))
            torch.cuda.synchronize()
            launches = {kn: c for kn, c in cuda_lib.launch_counts().items() if c}
            again = (mlp_cuda.forward(h, w), *mlp_cuda.backward(h, w, dy))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            want = (mlp_cuda.forward_plain(h, w), *mlp_cuda.backward_plain(h, w, dy))
            err = {name: errors([a], [b])[1] for name, a, b in zip(("out", "dh", "dw"), got, want)}
            h32, w32 = h.float(), w.float()
            fwd = lambda: mlp_cuda.forward(h, w)
            bwd = lambda: mlp_cuda.backward(h, w, dy)
            turns = (("M1", fwd), ("plain M1", lambda: mlp_cuda.forward_plain(h, w)),
                     ("plain M2", lambda: mlp_cuda.backward_plain(h, w, dy)), ("M2", bwd))
            times = {}
            for name, fn in turns + turns[::-1]:
                times.setdefault(name, []).append(median_ms(fn))
            ms = {key: statistics.mean(v) for key, v in times.items()}
            library = {"M1": median_ms(lambda: torch.bmm(h32, w32)),
                       "M2": median_ms(lambda: (torch.bmm(dy, w32.transpose(1, 2)),
                                                torch.bmm(h32.transpose(1, 2), dy)))}
            sz = h.element_size()
            nbytes = {"M1": o * p * (k * sz + n * 4), "M2": o * p * (2 * k * sz + n * 4)}
            ops = {"M1": 2 * o * p * k * n, "M2": 4 * o * p * k * n}
            bound = {key: 1e3 * max(nbytes[key] / PEAK_BYTES_PER_S, ops[key] / PEAK_FP32_PER_S)
                     for key in nbytes}
            rec = dict(objects=o, points=p, k=k, n=n, launches=launches, same_bits=same,
                       rel_err=err, **{f"{key}_ms": ms[key] for key in ("M1", "M2")},
                       **{f"{key}_plain_ms": ms["plain " + key] for key in ("M1", "M2")},
                       **{f"{key}_library_ms": library[key] for key in library},
                       **{f"{key}_bound_ms": bound[key] for key in bound},
                       bound_by={key: "bytes" if nbytes[key] / PEAK_BYTES_PER_S
                                 >= ops[key] / PEAK_FP32_PER_S else "fp32" for key in nbytes})
            label = f"{net} {str(dtype).split('.')[1]}"
            records[label] = rec
            say("3 kernels", kernel="M1/M2", spec=json.dumps(label),
                **{key: f"{v:.4f}" if isinstance(v, float) else json.dumps(v)
                   for key, v in rec.items()})
            tol = REL_TOL[dtype]
            if (not same or launches != {"M1": 1, "M2": 2}
                    or any(e > tol for e in err.values())):
                raise AssertionError(f"M1/M2 {label}: same bits {same}, launches {launches}, "
                                     f"errors {err} (tolerance {tol})")
            del h, w, dy, got, again, want, h32, w32
            torch.cuda.empty_cache()
    return records


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

    cuda_lib.reset_launch_counts()
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
    cuda_lib.reset_launch_counts()
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
        cuda_lib.reset_launch_counts()
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
        cuda_lib.reset_launch_counts()
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
    cuda_lib.reset_launch_counts()
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


# phase 10: the kernels' losses against the twins' from the same seed, 21
# bf16 steps. The two differ by the order of fp32 sums before each bf16
# rounding (one bf16 step, 2^-8, in some features and gradient entries);
# Adam (eps 1e-15) moves an entry by about the full rate whatever its
# gradient's size, so an entry whose gradient is at rounding level can move
# the other way: the losses part slowly, not by rounding alone (7.6e-5 at
# step 21 on an H100). instant-ngp's field parts faster (1.9e-3 at step 21
# on an H100): its 2^19 rows take more such entries a step, and their
# changes pass through two networks; a wrong H2 reads 0.04 or more in three
# steps (portbench's half-batch fault). nerfacto's parts by 1.4e-3 and
# 3.6e-3 at step 21 in two runs on an H100: its samples follow the proposal
# fields' weights, which the same entries move.
LOSS_RTOL = {"tcnn": 2e-3, "ngp": 5e-3, "nerfacto": 1e-2}


@contextlib.contextmanager
def hash_twins():
    """The hash grid's wrappers replaced by their plain twins, on any
    device, for the block (`hashgrid_cuda._Encode` looks them up by name)."""
    saved = {name: getattr(hashgrid_cuda, name)
             for name in ("forward", "table_gradient", "points_gradient")}
    for name in saved:
        setattr(hashgrid_cuda, name, getattr(hashgrid_cuda, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(hashgrid_cuda, name, fn)


def phase_hash_field(dev, field: str, cfg: NerfConfig) -> float:
    """A hash-grid field (H1 forward, H2 the table's gradient) through
    train_objects on the card: the scene of phase 5, 10 objects x 4096 x 32,
    1 + 20 steps, H1/H2 and the optimizer's A1 once a step, each network's
    M1 once and M2 twice (with its sum), and no other kernel; then the same
    seed's 1 + 20 steps through the encode's plain twins on the card (A1,
    M1 and M2 still run; eager steps, drawn through a replay source: the
    twins put constants on the card at each call, which a CUDA graph's
    capture cannot take), whose losses must agree within LOSS_RTOL. `field`
    names the phase: `tcnn` (RO-MAP's), `ngp` (instant-ngp's two networks
    over a 2^19 table) or `nerfacto` (the same field at 48 points a ray
    behind two proposal fields: H1, H2 three times a step, M1 once and M2
    twice for each of four networks)."""
    phase = f"10 {field}"
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    active = objs.active.cpu()

    def run(eager=False):
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
        draw = (dict(uniforms=lambda: nerf.draw_uniforms(gen, N_OBJECTS, cfg)) if eager
                else dict(generator=gen))
        state = nerf.train_objects(state, objs, frames, cfg, spec, 1, **draw)
        loss1 = state.loss.cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = nerf.train_objects(state, objs, frames, cfg, spec, 20, **draw)
        torch.cuda.synchronize()
        return loss1, state.loss.cpu(), time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    loss1, loss2, wave_s = run()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: n for k, n in cuda_lib.launch_counts().items() if n}
    by_dtype = {k: dict(hashgrid_cuda.KERNELS[k].launches_by_dtype)
                for k in launches if k in hashgrid_cuda.KERNELS}
    cuda_lib.reset_launch_counts()
    with hash_twins():
        plain1, plain2, plain_s = run(eager=True)
    plain_launches = {k: n for k, n in cuda_lib.launch_counts().items() if n}
    gap = max(float(((a - b).abs() / b.abs())[active].max())
              for a, b in ((loss1, plain1), (loss2, plain2)))
    rate = N_OBJECTS * 20 / wave_s
    say(phase, levels=spec.n_levels, table_rows=spec.total_params, features=spec.n_features,
        loss_step1=[round(x, 5) for x in loss1.tolist()],
        loss_step21=[round(x, 5) for x in loss2.tolist()], wave_s=f"{wave_s:.4f}",
        obj_iters_per_s=f"{rate:.2f}", peak_mem_gib=f"{peak_gib:.3f}", kernels=launches,
        by_dtype=by_dtype)
    say(phase, twins="plain", loss_step1=[round(x, 5) for x in plain1.tolist()],
        loss_step21=[round(x, 5) for x in plain2.tolist()], wave_s=f"{plain_s:.4f}",
        obj_iters_per_s=f"{N_OBJECTS * 20 / plain_s:.2f}", kernels=plain_launches,
        max_rel_loss_gap=f"{gap:.3e}", rel_tol=LOSS_RTOL[field])
    if not (torch.isfinite(loss2[active]).all() and (loss2[active] < loss1[active]).all()):
        raise AssertionError(f"{field}: a loss is not finite or did not fall")
    props = len(cfg.network.proposal_max_resolutions) if field == "nerfacto" else 0
    nets = (2 if cfg.network.sh_degree > 0 else 1) + props
    mlp = {"M1": 21 * nets, "M2": 2 * 21 * nets}
    grids = 21 * (1 + props)
    if (launches != {"H1": grids, "H2": grids, "A1": 21, **mlp}
            or plain_launches != {"A1": 21, **mlp}):
        raise AssertionError(f"{field}: launches {launches}, with the twins {plain_launches} "
                             "(want H1, H2 once a grid and step, A1 once a step and M1, M2 as "
                             "the networks need, and no H1/H2 with the twins)")
    if not gap <= LOSS_RTOL[field]:
        raise AssertionError(f"{field}: the kernels' losses part from the twins' by {gap}")
    return rate


def phase_quality() -> None:
    """The flagship-parity gate (`romap_tpu_torch.tools.quality_gate`, the
    port's scripts/quality_gate.py) at its full budget: seeds 0-2, 5000 bf16
    steps each through K1/K2, the held-out PSNR of each (K1 in fp32), the
    3-seed mean within 0.5 dB of the hash-grid anchors' mean. The record goes
    to build/, not into the tree; a failed gate fails the script."""
    out = os.path.join(ROOT, "build", "quality_torch.json")
    cuda_lib.reset_launch_counts()
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
            cuda_lib.reset_launch_counts()
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
# (label, encoding, environment, backward, the backward's record entry):
# the fp32 train paths, each at its preset's full width, whose table
# backward runs on the tensor cores split: the unsnapped ladder (K3/K4), the
# split path (K7-K10), the folded flagship (K1/K2), `fast` (K5/K6) and
# `quality` folded (K1/K2)
FP32_PATHS = (("unsnapped", EncodingConfig(), {"MX_SNAP": "0"}, "K4", ("fp32",)),
              ("split", EncodingConfig(), {"MX_SNAP": "0", "MX_FUSED": "0"}, "K8", ("fp32",)),
              ("folded", EncodingConfig(), {}, "K2", ("fp32",)),
              ("fast", EncodingConfig.preset("fast"), {}, "K6", ("fp32",)),
              ("quality", EncodingConfig.preset("quality"), {}, "K2", ("quality", "fp32")))
TABLE_BACKWARDS = ("K2", "K4", "K6", "K8")


def phase_fp32(dev) -> list:
    """`TrainConfig(compute_dtype="float32")` through train_objects on the
    scene of phase 5, 1 + 20 steps on each of FP32_PATHS, nothing cut. The
    losses must be finite and fall on every active slot; the path's table
    backward (K2, K4, K6 or K8) must launch once a step, in fp32, as
    "tensor_core_split", never as the scalar kernel, and no other table
    backward and no bf16 kernel may run (K10 stays scalar in fp32: its
    redesign is queued). Returns (backward, record entry, launches) of each
    path."""
    _, _, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    active = objs.active.cpu()
    launches = []
    for label, encoding, env, kb, entry in FP32_PATHS:
        cfg = NerfConfig(encoding=encoding, train=TrainConfig(compute_dtype="float32"))
        with environ(**env):
            spec = nerf.make_field_spec(cfg)
            route = mxgrid_cuda.kernel_path(spec)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
            cuda_lib.reset_launch_counts()
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
        say("13 fp32", path=route, preset=label, dtype="float32", steps=f"1+{FP32_WAVE}",
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
                k in by_variant for k in TABLE_BACKWARDS if k != kb):
            raise AssertionError(f"fp32 {label}: {kb} launches {by_variant} (want {want})")
        if any(n.get("bfloat16") for n in by_dtype.values()):
            raise AssertionError(f"fp32 {label}: a bf16 kernel ran: {by_dtype}")
        launches.append((kb, entry, by_variant[kb]["float32 tensor_core_split"]))
        del state
        torch.cuda.empty_cache()
    return launches


GRAPH_WAVE = 500  # room10's steps a wave


def phase_train_graph(dev) -> dict:
    """The train step as a CUDA graph against eager steps, for `tcnn` and
    `ngp` at room10's sizes (O = 10 x 4096 rays x 32 samples, the scene of
    phase 5): 500-step waves from one state, in turns eager, graph, graph,
    eager, after a warm-up of each (the graph's: a first call of 2 steps, 1
    eager, the capture, 1 replay). Eager is `_object_train_step` step by
    step, as `train_objects` ran before the graph. Each wave: obj-iters/s,
    its seconds and the host's (until the call returned), the counters
    (a graphed wave must replay all 500 steps), max_memory_allocated and
    the last losses. Returns {field: {path: [obj-iters/s, ...]}}."""
    _, _, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    n_active = int(objs.active.sum())
    rates = {}
    for field, cfg in (("tcnn", NerfConfig(encoding=EncodingConfig.preset("tcnn"))),
                       ("ngp", NGP_CONFIG)):
        spec = nerf.make_field_spec(cfg)
        state0 = nerf.init_train_state(torch.Generator(device=dev).manual_seed(cfg.seed),
                                       N_OBJECTS, cfg, spec, device=dev)
        gens = {p: torch.Generator(device=dev).manual_seed(cfg.seed + 1)
                for p in ("eager", "graph")}

        def eager(state, n):
            for _ in range(n):
                u = nerf.draw_uniforms(gens["eager"], N_OBJECTS, cfg)
                state = nerf._object_train_step(state, frames, objs, cfg, spec, u, False)
            return state

        def graph(state, n):
            return nerf.train_objects(state, objs, frames, cfg, spec, n, generator=gens["graph"])

        run = {"eager": eager, "graph": graph}
        for path in run:
            nerf.reset_train_graph_counts()
            run[path](state0, 2).loss.cpu()
            say("10b graph", field=field, warm_up=path, counts=nerf.train_graph_counts())
        rates[field] = {"eager": [], "graph": []}
        for path in ("eager", "graph", "graph", "eager"):
            nerf.reset_train_graph_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run[path](state0, GRAPH_WAVE)
            host_s = time.perf_counter() - t0
            loss = out.loss.cpu()
            wave_s = time.perf_counter() - t0
            counts = nerf.train_graph_counts()
            rate = n_active * GRAPH_WAVE / wave_s
            rates[field][path].append(rate)
            say("10b graph", field=field, path=path, obj_iters_per_s=f"{rate:.2f}",
                wave_s=f"{wave_s:.4f}", host_s=f"{host_s:.4f}", counts=counts,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                loss=[round(x, 5) for x in loss.tolist()])
            if not torch.isfinite(loss).all():
                raise AssertionError(f"{field} {path}: a loss is not finite")
            if path == "graph" and counts["train_graph_replays"] != GRAPH_WAVE:
                raise AssertionError(f"{field}: a graphed wave replayed {counts}")
        med = {p: statistics.median(v) for p, v in rates[field].items()}
        say("10b graph", field=field, median_eager=f"{med['eager']:.2f}",
            median_graph=f"{med['graph']:.2f}", ratio=f"{med['graph'] / med['eager']:.3f}")
        nerf._graph = None
        del state0
        torch.cuda.empty_cache()
    return rates


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
    hash_records = timed("3 kernels", check_hash_grid, dev)
    optimizer_records = timed("3 kernels", check_optimizer, dev)
    last_product_records = timed("3 kernels", check_last_product, dev)
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
        timed("10 tcnn", phase_hash_field, dev, "tcnn",
              NerfConfig(encoding=EncodingConfig.preset("tcnn")))
        torch.cuda.empty_cache()
        timed("10 ngp", phase_hash_field, dev, "ngp", NGP_CONFIG)
        torch.cuda.empty_cache()
        timed("10 nerfacto", phase_hash_field, dev, "nerfacto", NERFACTO_CONFIG)
        torch.cuda.empty_cache()
        timed("10b graph", phase_train_graph, dev)
        torch.cuda.empty_cache()
        timed("11 quality", phase_quality)
        torch.cuda.empty_cache()
        for kb, n in timed("12 quality", phase_quality_preset, dev).items():
            records[kb]["quality"]["launches"] = n
        torch.cuda.empty_cache()
        for kb, entry, n in timed("13 fp32", phase_fp32, dev):
            rec = records[kb]
            for key in entry:
                rec = rec[key]
            rec["launches"] = n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("total", seconds=f"{time.perf_counter() - t_start:.3f}")
    kernels = [
        dict(name=f"{k} {fn.__name__}", route="cuda", source=SOURCES[k],
             replaces=REPLACES[k], launches=launches[k], **records[k])
        for k, fn in mxgrid_cuda.KERNELS.items()
    ]
    kernels += [dict(name=f"{k} {fn.__name__}", route="cuda", source=CSRC + "hashgrid.cu",
                     replaces=("none: the JAX package has no SDF field" if k == "H3"
                               else "romap_tpu/ops/hashgrid.py:108"),
                     by_dtype=hash_records["tcnn"].get(k, {}),
                     **{f: r[k] for f, r in hash_records.items() if f != "tcnn" and k in r})
                for k, fn in hashgrid_cuda.KERNELS.items()]
    kernels.append(dict(name="A1 update", route="cuda", source=CSRC + "optimizer.cu",
                        replaces="none: the optax chain of romap_tpu/models/nerf.py",
                        by_field=optimizer_records))
    kernels.append(dict(name="M1 forward, M2 backward", route="cuda", source=CSRC + "mlp.cu",
                        replaces="none: the einsum of romap_tpu/ops/mlp.py:45 (XLA)",
                        by_shape=last_product_records))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
