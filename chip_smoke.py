"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version at the flagship shapes, then drives
the main path (a 10-object train wave and a held-out render per object)
through the port's public entry points.

Usage: python3 chip_smoke.py     (needs one CUDA device; exits non-zero on
any failure and prints no result line then)

Phases, one line each:
  1 device   card name and power limit (nvidia-smi), TF32 switched off
  2 build    nvcc build of romap_tpu_torch/csrc into build/romap_tpu_torch
  3 kernels  K1 and K2 vs their plain versions, O=2 x P=131072, bf16 and
             fp32: max abs / relative error beside the tolerance, and the
             median kernel and plain times
  4 parity   one tiny train step, fp32, kernels on the card vs the plain
             path on the CPU, from the same state and uniforms
  5 train    build_synthetic_world(10, 16, 128) + NerfConfig(): init, 1
             step, then a timed 50-step wave (obj-iters/s); launch counts
             of K1 and K2 on that path
  6 render   one held-out bbox view per object through render_rays (fp32):
             PSNR on object pixels and mask IoU
then a JSON line with each kernel's record, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from romap_tpu.config import EncodingConfig, NerfConfig, TrainConfig  # noqa: E402
from romap_tpu.data import synthetic  # noqa: E402
from romap_tpu_torch.data.world import build_synthetic_world  # noqa: E402
from romap_tpu_torch.models import nerf  # noqa: E402
from romap_tpu_torch.ops import mxgrid, mxgrid_cuda  # noqa: E402
from romap_tpu_torch.ops.geometry import camera_rays, ray_aabb_intersect  # noqa: E402

N_OBJECTS, WAVE = 10, 50
KERNEL_O, KERNEL_P = 2, 4096 * 32
# Kernel vs plain: fp32 differs only in summation order (and K2's atomic
# order), bf16 additionally by one rounding step of a stored value.
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SOURCE = "romap_tpu_torch/csrc/mxgrid_folded.cu"
PALLAS = "romap_tpu/ops/mxgrid_pallas.py"


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def median_ms(fn, reps: int = 7) -> float:
    """Median time of one call, CUDA events around each, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def flagship_inputs(spec, dtype, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    (ru, rv, kp), = spec.plane_specs
    o, p = KERNEL_O, KERNEL_P
    pts = torch.rand((o, p, 3), generator=g) * (1 + 4e-3) - 2e-3  # edges included
    tables = mxgrid.init_mxgrid(g, spec, o)
    w_eff = mxgrid.fold_lines(tables["lines"], spec)
    gout = torch.randn((o, p, spec.n_output_dims), generator=g)
    to = lambda t: t.to(device=dev, dtype=dtype).contiguous()
    return (pts.to(dev), to(w_eff), to(tables["planes"][0]), to(tables["plane_lines"][0]),
            to(gout))


def phase_kernels(spec, dev) -> dict:
    """K1 and K2 vs their plain versions; returns the bf16 (train dtype)
    records for the JSON line."""
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = REL_TOL[dtype]
        pts, w_eff, planes, plines, gout = flagship_inputs(spec, dtype, dev, seed=3)
        fwd = lambda: mxgrid_cuda.folded_fused_forward(pts, w_eff, planes, plines, spec)
        fwd_plain = lambda: mxgrid_cuda.folded_fused_forward_plain(pts, w_eff, planes, plines, spec)
        got = fwd()
        want = fwd_plain()
        torch.cuda.synchronize()
        k1_abs, k1_rel = errors(got, want)
        k1_ms, k1_plain_ms = median_ms(fwd), median_ms(fwd_plain)
        say("3 kernels", kernel="K1", dtype=str(dtype).split(".")[1], max_abs_err=f"{k1_abs:.3e}",
            max_rel_err=f"{k1_rel:.3e}", rel_tol=tol, ms=f"{k1_ms:.4f}",
            plain_ms=f"{k1_plain_ms:.4f}")
        if not k1_rel <= tol or not all(torch.isfinite(t.float()).all() for t in got):
            raise AssertionError(f"K1 {dtype}: relative error {k1_rel} above {tol}")

        # K2 against autograd through K1's plain version, and against its
        # own plain version; both take the kernel forward's residuals
        _, afac, fpl, fli = got
        leaves = [w_eff.clone().requires_grad_(True), planes.clone().requires_grad_(True),
                  plines.clone().requires_grad_(True)]
        out_plain = mxgrid_cuda.folded_fused_forward_plain(pts, *leaves, spec)[0]
        want_ad = torch.autograd.grad(out_plain, leaves, grad_outputs=gout)
        del out_plain
        bwd = lambda: mxgrid_cuda.folded_fused_backward(pts, afac, fpl, fli, gout, spec)
        bwd_plain = lambda: mxgrid_cuda.folded_fused_backward_plain(pts, afac, fpl, fli, gout, spec)
        got_b = bwd()
        torch.cuda.synchronize()
        k2_abs, k2_rel = errors(got_b, want_ad)
        k2_abs_p, k2_rel_p = errors(got_b, bwd_plain())
        k2_ms, k2_plain_ms = median_ms(bwd), median_ms(bwd_plain)
        say("3 kernels", kernel="K2", dtype=str(dtype).split(".")[1],
            max_abs_err_vs_autograd=f"{k2_abs:.3e}", max_rel_err_vs_autograd=f"{k2_rel:.3e}",
            max_rel_err_vs_plain=f"{k2_rel_p:.3e}", rel_tol=tol, ms=f"{k2_ms:.4f}",
            plain_ms=f"{k2_plain_ms:.4f}")
        if not (k2_rel <= tol and k2_rel_p <= tol):
            raise AssertionError(f"K2 {dtype}: relative error {k2_rel}/{k2_rel_p} above {tol}")
        if dtype == torch.bfloat16:
            records["K1"] = dict(max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms)
            records["K2"] = dict(max_abs_err=max(k2_abs, k2_abs_p), ms=k2_ms,
                                 plain_ms=k2_plain_ms)
        del got, want, got_b, want_ad, afac, fpl, fli
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
    t0 = time.perf_counter()
    cam, objects, _, store, objs = build_synthetic_world(N_OBJECTS, 16, 128, device=dev)
    frames = store.arrays()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device=dev)
    torch.cuda.synchronize()
    say("5 train", setup_s=f"{time.perf_counter() - t0:.3f}", spec_out=spec.n_output_dims,
        dtype=str(nerf.compute_dtype(cfg, torch.device(dev))).split(".")[1])

    mxgrid_cuda.folded_fused_forward.launches = 0
    mxgrid_cuda.folded_fused_backward.launches = 0
    state = nerf.train_objects(state, objs, frames, cfg, spec, 1, generator=gen)
    loss1 = state.loss.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = nerf.train_objects(state, objs, frames, cfg, spec, WAVE, generator=gen)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    loss2 = state.loss.cpu()
    active = objs.active.cpu()
    rate = N_OBJECTS * WAVE / wave_s
    say("5 train", loss_step1=[round(x, 5) for x in loss1.tolist()],
        loss_wave=[round(x, 5) for x in loss2.tolist()], wave_s=f"{wave_s:.4f}",
        obj_iters_per_s=f"{rate:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    if not (torch.isfinite(loss1[active]).all() and torch.isfinite(loss2[active]).all()):
        raise AssertionError("non-finite loss on an active slot")
    if not (loss2[active] < loss1[active]).all():
        raise AssertionError("loss did not fall over the wave")
    if not (state.step[objs.active] == WAVE + 1).all():
        raise AssertionError("an active slot skipped steps")

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
        say("6 render", object=oi, psnr_db=f"{psnrs[-1]:.3f}", mask_iou=f"{ious[-1]:.4f}",
            rays=h * w)
    torch.cuda.synchronize()
    launches = {"K1": mxgrid_cuda.folded_fused_forward.launches,
                "K2": mxgrid_cuda.folded_fused_backward.launches}
    say("6 render", mean_psnr_db=f"{np.mean(psnrs):.3f}", mean_mask_iou=f"{np.mean(ious):.4f}",
        views=len(psnrs), launches=launches)
    if len(psnrs) != N_OBJECTS or not all(np.isfinite(psnrs)):
        raise AssertionError("held-out render failed")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    return launches, rate


def main() -> None:
    name, _ = phase_device()
    dev = "cuda"
    phase_build()
    spec = nerf.make_field_spec(NerfConfig())
    records = phase_kernels(spec, dev)
    phase_parity(dev)
    launches, _ = phase_train_and_render(dev)
    kernels = [
        dict(name="K1 folded_fused_forward", route="cuda", source=SOURCE,
             replaces=f"{PALLAS}:448", launches=launches["K1"], **records["K1"]),
        dict(name="K2 folded_fused_backward", route="cuda", source=SOURCE,
             replaces=f"{PALLAS}:468", launches=launches["K2"], **records["K2"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
