"""Where the time of one train step of romap_tpu_torch goes, on one GPU.

For each encode path of the port (the flagship fused K1/K2, unsnapped
K3/K4, the CP-only `fast` preset K5/K6, the split path MX_FUSED=0
MX_SNAP=0 that the online phase of chip_smoke.py runs, K7-K10, and the
`quality` preset, 256 x 64 with a (128, 128, 8) plane level, folded K1/K2
and unsnapped K3/K4; all of them in the dtype "auto" picks, bf16 on the
card; then in fp32, TrainConfig(compute_dtype="float32"), the flagship
unsnapped, the split path and `quality` unsnapped, whose K4/K8 run
"tensor_core_split", and the folded flagship, `fast` and `quality`, whose
K2/K6 do), at the
reference batch geometry on the scene of build_synthetic_world(10, 16, 128):
  - step ms and obj-iters/s: host clock around 20 steps ending in a
    synchronize, after 3 warm-up steps; host enqueue ms: the same clock read
    before the synchronize, the time Python needs to queue a step's
    launches (a step whose enqueue time equals its step time is paced by the
    host, not the card);
  - device busy ms per step: CUDA kernel time under torch.profiler over 5
    steps;
  - two idle shares: `idle_share_profiled`, 1 - busy / wall time of the
    profiled steps (the profiler's own host overhead stretches that
    window), and `idle_share_unprofiled_step`, 1 - busy / the unprofiled
    step ms;
  - the kernels by device time, largest first;
  - the device time under each part of the step, its host time, and its
    largest kernels: the program's own spans (`utils/tracing.py`,
    `nerf.STEP_SPANS`: batch, encode.fwd, mlp.fwd, loss.fwd, loss.bwd,
    mlp.bwd, encode.bwd with the unfold, optimizer.update), turned on over
    the profiled steps, where each also enters `record_function`; the
    backward spans open and close in tensor hooks, on the autograd thread
    that launches those kernels. The spans' own device-side ranges are left
    out of the busy time and the kernel list.

With `--refine`, one step of photometric pose refinement instead
(`pose_refine.make_view_loss`'s loss of one view's 4 starts x 1536 pixels x
32 samples, then its `torch.autograd.grad` over the SE(3) deltas, as
`refine_poses` runs it 300 times a view), on the flagship folded spec (K1
forward, K0) and on the split path MX_FUSED=0 MX_SNAP=0 (K7 + K9 forward,
K0), on one object of build_synthetic_world(1, 24, 96) with random weights
(the step's work does not depend on them): step ms, host enqueue ms, device
busy ms, the idle share, launches a step and the kernels by device time.

Usage: python3 -m romap_tpu_torch.tools.profile_step [--steps 20] [--top 8]
[--configs split,...] [--refine] (from the repo root; needs a CUDA device;
prints the card's name and power limit first and a JSON line of every
configuration last; `--configs` keeps the configurations whose name
contains one of the words). Run by path with another checkout first on PYTHONPATH
(`PYTHONPATH=build/parent python3 romap_tpu_torch/tools/profile_step.py`),
it profiles that checkout's package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import EncodingConfig, NerfConfig, TrainConfig
from romap_tpu_torch.data.world import build_synthetic_world
from romap_tpu_torch.models import nerf
from romap_tpu_torch.runtime import pose_refine
from romap_tpu_torch.utils import tracing

N_OBJECTS = 10


def span_report(prof, steps):
    """{span: (device ms a step, [(kernel, ms a step), ...])} from the
    profiler's event tree: the kernels launched under each of the step's
    spans (`nerf.STEP_SPANS`) and their children."""
    out = {}
    for evt in prof.events():
        if evt.name not in nerf.STEP_SPANS:
            continue
        ms, kernels = out.setdefault(evt.name, [0.0, {}])
        stack = [evt]
        while stack:
            e = stack.pop()
            for k in getattr(e, "kernels", []):
                kernels[k.name] = kernels.get(k.name, 0.0) + k.duration / 1e3 / steps
                out[evt.name][0] += k.duration / 1e3 / steps
            stack.extend(getattr(e, "cpu_children", []))
    return {name: (ms, sorted(ks.items(), key=lambda kv: -kv[1])[:4])
            for name, (ms, ks) in out.items()}


CONFIGS = {  # name -> (encoding, environment, TrainConfig.compute_dtype)
    "flagship K1/K2": (EncodingConfig(), {}, "auto"),
    "unsnapped K3/K4": (EncodingConfig(), {"MX_SNAP": "0"}, "auto"),
    "fast K5/K6": (EncodingConfig.preset("fast"), {}, "auto"),
    "split unsnapped K7-K10": (EncodingConfig(), {"MX_SNAP": "0", "MX_FUSED": "0"}, "auto"),
    "quality K1/K2": (EncodingConfig.preset("quality"), {}, "auto"),
    "quality unsnapped K3/K4": (EncodingConfig.preset("quality"), {"MX_SNAP": "0"}, "auto"),
    "fp32 unsnapped K3/K4": (EncodingConfig(), {"MX_SNAP": "0"}, "float32"),
    "fp32 split unsnapped K7-K10": (EncodingConfig(), {"MX_SNAP": "0", "MX_FUSED": "0"},
                                    "float32"),
    "fp32 quality unsnapped K3/K4": (EncodingConfig.preset("quality"), {"MX_SNAP": "0"},
                                     "float32"),
    "fp32 flagship K1/K2": (EncodingConfig(), {}, "float32"),
    "fp32 fast K5/K6": (EncodingConfig.preset("fast"), {}, "float32"),
    "fp32 quality K1/K2": (EncodingConfig.preset("quality"), {}, "float32"),
}


def profile(name, encoding, env, dtype, steps, top, world):
    os.environ.pop("MX_SNAP", None)
    os.environ.pop("MX_FUSED", None)
    os.environ.update(env)
    cfg = NerfConfig(encoding=encoding, train=TrainConfig(compute_dtype=dtype))
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = world
    frames = store.arrays()
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    state = nerf.init_train_state(gen, N_OBJECTS, cfg, spec, device="cuda")
    run = lambda s, n: nerf.train_objects(s, objs, frames, cfg, spec, n, generator=gen)
    state = run(state, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, steps)
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / steps  # the host alone: launches queued
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tracing.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state = run(state, 5)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        tracing.disable()
    drained = tracing.drain()
    span_names = {r["name"] for r in drained["spans"]}
    host = tracing.summary(drained)["spans"]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in span_names]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    kernels.sort(key=dev_us, reverse=True)
    out = dict(config=name, step_ms=step_ms, host_enqueue_ms_per_step=enqueue_ms,
               obj_iters_per_s=N_OBJECTS * 1e3 / step_ms,
               busy_ms_per_step=busy_ms / 5, idle_share_profiled=1 - busy_ms / wall_ms,
               idle_share_unprofiled_step=1 - busy_ms / 5 / step_ms,
               launches_per_step=sum(e.count for e in kernels) / 5,
               top=[dict(kernel=e.key[:90], ms_per_step=dev_us(e) / 5e3, calls_per_step=e.count / 5)
                    for e in kernels[:top]])
    print(f"[{name}] step_ms={step_ms:.4f} host_enqueue_ms_per_step={enqueue_ms:.4f} "
          f"obj_iters_per_s={out['obj_iters_per_s']:.2f} "
          f"busy_ms_per_step={out['busy_ms_per_step']:.4f} "
          f"idle_share_profiled={out['idle_share_profiled']:.4f} "
          f"idle_share_unprofiled_step={out['idle_share_unprofiled_step']:.4f} "
          f"launches_per_step={out['launches_per_step']:.1f}", flush=True)
    for t in out["top"]:
        print(f"  {t['ms_per_step']:9.4f} ms  x{t['calls_per_step']:.1f}  {t['kernel']}", flush=True)
    report = span_report(prof, 5)
    host_ms = lambda name: 1e3 * host.get(f"train.step/{name}", dict(total_s=0.0))["total_s"] / 5
    out["spans"] = {name: dict(device_ms_per_step=ms, host_ms_per_step=host_ms(name),
                               top=[dict(kernel=k[:90], ms_per_step=v) for k, v in top])
                    for name, (ms, top) in report.items()}
    for name in nerf.STEP_SPANS:
        ms, top_kernels = report.get(name, (0.0, []))
        print(f"  span {name!r}: device_ms_per_step={ms:.4f} "
              f"host_ms_per_step={host_ms(name):.4f}", flush=True)
        for k, v in top_kernels:
            print(f"      {v:9.4f} ms  {k[:90]}", flush=True)
    return out


REFINE_CONFIGS = {  # name -> environment: [9b]'s spec (folded) and [9]'s (split)
    "refine folded K1+K0": {},
    "refine split K7+K9+K0": {"MX_SNAP": "0", "MX_FUSED": "0"},
}


def refine_step(env, device="cuda"):
    """One refinement step's closure: the loss of one view's N_STARTS starts
    and its gradient over their SE(3) deltas (pose_refine's N_PIXELS and
    N_SAMPLES, read at the call)."""
    os.environ.pop("MX_SNAP", None)
    os.environ.pop("MX_FUSED", None)
    os.environ.update(env)
    cfg = NerfConfig()
    spec = nerf.make_field_spec(cfg)
    _, objects, seq, store, objs = build_synthetic_world(1, 24, 96, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    state = nerf.init_train_state(gen, 1, cfg, spec, device=device)
    params = pytree.tree_map(lambda a: a[0], state.ema)
    frame, obj = seq[5], objects[0]
    x, y, h, w = frame["bboxes"][obj.instance_id]
    mask = (frame["instance"][y : y + h, x : x + w] == obj.instance_id).astype("uint8") * 255
    batch = pose_refine.build_refine_batch([(x, y, h, w)],
                                           [(frame["rgb"][y : y + h, x : x + w], mask)],
                                           pose_refine.N_PIXELS)
    on = lambda a: torch.as_tensor(a[:1], device=device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    view_loss = pose_refine.make_view_loss(
        params, f32(store._intrinsics), f32(frame["twc"])[None], objs.tow[0], objs.aabb_min[0],
        objs.aabb_max[0], on(batch["xy"]), on(batch["rgb"]), on(batch["w_rgb"]),
        on(batch["mask"]), on(batch["valid"]), cfg, spec, pose_refine.N_STARTS,
        pose_refine.N_SAMPLES)
    noise = torch.randn((pose_refine.N_STARTS, 6), generator=torch.Generator().manual_seed(17))
    delta = (0.01 * noise).to(device)

    def step():
        pv, leaf = view_loss(delta)
        return torch.autograd.grad(pv.sum(), leaf)[0]

    return step


def profile_refine(name, env, steps, top):
    step = refine_step(env)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / steps
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy_ms = sum(dev_us(e) for e in kernels) / 5e3
    kernels.sort(key=dev_us, reverse=True)
    out = dict(config=name, points=pose_refine.N_STARTS * pose_refine.N_PIXELS
               * pose_refine.N_SAMPLES, step_ms=step_ms, host_enqueue_ms_per_step=enqueue_ms,
               busy_ms_per_step=busy_ms, idle_share_unprofiled_step=1 - busy_ms / step_ms,
               launches_per_step=sum(e.count for e in kernels) / 5,
               top=[dict(kernel=e.key[:90], ms_per_step=dev_us(e) / 5e3, calls_per_step=e.count / 5)
                    for e in kernels[:top]])
    print(f"[{name}] points={out['points']} step_ms={step_ms:.4f} "
          f"host_enqueue_ms_per_step={enqueue_ms:.4f} busy_ms_per_step={busy_ms:.4f} "
          f"idle_share_unprofiled_step={out['idle_share_unprofiled_step']:.4f} "
          f"launches_per_step={out['launches_per_step']:.1f}", flush=True)
    for t in out["top"]:
        print(f"  {t['ms_per_step']:9.4f} ms  x{t['calls_per_step']:.1f}  {t['kernel']}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--configs", default="", help="comma list of words of config names")
    ap.add_argument("--refine", action="store_true",
                    help="one pose-refinement step instead of a train step")
    args = ap.parse_args(argv)
    words = [w for w in args.configs.split(",") if w]
    configs = {name: c for name, c in (REFINE_CONFIGS if args.refine else CONFIGS).items()
               if not words or any(w in name for w in words)}
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.refine:
        results = [profile_refine(name, env, args.steps, args.top)
                   for name, env in configs.items()]
        print(json.dumps({"device": torch.cuda.get_device_name(0), "refine": results}))
        return
    world = build_synthetic_world(N_OBJECTS, 16, 128, device="cuda")
    results = [profile(name, enc, env, dtype, args.steps, args.top, world)
               for name, (enc, env, dtype) in configs.items()]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "configs": results}))


if __name__ == "__main__":
    main()
