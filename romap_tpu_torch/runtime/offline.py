"""Offline multi-object NeRF training, the OfflineNeRF equivalent
(counterpart of romap_tpu/runtime/offline.py).

One frame store on the device and one batched train step advance every
object together; the reference's schedule is 10 waves x 500 steps with a
mesh every 2 waves. There is no device mesh: the object table's capacity is
the object count, on one device.

Two behaviours of the reference runner are not copied:
  * rebuilding the object table appended the held-out views a second time
    (`setdefault`, romap_tpu/runtime/offline.py:123); here each build
    starts the list anew;
  * with `holdout` set, an object whose held-out set came out empty was
    evaluated on training views (offline.py:207); here that raises.

Run: python -m romap_tpu_torch.runtime.offline <network_config|-> <dataset>
<use_gt_depth> [--device cuda] [--waves N --steps-per-wave N ...] [--trace PATH]
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import NerfConfig, load_network_config
from romap_tpu_torch.data.formats import (
    DatasetMeta,
    load_dataset_meta,
    load_frame_images,
    load_object_file,
)
from romap_tpu_torch.data.frame_store import FrameStore
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import cuda_lib
from romap_tpu_torch.runtime import artifacts
from romap_tpu_torch.utils import tracing
from romap_tpu_torch.utils.device import resolve_device
from romap_tpu_torch.utils.mesh_io import save_ply


class OfflineRunner:
    def __init__(self, dataset_path: str, network_config: str | NerfConfig | None = None,
                 use_depth: bool = False, mesh: bool = True, holdout: int | None = None,
                 device=None):
        if isinstance(network_config, str):
            self.cfg = load_network_config(network_config)
        else:
            self.cfg = network_config or NerfConfig()
        self.spec = nerf.make_field_spec(self.cfg)
        self.use_depth = use_depth
        self.mesh_enabled = mesh
        # holdout=N: every Nth per-object view is left out of training and
        # becomes the eval view set (None: train on every view, as the
        # reference does)
        self.holdout = holdout
        self.device = resolve_device(device)  # the card unless asked otherwise

        self.meta: DatasetMeta = load_dataset_meta(dataset_path, use_depth)
        n = len(self.meta.stamps)
        self.store = FrameStore(n, self.meta.h, self.meta.w, self.meta.intrinsics, use_depth,
                                depth_scale=1.0,  # scaled at load time below
                                device=self.device)
        print("Load Images to device ...")
        with tracing.span("frames.load"):
            n_bytes = 0
            for i in range(n):
                rgb, depth, inst = load_frame_images(self.meta, i, use_depth)
                self.store.add_frame(i, self.meta.stamps[i], rgb, inst, self.meta.poses[i],
                                     depth=depth)
                n_bytes += rgb.nbytes + inst.nbytes + (depth.nbytes if use_depth else 0)
            self.store.arrays()  # the upload
            tracing.count("frames.loaded", n)
            tracing.count("frames.bytes", n_bytes)
        print("Load Images to device completed...")

        self.objects: list[dict] = []
        self.state: nerf.TrainState | None = None
        self.objs_state: nerf.ObjectsState | None = None
        self.generator: torch.Generator | None = None
        self.wave_seconds: list[float] = []  # train time of each wave, synced

    def create_nerf(self, object_file: str) -> int:
        self.objects.append(dict(data=load_object_file(object_file), path=object_file))
        return len(self.objects) - 1

    def create_nerfs_from_dir(self, obj_dir: str | None = None) -> int:
        obj_dir = obj_dir or os.path.join(self.meta.root, "obj_offline")
        files = sorted(glob.glob(os.path.join(obj_dir, "*.txt")))
        for f in files:
            self.create_nerf(f)
        return len(files)

    def _build_object_table(self) -> None:
        cap = max(len(self.objects), 1)
        stamp_to_idx = self.meta.stamp_to_idx
        max_b = max((len(o["data"].stamps) for o in self.objects), default=1)
        objs = dict(
            aabb_min=np.zeros((cap, 3), np.float32),
            aabb_max=np.ones((cap, 3), np.float32),
            tow=np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1)),
            instance_id=np.zeros(cap, np.int32),
            bboxes=np.zeros((cap, max_b, 5), np.int32),
            n_bbox=np.zeros(cap, np.int32),
            active=np.zeros(cap, bool),
        )
        for oi, o in enumerate(self.objects):
            d = o["data"]
            objs["aabb_min"][oi] = -d.half_extents
            objs["aabb_max"][oi] = d.half_extents
            objs["tow"][oi] = d.tow
            objs["instance_id"][oi] = d.cls  # mInstanceId = uint8(class)
            held = o["holdout_views"] = []
            nb = 0
            for serial, (stamp, box) in enumerate(zip(d.stamps, d.bboxes)):
                fid = stamp_to_idx.get(stamp)
                if fid is None:
                    continue
                if self.holdout and serial % self.holdout == 0:
                    held.append(dict(stamp=stamp, twc=self.meta.poses[fid],
                                     box=tuple(int(v) for v in box)))
                    continue
                objs["bboxes"][oi, nb] = (fid, box[0], box[1], box[2], box[3])
                nb += 1
            objs["n_bbox"][oi] = nb
            objs["active"][oi] = nb > 0
        self.objs_state = nerf.ObjectsState(
            **{k: torch.from_numpy(v).to(self.device) for k, v in objs.items()})
        self.n_active = int(objs["active"].sum())
        self.generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        self.state = nerf.init_train_state(self.generator, cap, self.cfg, self.spec,
                                           device=self.device)

    def train(self, waves: int = 10, steps_per_wave: int = 500, mesh_every: int = 2,
              out_dir: str = "./output") -> None:
        if self.state is None:
            self._build_object_table()
        frames = self.store.arrays()
        os.makedirs(out_dir, exist_ok=True)
        self.meshes: dict[int, object] = {}
        for wave in range(1, waves + 1):
            with tracing.span("train.wave", wave=wave):
                t0 = time.perf_counter()
                step_before = self.state.step
                self.state = nerf.train_objects(
                    self.state, self.objs_state, frames, self.cfg, self.spec, steps_per_wave,
                    self.use_depth, generator=self.generator)
                with tracing.span("train.barrier"):
                    losses = self.state.loss.cpu().numpy()  # also the sync for the clock
                    steps = self.state.step.cpu().numpy()
                self.wave_seconds.append(time.perf_counter() - t0)
            nerf.count_wave(step_before, steps, self.n_active, steps_per_wave, wave=wave)
            with tracing.span("train.log"):
                for oi in range(len(self.objects)):
                    print(f"Id: {oi} train_time: {self.wave_seconds[-1] * 1000:.0f} "
                          f"Step: {int(steps[oi])} loss: {losses[oi]:.6f}")
            if self.mesh_enabled and wave % mesh_every == 0:
                self.extract_meshes()
        self.save_meshes(out_dir)
        print("Training completed")

    def params_of(self, oi: int):
        return pytree.tree_map(lambda a: a[oi], self.state.ema)

    def extract_meshes(self) -> None:
        with tracing.span("mesh.round"):
            for oi in range(len(self.objects)):
                with tracing.span("mesh.object", object=oi):
                    self.meshes[oi] = artifacts.extract_object_mesh(
                        self.params_of(oi), self.objs_state.aabb_min[oi],
                        self.objs_state.aabb_max[oi], self.cfg, self.spec)

    def save_meshes(self, out_dir: str) -> None:
        if not self.mesh_enabled:
            return
        self.extract_meshes()
        for oi, mesh in self.meshes.items():
            save_ply(mesh, os.path.join(out_dir, f"{oi}.ply"))

    def render_test_artifacts(self, out_dir: str, test_every: int = 8,
                              video: bool = True) -> None:
        for oi, o in enumerate(self.objects):
            d = o["data"]
            views = []
            for stamp, box in zip(d.stamps, d.bboxes):
                fid = self.meta.stamp_to_idx.get(stamp)
                if fid is None:
                    continue
                views.append(dict(stamp=stamp, twc=self.meta.poses[fid],
                                  box=tuple(int(v) for v in box)))
            if self.holdout:
                # leakage-free protocol: the held-out views, never supervision
                test_views = o["holdout_views"]
                if not test_views:
                    raise ValueError(
                        f"object {oi}: holdout={self.holdout} left no held-out view to "
                        "evaluate (the reference would silently use training views)")
            else:
                test_views = views[::test_every]
            radius = 5.0 * float(np.max(d.half_extents))
            artifacts.render_test_artifacts(
                out_dir, oi, self.params_of(oi), self.meta.intrinsics, d.tow,
                -d.half_extents, d.half_extents, (self.meta.h, self.meta.w), test_views,
                views, d.cls, radius, self.cfg, self.spec, video=video)


def main(argv: list[str] | None = None) -> OfflineRunner:
    """CLI mirroring `./OfflineNeRF <network_config> <dataset> <use_gt_depth>`
    (object files discovered in <dataset>/obj_offline/); the flags scale the
    run down, `--device` picks the torch device. Returns the runner."""
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(prog="romap-offline-nerf-torch")
    ap.add_argument("network_config", help="reference-format network JSON, or '-'")
    ap.add_argument("dataset")
    ap.add_argument("use_gt_depth", type=int, choices=[0, 1])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the run fails without a card "
                    "unless cpu is asked for)")
    ap.add_argument("--waves", type=int, default=10)
    ap.add_argument("--steps-per-wave", type=int, default=500)
    ap.add_argument("--out", default="./output")
    ap.add_argument("--no-video", action="store_true")
    ap.add_argument("--no-artifacts", action="store_true")
    ap.add_argument("--rays", type=int, help="rays/batch override (default 4096)")
    ap.add_argument("--samples", type=int, help="samples/ray override (default 32)")
    ap.add_argument("--mc-res", type=int, help="marching cubes res (default 64)")
    ap.add_argument("--mx-features", type=int, help="mxgrid channels (default 48)")
    ap.add_argument("--mx-max-res", type=int, help="mxgrid max resolution")
    ap.add_argument("--holdout", type=int, default=None,
                    help="exclude every Nth per-object view from training and evaluate "
                    "on exactly those views (default: train on all views)")
    ap.add_argument("--trace", metavar="PATH",
                    help="record the run's spans and counters (utils/tracing.py) and write "
                    "them to PATH as Chrome trace JSON with their per-name summary")
    args = ap.parse_args(argv)
    if args.trace:
        tracing.enable()
        cuda_lib.reset_launch_counts()

    cfg = (NerfConfig() if args.network_config == "-"
           else load_network_config(args.network_config))
    train_kw = {k: v for k, v in (("rays_per_batch", args.rays),
                                  ("samples_per_ray", args.samples),
                                  ("mc_resolution", args.mc_res)) if v}
    if train_kw:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    enc_kw = {k: v for k, v in (("mx_features", args.mx_features),
                                ("mx_max_resolution", args.mx_max_res)) if v}
    if enc_kw:
        cfg = dataclasses.replace(cfg, encoding=dataclasses.replace(cfg.encoding, **enc_kw))

    print(f"Device: {args.device}")
    runner = OfflineRunner(args.dataset, cfg, use_depth=bool(args.use_gt_depth),
                           holdout=args.holdout, device=args.device)
    n = runner.create_nerfs_from_dir()
    print(f"Create {n} NeRF instances ...")
    runner.train(waves=args.waves, steps_per_wave=args.steps_per_wave, out_dir=args.out)
    if not args.no_artifacts:
        runner.render_test_artifacts(args.out, video=not args.no_video)
    if args.trace:
        tracing.disable()
        tracing.write_chrome_trace(args.trace, tracing.drain(), cuda_lib.launch_counts())
    return runner


if __name__ == "__main__":
    main()
