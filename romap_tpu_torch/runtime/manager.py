"""Online multi-object NeRF manager, the NerfManagerOnline equivalent
(counterpart of romap_tpu/runtime/manager.py, same API and bookkeeping).

API surface of the reference (ref nerf_manager.h:54-91), so a SLAM
frontend, or the socket server in front of it, drives it unchanged:

  Init                 -> constructor
  DatasetInit          -> dataset_init(fx, fy, cx, cy, H, W, imgs)
  NewFrameToDataset    -> new_frame_to_dataset(img_id, stamp, rgb, instance,
                          depth, pose)
  UpdateDataset        -> update_dataset(cur_id, frame_num, poses)
  CreateNeRF           -> create_nerf(cls, obj_tow, bbox_min, bbox_max) -> idx
  UpdateNeRFBbox       -> update_nerf_bbox(idx, frame_bboxes, train_step)
  GetFrameIdx          -> get_frame_idx(stamp)
  WaitThreadsEnd       -> wait_threads_end()
  RenderNeRFsTest      -> render_nerfs_test(out, idx, stamps, boxes, twcs, r)
  DrawMesh             -> get_mesh(idx)

Every object is a row of one batched TrainState and one pump trains every
slot whose wave budget is positive, in quanta of `train_step_iterations`
steps. Reference semantics kept: bbox inflation 1.1x (1.2x for classes 41
and 73), training only past 10 bboxes, `train_step` waves credited per
UpdateNeRFBbox, a mesh every `mesh_every_waves` waves, one final wave and
mesh at WaitThreadsEnd; and romap_tpu's additions: slot and bbox-table
growth, `update_nerf_volume` (reinit and re-credit from the lifetime
budget `_waves_earned`), the shutdown `final_retrain`, `final_waves`, and a
state snapshot when ROMAP_SAVE_STATE names a file (with the random stream's
state, `extra["generator"]`, as the reference's holds its keys).

Not ported (ROADMAP M11): the device mesh and sharding, the ahead-of-time
compiles (PyTorch runs eagerly, there is no jit to warm), and joint
photometric BA (`joint_ba_iters > 0` raises). RENDER_TEST views with pixel
crops are photometrically refined first (`runtime/pose_refine.py`), as in
the reference.

Random numbers come from torch.Generators on the manager's device: the
initial state and every wave's uniforms from one seeded with `cfg.seed`,
the slots added by a growth from one seeded with `cfg.seed + old
capacity`, a reinit from one seeded with `cfg.seed + 7919 + idx` folded
with the slot's reinit count. `uniforms`, None in normal use, may be set to
a replay source of per-step uniforms (as `train_objects` takes it); the
parity tests feed JAX's draws through it.

Call pump() to run pending work synchronously (replay, tests), or
start()/wait_threads_end() to run it on a background thread.
"""

from __future__ import annotations

import os
import pickle
import threading
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from romap_tpu_torch.config import NerfConfig, load_network_config
from romap_tpu_torch.data.frame_store import FrameStore
from romap_tpu_torch.models import nerf
from romap_tpu_torch.runtime import artifacts, pose_refine
from romap_tpu_torch.utils import tracing
from romap_tpu_torch.utils.checkpoint import generator_state, save_checkpoint
from romap_tpu_torch.utils.device import resolve_device

MIN_BBOXES_TO_TRAIN = 10  # ref nerf.cu:222


def _fold_seed(seed: int, n: int) -> int:
    """A seed per (base seed, counter) pair: the reinit draws of one slot."""
    return seed * 1_000_003 + n


class NerfManagerOnline:
    def __init__(
        self,
        network_config: str | NerfConfig | None = None,
        use_sparse_depth: bool = False,
        train_step_iterations: int = 500,
        capacity: int = 16,
        mesh_every_waves: int = 2,
        mesh_enabled: bool = True,
        final_waves: int = 1,
        joint_ba_iters: int = 0,
        final_retrain: bool = True,
        device=None,
    ):
        if isinstance(network_config, str):
            self.cfg = load_network_config(network_config)
        else:
            self.cfg = network_config or NerfConfig()
        if joint_ba_iters:
            raise NotImplementedError(
                "joint photometric BA (joint_ba_iters > 0) is not ported (ROADMAP M11)")
        self.device = resolve_device(device)
        self.spec = nerf.make_field_spec(self.cfg)
        self.use_depth = use_sparse_depth
        self.iters_per_wave = train_step_iterations
        self.capacity = capacity
        self.mesh_every_waves = mesh_every_waves
        self.mesh_enabled = mesh_enabled
        # waves run at shutdown per still-active object (1 = reference parity)
        self.final_waves = max(1, int(final_waves))
        # shutdown from-scratch retrain of every slot on the final pose graph
        self.final_retrain = bool(final_retrain)
        self.uniforms = None  # replay source of per-step uniforms (tests)
        # host seconds of each wave (device work included) and its slot count
        self.wave_seconds: list[float] = []
        self.wave_slots: list[int] = []

        self.store: FrameStore | None = None
        self.state: nerf.TrainState | None = None
        self._gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)

        self._lock = threading.RLock()
        # While a wave is in flight the state it trains is not self.state's
        # successor yet: every consumer of self.state (grow, reinit, losses,
        # mesh and render snapshots, the final train) waits for _train_busy
        # to clear. pump() sets it around the unlocked device work and
        # publishes the result under the lock.
        self._cond = threading.Condition(self._lock)
        self._train_busy = False
        self._n_objects = 0
        self._classes: list[int] = []
        self._pending_waves = np.zeros(capacity, np.int64)
        self._wave_count = np.zeros(capacity, np.int64)
        # lifetime bbox-earned wave budget, never reset by a reinit: a
        # from-scratch retrain restores pending to exactly this
        self._waves_earned = np.zeros(capacity, np.int64)
        # per-slot reinit count, folded into the reinit seed (fresh draws)
        self._reinit_count = np.zeros(capacity, np.int64)
        self._meshes: dict[int, object] = {}
        self._objs: dict[str, np.ndarray] | None = None

        self._thread: threading.Thread | None = None
        self._finish = threading.Event()

    # ------------------------------------------------------------------ data
    def dataset_init(self, fx, fy, cx, cy, h, w, imgs: int) -> None:
        """ref NerfManagerOnline::DatasetInit nerf_manager.cu:160-187; `imgs`
        is the preallocated keyframe budget."""
        self.store = FrameStore(int(imgs), int(h), int(w), np.array([fx, fy, cx, cy], np.float32),
                                use_depth=self.use_depth, depth_scale=1.0, device=self.device)
        self._max_bboxes = int(imgs)
        self._objs = dict(
            aabb_min=np.zeros((self.capacity, 3), np.float32),
            aabb_max=np.ones((self.capacity, 3), np.float32),
            tow=np.tile(np.eye(4, dtype=np.float32), (self.capacity, 1, 1)),
            instance_id=np.zeros(self.capacity, np.int32),
            bboxes=np.zeros((self.capacity, self._max_bboxes, 5), np.int32),
            n_bbox=np.zeros(self.capacity, np.int32),
            active=np.zeros(self.capacity, bool),
        )
        self.state = nerf.init_train_state(self._gen, self.capacity, self.cfg, self.spec,
                                           device=self.device)

    def new_frame_to_dataset(self, img_id: int, stamp: str, rgb, instance,
                             depth=None, pose=None) -> None:
        """ref NewFrameToDataset nerf_manager.cu:189-218 (rgb is RGB u8)."""
        with self._lock:
            self.store.add_frame(int(img_id), stamp, rgb, instance, pose, depth)

    def update_dataset(self, cur_id: int, frame_num: int, poses) -> None:
        """Pose-window rewrite (ref UpdateDataset nerf_manager.cu:220-235)."""
        with self._lock:
            self.store.update_poses(int(cur_id) - int(frame_num), poses)

    def get_frame_idx(self, stamp: str) -> int:
        """ref GetFrameIdx nerf_manager.cu:288-296."""
        return self.store.stamp_to_idx.get(stamp, -1)

    # --------------------------------------------------------------- objects
    def create_nerf(self, cls: int, obj_tow, bbox_min, bbox_max) -> int:
        """ref CreateNeRF nerf_manager.cu:237-261 + SetAttributes nerf.cu:
        155-176 (bbox inflation)."""
        with self._lock:
            if self._n_objects >= self.capacity:
                self._grow()
            idx = self._n_objects
            self._n_objects += 1
            scale = 1.2 if cls in (41, 73) else 1.1
            self._objs["aabb_min"][idx] = np.asarray(bbox_min, np.float32) * scale
            self._objs["aabb_max"][idx] = np.asarray(bbox_max, np.float32) * scale
            self._objs["tow"][idx] = np.asarray(obj_tow, np.float32)
            self._objs["instance_id"][idx] = int(cls)
            self._classes.append(int(cls))
            self._objs["n_bbox"][idx] = 0
            self._objs["active"][idx] = False
            return idx

    def aabb_half(self, idx: int) -> np.ndarray:
        """The object's training-volume half-widths (object frame, inflation
        included)."""
        with self._lock:
            return np.array(self._objs["aabb_max"][idx], np.float32)

    def _wait_idle_locked(self) -> None:
        """Block (lock held via the condition) until no wave is in flight."""
        while self._train_busy:
            self._cond.wait()

    def _grow(self) -> None:
        """Double the slot capacity; the new slots get fresh state. Caller
        holds the lock; waits out any in-flight wave."""
        self._wait_idle_locked()
        old_cap, new_cap = self.capacity, self.capacity * 2
        for k, v in self._objs.items():
            pad = np.zeros((new_cap - old_cap,) + v.shape[1:], v.dtype)
            if k == "aabb_max":
                pad[:] = 1.0
            if k == "tow":
                pad[:] = np.eye(4, dtype=np.float32)
            self._objs[k] = np.concatenate([v, pad], 0)
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + old_cap)
        extra = nerf.init_train_state(gen, new_cap - old_cap, self.cfg, self.spec,
                                      device=self.device)
        self.state = pytree.tree_map(lambda a, b: torch.cat([a, b], 0), self.state, extra)
        grow = lambda a: np.concatenate([a, np.zeros(new_cap - old_cap, np.int64)])
        self._pending_waves = grow(self._pending_waves)
        self._wave_count = grow(self._wave_count)
        self._waves_earned = grow(self._waves_earned)
        self._reinit_count = grow(self._reinit_count)
        self.capacity = new_cap

    def update_nerf_bbox(self, idx: int, frame_bboxes, train_step: int = 1) -> None:
        """Append (frame_id, x, y, h, w) rows and credit training waves (ref
        UpdateNeRFBbox nerf_manager.cu:298-303 -> UpdateFrameBBox nerf.cu:
        406-421)."""
        rows = np.asarray(frame_bboxes, np.int32).reshape(-1, 5)
        if len(rows) == 0:
            return
        with self._lock:
            nb = int(self._objs["n_bbox"][idx])
            while nb + len(rows) > self._max_bboxes:
                self._grow_bboxes()
            end = nb + len(rows)
            self._objs["bboxes"][idx, nb:end] = rows
            self._objs["n_bbox"][idx] = end
            self._pending_waves[idx] += int(train_step)
            self._waves_earned[idx] += int(train_step)

    def _grow_bboxes(self) -> None:
        """Double the per-object bbox-row capacity rather than drop rows.
        Caller holds the lock."""
        old = self._max_bboxes
        self._max_bboxes = old * 2
        b = self._objs["bboxes"]
        self._objs["bboxes"] = np.concatenate([b, np.zeros((b.shape[0], old, 5), b.dtype)], axis=1)
        print(f"[manager] bbox table grown {old} -> {self._max_bboxes} rows/object", flush=True)

    def update_nerf_volume(self, idx: int, obj_tow, bbox_min, bbox_max) -> bool:
        """Replace a slot's pose and training volume (beyond the reference,
        which freezes SetAttributes at creation): the slot re-initializes and
        its pending waves are restored to its lifetime budget. Returns False
        (no-op) for an out-of-range slot, e.g. a stale index after a SLAM
        reset."""
        with self._lock:
            if not (0 <= idx < self._n_objects):
                print(f"[manager] update_nerf_volume: slot {idx} out of range "
                      f"(n_objects={self._n_objects}); ignored", flush=True)
                return False
            self._wait_idle_locked()
            cls = int(self._objs["instance_id"][idx])
            scale = 1.2 if cls in (41, 73) else 1.1
            self._objs["aabb_min"][idx] = np.asarray(bbox_min, np.float32) * scale
            self._objs["aabb_max"][idx] = np.asarray(bbox_max, np.float32) * scale
            self._objs["tow"][idx] = np.asarray(obj_tow, np.float32)
            if self.state is not None:
                self._reinit(idx)
            self._pending_waves[idx] = self._waves_earned[idx]
            self._wave_count[idx] = 0
            self._meshes.pop(idx, None)  # stale mesh from the old field
            return True

    def _reinit(self, idx: int) -> None:
        """Re-draw slot idx from its next reinit seed. Caller holds the lock
        with training idle."""
        seed = _fold_seed(self.cfg.seed + 7919 + idx, int(self._reinit_count[idx]))
        self._reinit_count[idx] += 1
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = nerf.reinit_slot(self.state, gen, idx, self.cfg, self.spec)

    # -------------------------------------------------------------- training
    def _objects_state(self, active_mask: np.ndarray) -> nerf.ObjectsState:
        """The object table on the device (copies: the host arrays keep
        changing while a wave runs)."""
        put = lambda a: torch.tensor(a, device=self.device)
        o = self._objs
        return nerf.ObjectsState(
            aabb_min=put(o["aabb_min"]), aabb_max=put(o["aabb_max"]), tow=put(o["tow"]),
            instance_id=put(o["instance_id"]), bboxes=put(o["bboxes"]),
            n_bbox=put(o["n_bbox"]), active=put(active_mask))

    def _trainable(self) -> np.ndarray:
        return (self._pending_waves > 0) & (self._objs["n_bbox"] > MIN_BBOXES_TO_TRAIN)

    def _train(self, state, objs, frames, n_slots: int):
        """One wave of iters_per_wave steps; returns once the device is done
        and logs its seconds."""
        draw = (dict(uniforms=self.uniforms) if self.uniforms is not None
                else dict(generator=self._gen))
        wave = len(self.wave_seconds) + 1
        with tracing.span("train.wave", wave=wave):
            t0 = time.perf_counter()
            step_before = state.step
            state = nerf.train_objects(state, objs, frames, self.cfg, self.spec,
                                       self.iters_per_wave, self.use_depth, **draw)
            with tracing.span("train.barrier"):
                state.loss.cpu()  # barrier
            self.wave_seconds.append(time.perf_counter() - t0)
        self.wave_slots.append(n_slots)
        nerf.count_wave(step_before, state.step, n_slots, self.iters_per_wave, wave=wave)
        return state

    def pump(self, max_waves: int | None = None) -> int:
        """Run pending training waves; returns the number of quanta run. A
        quantum is iters_per_wave steps for every slot whose wave budget is
        positive and that has passed the bbox gate."""
        waves_run = 0
        while max_waves is None or waves_run < max_waves:
            with self._cond:
                self._wait_idle_locked()  # serialize concurrent pumps
                mask = self._trainable()
                if not mask.any():
                    break
                objs = self._objects_state(mask)
                frames = self.store.arrays()
                state = self.state
                self._train_busy = True
            try:
                state = self._train(state, objs, frames, int(mask.sum()))
            except BaseException:
                with self._cond:
                    self._train_busy = False
                    self._cond.notify_all()
                raise
            with self._cond:
                self.state = state
                self._pending_waves[mask] -= 1
                self._wave_count[mask] += 1
                mesh_due = mask & (self._wave_count % self.mesh_every_waves == 0)
                self._train_busy = False
                self._cond.notify_all()
            if self.mesh_enabled:
                for oi in np.nonzero(mesh_due)[0]:
                    self._extract_mesh(int(oi))
            waves_run += 1
        return waves_run

    def _extract_mesh(self, oi: int) -> None:
        with self._cond:
            self._wait_idle_locked()
            params = pytree.tree_map(lambda a: a[oi], self.state.ema)
        with tracing.span("mesh.object", object=oi):
            mesh = artifacts.extract_object_mesh(params, self._objs["aabb_min"][oi],
                                                 self._objs["aabb_max"][oi], self.cfg, self.spec)
        with self._lock:
            self._meshes[oi] = mesh

    # ---------------------------------------------------------- thread pump
    def start(self) -> None:
        """Run the pump on a background thread (the reference's per-object
        training threads collapsed into one)."""
        if self._thread is not None:
            return
        self._finish.clear()

        def run():
            while not self._finish.is_set():
                if self.pump(max_waves=1) == 0:
                    time.sleep(0.003)  # ref nerf.cu:243 usleep(3000)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait_threads_end(self) -> None:
        """ref WaitThreadsEnd nerf_manager.cu:263-278: stop the pump thread;
        with final_retrain, re-initialize every slot that earned waves and
        re-credit its lifetime budget; drain; then final_waves waves and a
        mesh per object past the bbox gate (ref nerf.cu:246-251)."""
        self._finish.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.final_retrain:
            with self._lock:
                self._wait_idle_locked()
                n_slots = n_waves = 0
                if self.state is not None:
                    for idx in range(self._n_objects):
                        # gate on the lifetime budget: _wave_count is zeroed
                        # by mid-run volume updates
                        if self._waves_earned[idx] <= 0:
                            continue
                        self._reinit(idx)
                        self._pending_waves[idx] = self._waves_earned[idx]
                        n_waves += int(self._waves_earned[idx])
                        self._wave_count[idx] = 0
                        n_slots += 1
                        self._meshes.pop(idx, None)
                if n_slots:
                    print(f"final retrain: re-initialized {n_slots} slot(s), re-credited "
                          f"{n_waves} wave(s) on the refined pose graph", flush=True)
        self.pump()  # drain
        with self._cond:
            self._wait_idle_locked()
            mask = self._objs["n_bbox"] > MIN_BBOXES_TO_TRAIN
            if mask.any():
                objs = self._objects_state(mask)
                for _ in range(self.final_waves):
                    self.state = self._train(self.state, objs, self.store.arrays(),
                                             int(mask.sum()))
        if mask.any() and self.mesh_enabled:
            for oi in np.nonzero(mask)[0]:
                self._extract_mesh(int(oi))
        ckpt = os.environ.get("ROMAP_SAVE_STATE")
        if ckpt:
            with self._cond:
                self._wait_idle_locked()
                o = self._objs
                save_checkpoint(ckpt, self.state, extra={
                    "objs": {k: np.asarray(o[k]).tolist()
                             for k in ("aabb_min", "aabb_max", "instance_id", "n_bbox")},
                    "tow": np.asarray(o["tow"]).tolist(),
                    "n_objects": self._n_objects,
                    "generator": generator_state(self._gen)})
            print(f"state checkpoint saved to {ckpt}", flush=True)
        print("All NeRF slots completed ...")

    # ------------------------------------------------------------ inference
    def get_mesh(self, idx: int):
        """Viewer-side mesh fetch (ref DrawMesh -> DrawCPUMesh)."""
        with self._lock:
            return self._meshes.get(idx)

    def losses(self) -> np.ndarray:
        with self._cond:
            self._wait_idle_locked()
            return self.state.loss.cpu().numpy()[: self._n_objects]

    def render_nerfs_test(self, out_path: str, idx: int, stamps, boxes, twcs,
                          radius: float, video: bool = True, pixels=None) -> None:
        """ref RenderNeRFsTest nerf_manager.cu:280-285 -> RenderTestImg: the
        artifact tree of object idx for the given held-out views.

        `pixels` (per-view rgb and mask crops, or None) asks for those
        views' poses to be photometrically refined against the trained,
        frozen field first (`runtime/pose_refine.py`); a refined pose is
        kept only where it lowers the view's loss. With ROMAP_SAVE_STATE
        set, the refinement's inputs go to `<that path>.refine_obj<idx>.pkl`
        (`scripts/debug_refine.py` reads it)."""
        with self._cond:
            self._wait_idle_locked()
            params = pytree.tree_map(lambda a: a[idx], self.state.ema)
        twcs = [np.asarray(t, np.float32) for t in twcs]
        dbg = os.environ.get("ROMAP_SAVE_STATE")
        if dbg and pixels is not None:
            with open(f"{dbg}.refine_obj{idx}.pkl", "wb") as f:
                pickle.dump({
                    "stamps": stamps, "boxes": boxes, "twcs": twcs, "pixels": pixels,
                    "tow": self._objs["tow"][idx], "aabb_min": self._objs["aabb_min"][idx],
                    "aabb_max": self._objs["aabb_max"][idx],
                    "intrinsics": np.asarray(self.store._intrinsics), "radius": radius,
                }, f)
        if pixels is not None and any(p is not None for p in pixels):
            sel = [i for i, p in enumerate(pixels) if p is not None]
            refined, stats = pose_refine.refine_view_poses_host(
                params, self.store._intrinsics, [twcs[i] for i in sel], self._objs["tow"][idx],
                self._objs["aabb_min"][idx], self._objs["aabb_max"][idx],
                [tuple(int(v) for v in boxes[i]) for i in sel], [pixels[i] for i in sel],
                self.cfg, self.spec)
            for i, t in zip(sel, refined):
                twcs[i] = t
            print(f"pose refine: object {idx}: {stats['refined']}/{len(sel)} "
                  f"views improved, loss {stats.get('mean_loss_before', 0):.4f}"
                  f" -> {stats.get('mean_loss_after', 0):.4f}", flush=True)
        test_views = [dict(stamp=s, twc=np.asarray(t, np.float32), box=tuple(int(v) for v in b))
                      for s, b, t in zip(stamps, boxes, twcs)]
        # training manifest from the slot's bbox table
        nb = int(self._objs["n_bbox"][idx])
        idx_to_stamp = {v: k for k, v in self.store.stamp_to_idx.items()}
        train_views = []
        for row in self._objs["bboxes"][idx, :nb]:
            fid = int(row[0])
            train_views.append(dict(stamp=idx_to_stamp.get(fid, str(fid)),
                                    twc=self.store._poses[fid],
                                    box=(int(row[1]), int(row[2]), int(row[3]), int(row[4]))))
        artifacts.render_test_artifacts(
            out_path, idx, params, self.store._intrinsics, self._objs["tow"][idx],
            self._objs["aabb_min"][idx], self._objs["aabb_max"][idx],
            (self.store.h, self.store.w), test_views, train_views, self._classes[idx],
            radius, self.cfg, self.spec, video=video)
