"""On-disk dataset formats, byte-compatible with the reference.

Readers (mirroring NeRF_Dataset::ReadDataset, ref nerf_data.cu:27-121 and
NeRF::ReadBboxOffline, ref nerf.cu:58-118):

  <dataset>/config.yaml       OpenCV FileStorage: Camera.fx/fy/cx/cy/H/W,
                              DepthMapFactor (+ SLAM keys ignored here)
  <dataset>/img.txt           '# comment' then 'stamp imgname' per line
  <dataset>/groundtruth.txt   '# comment' then TUM 'stamp tx ty tz qx qy qz qw'
  <dataset>/rgb|depth|instance/<imgname>
  <dataset>/obj_offline/<i>.txt
      line 1: comment
      line 2: class tx ty tz qx qy qz qw a1 a2 a3   (Two + half extents)
      rest:   stamp x y h w                          (2D bboxes per frame)

Writers produce the same layout (used to export synthetic datasets for the
end-to-end offline tests and to emit train/test manifests).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from romap_tpu_torch.utils.camera import invert_pose, pose_from_tq


def load_opencv_yaml(path: str) -> dict[str, float | str]:
    """Minimal OpenCV FileStorage YAML reader ('%YAML:1.0' + 'key: value')."""
    out: dict[str, float | str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or line.startswith("---"):
                continue
            m = re.match(r"^([\w.]+)\s*:\s*(.+)$", line)
            if not m:
                continue
            key, val = m.group(1), m.group(2).strip().strip('"')
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


@dataclasses.dataclass
class DatasetMeta:
    fx: float
    fy: float
    cx: float
    cy: float
    h: int
    w: int
    depth_scale: float
    stamps: list[str]
    image_names: list[str]
    poses: list[np.ndarray]  # Twc per frame
    root: str

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float32)

    @property
    def stamp_to_idx(self) -> dict[str, int]:
        return {s: i for i, s in enumerate(self.stamps)}


def _data_lines(path: str) -> list[list[str]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    return rows


def load_dataset_meta(root: str, use_depth: bool = False) -> DatasetMeta:
    cfg = load_opencv_yaml(os.path.join(root, "config.yaml"))
    stamps, names = [], []
    for row in _data_lines(os.path.join(root, "img.txt")):
        stamps.append(row[0])
        names.append(row[1])
    poses = []
    for row in _data_lines(os.path.join(root, "groundtruth.txt")):
        t = [float(x) for x in row[1:4]]
        q = [float(x) for x in row[4:8]]
        poses.append(pose_from_tq(t, q))
    if not poses:
        raise ValueError(f"Load dataset error...No images... ({root})")
    return DatasetMeta(
        fx=float(cfg["Camera.fx"]), fy=float(cfg["Camera.fy"]),
        cx=float(cfg["Camera.cx"]), cy=float(cfg["Camera.cy"]),
        h=int(cfg["Camera.H"]), w=int(cfg["Camera.W"]),
        depth_scale=float(cfg.get("DepthMapFactor", 1.0)) if use_depth else 1.0,
        stamps=stamps, image_names=names, poses=poses, root=root,
    )


def load_frame_images(meta: DatasetMeta, idx: int, use_depth: bool = False):
    """-> (rgb u8 [H,W,3] RGB order, depth f32 [H,W] scaled or None,
    instance u8 [H,W]); mirrors NeRF_Dataset::DataToGPU (ref :153-217)."""
    import cv2

    name = meta.image_names[idx]
    rgb = cv2.imread(os.path.join(meta.root, "rgb", name), cv2.IMREAD_COLOR)
    if rgb is None:
        raise FileNotFoundError(f"Can not read image... path: rgb/{name}")
    rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
    depth = None
    if use_depth:
        d = cv2.imread(os.path.join(meta.root, "depth", name), cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(f"Can not read image... path: depth/{name}")
        # reference converts u16 -> f32 * (1/DepthMapFactor)? No: * factor
        # directly (ref nerf_data.cu:182, convertTo(..., mfDepthScale)).
        depth = d.astype(np.float32) * meta.depth_scale
    inst = cv2.imread(os.path.join(meta.root, "instance", name), cv2.IMREAD_UNCHANGED)
    if inst is None:
        raise FileNotFoundError(f"Can not read image... path: instance/{name}")
    if inst.ndim == 3:
        inst = inst[..., 0]
    return rgb, depth, inst.astype(np.uint8)


@dataclasses.dataclass
class ObjectFileData:
    cls: int
    two: np.ndarray  # object -> world
    tow: np.ndarray  # world -> object (= inv(Two), ref nerf.cu:89-90)
    half_extents: np.ndarray  # [3]
    stamps: list[str]
    bboxes: np.ndarray  # [N, 4] int (x, y, h, w)


def load_object_file(path: str) -> ObjectFileData:
    rows = _data_lines(path)
    head = rows[0]
    cls = int(head[0])
    nums = [float(x) for x in head[1:11]]
    t, q, half = nums[0:3], nums[3:7], np.array(nums[7:10], np.float32)
    two = pose_from_tq(t, q)
    stamps, boxes = [], []
    for row in rows[1:]:
        stamps.append(row[0])
        boxes.append([int(float(v)) for v in row[1:5]])  # x y h w
    return ObjectFileData(
        cls=cls, two=two, tow=invert_pose(two), half_extents=half,
        stamps=stamps,
        bboxes=np.asarray(boxes, np.int32).reshape(-1, 4),
    )


# ---------------------------------------------------------------------------
# Writers (synthetic dataset export + reference-format manifests)
# ---------------------------------------------------------------------------


def write_dataset(root: str, cam, frames: list[dict], objects=None, use_depth=True):
    """Write a full reference-format dataset from synthetic frames
    (data/synthetic.make_sequence output). Depth is stored as 16-bit PNG with
    DepthMapFactor chosen so depth_png * factor = meters (factor 1/5000,
    TUM-style)."""
    import cv2

    from romap_tpu_torch.utils.camera import rot_to_quat

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "instance"), exist_ok=True)
    if use_depth:
        os.makedirs(os.path.join(root, "depth"), exist_ok=True)

    factor = 1.0 / 5000.0
    with open(os.path.join(root, "config.yaml"), "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n")
        f.write(f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n")
        f.write(f"Camera.H: {cam.h}\nCamera.W: {cam.w}\n")
        f.write(f"DepthMapFactor: {factor}\n")

    with open(os.path.join(root, "img.txt"), "w") as fimg, open(
        os.path.join(root, "groundtruth.txt"), "w"
    ) as fgt:
        fimg.write("# stamp filename\n")
        fgt.write("# stamp tx ty tz qx qy qz qw\n")
        for i, fr in enumerate(frames):
            name = f"{i:06d}.png"
            cv2.imwrite(
                os.path.join(root, "rgb", name),
                cv2.cvtColor(fr["rgb"], cv2.COLOR_RGB2BGR),
            )
            cv2.imwrite(os.path.join(root, "instance", name), fr["instance"])
            if use_depth:
                d16 = np.clip(fr["depth"] / factor, 0, 65535).astype(np.uint16)
                cv2.imwrite(os.path.join(root, "depth", name), d16)
            fimg.write(f"{fr['stamp']} {name}\n")
            twc = fr["twc"]
            q = rot_to_quat(twc[:3, :3])
            t = twc[:3, 3]
            fgt.write(
                f"{fr['stamp']} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )

    # per-frame YOLO-style detection files for the online SLAM path
    # (ref src/Tracking.cc:345-390: bbox/<stamp>.txt, 'class x y w h conf')
    if objects is not None:
        os.makedirs(os.path.join(root, "bbox"), exist_ok=True)
        for fr in frames:
            with open(os.path.join(root, "bbox", f"{fr['stamp']}.txt"), "w") as f:
                for obj in objects:
                    bb = fr["bboxes"].get(obj.instance_id)
                    if bb is None:
                        continue
                    x, y, h, w = bb
                    f.write(f"{obj.instance_id} {x} {y} {w} {h} 0.95\n")

    if objects is not None:
        os.makedirs(os.path.join(root, "obj_offline"), exist_ok=True)
        for oi, obj in enumerate(objects):
            with open(os.path.join(root, "obj_offline", f"{oi}.txt"), "w") as f:
                f.write("# class tx ty tz qx qy qz qw a1 a2 a3\n")
                c = obj.center
                h = obj.aabb_half_extents() * 1.1
                f.write(
                    f"{obj.instance_id} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"0 0 0 1 {h[0]:.6f} {h[1]:.6f} {h[2]:.6f}\n"
                )
                for fi, fr in enumerate(frames):
                    bb = fr["bboxes"].get(obj.instance_id)
                    if bb is not None:
                        x, y, hh, ww = bb
                        f.write(f"{fr['stamp']} {x} {y} {hh} {ww}\n")
