"""Evaluation harness over the reference-format artifact tree.

The reference's de-facto eval contract (SURVEY.md §3.4) is the
`output/<objId>/{test_img,test_depth,test_mask,test.txt}` tree written by
RenderTestImg (ref nerf.cu:255-404): held-out view renders that external
tooling compares against dataset pixels. The reference ships NO in-repo
metric code; this module closes that gap — per-object PSNR / SSIM on object
pixels + mask IoU, against the dataset's rgb/ + instance/ images, written to
a json.

The port's copy of romap_tpu/utils/eval_psnr.py (the port imports nothing of
romap_tpu): only the import of `mesh_io` differs, held by
tests/test_torch_port_copies.py. OpenCV is imported only inside the
functions that read images or blur, so the module imports without it.

CLI:  python -m romap_tpu_torch.utils.eval_psnr <output_dir> <dataset_dir>
      [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _imread(path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return img


def _ssim(a: np.ndarray, b: np.ndarray, mask: np.ndarray | None = None) -> float:
    """Standard SSIM (Wang et al. 2004): 11x11 Gaussian window, sigma 1.5,
    on [0,1] grayscale; the SSIM map is averaged over `mask` (object pixels)
    so background zeros don't inflate the score. Comparable to literature
    numbers, unlike the single-window variant this replaced."""
    import cv2

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1, c2 = 0.01**2, 0.03**2
    blur = lambda x: cv2.GaussianBlur(x, (11, 11), 1.5)
    mu_a, mu_b = blur(a), blur(b)
    va = blur(a * a) - mu_a * mu_a
    vb = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    smap = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (va + vb + c2)
    )
    if mask is not None and mask.any():
        return float(smap[mask].mean())
    return float(smap.mean())


def _read_manifest(path):
    views = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            views.append(
                dict(stamp=parts[0], x=int(parts[1]), y=int(parts[2]),
                     h=int(parts[3]), w=int(parts[4]))
            )
    return views


def _stamp_to_image(dataset: str):
    """stamp(float-normalized) -> rgb/instance paths via img.txt."""
    table = {}
    with open(os.path.join(dataset, "img.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            stamp, name = line.split()[:2]
            table[f"{float(stamp):.6f}"] = name
    return table


def _chamfer_yaw(pred: np.ndarray, gt: np.ndarray, n_yaw: int = 36) -> float:
    """Symmetric chamfer distance between centered, scale-normalized point
    sets, minimized over a yaw search about z (the SLAM object frame's yaw
    gauge is arbitrary; monocular scale and translation were normalized
    out by the caller)."""
    best = np.inf
    for k in range(n_yaw):
        th = 2 * np.pi * k / n_yaw
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        a = pred @ rot.T
        d2 = ((a[:, None, :] - gt[None, :, :]) ** 2).sum(-1)
        ch = 0.5 * (np.sqrt(d2.min(1)).mean() + np.sqrt(d2.min(0)).mean())
        best = min(best, float(ch))
    return best


def _mesh_metrics(obj_dir: str, dataset: str):
    """Mesh-geometry metrics against the `gt_objects.json` sidecar (the
    north star's "extracted-mesh geometry within tolerance").

    For spherical GT (kind SphereObject, or legacy sidecars with only
    center/radius): fit a sphere to obj.ply (centroid + mean vertex radius,
    rotation/translation invariant — the mesh lives in the metric object
    frame) and report
      mesh_radius_ratio — fitted radius / GT radius (1.0 = perfect; carries
                          the monocular-scale error in online runs)
      mesh_shape_rms    — rms of (vertex radius - fitted radius) / fitted
                          radius: pure shape error, scale-free

    For ANY geometry with `surface_points` in the sidecar (boxes, concave
    compounds — the reference's mesh contract is object-agnostic, ref
    Core/src/marching_cubes.cu:512-650):
      mesh_scale_ratio  — mesh mean-radius / GT mean-radius (monocular scale)
      mesh_chamfer_norm — symmetric chamfer between centered,
                          scale-normalized mesh verts and GT surface samples,
                          min over a 36-step yaw search (fraction of the
                          object's mean radius; 0 = perfect shape)
    """
    gt_path = os.path.join(dataset, "gt_objects.json")
    ply_path = os.path.join(obj_dir, "obj.ply")
    if not (os.path.exists(gt_path) and os.path.exists(ply_path)):
        return {}
    try:
        with open(gt_path) as f:
            gt = json.load(f)
    except Exception:
        return {}  # malformed sidecar: skip the mesh metric, keep the rest
    # online SLAM object ids need not match dataset indices (output dirs are
    # slot/creation order, the sidecar is dataset enumeration order) — only
    # the single-object case is unambiguous without a pose-level match
    if len(gt) != 1:
        return {}
    entry = next(iter(gt.values()))
    try:
        from romap_tpu_torch.utils.mesh_io import load_ply

        verts = np.asarray(load_ply(ply_path).verts, np.float64)
    except Exception:
        return {}
    if len(verts) < 32:
        return {}
    out = {"mesh_verts": int(len(verts))}
    c = verts.mean(0)
    rad = np.linalg.norm(verts - c, axis=1)
    r_fit = float(rad.mean())
    if r_fit <= 0:
        return {}
    if entry.get("kind", "SphereObject") == "SphereObject":
        out["mesh_radius_ratio"] = round(r_fit / float(entry["radius"]), 4)
        out["mesh_shape_rms"] = round(float(np.sqrt(np.mean(
            ((rad - r_fit) / r_fit) ** 2))), 4)
    sp = entry.get("surface_points")
    if sp is not None:
        rng = np.random.default_rng(0)
        gtp = np.asarray(sp, np.float64)
        gtp = gtp - gtp.mean(0)
        g_scale = float(np.linalg.norm(gtp, axis=1).mean())
        if g_scale > 0:
            out["mesh_scale_ratio"] = round(r_fit / g_scale, 4)
            pv = (verts - c) / r_fit
            if len(pv) > 1024:
                pv = pv[rng.choice(len(pv), 1024, replace=False)]
            gn = gtp / g_scale
            if len(gn) > 1024:
                gn = gn[rng.choice(len(gn), 1024, replace=False)]
            out["mesh_chamfer_norm"] = round(_chamfer_yaw(pv, gn), 4)
    return out


def _infer_instance_id(crops) -> int | None:
    """Pick the dataset instance id this object dir corresponds to.

    Online SLAM object ids need not match dataset instance ids (output dirs
    are slot/creation order). When a bbox crop contains pixels of SEVERAL
    instances, `inst > 0` would score this object's render against other
    objects' ground-truth pixels too. Disambiguate by mask agreement: the
    id whose GT mask best matches the predicted mask, summed over views.
    Returns None when no view has a predicted mask (keeps the >0 fallback).
    """
    scores: dict[int, float] = {}
    for _ren, msk, _gt, inst in crops:
        if msk is None:
            continue
        pred = (msk if msk.ndim == 2 else msk[..., 0]) > 127
        for iid in np.unique(inst):
            if iid == 0:
                continue
            gt_px = inst == iid
            union = (pred | gt_px).sum()
            if union:
                scores[int(iid)] = scores.get(int(iid), 0.0) + float(
                    (pred & gt_px).sum()
                ) / float(union)
    if not scores:
        return None
    return max(scores, key=scores.get)


def evaluate_object(obj_dir: str, dataset: str, instance_id: int | None = None):
    """Metrics for one object's artifact dir. Returns dict or None."""
    manifest = os.path.join(obj_dir, "test.txt")
    if not os.path.exists(manifest):
        return None
    views = _read_manifest(manifest)
    stamp_map = _stamp_to_image(dataset)
    crops, view_stamps_all = [], []
    for v in views:
        name = stamp_map.get(f"{float(v['stamp']):.6f}")
        if name is None:
            continue
        ren = _imread(os.path.join(obj_dir, "test_img", f"{v['stamp']}.png"))
        msk = _imread(os.path.join(obj_dir, "test_mask", f"{v['stamp']}.png"))
        gt_full = _imread(os.path.join(dataset, "rgb", name))
        inst_full = _imread(os.path.join(dataset, "instance", name))
        if ren is None or gt_full is None or inst_full is None:
            continue
        x, y, h, w = v["x"], v["y"], v["h"], v["w"]
        gt = gt_full[y : y + h, x : x + w].astype(np.float32) / 255.0
        inst = inst_full[y : y + h, x : x + w]
        if inst.ndim == 3:
            inst = inst[..., 0]
        crops.append((ren, msk, gt, inst))
        view_stamps_all.append(v["stamp"])
    if instance_id is None and any(
        len(np.unique(inst[inst > 0])) > 1 for _, _, _, inst in crops
    ):
        instance_id = _infer_instance_id(crops)
    psnrs, ssims, ious, view_stamps = [], [], [], []
    for (ren, msk, gt, inst), stamp in zip(crops, view_stamps_all):
        if instance_id is None:
            obj_px = inst > 0
        else:
            obj_px = inst == instance_id
        if gt.shape[:2] != ren.shape[:2] or obj_px.sum() < 16:
            continue
        renf = ren.astype(np.float32) / 255.0
        mse = float(np.mean((renf[obj_px] - gt[obj_px]) ** 2))
        psnrs.append(-10.0 * np.log10(max(mse, 1e-9)))
        view_stamps.append(stamp)
        ga = renf[..., :3].mean(-1) * obj_px
        gb = gt[..., :3].mean(-1) * obj_px
        ssims.append(_ssim(ga, gb, obj_px))
        if msk is not None:
            pred = (msk if msk.ndim == 2 else msk[..., 0]) > 127
            union = (pred | obj_px).sum()
            if union:
                ious.append(float((pred & obj_px).sum()) / union)
    if not psnrs:
        return None
    out = {
        "n_views": len(psnrs),
        "psnr_db": round(float(np.mean(psnrs)), 2),
        "ssim": round(float(np.mean(ssims)), 4),
        "mask_iou": round(float(np.mean(ious)), 4) if ious else None,
        # per-view distribution: the mean hides stuck views (a single
        # 10 dB view costs the 29-view mean ~0.5 dB) — diagnostics need
        # the tail
        "psnr_min_db": round(float(np.min(psnrs)), 2),
        "psnr_p10_db": round(float(np.percentile(psnrs, 10)), 2),
        "psnr_median_db": round(float(np.median(psnrs)), 2),
        "per_view": {
            s: round(float(p), 2) for s, p in zip(view_stamps, psnrs)
        },
    }
    out.update(_mesh_metrics(obj_dir, dataset))
    return out


def _read_tum(path):
    """TUM trajectory: stamp tx ty tz qx qy qz qw -> {stamp: position}."""
    rows = {}
    try:
        with open(path) as f:
            for line in f:
                p = line.split()
                if len(p) < 4 or p[0].startswith("#"):
                    continue
                rows[f"{float(p[0]):.6f}"] = np.asarray(
                    [float(x) for x in p[1:4]], np.float64)
    except Exception:
        return {}
    return rows


def _align_sim3(src: dict, dst: dict):
    """Umeyama Sim(3) alignment of matched-by-stamp positions: returns
    (s, R, t, ate_rmse, n) with dst ≈ s·R·src + t — the standard monocular
    trajectory evaluation (scale is unobservable to a monocular SLAM)."""
    common = sorted(set(src) & set(dst))
    if len(common) < 3:
        return None
    a = np.stack([src[k] for k in common])
    b = np.stack([dst[k] for k in common])
    mu_a, mu_b = a.mean(0), b.mean(0)
    am, bm = a - mu_a, b - mu_b
    cov = bm.T @ am / len(common)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1
    rot = u @ sgn @ vt
    var_a = float((am**2).sum()) / len(common)
    if var_a <= 0:
        return None
    s = float(np.trace(np.diag(d) @ sgn)) / var_a
    t = mu_b - s * rot @ mu_a
    err = (s * (rot @ a.T).T + t) - b
    ate = float(np.sqrt(np.mean(np.sum(err**2, axis=1))))
    return s, rot, t, ate, len(common)


def _trajectory_alignment(output_dir: str, dataset: str):
    """Sim(3) from the run's FrameTrajectory.txt to dataset groundtruth.txt."""
    src = _read_tum(os.path.join(output_dir, "FrameTrajectory.txt"))
    dst = _read_tum(os.path.join(dataset, "groundtruth.txt"))
    if not src or not dst:
        return None
    return _align_sim3(src, dst)


def _read_tum_poses(path):
    """TUM trajectory -> {stamp: (R, t)} full SE(3) (file stores qx qy qz qw)."""
    rows = {}
    try:
        with open(path) as f:
            for line in f:
                p = line.split()
                if len(p) < 8 or p[0].startswith("#"):
                    continue
                t = np.asarray([float(x) for x in p[1:4]], np.float64)
                qx, qy, qz, qw = (float(x) for x in p[4:8])
                n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
                if n == 0:
                    continue
                qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
                rot = np.array([
                    [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)],
                    [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)],
                    [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)]])
                rows[f"{float(p[0]):.6f}"] = (rot, t)
    except Exception:
        return {}
    return rows


def _rpe(output_dir: str, dataset: str, scale: float, delta: int = 1):
    """TUM relative pose error (evaluate_rpe.py semantics) over consecutive
    matched stamps: E = (Qi⁻¹Qj)⁻¹(Pi⁻¹Pj) with the estimate's translations
    pre-scaled by the trajectory Sim(3) scale (monocular scale is gauge).
    Returns (trans_rmse_m, rot_mean_deg, n_pairs) or None."""
    est = _read_tum_poses(os.path.join(output_dir, "FrameTrajectory.txt"))
    gt = _read_tum_poses(os.path.join(dataset, "groundtruth.txt"))
    common = sorted(set(est) & set(gt))
    if len(common) < delta + 1:
        return None
    terr, rerr = [], []
    for i in range(len(common) - delta):
        a, b = common[i], common[i + delta]
        rp_a, tp_a = est[a][0], scale * est[a][1]
        rp_b, tp_b = est[b][0], scale * est[b][1]
        rq_a, tq_a = gt[a]
        rq_b, tq_b = gt[b]
        # relative motions P = Pa⁻¹Pb, Q = Qa⁻¹Qb, then E = Q⁻¹P
        rp = rp_a.T @ rp_b
        tp = rp_a.T @ (tp_b - tp_a)
        rq = rq_a.T @ rq_b
        tq = rq_a.T @ (tq_b - tq_a)
        re = rq.T @ rp
        te = rq.T @ (tp - tq)
        terr.append(float(te @ te))
        cosang = np.clip((np.trace(re) - 1.0) / 2.0, -1.0, 1.0)
        rerr.append(float(np.degrees(np.arccos(cosang))))
    return (float(np.sqrt(np.mean(terr))), float(np.mean(rerr)), len(terr))


def _cuboid_metrics(output_dir: str, dataset: str, align) -> dict:
    """Score objects.txt cuboids (ref System::SaveObjects src/System.cc:
    529-563 format: `id cls t q a1 a2 a3`) against the GT sidecar. Cuboids
    live in the (scale-free) SLAM world, so they are transported into the
    GT frame through the trajectory Sim(3) first; each row is then matched
    to the nearest GT center. Reports center error and per-axis
    half-extent / GT-radius ratios (spherical GT objects)."""
    obj_path = os.path.join(output_dir, "objects.txt")
    gt_path = os.path.join(dataset, "gt_objects.json")
    if not (os.path.exists(obj_path) and os.path.exists(gt_path)):
        return {}
    try:
        with open(gt_path) as f:
            gt = {}
            for k, v in json.load(f).items():
                # non-sphere GT compares per-axis half-extents (sorted on
                # both sides: the SLAM cuboid's yaw gauge is its own);
                # spheres compare every axis against the radius.
                # Prefer the minimal yaw-aligned cuboid GT when the sidecar
                # carries it: for yawed geometry the world-AABB
                # half_extents are inflated (|R(yaw)|·half) and would
                # penalize even a PERFECT body-frame cuboid estimate.
                if "cuboid_half_extents" in v:
                    ref = np.sort(np.asarray(
                        v["cuboid_half_extents"], np.float64))
                    cen = np.asarray(
                        v.get("cuboid_center", v["center"]), np.float64)
                elif v.get("kind", "SphereObject") != "SphereObject" and \
                        "half_extents" in v:
                    ref = np.sort(np.asarray(v["half_extents"], np.float64))
                    cen = np.asarray(v["center"], np.float64)
                else:
                    ref = np.full(3, float(v["radius"]))
                    cen = np.asarray(v["center"], np.float64)
                gt[k] = (cen, ref)
    except Exception:
        return {}
    if align is not None:
        s, rot, t = align[0], align[1], align[2]
    else:
        s, rot, t = 1.0, np.eye(3), np.zeros(3)
    rows = {}
    with open(obj_path) as f:
        for line in f:
            p = line.split()
            if len(p) < 12:
                continue
            center = s * rot @ np.asarray([float(x) for x in p[2:5]]) + t
            ext = s * np.asarray([float(x) for x in p[9:12]])
            gid = min(gt, key=lambda k: np.linalg.norm(gt[k][0] - center))
            c_gt, ref = gt[gid]
            cmp_ext = ext if (ref == ref[0]).all() else np.sort(ext)
            ratio = cmp_ext / ref
            rows[p[0]] = {
                "gt_id": gid,
                "center_err": round(float(np.linalg.norm(center - c_gt)), 4),
                "ext": [round(float(e), 4) for e in ext],
                "ext_ratio": [round(float(r), 4) for r in ratio],
                "ext_err_max": round(float(np.max(np.abs(ratio - 1))), 4),
            }
    if not rows:
        return {}
    return {
        "objects": rows,
        "mean_center_err": round(
            float(np.mean([r["center_err"] for r in rows.values()])), 4),
        "mean_ext_err_max": round(
            float(np.mean([r["ext_err_max"] for r in rows.values()])), 4),
    }


def evaluate_tree(output_dir: str, dataset: str) -> dict:
    results = {}
    for entry in sorted(os.listdir(output_dir)):
        obj_dir = os.path.join(output_dir, entry)
        if not (entry.isdigit() and os.path.isdir(obj_dir)):
            continue
        m = evaluate_object(obj_dir, dataset)
        if m:
            results[entry] = m
    agg = {}
    if results:
        agg = {
            "mean_psnr_db": round(
                float(np.mean([m["psnr_db"] for m in results.values()])), 2),
            "mean_mask_iou": round(
                float(np.mean([m["mask_iou"] for m in results.values()
                               if m["mask_iou"] is not None] or [0])), 4),
        }
    out = {"objects": results, "aggregate": agg}
    align = _trajectory_alignment(output_dir, dataset)
    if align is not None:
        out["trajectory"] = {
            "ate_m": round(align[3], 4),
            "n_poses": align[4],
            "scale": round(align[0], 4),
        }
        rpe = _rpe(output_dir, dataset, align[0])
        if rpe is not None:
            out["trajectory"]["rpe_trans_m"] = round(rpe[0], 4)
            out["trajectory"]["rpe_rot_deg"] = round(rpe[1], 4)
    cub = _cuboid_metrics(output_dir, dataset, align)
    if cub:
        out["cuboids"] = cub
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output_dir")
    ap.add_argument("dataset")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    res = evaluate_tree(args.output_dir, args.dataset)
    print(json.dumps(res, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
