"""Ray/AABB geometry, camera rays and stratified sampling (counterpart of
romap_tpu/ops/geometry.py; reference kernels cited there).

Everything broadcasts over leading batch axes; misses are reported with a
boolean mask instead of a sentinel distance.
"""

from __future__ import annotations

import torch


def ray_aabb_intersect(o, d, box_min, box_max):
    """Slab-method ray/AABB intersection.

    Args:
      o, d: [..., 3] ray origins and directions (object frame).
      box_min, box_max: [3] or broadcastable AABB corners.
    Returns:
      (tmin, tmax, hit) [...] each; tmin is not clamped to 0 here.

    |d| components below 1e-12 are replaced by +-1e-12, so slopes stay
    finite and gradients through the ray never become 0 * inf.
    """
    tiny = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
    d_safe = torch.where(torch.abs(d) < 1e-12, tiny, d)
    t0 = (box_min - o) / d_safe
    t1 = (box_max - o) / d_safe
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tmin, tmax, tmin <= tmax


def warp_point(p, box_min, box_max):
    """Map object-frame point(s) into the unit cube of the AABB."""
    return (p - box_min) / (box_max - box_min)


def pixel_dirs(x, y, intrinsics):
    """Camera-frame directions (z = 1) for pixel coords and their norms.

    Args:
      x, y: [...] pixel coordinates; intrinsics: [4] (fx, fy, cx, cy).
    Returns:
      (d_cam [..., 3], d_norm [...]).
    """
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x)], dim=-1)
    return d, torch.linalg.vector_norm(d, dim=-1)


def camera_rays(x, y, intrinsics, pose_wc, obj_tow):
    """Pixel -> world -> object-frame rays.

    Args:
      x, y: [...] pixel coordinates; intrinsics: [4].
      pose_wc: [..., 4, 4] camera-to-world; obj_tow: [..., 4, 4]
        world-to-object (broadcast against the pixel batch).
    Returns:
      (o [..., 3], unit d [..., 3], d_norm [...]).
    """
    d_cam, d_norm = pixel_dirs(x, y, intrinsics)
    d_cam = d_cam / d_norm[..., None]
    d_w = torch.einsum("...ij,...j->...i", pose_wc[..., :3, :3], d_cam)
    r_ow = obj_tow[..., :3, :3]
    d_o = torch.einsum("...ij,...j->...i", r_ow, d_w)
    o_o = torch.einsum("...ij,...j->...i", r_ow, pose_wc[..., :3, 3]) + obj_tow[..., :3, 3]
    return o_o.expand(d_o.shape), d_o, d_norm


def stratified_distances(tmin, tmax, jitter, n_samples: int):
    """t_n = tmin + dt (n + u_n), dt = (tmax - tmin) / S, u_n in [0, 1).

    Args:
      tmin, tmax: [...]; jitter: [..., S].
    Returns:
      [..., S] increasing distances.
    """
    dt = (tmax - tmin) / float(n_samples)
    n = torch.arange(n_samples, dtype=torch.float32, device=jitter.device)
    return tmin[..., None] + dt[..., None] * (n + jitter)


def unwarp_point(p, box_min, box_max):
    """Inverse of warp_point."""
    return box_min + p * (box_max - box_min)


def orbit_pose(theta_deg: float, phi_deg: float, radius: float) -> torch.Tensor:
    """Object-centric orbit camera pose Toc [4, 4] float32 (CPU): camera on
    the sphere at (theta, phi, radius), z axis looking at the origin, x axis
    horizontal at theta + 90 degrees (romap_tpu/ops/geometry.py:172)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    theta = torch.deg2rad(f32(theta_deg))
    phi = torch.deg2rad(f32(phi_deg))
    t = torch.stack([radius * torch.cos(phi) * torch.cos(theta),
                     radius * torch.cos(phi) * torch.sin(theta),
                     radius * torch.sin(phi)])
    z_axis = -t / torch.linalg.vector_norm(t)
    r_v = theta + torch.deg2rad(f32(90.0))
    x_axis = torch.stack([torch.cos(r_v), torch.sin(r_v), torch.zeros_like(r_v)])
    x_axis = x_axis / torch.linalg.vector_norm(x_axis)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    y_axis = y_axis / torch.linalg.vector_norm(y_axis)
    toc = torch.eye(4, dtype=torch.float32)
    toc[:3, 0], toc[:3, 1], toc[:3, 2], toc[:3, 3] = x_axis, y_axis, z_axis, t
    return toc


def se3_exp(delta: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: [..., 6] (omega, v) -> [..., 4, 4]
    (romap_tpu/ops/geometry.py:128-169).

    Below theta^2 = 1e-12 the Taylor forms of A, B, C are taken. The other
    branch is still differentiated, and (theta - sin theta) / theta^3 has a
    gradient that divides by ~0 there: theta = 1 is put in wherever the
    Taylor branch wins, so no NaN reaches the gradient at zero angle.
    """
    w, v = delta[..., :3], delta[..., 3:]
    theta2_raw = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # [..., 1, 1]
    small = theta2_raw < 1e-12
    theta2 = torch.where(small, torch.ones_like(theta2_raw), theta2_raw)
    theta = torch.sqrt(theta2)
    zeros = torch.zeros_like(w[..., 0])
    k = torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)  # [..., 3, 3]
    kk = k @ k
    a = torch.where(small, 1.0 - theta2_raw / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2_raw / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2_raw / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device).expand(k.shape)
    r = eye + a * k + b * kk
    vmat = eye + b * k + c * kk
    t = torch.einsum("...ij,...j->...i", vmat, v)
    top = torch.cat([r, t[..., None]], dim=-1)  # [..., 3, 4]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=delta.dtype,
                          device=delta.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)
