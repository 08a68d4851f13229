"""Pose math: quaternions <-> rotations, TUM-format helpers (numpy, host)."""

from __future__ import annotations

import numpy as np


def quat_to_rot(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Unit quaternion (x, y, z, w) -> 3x3 rotation matrix."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ],
        np.float64,
    )


def rot_to_quat(r: np.ndarray) -> tuple[float, float, float, float]:
    """3x3 rotation -> quaternion (x, y, z, w), w >= 0."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        qw = (r[k, j] - r[j, k]) / s
        qx, qy, qz = q
    if qw < 0:
        qx, qy, qz, qw = -qx, -qy, -qz, -qw
    return float(qx), float(qy), float(qz), float(qw)


def pose_from_tq(t, q_xyzw) -> np.ndarray:
    """4x4 transform from translation + quaternion (TUM line order)."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_rot(*q_xyzw)
    m[:3, 3] = t
    return m


def invert_pose(m: np.ndarray) -> np.ndarray:
    """Fast inverse of a rigid transform."""
    out = np.eye(4, dtype=m.dtype)
    r = m[:3, :3]
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ m[:3, 3]
    return out
