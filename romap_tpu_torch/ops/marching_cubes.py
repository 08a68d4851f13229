"""Marching cubes on the device: two passes of tensor ops + compaction
(counterpart of romap_tpu/ops/marching_cubes.py).

  pass 1: edge-crossing masks and lerped vertex positions for the three
    edge directions over the whole grid; vertex ids assigned by an
    exclusive cumsum over the flattened [3, res^3] crossing mask, so ids
    (and therefore faces) come out in the reference's order;
  pass 2: per-cell 8-corner sign mask -> triangle table row -> edge ids
    mapped to vertex ids through the three id grids;
  compaction: drop the -1 padding (the only dynamic-shape step), then the
    mesh goes to the host as numpy arrays.

The triangle table is generated here with the reference's rule (marching
squares on the 6 faces, ambiguous faces split around the inside corners,
loops fan-triangulated and oriented inside -> outside); the parity tests
hold it equal to romap_tpu's table, which cannot be imported without jax.
Corner, edge and bit conventions are those of the reference module.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# corner index -> (dx, dy, dz), bit order of the reference's cell mask
CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32
)
# edge index -> (corner a, corner b)
EDGE_CORNERS = np.array(
    [(0, 1), (1, 2), (3, 2), (0, 3),
     (4, 5), (5, 6), (7, 6), (4, 7),
     (0, 4), (1, 5), (2, 6), (3, 7)], np.int32
)
# edge index -> (axis, dx, dy, dz): direction of the edge grid it lives in
# and the offset of its anchor lattice point within the cell.
EDGE_GRID = np.array(
    [(0, 0, 0, 0), (1, 1, 0, 0), (0, 0, 1, 0), (1, 0, 0, 0),
     (0, 0, 0, 1), (1, 1, 0, 1), (0, 0, 1, 1), (1, 0, 0, 1),
     (2, 0, 0, 0), (2, 1, 0, 0), (2, 1, 1, 0), (2, 0, 1, 0)], np.int32
)

# faces: 4 corners in cyclic order (so consecutive pairs are face edges)
_FACES = [
    (0, 1, 2, 3),  # z = 0
    (4, 5, 6, 7),  # z = 1
    (0, 1, 5, 4),  # y = 0
    (3, 2, 6, 7),  # y = 1
    (0, 3, 7, 4),  # x = 0
    (1, 2, 6, 5),  # x = 1
]


def _edge_between(ca: int, cb: int) -> int:
    for e, (a, b) in enumerate(EDGE_CORNERS):
        if {a, b} == {ca, cb}:
            return e
    raise ValueError((ca, cb))


@functools.cache
def build_triangle_table() -> np.ndarray:
    """[256, 16] int8 triangle table (edge ids, -1 padded), generated."""
    table = np.full((256, 16), -1, np.int8)
    midpoints = (CORNERS[EDGE_CORNERS[:, 0]] + CORNERS[EDGE_CORNERS[:, 1]]) / 2.0

    for mask in range(1, 255):
        inside = [(mask >> c) & 1 == 1 for c in range(8)]
        # pair cut edges on each face (marching squares per face)
        links: dict[int, list[int]] = {}

        def link(e1, e2):
            links.setdefault(e1, []).append(e2)
            links.setdefault(e2, []).append(e1)

        for f in _FACES:
            cut = []
            for k in range(4):
                a, b = f[k], f[(k + 1) % 4]
                if inside[a] != inside[b]:
                    cut.append((k, _edge_between(a, b)))
            if len(cut) == 2:
                link(cut[0][1], cut[1][1])
            elif len(cut) == 4:
                # ambiguous face: separate the inside(positive) diagonal —
                # pair each cut edge with its neighbor around an OUTSIDE corner,
                # a rule that depends only on the face's corner states (view-
                # consistent between the two cells sharing the face).
                # cut edges are at positions k0<k1<k2<k3 = 0,1,2,3 (alternating
                # corners); pair (edge after corner f[1], edge after f[2]) etc.
                # Walk corners: segments must isolate each inside corner.
                # corners alternate inside/outside; pair edges adjacent to the
                # same INSIDE corner.
                for k in range(4):
                    if inside[f[k]]:
                        e_prev = _edge_between(f[(k + 3) % 4], f[k])
                        e_next = _edge_between(f[k], f[(k + 1) % 4])
                        link(e_prev, e_next)
            # len(cut) == 0: nothing

        # trace closed loops
        cut_edges = sorted(links.keys())
        visited: set[int] = set()
        tris: list[tuple[int, int, int]] = []

        for start in cut_edges:
            if start in visited:
                continue
            loop = [start]
            visited.add(start)
            prev, cur = None, start
            while True:
                nxt = next(e for e in links[cur] if e != prev)
                if nxt == start:
                    break
                loop.append(nxt)
                visited.add(nxt)
                prev, cur = cur, nxt

            # Orient the loop so triangles are CCW seen from OUTSIDE (normal
            # (p1-p0)x(p2-p0) points inside -> outside). Robust local rule:
            # every cut edge's inside->outside corner direction has positive
            # dot with the true surface normal, so vote them against the
            # loop's Newell normal.
            pts = midpoints[loop]
            n = np.zeros(3)
            for i in range(len(loop)):
                p0, p1 = pts[i], pts[(i + 1) % len(loop)]
                n += np.cross(p0, p1)
            vote = 0.0
            for e in loop:
                a, b = EDGE_CORNERS[e]
                if not inside[a]:
                    a, b = b, a  # a inside, b outside
                vote += np.dot(n, CORNERS[b] - CORNERS[a])
            if vote < 0:
                loop = loop[::-1]
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))

        flat = [e for t in tris for e in t]
        assert len(flat) <= 16, (mask, len(flat))
        table[mask, : len(flat)] = flat
    return table


class Mesh(NamedTuple):
    verts: np.ndarray  # [V, 3] float32, object-frame coordinates
    faces: np.ndarray  # [T, 3] int32 vertex indices
    normals: np.ndarray | None = None  # [V, 3]
    colors: np.ndarray | None = None  # [V, 3] float in [0,1]


def _mc_passes(density: torch.Tensor, thresh: float, res: int):
    """Crossing, vertex and face passes on density's device. density:
    [res^3] flat, index x + y res + z res^2 (as models.nerf.density_on_grid).
    Returns (cross [3, res^3] bool, verts_all [3, res^3, 3] in grid units,
    face_vids [cells, 16] vertex ids, -1 padded)."""
    d = density.reshape(res, res, res).float()  # [z, y, x]
    inside = d > thresh
    dev = d.device

    def crossings(axis):  # 0 = x (last dim), 1 = y, 2 = z
        dim = 2 - axis
        cross = torch.zeros_like(inside)
        frac = torch.zeros_like(d)
        f0, f1 = d.narrow(dim, 0, res - 1), d.narrow(dim, 1, res - 1)
        cross.narrow(dim, 0, res - 1).copy_(inside.narrow(dim, 0, res - 1)
                                            != inside.narrow(dim, 1, res - 1))
        frac.narrow(dim, 0, res - 1).copy_((thresh - f0) / (f1 - f0))
        return cross, frac

    cross, fracs = zip(*(crossings(a) for a in range(3)))
    cross_flat = torch.stack([c.reshape(-1) for c in cross])  # [3, res^3]
    flat = cross_flat.reshape(-1)
    vid = torch.where(flat, torch.cumsum(flat, 0) - 1, -1).reshape(3, res, res, res)

    lin = torch.arange(res, dtype=torch.float32, device=dev)
    zz, yy, xx = torch.meshgrid(lin, lin, lin, indexing="ij")
    base = torch.stack([xx, yy, zz], -1)  # [z, y, x, 3]
    verts_all = base[None].repeat(3, 1, 1, 1, 1)
    for a in range(3):
        verts_all[a, ..., a] += fracs[a]
    verts_all = verts_all.reshape(3, -1, 3)

    c = res - 1
    window = lambda t, dx, dy, dz: t[dz : dz + c, dy : dy + c, dx : dx + c]
    mask = torch.zeros((c, c, c), dtype=torch.int64, device=dev)
    for bit, (dx, dy, dz) in enumerate(CORNERS.tolist()):
        mask |= window(inside, dx, dy, dz).long() << bit
    table = torch.as_tensor(build_triangle_table(), dtype=torch.int64, device=dev)
    tri_edges = table[mask.reshape(-1)]  # [cells, 16]
    local = torch.stack([window(vid[a], dx, dy, dz).reshape(-1)
                         for a, dx, dy, dz in EDGE_GRID.tolist()], dim=1)  # [cells, 12]
    face_vids = torch.where(tri_edges >= 0,
                            torch.gather(local, 1, tri_edges.clamp(min=0)), -1)
    return cross_flat, verts_all, face_vids


def marching_cubes(density, box_min, box_max, res: int, thresh: float = 2.0) -> Mesh:
    """Extract the iso-surface mesh.

    Args:
      density: [res^3] flat density grid (index x + y res + z res^2), a
        tensor on any device or a numpy array.
      box_min/box_max: object-frame AABB; vertices are mapped into it (the
        grid spans the AABB with res lattice points per axis).
    Returns:
      Mesh with numpy verts [V, 3] f32 and faces [T, 3] int32.
    """
    cross, verts_all, face_vids = _mc_passes(torch.as_tensor(density), float(thresh), res)
    # the -1 padding is a suffix of each row, so row-major selection keeps
    # the triples intact
    verts = verts_all.reshape(-1, 3)[cross.reshape(-1)].cpu().numpy()
    faces = face_vids[face_vids >= 0].reshape(-1, 3).to(torch.int32).cpu().numpy()
    scale = (np.asarray(box_max) - np.asarray(box_min)) / (res - 1)
    verts = verts.astype(np.float32) * scale.astype(np.float32) + np.asarray(
        box_min, np.float32)
    return Mesh(verts=verts, faces=faces)


def compute_normals(mesh: Mesh) -> Mesh:
    """Area-weighted vertex normals by 1-ring accumulation of
    (pb - pa) x (pc - pa) (faces are CCW seen from outside)."""
    v, f = mesh.verts, mesh.faces
    if len(f) == 0:
        return mesh._replace(normals=np.zeros_like(v))
    pa, pb, pc = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(pb - pa, pc - pa)
    normals = np.zeros_like(v)
    np.add.at(normals, f[:, 0], n)
    np.add.at(normals, f[:, 1], n)
    np.add.at(normals, f[:, 2], n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(lens, 1e-12)
    return mesh._replace(normals=normals.astype(np.float32))
