"""Mesh export, byte-compatible with romap_tpu/utils/mesh_io.py (and so
with the reference's writers): ascii PLY (verts, normals, uchar colours,
reversed-winding faces), OBJ with optional chart UV unwrap, .mtl and a
baked TGA atlas, and a PLY reader for tests and tools. numpy code on the
port's Mesh; nerf_scale/nerf_offset undo an optional scene transform.
"""

from __future__ import annotations

import numpy as np

from romap_tpu_torch.ops.marching_cubes import Mesh


def save_ply(mesh: Mesh, path: str, nerf_scale: float = 1.0, nerf_offset=(0, 0, 0)):
    v = (mesh.verts - np.asarray(nerf_offset, np.float32)) / nerf_scale
    n = mesh.normals if mesh.normals is not None else np.zeros_like(v)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(lens, 1e-12)
    c = mesh.colors if mesh.colors is not None else np.ones_like(v)
    c8 = np.clip(c * 255.0, 0, 255).astype(np.uint8)
    f = mesh.faces
    with open(path, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            "comment romap_tpu marching cubes output\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(f)}\n"
            "property list uchar int vertex_index\nend_header\n"
        )
        for i in range(len(v)):
            fh.write(
                f"{v[i,0]:0.5f} {v[i,1]:0.5f} {v[i,2]:0.5f} "
                f"{n[i,0]:0.3f} {n[i,1]:0.3f} {n[i,2]:0.3f} "
                f"{c8[i,0]} {c8[i,1]} {c8[i,2]}\n"
            )
        for t in f:
            # reversed winding, matching the reference writer (ref :608)
            fh.write(f"3 {t[2]} {t[1]} {t[0]}\n")


def _quad_layout(n_tri: int) -> tuple[int, int, int, int, int, int]:
    """Texture-atlas chart layout: two triangles per 11x8 quad, quads in a
    near-square grid rounded to a multiple of 4 columns (same layout math as
    the reference, ref save_mesh marching_cubes.cu:532-539)."""
    numquads = (n_tri + 1) // 2
    numquadsx = (int(np.sqrt(max(numquads, 1))) + 4) & ~3
    numquadsy = (numquads + numquadsx - 1) // numquadsx
    quadresy = 8
    quadresx = quadresy + 3
    return numquads, numquadsx, numquadsy, quadresx, quadresy


# per-triangle corner offsets inside a chart quad (d = quadresy - 1):
# even triangle: (0,0), (d,d), (0,d);  odd triangle: (3,0), (3+d,0), (3+d,d)
# (ref marching_cubes.cu:630-641)
_TRI_CORNERS = (((0, 0), ("d", "d"), (0, "d")), ((3, 0), ("3d", 0), ("3d", "d")))


def _corner_xy(which, d: int) -> np.ndarray:
    def val(s):
        return d if s == "d" else (3 + d if s == "3d" else s)

    return np.array([[val(a), val(b)] for a, b in which], np.float32)


def save_tga(img: np.ndarray, path: str) -> None:
    """Minimal uncompressed true-color TGA writer (top-left origin), the
    format the reference emits via stb (ref marching_cubes.cu:563)."""
    h, w = img.shape[:2]
    header = np.zeros(18, np.uint8)
    header[2] = 2  # uncompressed true color
    header[12], header[13] = w & 255, (w >> 8) & 255
    header[14], header[15] = h & 255, (h >> 8) & 255
    header[16] = 24
    header[17] = 0x20  # top-left origin
    bgr = np.ascontiguousarray(img[..., ::-1])
    with open(path, "wb") as fh:
        fh.write(header.tobytes())
        fh.write(bgr.tobytes())


def bake_chart_texture(mesh: Mesh, numquadsx: int, numquadsy: int,
                       quadresx: int, quadresy: int) -> np.ndarray:
    """Bake per-vertex colors into the chart atlas by barycentric
    interpolation. The reference fills the atlas with per-triangle hash
    colors (a placeholder, ref marching_cubes.cu:549-556); interpolating the
    NeRF vertex colors keeps the identical layout but produces a texture
    that actually renders the object."""
    n_tri = len(mesh.faces)
    numquads = (n_tri + 1) // 2
    d = quadresy - 1
    texw, texh = quadresx * numquadsx, quadresy * numquadsy

    cols = mesh.colors if mesh.colors is not None else np.ones_like(mesh.verts)
    # [n_tri, 3 corners, rgb] padded to 2*numquads triangles
    tri_cols = np.clip(cols[mesh.faces], 0.0, 1.0).astype(np.float32)
    pad = 2 * numquads - n_tri
    if pad:
        tri_cols = np.concatenate([tri_cols, np.zeros((pad, 3, 3), np.float32)])

    # barycentric weights of every local texel wrt both triangle layouts
    yy, xx = np.mgrid[0:quadresy, 0:quadresx].astype(np.float32)
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)  # [Q, 2]

    def bary(corners: np.ndarray) -> np.ndarray:
        a, b, c = corners
        m = np.array([[b[0] - a[0], c[0] - a[0]], [b[1] - a[1], c[1] - a[1]]])
        uv = (pts - a) @ np.linalg.inv(m).T  # [Q, 2]
        w = np.stack([1 - uv[:, 0] - uv[:, 1], uv[:, 0], uv[:, 1]], axis=1)
        w = np.clip(w, 0.0, None)
        return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-9)  # [Q, 3]

    w_even = bary(_corner_xy(_TRI_CORNERS[0], d))
    w_odd = bary(_corner_xy(_TRI_CORNERS[1], d))
    odd_mask = (pts[:, 0] > pts[:, 1] + 1)[:, None]  # ref: xi > yi + 1

    even_cols = np.einsum("qk,nkc->nqc", w_even, tri_cols[0::2])
    odd_cols = np.einsum("qk,nkc->nqc", w_odd, tri_cols[1::2])
    quad_tex = np.where(odd_mask[None], odd_cols, even_cols)  # [numquads, Q, 3]
    quad_tex = quad_tex.reshape(numquads, quadresy, quadresx, 3)

    tex = np.zeros((texh, texw, 3), np.float32)
    qi = np.arange(numquads)
    qx, qy = qi % numquadsx, qi // numquadsx
    for q in range(numquads):  # row-block copies; cheap vs the einsum above
        tex[qy[q] * quadresy:(qy[q] + 1) * quadresy,
            qx[q] * quadresx:(qx[q] + 1) * quadresx] = quad_tex[q]
    return (tex * 255.0 + 0.5).astype(np.uint8)


def save_obj(mesh: Mesh, path: str, nerf_scale: float = 1.0,
             nerf_offset=(0, 0, 0), unwrap: bool = False):
    """OBJ writer. unwrap=False: v/vn/f with per-vertex colors (ref
    marching_cubes.cu:612-618, 643-647). unwrap=True: additionally emits the
    reference's chart UV layout (vt per face corner, ref :630-641), an
    .mtl, and a baked .tga texture atlas (the reference writes the same
    atlas but with placeholder hash colors and omits the .mtl it names)."""
    v = (mesh.verts - np.asarray(nerf_offset, np.float32)) / nerf_scale
    n = mesh.normals if mesh.normals is not None else np.zeros_like(v)
    c = mesh.colors if mesh.colors is not None else np.ones_like(v)
    base = path[:-4] if path.endswith(".obj") else path
    _, numquadsx, numquadsy, quadresx, quadresy = _quad_layout(len(mesh.faces))
    texw, texh = quadresx * numquadsx, quadresy * numquadsy
    d = quadresy - 1
    with open(path, "w") as fh:
        if unwrap:
            fh.write(f"mtllib {base.split('/')[-1]}.mtl\n")
        for i in range(len(v)):
            cc = np.clip(c[i], 0, 1)
            fh.write(
                f"v {v[i,0]:0.5f} {v[i,1]:0.5f} {v[i,2]:0.5f} "
                f"{cc[0]:0.3f} {cc[1]:0.3f} {cc[2]:0.3f}\n"
            )
        for i in range(len(n)):
            nn = n[i] / max(np.linalg.norm(n[i]), 1e-12)
            fh.write(f"vn {nn[0]:0.5f} {nn[1]:0.5f} {nn[2]:0.5f}\n")
        if not unwrap:
            for t in mesh.faces:
                fh.write(
                    f"f {t[2]+1}//{t[2]+1} {t[1]+1}//{t[1]+1} {t[0]+1}//{t[0]+1}\n"
                )
            return
        # one vt per face corner at the chart positions (ref :627-641)
        offs = [(0, 0), (d, d), (0, d), (3, 0), (3 + d, 0), (3 + d, d)]
        for i in range(3 * len(mesh.faces)):
            q = i // 6
            x = (q % numquadsx) * quadresx + offs[i % 6][0]
            y = (q // numquadsx) * quadresy + offs[i % 6][1]
            fh.write(f"vt {(x + 0.5) / texw:0.5f} {1.0 - (y + 0.5) / texh:0.5f}\n")
        fh.write("g default\nusemtl nerf\ns 1\n")
        for i, t in enumerate(mesh.faces):
            b = 3 * i
            fh.write(
                f"f {t[2]+1}/{b+3}/{t[2]+1} {t[1]+1}/{b+2}/{t[1]+1} "
                f"{t[0]+1}/{b+1}/{t[0]+1}\n"
            )
    tex = bake_chart_texture(mesh, numquadsx, numquadsy, quadresx, quadresy)
    save_tga(tex, base + ".tga")
    with open(base + ".mtl", "w") as fh:
        name = base.split("/")[-1]
        fh.write(f"newmtl nerf\nKd 1 1 1\nmap_Kd {name}.tga\n")


def load_ply(path: str) -> Mesh:
    """Read back an ascii PLY written by save_ply (for tests/tools)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    n_v = n_f = 0
    i = 0
    for i, ln in enumerate(lines):
        if ln.startswith("element vertex"):
            n_v = int(ln.split()[-1])
        elif ln.startswith("element face"):
            n_f = int(ln.split()[-1])
        elif ln == "end_header":
            break
    body = lines[i + 1 :]
    vdata = np.array([[float(x) for x in ln.split()] for ln in body[:n_v]])
    fdata = np.array(
        [[int(x) for x in ln.split()[1:]] for ln in body[n_v : n_v + n_f]], np.int32
    )
    verts = vdata[:, 0:3].astype(np.float32)
    normals = vdata[:, 3:6].astype(np.float32)
    colors = (vdata[:, 6:9] / 255.0).astype(np.float32)
    faces = fdata[:, ::-1]  # undo reversed winding
    return Mesh(verts=verts, faces=faces, normals=normals, colors=colors)
