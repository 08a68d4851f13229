"""The encodings a field puts in front of its network, one object at a
time, points [N, 3] in the unit cube, from the configuration file's
`encoding` section:

  mxgrid    CP lines folded through the finest level's tent basis (or
            summed over the ladder, unsnapped), multiplied over x, y, z,
            plus plane x line pairs
  hashgrid  the tiny-cuda-nn hash grid (levels x features, trilinear)
"""

from __future__ import annotations

import math

import torch

from portbench.reference.precision import F32, Precision

# --------------------------------------------------------------------------
# Sizes
# --------------------------------------------------------------------------


def mx_sizes(enc: dict) -> dict:
    """The MX-grid ladder: per-level resolutions (geometric from
    base_resolution to mx_max_resolution), their row offsets, the plane
    levels (ru, rv, k) and the plane pairs' (u, v, line) axes."""
    n, base, top = enc["mx_levels"], enc["base_resolution"], enc["mx_max_resolution"]
    b = (top / base) ** (1.0 / (n - 1)) if n > 1 else 1.0
    res = [int(round(base * b**l)) for l in range(n)]
    offsets = [sum(res[:l]) for l in range(n)]
    pr = enc["mx_plane_res"]
    ru, rv = (pr, pr) if isinstance(pr, int) else pr
    planes = [(ru, rv, enc["mx_plane_features"])] if enc["mx_plane_features"] > 0 else []
    if enc.get("mx_plane_specs") is not None:
        planes = [tuple(p) if len(p) == 3 else (p[0], p[0], p[1]) for p in enc["mx_plane_specs"]]
    axes = {"uuv": [(0, 1, 2), (0, 2, 1), (1, 2, 0)],
            "balanced": [(0, 1, 2), (2, 0, 1), (1, 2, 0)]}[enc["mx_plane_axes"]]
    return dict(res=res, offsets=offsets, total=sum(res), features=enc["mx_features"],
                planes=planes, axes=axes, snap=enc["mx_snap_levels"])


def hash_sizes(enc: dict) -> dict:
    """tiny-cuda-nn's HashGrid: scale_l = 2^(l log2 b) N_min - 1 with b from
    the desired resolution 2048; resolution ceil(scale) + 1; a level holds
    min(2^log2_T, res^3) rows rounded up to 8, dense where res^3 fits."""
    n, base = enc["n_levels"], enc["base_resolution"]
    b = math.exp(math.log(enc["desired_resolution"] / base) / (n - 1)) if n > 1 else 1.0
    t = 1 << enc["log2_hashmap_size"]
    levels, off = [], 0
    for l in range(n):
        scale = 2.0 ** (l * math.log2(b)) * base - 1.0
        res = int(math.ceil(scale)) + 1
        size = -(-min(t, res**3 if res < 2048 else t + 1) // 8) * 8
        levels.append(dict(scale=scale, res=res, size=size, offset=off, dense=res**3 <= size))
        off += size
    return dict(levels=levels, total=off, features=enc["n_features_per_level"])


def out_dims(enc: dict) -> int:
    """Width of the features the encoding gives a point."""
    if enc["kind"] == "hashgrid":
        return enc["n_levels"] * enc["n_features_per_level"]
    s = mx_sizes(enc)
    return s["features"] + 3 * sum(k for _, _, k in s["planes"])


def leaf_shapes(enc: dict) -> dict:
    """{leaf name: shape of one object's leaf} of the encoding, in a fixed
    order: `table`; or `lines`, then `planes{i}` and `plane_lines{i}` of
    each plane level."""
    if enc["kind"] == "hashgrid":
        h = hash_sizes(enc)
        return {"table": (h["total"], h["features"])}
    s = mx_sizes(enc)
    shapes = {"lines": (3, s["total"], s["features"])}
    for i, (ru, rv, k) in enumerate(s["planes"]):
        shapes[f"planes{i}"] = (3, ru, rv, k)
        shapes[f"plane_lines{i}"] = (3, max(ru, rv), k)
    return shapes


# --------------------------------------------------------------------------
# Encodes
# --------------------------------------------------------------------------


def _tent(x: torch.Tensor, r: int, table: torch.Tensor) -> torch.Tensor:
    """sum_i max(0, 1 - |x (r-1) - i|) table[i] over rows i: two taps."""
    pos = x * (r - 1)
    i0 = torch.clamp(torch.floor(pos), 0, r - 2).long()
    w0 = torch.clamp(1.0 - torch.abs(pos - i0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(pos - i0 - 1), min=0.0)
    return w0[:, None] * table[i0] + w1[:, None] * table[i0 + 1]


def fold(s: dict, device) -> torch.Tensor:
    """[total, rf]: row (level l, index b) is level l's hat b sampled at the
    finest level's rf nodes (float64 arithmetic, fp32 result)."""
    rf = max(s["res"])
    c = torch.zeros((s["total"], rf), dtype=torch.float64, device=device)
    nodes = torch.arange(rf, dtype=torch.float64, device=device) / (rf - 1)
    for r, off in zip(s["res"], s["offsets"]):
        z = nodes[None, :] * (r - 1) - torch.arange(r, dtype=torch.float64, device=device)[:, None]
        c[off : off + r] = torch.clamp(1.0 - torch.abs(z), min=0.0)
    return c.to(F32)


def folding(enc: dict, device) -> torch.Tensor | None:
    """The folded ladder's basis (`fold`) where the encoding snaps its
    levels, else None: the `c` a field's forward passes to `encode`."""
    if enc["kind"] == "mxgrid" and enc["mx_snap_levels"]:
        return fold(mx_sizes(enc), device)
    return None


def encode_mx(w: dict, p: torch.Tensor, s: dict, q: Precision, c: torch.Tensor | None):
    """MX-grid features [N, K + 3 sum kp]: the CP product over axes, then
    each plane level's three (plane x line) pairs."""
    lines = q(w["lines"])
    cp = None
    for d in range(3):
        if s["snap"]:
            eff = torch.einsum("rk,rf->fk", lines[d], c)
            a = _tent(p[:, d], eff.shape[0], eff)
        else:
            a = sum(_tent(p[:, d], r, lines[d, off : off + r])
                    for r, off in zip(s["res"], s["offsets"]))
        cp = a if cp is None else cp * a
    blocks = [cp]
    for lvl, (ru, rv, k) in enumerate(s["planes"]):
        planes, plines = q(w[f"planes{lvl}"]), q(w[f"plane_lines{lvl}"])
        for i, (u, v, ax) in enumerate(s["axes"]):
            # bilinear on [ru, rv]: tent over u of (tent over v of the plane)
            pu, pv = p[:, u] * (ru - 1), p[:, v] * (rv - 1)
            iu = torch.clamp(torch.floor(pu), 0, ru - 2).long()
            iv = torch.clamp(torch.floor(pv), 0, rv - 2).long()
            f_pl = 0.0
            for du in (0, 1):
                wu = torch.clamp(1.0 - torch.abs(pu - iu - du), min=0.0)
                for dv in (0, 1):
                    wv = torch.clamp(1.0 - torch.abs(pv - iv - dv), min=0.0)
                    f_pl = f_pl + (wu * wv)[:, None] * planes[i][iu + du, iv + dv]
            f_li = _tent(p[:, ax], max(ru, rv), plines[i])
            blocks.append(f_pl * f_li)
    return q(torch.cat(blocks, dim=-1))


_PY, _PZ, _M32 = 2654435761, 805459861, 0xFFFFFFFF


def _mul32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a * prime) mod 2^32 in int64 without overflow: 16-bit halves of the prime."""
    return ((a * (prime >> 16)) % 65536 * 65536 + a * (prime & 0xFFFF)) % (1 << 32)


def encode_hash(w: dict, p: torch.Tensor, h: dict, q: Precision):
    """Hash-grid features [N, L F], level-major."""
    table = q(w["table"])
    outs = []
    for lv in h["levels"]:
        pos = p * lv["scale"] + 0.5
        cell = torch.floor(pos)
        frac = pos - cell
        ci = cell.long()
        feat = 0.0
        for corner in range(8):
            bit = [(corner >> d) & 1 for d in range(3)]
            c = [(ci[:, d] + bit[d]) & _M32 for d in range(3)]
            if lv["dense"]:
                idx = (c[0] + c[1] * lv["res"] + c[2] * lv["res"] ** 2) & _M32
            else:
                idx = c[0] ^ _mul32(c[1], _PY) ^ _mul32(c[2], _PZ)
            row = idx % lv["size"] + lv["offset"]
            wt = 1.0
            for d in range(3):
                wt = wt * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
            feat = feat + wt[:, None] * table[row]
        outs.append(feat)
    return q(torch.cat(outs, dim=-1))


def encode(w: dict, p: torch.Tensor, enc: dict, q: Precision, c: torch.Tensor | None):
    """The encoding's features of points `p` [N, 3] from the leaves in `w`."""
    if enc["kind"] == "hashgrid":
        return encode_hash(w, p, hash_sizes(enc), q)
    return encode_mx(w, p, mx_sizes(enc), q, c)
