"""What a tensor-core encode backward spends its time on: K2
(`folded_bwd_tc`, mxgrid_folded.cu) or K4 (`unsnapped_bwd_tc`,
mxgrid_unsnapped.cu), at the flagship spec or (`K2q`, `K4q`) at the
`quality` preset's, timed with one part removed at a time; with
`--kernel K3`, the same for the three-axis unsnapped forward
(`unsnapped_fwd3`, K3 and K7); with `--kernel K9`, for the split path's
plane kernels K9 and K10 (mxgrid_planes.cu, both timed).

Copies the package into `build/ablate/<name>/` (gitignored), edits the copy
of the source that holds the part (the kernel's `.cu`, or `mxgrid_tc.cuh`
for the helpers both kernels share), and runs `tools/time_encode.py` on
every copy in one run on one card (K1/K2 at the flagship spec or K3/K4 at
the flagship spec unsnapped, or both at `quality`'s; bf16, --objects x
131072 points). The ablated
kernels compute wrong sums; only their times mean anything. The difference
to `base` is the part's share of the time, as far as the parts do not
overlap.

  base    the kernel as it is (run first and last)
  nomma   no mma.sync (the compiler then drops the `hat` fragments too)
  nohat   `hat` fragments replaced by a constant (the products stay)
  nored   no vector atomics into the plane gradient
  nou     u_d = g A_e A_f not formed
  noload  only the first tile is loaded

and for K3 (K3 and K7 timed, bf16):

  noafac   no afac stores
  noload   no table reads (the row offsets stand in for the values)
  nostore  no copy of the staged rows to the output
  noplanes no plane pairs (K3)
  lv8      the 8-level build instead of the 6-level one

and for K9 (K9 and K10 timed at the flagship plane level, bf16; each edit
has the patterns of PR 3's first design and of PR 7's, so `--root` may name
a checkout of either):

  k9_noload    K9 reads no table (the row offsets stand in for the values)
  k9_nostore   K9 stores no residual row and no plane feature
  k10_noload   K10 reads no point, residual or cotangent from memory
  k10_noline   no line gradient (PR 3: its shared-memory atomics; PR 7: the
               products, and with them the hat_w fragments and the flush)
  k10_noplane  no plane-gradient atomics
  k10_neither  neither (what is left: loads, operand, barriers, flush)

Usage: python3 -m romap_tpu_torch.tools.ablate_backward [--kernel K2|K4|K2q|K4q|K3|K9]
[--objects 10] [--points-kind uniform|rays] [--root <checkout>] (from the
repo root; needs a CUDA device and nvcc; `--root` ablates the package of
another checkout, e.g. the parent unpacked under build/). Each edit asserts
that it changed the source, so the script fails when the kernel has moved
on.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
OUT = PKG.parent / "build" / "ablate"
HELPERS = "mxgrid_tc.cuh"
# kernel -> (its source, the pair time_encode.py runs, its line-gradient
# product, the warp count in its u loop)
KERNELS = {"K2": ("mxgrid_folded.cu", "K1", "mma16816(la[m], al, b0, b1);", "kTcWarps"),
           "K4": ("mxgrid_unsnapped.cu", "K3", "mma16816(lacc, al, b0, b1);", "kWarps"),
           "K2q": ("mxgrid_folded.cu", "K1q", "mma16816(la[m], al, b0, b1);", "kTcWarps"),
           "K4q": ("mxgrid_unsnapped.cu", "K3q", "mma16816(lacc, al, b0, b1);", "kWarps"),
           "K3": ("mxgrid_unsnapped.cu", "K3,K7", None, None),
           "K9": ("mxgrid_planes.cu", "K9", None, None)}
COMMON = "mxgrid_common.cuh"


def _subs(*patterns):
    """An edit that applies every (regex, replacement) that matches."""
    def edit(s):
        for pat, rep in patterns:
            s = re.sub(pat, rep, s)
        return s
    return edit


NOLINE = ((r"\n\s*add_if\(&l_i\[tw\.j[01] \* ls \+ c\], tw\.w[01], gp\);", ""),
          (r"\n\s*mma16816\(lacc\[m\], al, b0, b1\);", ""))
NOPLANE = ((r"\n\s*add_if\(&c[01][01]\[c\], tu\.w[01] \* tv\.w[01], gl\);", ""),
           (r"\n\s*red4_if\(p_i[^;]*;", ""))


def plane_edits() -> dict:
    """{name: (files, edit)} for K9/K10: PR 3's design (the pair helpers of
    mxgrid_common.cuh) and PR 7's (mxgrid_planes.cu); an edit changes
    whichever of the files holds its pattern."""
    both = ("mxgrid_planes.cu", COMMON)
    return {
        "base": (both, lambda s: s),
        "k9_noload": (both, _subs(
            # PR 3: scalar corner and tap reads in plane_pair_fwd
            (r"to_f\((c[01][01])\[c\]\)", r"(float)(size_t)(\1 + c)"),
            (r"to_f\(l_i\[(tw\.j[01]) \* kp \+ c\]\)", r"(float)(\1 * kp + c)"),
            # PR 7: the vector loads of load_chans
            (r"load_chans<T, G>\((\w+) \+ (\w+), (\w+)\);",
             r"for (int c = 0; c < G; ++c) \3[c] = (float)(\2 + c);"))),
        "k9_nostore": (both, _subs(
            (r"\n(\s*)(fpl_o\[\(size_t\)row \* P \+ p\] = from_f<T>\(f_pl\);)",
             r"\n\1if (f_pl == 12345.f) \2"),
            (r"\n(\s*)(fli_o\[\(size_t\)row \* P \+ p\] = from_f<T>\(f_li\);)",
             r"\n\1if (f_li == 12345.f) \2"),
            (r"\n(\s*)(store_rows<T, G>\()",
             r"\n\1if (pl[0] + li[G - 1] + pl[G - 1] + li[0] == 12345.f) \2"))),
        "k10_noload": (both, _subs(
            (r"to_f\(g_p\[c\]\)", "(float)c"),
            (r"to_f\((fpl_o|fli_o)\[\(size_t\)row \* P \+ p\]\)", r"(float)(row + p)"),
            (r"const float x\[3\] = \{pts\[op \* 3 \+ 0\], pts\[op \* 3 \+ 1\], "
             r"pts\[op \* 3 \+ 2\]\};\n(\s*)const T\* g_p",
             # hashed points in the unit cube: the same taps and atomics as uniform ones
             r"const float x[3] = {(float)((p * 2654435761u) >> 8) * 5.96e-8f, "
             r"(float)((p * 2246822519u) >> 8) * 5.96e-8f, "
             r"(float)((p * 3266489917u) >> 8) * 5.96e-8f};\n\1const T* g_p"),
            (r"if \(tile \+ \(int\)gridDim\.x < n_tiles\) load_tile\(tile \+ gridDim\.x, s \^ 1\);"
             r"\n\s*else cp_async_commit\(\);", "cp_async_commit();"))),
        "k10_noline": (both, _subs(*NOLINE)),
        "k10_noplane": (both, _subs(*NOPLANE)),
        "k10_neither": (both, _subs(*NOLINE, *NOPLANE)),
    }


def forward_edits() -> dict:
    """{name: (file, edit)} for `unsnapped_fwd3`."""
    src = KERNELS["K3"][0]
    sub = lambda old, new: (src, lambda s: s.replace(old, new))
    store = "afac_o[((size_t)d * K + k + c) * P + p] = a_t;"
    load = "load4(w_s + tp[d][l].row + {}k, v{});"
    fake = "for (int c = 0; c < 4; ++c) v{}[c] = __int_as_float(tp[d][l].row + {}k + c);"
    copy = "for (int v = lane; v < (int)(n_bytes / 16); v += 32) dst4[v] = src4[v];"
    pair = "plane_pair_fwd<T>(x, i, axes, pl_o, li_o, fpl_o, fli_o, row + K + i * kp, P, p,"
    return {
        "base": (src, lambda s: s),
        "noafac": sub(store, "if (to_f(a_t) == 12345.f) " + store),
        "noload": (src, lambda s: s.replace(load.format("", 0), fake.format(0, "")).replace(
            load.format("ks + ", 1), fake.format(1, "ks + "))),
        "nostore": sub(copy, "if (n_rows < 0) " + copy),
        "noplanes": sub(pair, "if (kp < 0) " + pair),
        "lv8": sub("  if (lad.n == 6)\n", "  if (lad.n == -1)\n"),
    }


def _nomma(s, line_mma):
    for call in ("mma16816(acc[m][2 * np], a[m], b[0], b[1]);",
                 "mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);", line_mma):
        assert call in s, call
        s = s.replace(call, "")
    return s


def _nohat(s):
    i = s.index("__device__ __forceinline__ void hat_fragment")
    j = s.index("__device__ __forceinline__ void mma16816")
    return s[:i] + ("__device__ __forceinline__ void hat_fragment(float, float2 t, float2, "
                    "uint32_t* a) {\n  a[0] = a[1] = a[2] = a[3] = __float_as_uint(t.x) & "
                    "0x3f803f80u;\n}\n\n") + s[j:]


def edits(kernel: str) -> dict:
    """{name: (file under csrc/, edit of its text)} for `kernel`."""
    if kernel == "K3":
        return forward_edits()
    if kernel == "K9":
        return plane_edits()
    src, _, line_mma, warps = KERNELS[kernel]
    u_loop = f"for (int ws = warp; ws < K; ws += {warps}) {{"
    return {
        "base": (src, lambda s: s),
        "nomma": (src, lambda s: _nomma(s, line_mma)),
        "nohat": (HELPERS, _nohat),
        "nored": (src, lambda s: re.sub(r"\n\s*red4_if\(p_i[^;]*;", "", s)),
        "nou": (src, lambda s: s.replace(u_loop, u_loop.replace("ws = warp;", "ws = warp + K;"))),
        "noload": (src, lambda s: s.replace(
            "if (tile + (int)gridDim.x < n_tiles) load_tile(tile + gridDim.x, s ^ 1);\n"
            "    else cp_async_commit();", "cp_async_commit();")),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="K2", choices=tuple(KERNELS))
    ap.add_argument("--objects", type=int, default=10)
    ap.add_argument("--points-kind", default="uniform", choices=("uniform", "rays"))
    ap.add_argument("--root", default=None, help="checkout whose package is ablated")
    args = ap.parse_args(argv)
    pkg = Path(args.root).resolve() / PKG.name if args.root else PKG
    shutil.rmtree(OUT, ignore_errors=True)
    todo = edits(args.kernel)
    for name, (files, edit) in todo.items():
        shutil.copytree(pkg, OUT / name / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
        changed = False
        for file in (files,) if isinstance(files, str) else files:
            src = OUT / name / PKG.name / "csrc" / file
            old = src.read_text()
            new = edit(old)
            changed |= new != old
            src.write_text(new)
        if name != "base" and not changed:
            raise SystemExit(f"ablate_backward: edit {name!r} no longer matches {files}")
    # build every copy at once (one nvcc a source each), then time them in turn
    build = "from romap_tpu_torch.ops import mxgrid_cuda; mxgrid_cuda.build_library()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=OUT / n,
                              env=dict(os.environ, PYTHONPATH=str(OUT / n))) for n in todo]
    if any([p.wait() != 0 for p in procs]):
        raise SystemExit("ablate_backward: a copy failed to build")
    roots = ",".join(str(OUT / n) for n in (*todo, "base"))
    subprocess.run([sys.executable, str(PKG / "tools" / "time_encode.py"), "--pairs",
                    KERNELS[args.kernel][1], "--objects", str(args.objects), "--points-kind",
                    args.points_kind, "--roots", roots], check=True)


if __name__ == "__main__":
    main()
