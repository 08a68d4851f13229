"""What a tensor-core encode backward spends its time on: K2
(`folded_bwd_tc`, mxgrid_folded.cu) or K4 (`unsnapped_bwd_tc`,
mxgrid_unsnapped.cu), timed with one part removed at a time; with
`--kernel K3`, the same for the three-axis unsnapped forward
(`unsnapped_fwd3`, K3 and K7).

Copies the package into `build/ablate/<name>/` (gitignored), edits the copy
of the source that holds the part (the kernel's `.cu`, or `mxgrid_tc.cuh`
for the helpers both kernels share), and runs `tools/time_encode.py` on
every copy in one run on one card (K1/K2 at the flagship spec or K3/K4 at
the flagship spec unsnapped; bf16, --objects x 131072 points). The ablated
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

Usage: python3 -m romap_tpu_torch.tools.ablate_backward [--kernel K2|K4|K3]
[--objects 10] [--points-kind uniform|rays] (from the repo root; needs a
CUDA device and nvcc). Each edit asserts that it changed the source, so the
script fails when the kernel has moved on.
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
KERNELS = {"K2": ("mxgrid_folded.cu", "K1", "mma16816(lacc[m], al, b0, b1);", "kTcWarps"),
           "K4": ("mxgrid_unsnapped.cu", "K3", "mma16816(lacc, al, b0, b1);", "kWarps"),
           "K3": ("mxgrid_unsnapped.cu", "K3,K7", None, None)}


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
    args = ap.parse_args(argv)
    shutil.rmtree(OUT, ignore_errors=True)
    todo = edits(args.kernel)
    for name, (file, edit) in todo.items():
        shutil.copytree(PKG, OUT / name / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
        src = OUT / name / PKG.name / "csrc" / file
        old = src.read_text()
        new = edit(old)
        if name != "base" and new == old:
            raise SystemExit(f"ablate_backward: edit {name!r} no longer matches {file}")
        src.write_text(new)
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
