"""What the tensor-core encode backward (K2, `folded_bwd_tc`) spends its
time on: times the kernel with one part removed at a time.

Copies the package into `build/ablate/<name>/` (gitignored), edits the copy
of `csrc/mxgrid_folded.cu`, and runs `tools/time_encode.py` on every copy in
one run on one card (K1/K2 at the flagship spec, bf16, --objects x
131072 points). The ablated kernels compute wrong sums; only their times
mean anything. The difference to `base` is the part's share of the time, as
far as the parts do not overlap.

  base    the kernel as it is (run first and last)
  nomma   no mma.sync (the compiler then drops the `hat` fragments too)
  nohat   `hat` fragments replaced by a constant (the products stay)
  nored   no vector atomics into the plane gradient
  nou     u_d = g A_e A_f not formed
  noload  only the first tile is loaded

Usage: python3 -m romap_tpu_torch.tools.ablate_backward [--objects 10]
(from the repo root; needs a CUDA device and nvcc). Each edit asserts that
it changed the source, so the script fails when the kernel has moved on.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
OUT = PKG.parent / "build" / "ablate"


def _nomma(s):
    for call in ("mma16816(acc[m][2 * np], a[m], b[0], b[1]);",
                 "mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);",
                 "mma16816(lacc[m], al, b0, b1);"):
        assert call in s, call
        s = s.replace(call, "")
    return s


def _nohat(s):
    i = s.index("__device__ __forceinline__ void hat_fragment")
    j = s.index("__device__ __forceinline__ void mma16816")
    return s[:i] + ("__device__ __forceinline__ void hat_fragment(float, float2 t, float2, "
                    "uint32_t* a) {\n  a[0] = a[1] = a[2] = a[3] = __float_as_uint(t.x) & "
                    "0x3f803f80u;\n}\n\n") + s[j:]


EDITS = {
    "base": lambda s: s,
    "nomma": _nomma,
    "nohat": _nohat,
    "nored": lambda s: re.sub(r"\n\s*red4_if\(p_i[^;]*;", "", s),
    "nou": lambda s: s.replace("for (int ws = warp; ws < K; ws += kTcWarps) {",
                               "for (int ws = warp + K; ws < K; ws += kTcWarps) {"),
    "noload": lambda s: s.replace(
        "if (tile + (int)gridDim.x < n_tiles) load_tile(tile + gridDim.x, s ^ 1);\n"
        "    else cp_async_commit();", "cp_async_commit();"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=10)
    args = ap.parse_args(argv)
    shutil.rmtree(OUT, ignore_errors=True)
    for name, edit in EDITS.items():
        shutil.copytree(PKG, OUT / name / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
        src = OUT / name / PKG.name / "csrc" / "mxgrid_folded.cu"
        old = src.read_text()
        new = edit(old)
        if name != "base" and new == old:
            raise SystemExit(f"ablate_backward: edit {name!r} no longer matches the source")
        src.write_text(new)
    roots = ",".join(str(OUT / n) for n in (*EDITS, "base"))
    subprocess.run([sys.executable, str(PKG / "tools" / "time_encode.py"), "--pairs", "K1",
                    "--objects", str(args.objects), "--roots", roots], check=True)


if __name__ == "__main__":
    main()
