"""Wall time of pose refinement on one GPU, for one checkout or several in turns.

For each root listed (a checkout of the repository, e.g. the parent commit
unpacked into a gitignored directory with `git archive`), a child process
runs, from that root, the phases of its own `chip_smoke.py` that refine
poses: `[9 online]`, the online server on the split kernels (MX_FUSED=0
MX_SNAP=0) whose crop RENDER_TEST refines the view's pose before it renders
(`render_test_with_crops_s`), and `[9b refine]`, two perturbed views refined
against a 400-step flagship field (`refine_s`), each with its own checks.
The kernels build once a root. Listing the roots as parent, change, change,
parent compares two versions on one card in one run:

  python3 -m romap_tpu_torch.tools.time_refine --roots build/parent,.,.,build/parent

Needs a CUDA device; every child prints the card's name and power limit
first, then its phases' lines.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = """
import shutil, sys, tempfile
sys.path.insert(0, ".")
import chip_smoke as cs
cs.phase_device()
cs.timed("2 build", cs.phase_build)
root = tempfile.mkdtemp(prefix="romap_time_refine_")
try:
    cs.timed("9 online", cs.phase_online, root)
    cs.timed("9b refine", cs.phase_refine, "cuda")
finally:
    shutil.rmtree(root, ignore_errors=True)
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", default=".", help="comma list of checkouts, run in this order")
    args = ap.parse_args(argv)
    for root in args.roots.split(","):
        root = os.path.abspath(root)
        print(f"== root {root}", flush=True)
        subprocess.run([sys.executable, "-c", CHILD], cwd=root, check=True,
                       env=dict(os.environ, PYTHONPATH=root))


if __name__ == "__main__":
    main()
