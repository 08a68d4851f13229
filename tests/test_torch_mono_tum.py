"""The online pipeline end to end on the CPU: the SLAM frontend
`native/build/mono_tum` -> UNIX socket -> the port's runtime server ->
artifacts -> the port's evaluator.

The port's `write_room_dataset` writes the room sequence at the fewest frames
and the smallest size at which SLAM still starts an object's NeRF (48 frames
at 320 x 240; 40 frames, or 180 lines, start none). `mono_tum` runs against
`romap_tpu_torch.runtime.server --small --device cpu`, run as a module in a
process whose pose-refinement budget is cut (`pose_refine.N_STEPS`,
`N_PIXELS`, `N_SAMPLES`, read at each call, as tests/test_torch_online.py cuts
them): the full 4 x 300 x 1536 x 32 refinement of one view takes minutes on
the CPU's plain encode. `mono_tum`'s own knobs keep the evaluation to one
held-out view without the orbit video, and `ROMAP_MAX_BEHIND=0` blocks
tracking until the mapping thread has drained every keyframe, so that each
frame is tracked against the same map however loaded the host is: with the
default bound of 2 keyframes, a loaded host (six test workers on eight
cores) sometimes tracked against a map that lacked the last keyframes' points,
and SLAM gave its object the id 1 instead of 0. The run must exit 0, start
NeRF 0 for SLAM object 0 and render it, leave an object directory with a
non-empty mesh and test renders, refine the test view's pose (the server's
`pose refine` line), and `utils/eval_psnr` must score the tree with a
finite PSNR.
"""

import math
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from romap_tpu_torch.data import world
from romap_tpu_torch.utils import eval_psnr
from romap_tpu_torch.utils.mesh_io import load_ply
from tests.test_torch_native_build import BUILD_ERROR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONO_TUM = os.path.join(REPO, "native", "build", "mono_tum")
N_FRAMES, RES, ITERS = 48, 240, 10
# `python -c SERVER <args>` runs the server module as `python -m` would, with
# the refinement cut to 10 steps x 192 pixels x 8 samples
SERVER = """
import runpy
from romap_tpu_torch.runtime import pose_refine
pose_refine.N_STEPS, pose_refine.N_PIXELS, pose_refine.N_SAMPLES = 10, 192, 8
runpy.run_module("romap_tpu_torch.runtime.server", run_name="__main__", alter_sys=True)
"""


@pytest.mark.skipif(shutil.which("cmake") is None, reason="no cmake")
def test_mono_tum_drives_the_torch_server(tmp_path):
    assert BUILD_ERROR is None, BUILD_ERROR  # built at import (tests/test_torch_native_build.py)
    dataset, out, sock = (str(tmp_path / n) for n in ("dataset", "out", "monerf.sock"))
    world.write_room_dataset(dataset, n_frames=N_FRAMES, res=RES, seed=0)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    log = open(tmp_path / "server.log", "w")
    server = subprocess.Popen(
        [sys.executable, "-c", SERVER, "--socket", sock, "--small", "--device", "cpu"],
        env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.monotonic()
        while not os.path.exists(sock):
            assert server.poll() is None, (tmp_path / "server.log").read_text()
            assert time.monotonic() - t0 < 60, "server did not start"
            time.sleep(0.1)
        run = subprocess.run(
            [MONO_TUM, dataset, sock, str(ITERS), out], capture_output=True, text=True,
            timeout=300,
            env=dict(env, ROMAP_EVAL_MAX_VIEWS="1", ROMAP_NO_VIDEO="1", ROMAP_MAX_BEHIND="0"))
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=20)
        except subprocess.TimeoutExpired:
            server.kill()
        log.close()
    served = (tmp_path / "server.log").read_text()
    assert run.returncode == 0, f"stdout={run.stdout[-3000:]}\nstderr={run.stderr[-3000:]}"
    assert "Create NeRF 0" in run.stdout and "render test: object 0" in run.stdout, run.stdout
    assert "pose refine: object 0: " in served, served
    objs = sorted(e for e in os.listdir(out) if e.isdigit())
    assert objs, os.listdir(out)
    obj = os.path.join(out, objs[0])
    mesh = load_ply(os.path.join(obj, "obj.ply"))
    assert len(mesh.verts) > 0 and len(mesh.faces) > 0
    assert os.listdir(os.path.join(obj, "test_img")) and os.path.isfile(os.path.join(obj, "test.txt"))
    res = eval_psnr.evaluate_tree(out, dataset)
    assert math.isfinite(res["objects"][objs[0]]["psnr_db"]), res
    assert math.isfinite(res["aggregate"]["mean_psnr_db"]) and "trajectory" in res, res
