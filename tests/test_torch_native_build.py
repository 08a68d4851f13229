"""Build `native/build` once, before any test runs, for every test file that
starts a native binary (`tests/test_native_shim.py`, `tests/test_slam_objects.py`,
`tests/test_torch_online.py`, `tests/test_torch_mono_tum.py`).

Those files each build the tree when `manager_smoke` is missing and take
that one binary as the sign that the build is done. Under pytest-xdist
several workers then build at once, and `manager_smoke` is linked before the
SLAM test binaries, so a worker can start a binary that is not there yet.

pytest-xdist schedules tests only after every worker has collected, and
every worker imports every test module while it collects. So the build is
done here, while this module is imported, under an `fcntl.flock` on
`native/build.lock`: the first worker builds, the others wait on the lock
and find every binary there. `tests/test_torch_online.py` imports this
module, as does `tests/test_torch_mono_tum.py`, so the build also runs where
only one of them is collected with the two reference files. A failed build does not raise at import (that would
drop every test of the importing module): the error is kept, and
`test_native_build` fails with it.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
BUILD = os.path.join(NATIVE, "build")
LOCK = os.path.join(NATIVE, "build.lock")
# every executable a test starts: manager_smoke (test_native_shim.py,
# test_torch_online.py), the SLAM tests (test_slam_objects.py), bow_test,
# mono_tum (test_torch_mono_tum.py)
BINARIES = ("manager_smoke", "object_layer_test", "geometry_test", "tracking_test",
            "bow_test", "loop_test", "mono_tum")


def missing_binaries() -> list[str]:
    return [b for b in BINARIES if not os.path.isfile(os.path.join(BUILD, b))]


def build_native() -> str | None:
    """Configure and build `native/build` under the lock unless every binary
    is already there. Returns None, or the build's error as text."""
    if shutil.which("cmake") is None:
        return "no cmake"
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not missing_binaries():
                return None
            gen = ["-G", "Ninja"] if shutil.which("ninja") else []
            for cmd in (["cmake", "-S", NATIVE, "-B", BUILD, *gen], ["cmake", "--build", BUILD]):
                out = subprocess.run(cmd, capture_output=True, text=True)
                if out.returncode != 0:
                    return f"{' '.join(cmd)} failed ({out.returncode}):\n{out.stdout}\n{out.stderr}"
            missing = missing_binaries()
            return f"built, but missing {missing}" if missing else None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


BUILD_ERROR = build_native()


@pytest.mark.skipif(shutil.which("cmake") is None, reason="no cmake")
def test_native_build():
    """The build done at import succeeded and left every binary the tests run."""
    assert BUILD_ERROR is None, BUILD_ERROR
    assert not missing_binaries()
