"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from conftest import ROOT, WORKLOAD

FORBIDDEN = {"jax", "jaxlib", "flax", "romap_tpu"}


def _loaded_after(code: str) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
                        "for m in sys.modules}))"], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'portbench/tests')\n"
            "from conftest import tiny\nfrom portbench import run\n"
            f"run.run_cell({WORKLOAD!r}, 7, 0.3, True, device='cpu', "
            f"overrides=tiny({WORKLOAD!r}, 'float32'))")
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN
    assert "romap_tpu_torch" in loaded  # the whole-name comparison still sees the port


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"romap_tpu_torch"}, (path, n)
    modules = sorted(os.path.basename(p)[:-3] for p in
                     glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py")))
    loaded = _loaded_after("; ".join(f"import portbench.reference.{m}" for m in modules))
    assert not loaded & (FORBIDDEN | {"romap_tpu_torch"})
