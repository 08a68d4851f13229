"""The port's CUDA runtime (`romap_tpu_torch/ops/cuda_lib.py`) and its seam
with the kernel families, on the CPU: each family module declares the C
entries of its own sources and no other's, imports no other family, and
`launch_counts()` lists every family in one order whichever was imported
first; `check` and the wrappers refuse a start a kernel cannot take.
No JAX."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest
import torch

from romap_tpu_torch.config import EncodingConfig, NerfConfig
from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops import (
    cuda_lib, hashgrid, hashgrid_cuda, mlp_cuda, mxgrid_cuda, optimizer_cuda)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"mxgrid_cuda": mxgrid_cuda, "hashgrid_cuda": hashgrid_cuda,
            "optimizer_cuda": optimizer_cuda, "mlp_cuda": mlp_cuda}
# K0-K10, H0-H3, A1, M1-M2: the `--trace` files' launches
LAUNCH_KEYS = [*(f"K{i}" for i in range(11)), "H0", "H1", "H2", "H3", "A1", "M1", "M2"]


def c_entries() -> dict[str, tuple[str, int]]:
    """{C entry: (source, parameter count)} of the `extern "C"` blocks of
    csrc/*.cu; the count takes in the trailing stream."""
    found = {}
    for src in sorted(cuda_lib.CSRC_DIR.glob("*.cu")):
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', src.read_text(), re.S):
            for name, params in re.findall(r"^int (romap_\w+)\(([^)]*)\)\s*\{", block, re.M):
                assert name not in found, name
                found[name] = (src.name, len(params.split(",")))
    return found


ENTRIES = c_entries()


def owner(source: str) -> str:
    """The family module of a source: its name up to the first `_`, then
    `_cuda` (mxgrid_folded.cu -> mxgrid_cuda, hashgrid.cu -> hashgrid_cuda,
    mlp.cu -> mlp_cuda)."""
    return source.removesuffix(".cu").split("_")[0] + "_cuda"


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_each_c_entry_is_declared_once_by_the_family_of_its_source(entry):
    source, n_params = ENTRIES[entry]
    declared = [name for name, module in FAMILIES.items() if entry in module.ARGTYPES]
    assert declared == [owner(source)]
    assert len(FAMILIES[owner(source)].ARGTYPES[entry]) == n_params
    assert cuda_lib._ARGTYPES[entry] is FAMILIES[owner(source)].ARGTYPES[entry]


def test_families_declare_no_entry_the_sources_lack():
    """The families declare the sources' entries and no other, and the
    runtime binds exactly what they declared."""
    declared = [e for module in FAMILIES.values() for e in module.ARGTYPES]
    assert sorted(declared) == sorted(ENTRIES) == sorted(cuda_lib._ARGTYPES)


def run_python(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.strip()


def test_hash_grid_and_optimizer_import_without_the_mxgrid_module():
    """The hash grid's and the optimizer's kernels reach the runtime without
    the MX-grid encode; importing them builds and loads nothing."""
    out = run_python(
        "import sys\n"
        "import romap_tpu_torch.ops.hashgrid_cuda, romap_tpu_torch.ops.optimizer_cuda\n"
        "from romap_tpu_torch.ops import cuda_lib\n"
        "assert 'romap_tpu_torch.ops.mxgrid_cuda' not in sys.modules\n"
        "assert cuda_lib._lib is None\n"
        "print(list(cuda_lib.launch_counts()))\n")
    assert out == str(["H0", "H1", "H2", "H3", "A1"])


@pytest.mark.parametrize("modules", [
    ["romap_tpu_torch.ops.optimizer_cuda", "romap_tpu_torch.ops.mlp_cuda",
     "romap_tpu_torch.ops.hashgrid_cuda", "romap_tpu_torch.ops.mxgrid_cuda"],
    ["romap_tpu_torch.ops.hashgrid_cuda", "romap_tpu_torch.ops.mxgrid_cuda",
     "romap_tpu_torch.ops.mlp_cuda", "romap_tpu_torch.ops.optimizer_cuda"],
    ["romap_tpu_torch.runtime.offline"],
    ["romap_tpu_torch.runtime.server"],
], ids=["optimizer_first", "hash_grid_first", "offline_cli", "server"])
def test_launch_counts_list_every_family_in_one_order(modules):
    """K0-K10, then H0-H3, then A1, then M1-M2, whichever family was
    imported first; the offline CLI and the server, which write them into
    `--trace`, import every family."""
    out = run_python(
        "".join(f"import {m}\n" for m in modules)
        + "from romap_tpu_torch.ops import cuda_lib\n"
        "print(list(cuda_lib.launch_counts()))\n")
    assert out == str(LAUNCH_KEYS)


@pytest.mark.parametrize("dtype,align,offset,refused", [
    (torch.float32, 16, 4, False),  # an optimizer leaf: A1 moves four values an access
    (torch.float32, 16, 1, True),
    (torch.float32, 16, 2, True),
    (torch.bfloat16, 4, 2, False),  # a hash-grid row of two bf16 values
    (torch.bfloat16, 4, 1, True),
    (torch.float32, None, 1, False),
])
def test_check_refuses_a_misaligned_start(dtype, align, offset, refused):
    t = torch.zeros(64 + offset, dtype=dtype)[offset:].view(8, 8)
    assert t.data_ptr() % 64 == offset * t.element_size() % 64
    if refused:
        with pytest.raises(ValueError, match=f"not {align}-byte aligned"):
            cuda_lib.check("t", t, (8, 8), dtype, t.device, align=align)
    else:
        cuda_lib.check("t", t, (8, 8), dtype, t.device, align=align)


def test_wrappers_refuse_a_misaligned_row_and_leaf(monkeypatch):
    """With the card's path taken for CPU tensors, the hash grid's H1
    refuses a table that does not start on a row of F values, and A1 a
    leaf off 16 bytes, before anything launches."""
    monkeypatch.setattr(cuda_lib, "on_card", lambda t, dt: True)
    monkeypatch.setattr(cuda_lib, "launch", lambda *a, **k: pytest.fail("launched"))
    spec = hashgrid.make_spec(EncodingConfig(kind="hashgrid", n_levels=4,
                                             n_features_per_level=2, log2_hashmap_size=9,
                                             base_resolution=4, desired_resolution=64.0))
    rows = spec.total_params * spec.n_features
    table = torch.zeros(rows + 1, dtype=torch.bfloat16)[1:].view(1, spec.total_params, 2)
    with pytest.raises(ValueError, match="table: data pointer .* not 4-byte aligned"):
        hashgrid_cuda.forward(torch.zeros((1, 8, 3)), table, spec)

    params = {"w": torch.zeros((2, 8))}
    state = nerf.TrainState(
        params=params, ema={"w": torch.zeros(17)[1:].view(2, 8)}, loss=torch.zeros(2),
        opt=nerf.AdamState(found_nan={"w": torch.zeros(2, dtype=torch.bool)},
                           count=torch.zeros(2, dtype=torch.int32),
                           mu={"w": torch.zeros((2, 8))}, nu={"w": torch.zeros((2, 8))}),
        step=torch.zeros(2, dtype=torch.int32))
    ok = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"ema\[0\]: data pointer .* not 16-byte aligned"):
        optimizer_cuda.update({"w": torch.zeros((2, 8))}, state, ok, NerfConfig())
