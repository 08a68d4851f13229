"""The port's flagship-parity gate (`romap_tpu_torch.tools.quality_gate`) on
the CPU, against scripts/quality_gate.py.

- The held-out evaluation: JAX trains a tiny config a few steps; its state
  crosses with `utils/jax_bridge.py`; the port's `held_out_psnr` then gives
  the reference's PSNR (scripts/quality_gate.py:66-83, repeated here in JAX)
  on the same EMA parameters and render jitter, within 1e-3 dB.
- The gate: fed fixed per-seed values in place of training, it passes and
  fails at 0.5 dB as the reference's rule does, writes its record to
  `--out` (never QUALITY.json), and exits 1 on a failure.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from romap_tpu.config import EncodingConfig as JEnc
from romap_tpu.config import NerfConfig as JCfg
from romap_tpu.config import TrainConfig as JTrain
from romap_tpu.data.world import build_synthetic_world as jworld
from romap_tpu.models import nerf as jnerf
from romap_tpu.ops.geometry import camera_rays as jcamera_rays
from romap_tpu.ops.geometry import ray_aabb_intersect as jray_aabb
from romap_tpu_torch.config import EncodingConfig as TEnc
from romap_tpu_torch.config import NerfConfig as TCfg
from romap_tpu_torch.config import TrainConfig as TTrain
from romap_tpu_torch.data.world import build_synthetic_world as tworld
from romap_tpu_torch.models import nerf as tnerf
from romap_tpu_torch.tools import quality_gate
from romap_tpu_torch.utils import jax_bridge

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, RES, STEPS = 6, 32, 5
ENC = dict(kind="mxgrid", mx_levels=2, mx_max_resolution=32, mx_features=8,
           mx_plane_res=16, mx_plane_features=4, mx_impl="xla")
TRAIN = dict(rays_per_batch=64, samples_per_ray=4)


def reference_gate():
    """scripts/quality_gate.py as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "reference_quality_gate", os.path.join(REPO, "scripts", "quality_gate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_held_out_psnr(params, cam, objects, frames, objs, cfg, spec, jitter):
    """scripts/quality_gate.py:66-83 with the config, state and jitter
    passed in."""
    test = frames[len(frames) // 2]
    x0, y0, h, w = test["bboxes"][objects[0].instance_id]
    ys, xs = np.mgrid[y0:y0 + h, x0:x0 + w]
    o, d, dn = jcamera_rays(
        jnp.asarray(xs.ravel(), jnp.float32),
        jnp.asarray(ys.ravel(), jnp.float32),
        jnp.asarray(cam.intrinsics), jnp.asarray(test["twc"]), objs.tow[0])
    tmin, tmax, hit = jray_aabb(o, d, objs.aabb_min[0], objs.aabb_max[0])
    rgb, _, _ = jnerf.render_rays(
        params, o, d, dn, jnp.maximum(tmin, 0), tmax, hit, jitter,
        objs.aabb_min[0], objs.aabb_max[0], cfg, spec, n_samples=64)
    rgb = np.asarray(rgb).reshape(h, w, 3)
    gt = test["rgb"][y0:y0 + h, x0:x0 + w].astype(np.float32) / 255.0
    m = test["instance"][y0:y0 + h, x0:x0 + w] == objects[0].instance_id
    mse = float(np.mean((rgb[m] - gt[m]) ** 2))
    return -10 * float(np.log10(max(mse, 1e-9)))


@pytest.mark.parametrize("seed", [0, 2])
def test_held_out_psnr_equals_reference(seed):
    jcfg = JCfg(encoding=JEnc(**ENC), train=JTrain(**TRAIN))
    tcfg = TCfg(encoding=TEnc(**ENC), train=TTrain(**TRAIN))
    jspec, tspec = jnerf.make_field_spec(jcfg), tnerf.make_field_spec(tcfg)
    cam, objects, frames, store, jobjs = jworld(1, FRAMES, RES, seed=seed)
    state = jnerf.init_train_state(jax.random.PRNGKey(seed), 1, jcfg, jspec)
    state = jax.device_get(jnerf.train_objects(state, jobjs, store.arrays(), jcfg, jspec, STEPS))
    assert int(state.step[0]) == STEPS
    test = frames[len(frames) // 2]
    _, _, h, w = test["bboxes"][objects[0].instance_id]
    jitter = np.array(jax.random.uniform(jax.random.PRNGKey(1), (h * w, 64)))
    want = jax_held_out_psnr(jax.tree.map(lambda a: a[0], state.ema), cam, objects, frames,
                             jobjs, jcfg, jspec, jnp.asarray(jitter))

    tstate = jax_bridge.train_state_from_jax(state)
    params = pytree.tree_map(lambda a: a[0], tstate.ema)
    _, tobjects, tframes, _, tobjs = tworld(1, FRAMES, RES, seed=seed)
    got = quality_gate.held_out_psnr(params, cam, tobjects, tframes, tobjs, tcfg, tspec,
                                     jitter=torch.from_numpy(jitter))
    assert np.isfinite(want) and 3.0 < want < 60.0
    assert abs(got - want) <= 1e-3, (got, want)
    # the default jitter (a generator seeded 1) gives a value of the same field
    other = quality_gate.held_out_psnr(params, cam, tobjects, tframes, tobjs, tcfg, tspec)
    assert abs(other - want) < 1.0


def anchors():
    with open(os.path.join(REPO, "QUALITY.json")) as f:
        q = json.load(f)
    return ({int(k): v for k, v in q["psnr_hashgrid_seeds"].items()},
            q["parity_gate"]["flagship_by_seed"])


@pytest.mark.parametrize("shortfall", [0.0, 0.49, 0.51, 1.5])
def test_gate_passes_and_fails_as_the_reference(tmp_path, monkeypatch, capsys, shortfall):
    """Each seed's PSNR is its anchor less `shortfall` dB."""
    anchor, jax_by_seed = anchors()
    seeds = [0, 1, 2]
    calls = []

    def measure(iters, wave, res=192, frames_n=24, seed=0, device="cuda",
                compute_dtype="bfloat16"):
        calls.append((iters, wave, res, frames_n, seed, device, compute_dtype))
        return anchor[seed] - shortfall

    monkeypatch.setattr(quality_gate, "measure_flagship_psnr", measure)
    out = tmp_path / "rec" / "QUALITY_TORCH.json"
    rc = quality_gate.main(["--device", "cpu", "--out", str(out)])
    ref = reference_gate()
    psnr = float(np.mean([anchor[s] - shortfall for s in seeds]))
    gap = float(np.mean([anchor[s] for s in seeds])) - psnr
    want_pass = gap <= ref.THRESHOLD_DB  # the reference's rule
    assert quality_gate.THRESHOLD_DB == ref.THRESHOLD_DB == 0.5
    assert quality_gate.ITERS == ref.ITERS and quality_gate.WAVE == ref.WAVE
    assert calls == [(ref.ITERS, ref.WAVE, 192, 24, s, "cpu", "bfloat16") for s in seeds]
    assert rc == (0 if want_pass else 1)
    rec = json.loads(out.read_text())
    assert rec["pass"] is want_pass
    assert rec["gap_db"] == round(gap, 3) and rec["threshold_db"] == 0.5
    assert rec["flagship_psnr_db"] == round(psnr, 3)
    assert rec["hashgrid_anchor_db"] == round(float(np.mean(list(anchor.values()))), 3)
    assert rec["iters"] == 5000 and rec["seeds"] == seeds
    assert rec["anchor_by_seed"] == {str(s): round(anchor[s], 3) for s in seeds}
    assert rec["flagship_by_seed"] == {str(s): round(anchor[s] - shortfall, 3) for s in seeds}
    assert rec["jax_flagship_by_seed"] == {str(s): jax_by_seed[str(s)] for s in seeds}
    assert sorted(rec["seconds_by_seed"]) == ["0", "1", "2"]
    assert rec["torch"] == torch.__version__ and rec["card"] is None
    assert rec["compute_dtype"] == "bfloat16"
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [p["jax_flagship_db"] for p in printed[:3]] == [jax_by_seed[str(s)] for s in seeds]


def test_gate_refuses_quality_json_and_a_missing_card(monkeypatch):
    monkeypatch.setattr(quality_gate, "measure_flagship_psnr", lambda *a, **k: 0.0)
    with pytest.raises(SystemExit):
        quality_gate.main(["--device", "cpu", "--out", quality_gate.QUALITY_JSON])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quality_gate.main([])
