"""Rendering helpers: bbox-rect views and 360 orbit videos (counterpart of
romap_tpu/runtime/renderer.py).

The reference pads the ray count to a power-of-two bucket to limit JAX
recompiles; PyTorch runs eagerly, so the rays of a view go through
`models.nerf.render_rays` as they are, in chunks that bound the encode's
memory. A ray's result does not depend on the chunking.
"""

from __future__ import annotations

import numpy as np
import torch

from romap_tpu_torch.models import nerf
from romap_tpu_torch.ops.geometry import camera_rays, orbit_pose, ray_aabb_intersect

RAY_CHUNK = 32768  # rays per render_rays call (x 64 samples each)


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


@torch.no_grad()
def render_view(params_one, intrinsics, twc, tow, aabb_min, aabb_max,
                box_xyhw: tuple[int, int, int, int], cfg, spec, *,
                generator: torch.Generator | None = None,
                jitter: torch.Tensor | None = None, background: float = 1.0):
    """Render the pixel rect (x, y, h, w) of a posed view for ONE object
    (params without the object axis, on the device that renders).

    The sample jitter [h w, S] (S = cfg.train.render_samples_per_ray) is
    `jitter` when given, else drawn from `generator`, else from a generator
    on the params' device seeded 0 (the reference uses PRNGKey(0)).

    Returns numpy (rgb [h,w,3], z-depth [h,w], mask [h,w]), all f32: 64
    samples, fp32, gray background, mask > 0.5 gate.
    """
    dev = nerf.params_device(params_one)
    x0, y0, h, w = (int(v) for v in box_xyhw)
    n, s = h * w, cfg.train.render_samples_per_ray
    if jitter is None:
        gen = generator or torch.Generator(device=dev).manual_seed(0)
        jitter = torch.rand((n, s), generator=gen, device=gen.device)
    jitter = jitter.to(dev, torch.float32)
    ys, xs = np.mgrid[y0 : y0 + h, x0 : x0 + w]
    box_min, box_max = _on(aabb_min, dev), _on(aabb_max, dev)
    o, d, dn = camera_rays(_on(xs.ravel(), dev), _on(ys.ravel(), dev), _on(intrinsics, dev),
                           _on(twc, dev), _on(tow, dev))
    tmin, tmax, hit = ray_aabb_intersect(o, d, box_min, box_max)
    tmin = torch.clamp(tmin, min=0.0)
    outs = [nerf.render_rays(params_one, o[c : c + RAY_CHUNK], d[c : c + RAY_CHUNK],
                             dn[c : c + RAY_CHUNK], tmin[c : c + RAY_CHUNK],
                             tmax[c : c + RAY_CHUNK], hit[c : c + RAY_CHUNK],
                             jitter[c : c + RAY_CHUNK], box_min, box_max, cfg, spec,
                             n_samples=s, background=background)
            for c in range(0, n, RAY_CHUNK)]
    rgb, depth, mask = (torch.cat(parts).cpu().numpy() for parts in zip(*outs))
    return rgb.reshape(h, w, 3), depth.reshape(h, w), mask.reshape(h, w)


def orbit_poses(n_poses: int = 60, phi_deg: float = 30.0, radius: float = 1.0):
    """The reference's 360-video pose ring: theta steps of 360/n, starting
    at one step; numpy [4, 4] float32 poses."""
    step = 360.0 / n_poses
    return [orbit_pose(step * (i + 1), phi_deg, radius).numpy() for i in range(n_poses)]
