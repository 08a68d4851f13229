"""Typed configuration tree for the NeRF core.

Mirrors every knob of the reference's network config
(reference: dependencies/Multi-Object-NeRF/Core/configs/base.json and
Core/src/nerf_model.cu:1286-1342) plus the hard-coded constants collected in
BASELINE.md (batch sizes, lambdas, marching-cubes params).

Reference quirks reproduced deliberately:
  * the JSON's loss otype ("Huber") is overridden to L2 in code
    (nerf_model.cu:1296) — we only implement the L2 composite loss;
  * per-level scale is derived from desired resolution 2048, not read from the
    JSON (nerf_model.cu:1305-1306);
  * loss_scale=128 exists for fp16 gradient scaling (nerf_model.h:166); our
    gradients are fp32 so it is recorded but mathematically a no-op.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """Learned multiresolution spatial encoding.

    kind == "mxgrid": the TPU-native gather-free factorized encoding
    (ops/mxgrid.py) — the flagship path.
    kind == "hashgrid": exact tcnn HashGrid semantics (ops/hashgrid.py,
    ref base.json:23-29) — reference parity; slow on TPU (gather-bound).
    The hash-grid fields below also seed the mxgrid resolution ladder.
    """

    kind: str = "mxgrid"
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 16
    base_resolution: int = 16
    desired_resolution: float = 2048.0
    # mxgrid knobs — flagship defaults picked by the round-3..8 speed/quality
    # ladders on v5e (QUALITY.json): CP 6 levels to 192 @ 48ch + one
    # RECTANGULAR (128,64,4) plane level with balanced axis assignment runs
    # ~750 obj-iters/s (vs 628 for the square (128,128,4) it replaced) at a
    # 5000-step seed-0 PSNR of 28.81 dB — 0.24 dB under the tcnn-semantics
    # hash grid anchor (29.05), inside BASELINE.md's 0.5 dB parity budget;
    # 3-seed mean is 25.95 vs 26.22 for square (−0.27 dB, ≈ the 0.3 dB seed
    # spread). The walls are measured: CP k32 (28.39) and p3 (28.44) fall
    # below the 28.55 parity floor; rv=48 (27.80 uuv) degrades too far;
    # rv=96 is slower AND no better (28.13 balanced); 6 plane channels lose
    # both speed and quality. The square (128,128,4) level remains the
    # quality-headroom option (+0.3 dB seed-0 at ~19% cost).
    mx_levels: int = 6
    mx_max_resolution: int = 192
    mx_features: int = 48
    # VM plane-x-line components (TensoRF-style): restore full-rank texture
    # capacity that rank-limited CP lines lack. An int is a square plane;
    # an (ru, rv) pair is rectangular — on TPU the u axis contracts on the
    # MXU while v reduces on the VPU, so rv < ru trades v-detail for
    # near-linear speedup (flagship: (128, 64)). features 0 disables.
    mx_plane_res: int | tuple[int, int] = (128, 64)
    mx_plane_features: int = 4
    # Multi-level plane ladder — overrides the single mx_plane_res/
    # mx_plane_features level when set. Entries are (res, feats) squares or
    # (ru, rv, feats) rectangles.
    mx_plane_specs: tuple[tuple[int, ...], ...] | None = None
    # Plane-pair axis assignment: "uuv" (pairs contract x,x,y on the MXU) or
    # "balanced" (every axis gets one fine-u and one coarse-v appearance —
    # matters for rectangular planes where rv < ru, where "uuv" starves z).
    mx_plane_axes: str = "balanced"
    # "auto": fused Pallas kernel on TPU, chunked XLA elsewhere;
    # "pallas" / "xla" force an implementation.
    mx_impl: str = "auto"
    # Fold the multi-level CP ladder through the finest level's tent basis
    # (mxgrid.MXGridSpec.snap_levels): coarse hats are snapped to fine-grid
    # knots and the fold matrix is absorbed into the line weights per step.
    # Cuts the kernel's VPU hat-build and CP-matmul work ~2.7x at the
    # flagship ladder. Slightly different (equally valid) basis. Default ON
    # since round 5 on three-way evidence: bench 936.29 vs 738.17
    # obj-iters/s, its OWN 3-seed parity gate at 0.052 dB (tighter than
    # the unsnapped 0.189), and an end-to-end online run within noise of
    # the unsnapped row (21.19 vs 21.39 dB, IoU 0.990 both, seed 1).
    # MX_SNAP=1/0 overrides at runtime for A/B runs.
    mx_snap_levels: bool = True
    # hash-grid (tcnn-parity path) lookup implementation:
    # "gather" = direct XLA gather + scatter-add transpose;
    # "sorted" = argsort indices once, then sorted gather + sorted
    # segment-sum table gradient (TPU scatter-add serializes on the hash
    # collisions a hash table guarantees; sorting removes them).
    hash_impl: str = "gather"

    @property
    def plane_specs(self) -> tuple[tuple[int, int], ...]:
        if self.mx_plane_specs is not None:
            return tuple(tuple(p) for p in self.mx_plane_specs)
        if self.mx_plane_features > 0:
            r = self.mx_plane_res
            ru, rv = (r, r) if isinstance(r, int) else tuple(r)
            if ru > 0:
                return ((ru, rv, self.mx_plane_features),)
        return ()

    @property
    def per_level_scale(self) -> float:
        # ref nerf_model.cu:1305-1306
        if self.n_levels <= 1:
            return 1.0
        return math.exp(
            math.log(self.desired_resolution / float(self.base_resolution))
            / (self.n_levels - 1)
        )

    @property
    def n_output_dims(self) -> int:
        if self.kind == "mxgrid":
            # plane specs are (res, k) pairs or rectangular (ru, rv, k)
            # triples — channels are always the last element
            return self.mx_features + 3 * sum(p[-1] for p in self.plane_specs)
        return self.n_levels * self.n_features_per_level

    @classmethod
    def preset(cls, name: str) -> "EncodingConfig":
        """Named speed/quality points from the v5e ladder (QUALITY.json).

        flagship — default: ~729 obj-iters/s (headline bench), 28.81 dB
                   @ 5000 steps seed-0 (QUALITY.json speeds_r8/psnr_multiseed;
                   0.24 dB under the tcnn anchor, inside the 0.5 dB budget).
        fast     — CP-only, 852 obj-iters/s, 28.26 dB (outside the 0.5 dB
                   parity budget; for throughput-bound many-object scenes).
        quality  — cp256_k64 + (128,8) planes, 434 obj-iters/s, 29.29 dB
                   (best PSNR).
        tcnn     — exact tcnn HashGrid semantics (29.05 dB; gather-bound on
                   TPU, ~0.9 s/iter — parity/debug only).
        """
        presets = {
            "flagship": cls(),
            "fast": cls(mx_max_resolution=256, mx_features=64,
                        mx_plane_specs=()),
            "quality": cls(mx_max_resolution=256, mx_features=64,
                           mx_plane_res=128, mx_plane_features=8),
            "tcnn": cls(kind="hashgrid"),
        }
        if name not in presets:
            raise ValueError(
                f"unknown encoding preset {name!r}; "
                f"choose from {sorted(presets)}")
        return presets[name]


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Tiny MLP head, ref base.json:30-38 (FullyFusedMLP, bias-free).

    `sh_degree` 0 (the default) is RO-MAP's field: one head of
    `n_hidden_layers` x `n_neurons` to `output_dims` (4: rgb + sigma)
    outputs, no view direction. `sh_degree` 4 is instant-ngp's NeRF
    (configs/nerf/base.json): the head becomes the density network, to
    `output_dims` (16 there) outputs, output 0 the log-density, and a
    colour network of `rgb_n_hidden_layers` x `rgb_n_neurons` to 3 takes
    those outputs beside the 16 spherical harmonics of the ray's direction
    (`ops/sh.py`; `ops/mlp.view_dependent`). The `rgb_*` fields are unused
    at degree 0.

    `field` "sdf" is NeuS2's neural surface (Wang et al., ICCV 2023): the
    first network becomes a signed-distance network (output 0 the distance
    f, negative inside; the rest geometry features), its normal n = grad f
    enters the colour network beside the warped point, the SH of the view
    direction and the features (NeuS's `idr` inputs), and a learned
    variance per object (`init_variance`, NeuS's 0.3) sharpens the
    SDF-to-alpha render (`ops/render.sdf_render`). It needs `sh_degree` 4.
    "density" (the default) is the NeRF of both other fields.

    `field` "nerfacto" is nerfstudio's default field (Tancik et al.,
    SIGGRAPH 2023, `nerfstudio/models/nerfacto.py`): instant-ngp's density
    network (output 0 the log-density, outputs 1 on the geometry
    features), a colour network over [geometry features, SH of the view
    direction, the ray's frame's appearance code of `appearance_dims`, one
    of `appearance_frames` rows an object; frame f takes row f mod
    `appearance_frames`], and two proposal density fields, each a hash
    grid of `proposal_levels` x `proposal_features` at
    2^`proposal_log2_hashmap_size` rows a level from
    `proposal_base_resolution` to its entry of `proposal_max_resolutions`,
    and a bias-free net of `proposal_n_hidden_layers` x
    `proposal_n_neurons` to 1 log-density, which choose its samples
    (`TrainConfig.proposal_samples`). It needs `sh_degree` 4 and the hash
    grid (`NerfConfig` checks it). The `proposal_*` and `appearance_*`
    fields are unused by the other fields.
    """

    n_neurons: int = 64
    n_hidden_layers: int = 1
    # Activations fixed in code, not config: ref nerf_model.h mRgbActivation =
    # Logistic, mDensityActivation = Exponential.
    rgb_activation: str = "logistic"
    density_activation: str = "exponential"
    output_dims: int = 4  # rgb + sigma; the density network's width at sh_degree 4
    # the view branch (instant-ngp's dir_encoding and rgb_network)
    sh_degree: int = 0  # 0: no direction input; 4: 16 SH functions
    rgb_n_neurons: int = 64
    rgb_n_hidden_layers: int = 2
    field: str = "density"  # "density" (NeRF), "sdf" (NeuS2) or "nerfacto"
    init_variance: float = 0.3  # the SDF field's variance v at step 0: inv_s = exp(10 v)
    # nerfacto's appearance codes and proposal fields (NerfactoModelConfig's
    # appearance_embed_dim and proposal_net_args_list)
    appearance_dims: int = 32
    appearance_frames: int = 0  # rows of the appearance table: set for a nerfacto field
    proposal_levels: int = 5
    proposal_features: int = 2
    proposal_log2_hashmap_size: int = 17
    proposal_base_resolution: int = 16
    proposal_max_resolutions: tuple[int, ...] = (128, 256)
    proposal_n_neurons: int = 16
    proposal_n_hidden_layers: int = 1

    def __post_init__(self):
        if self.sh_degree not in (0, 4):
            raise ValueError(f"sh_degree {self.sh_degree}: 0 (no direction) or 4")
        if self.field not in ("density", "sdf", "nerfacto"):
            raise ValueError(f"field {self.field!r}: 'density', 'sdf' or 'nerfacto'")
        if self.field == "sdf" and self.sh_degree != 4:
            raise ValueError("an SDF field takes the view direction's SH: sh_degree 4")
        if self.field == "nerfacto":
            if self.sh_degree != 4:
                raise ValueError("nerfacto's field takes the view direction's SH: sh_degree 4")
            if self.appearance_dims < 1 or self.appearance_frames < 1:
                raise ValueError("nerfacto's field needs appearance_dims and appearance_frames "
                                 ">= 1 (one appearance code a training frame)")
            if len(self.proposal_max_resolutions) != 2:
                raise ValueError("nerfacto samples through two proposal fields: "
                                 "proposal_max_resolutions holds two resolutions")

    def proposal_encoding(self, level: int) -> EncodingConfig:
        """The hash grid of nerfacto's proposal field `level` (its
        proposal_net_args_list entry): levels x features at 2^log2 rows a
        level, from the base resolution to the level's max resolution."""
        return EncodingConfig(
            kind="hashgrid", n_levels=self.proposal_levels,
            n_features_per_level=self.proposal_features,
            log2_hashmap_size=self.proposal_log2_hashmap_size,
            base_resolution=self.proposal_base_resolution,
            desired_resolution=float(self.proposal_max_resolutions[level]))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """EMA -> ExponentialDecay -> Adam chain, ref base.json:5-22."""

    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    ema_decay: float = 0.95
    decay_start: int = 20000
    decay_interval: int = 10000
    decay_base: float = 0.33


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Batch geometry + loss weights (ref nerf_model.h:166-175, common.h:12)."""

    rays_per_batch: int = 4096
    samples_per_ray: int = 32
    render_samples_per_ray: int = 64
    loss_scale: float = 128.0
    depth_lambda: float = 0.5  # ref nerf_model.cu:869
    mask_lambda: float = 0.5  # ref nerf_model.cu:927
    bg_sigma_reg: float = 0.01  # ref nerf_model.cu:940
    # Marching cubes (ref marching_cubes.h:30-31)
    mc_resolution: int = 64
    mc_threshold: float = 2.0
    # NeuS's SDF field (NetworkConfig.field "sdf") alone: the eikonal term's
    # weight (NeuS's igr_weight) and the step at which the render's cosine
    # is fully annealed (its anneal_end)
    eikonal_lambda: float = 0.1
    cos_anneal_end: int = 50000
    # NetworkConfig.field "nerfacto" alone: its proposal sampler takes
    # proposal_samples bins a ray through the two proposal fields, uniform
    # then drawn from the first field's weights, then samples_per_ray bins
    # drawn from the second's for the field (the stratified sampler's
    # samples_per_ray otherwise); each draw from the weights raised to the
    # anneal exponent of the slot's step (`ops/sampler.anneal`);
    # nerfstudio's interlevel and distortion losses at their weights
    proposal_samples: tuple[int, ...] = (256, 96)
    interlevel_lambda: float = 1.0
    distortion_lambda: float = 0.002
    # dtype of the compute path; params stay fp32 and the render/mesh paths
    # force fp32 regardless (ref renders fp32, nerf_model.cu:1795).
    # "auto" = bfloat16 on TPU (matches the reference's fp16 training),
    # float32 on CPU (XLA CPU emulates bf16 ~5x slower — tests/dev only).
    compute_dtype: str = "auto"  # "auto" | "bfloat16" | "float32"


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    encoding: EncodingConfig = EncodingConfig()
    network: NetworkConfig = NetworkConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    train: TrainConfig = TrainConfig()
    seed: int = 1337  # ref nerf_model.h m_seed = 1337

    def __post_init__(self):
        if self.network.field != "nerfacto":
            return
        if self.encoding.kind != "hashgrid":
            raise ValueError("nerfacto's field is ported over the hash grid only")
        if len(self.train.proposal_samples) != 2 or min(self.train.proposal_samples) < 1:
            raise ValueError("nerfacto's sampler takes two proposal sample counts")
        if self.train.samples_per_ray < 3:
            raise ValueError("nerfacto's sampler reads three jitter columns a ray: "
                             "samples_per_ray >= 3")


def _sh_degree(dir_encoding: dict) -> int:
    """The SphericalHarmonics degree of an instant-ngp `dir_encoding`: the
    node itself or a child of its Composite's `nested` list; 0 if none."""
    for node in [dir_encoding] + list(dir_encoding.get("nested", [])):
        if str(node.get("otype", "")).lower() == "sphericalharmonics":
            return int(node.get("degree", 4))
    return 0


def _view_branch(cfg: dict) -> dict:
    """NetworkConfig's view-branch fields from instant-ngp's `dir_encoding`
    and `rgb_network` (configs/nerf/base.json); none where the JSON has no
    `dir_encoding` (RO-MAP's schema)."""
    degree = _sh_degree(cfg.get("dir_encoding", {}))
    if degree == 0:
        return {}
    rgb = cfg.get("rgb_network", {})
    return dict(sh_degree=degree, output_dims=16, rgb_n_neurons=int(rgb.get("n_neurons", 64)),
                rgb_n_hidden_layers=int(rgb.get("n_hidden_layers", 2)))


def load_network_config(path: str) -> NerfConfig:
    """Parse a reference-format network JSON (ref nerf_model.cu:1272-1284).

    Accepts the exact schema of Core/configs/base.json, and instant-ngp's
    configs/nerf/base.json, whose `dir_encoding` (SphericalHarmonics, alone
    or in a Composite) and `rgb_network` give the view branch; unknown keys
    are ignored; the loss otype is ignored (forced L2, matching the
    reference).
    """
    with open(path) as f:
        cfg: dict[str, Any] = json.load(f)

    enc = cfg.get("encoding", {})
    encoding = EncodingConfig(
        n_levels=int(enc.get("n_levels", 16)),
        n_features_per_level=int(enc.get("n_features_per_level", 2)),
        log2_hashmap_size=int(enc.get("log2_hashmap_size", 15)),
        base_resolution=int(enc.get("base_resolution", 16)),
    )

    net = cfg.get("network", {})
    network = NetworkConfig(
        n_neurons=int(net.get("n_neurons", 64)),
        n_hidden_layers=int(net.get("n_hidden_layers", 1)),
        **_view_branch(cfg),
    )

    # optimizer chain: Ema{ ExponentialDecay{ Adam } } (base.json:5-22)
    opt = cfg.get("optimizer", {})
    ema_decay = 0.95
    decay_start, decay_interval, decay_base = 20000, 10000, 0.33
    adam: dict[str, Any] = {}
    node = opt
    for _ in range(4):
        otype = str(node.get("otype", "")).lower()
        if otype == "ema":
            ema_decay = float(node.get("decay", 0.95))
        elif otype == "exponentialdecay":
            decay_start = int(node.get("decay_start", 20000))
            decay_interval = int(node.get("decay_interval", 10000))
            decay_base = float(node.get("decay_base", 0.33))
        elif otype == "adam":
            adam = node
        node = node.get("nested", {})
        if not node:
            break

    optimizer = OptimizerConfig(
        learning_rate=float(adam.get("learning_rate", 1e-2)),
        beta1=float(adam.get("beta1", 0.9)),
        beta2=float(adam.get("beta2", 0.99)),
        epsilon=float(adam.get("epsilon", 1e-15)),
        l2_reg=float(adam.get("l2_reg", 1e-6)),
        ema_decay=ema_decay,
        decay_start=decay_start,
        decay_interval=decay_interval,
        decay_base=decay_base,
    )

    return NerfConfig(encoding=encoding, network=network, optimizer=optimizer)
