"""romap_tpu_torch — the PyTorch/CUDA port of romap_tpu for one NVIDIA H100.

The JAX package `romap_tpu` stays the reference; every module here mirrors
its counterpart (same file names, same parameter layouts at the public
functions) and is tested against it on identical inputs on the CPU.

This package imports `torch` and never `jax`. It reuses the numpy-only
modules of the reference (`romap_tpu.config`, `romap_tpu.data.synthetic`,
`romap_tpu.data.formats`, `romap_tpu.utils.camera`), none of which import
jax.

Layout:
  ops/      — MX-grid encode (plain + CUDA kernels), geometry, MLP, render,
              loss, marching cubes
  csrc/     — the hand-written CUDA kernels (built at first CUDA use)
  models/   — the batched multi-object train step, ray render, density grid
  data/     — device-resident frame store and the synthetic world
  runtime/  — view renderer, evaluation artifacts, the offline runner + CLI
  utils/    — mesh writers, the JAX <-> port train-state bridge (numpy only)
"""

__version__ = "0.1.0"
