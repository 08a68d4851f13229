"""romap_tpu_torch — the PyTorch/CUDA port of romap_tpu for one NVIDIA H100.

The JAX package `romap_tpu` stays the reference; every module here mirrors
its counterpart (same file names, same parameter layouts at the public
functions) and is tested against it on identical inputs on the CPU.

This package imports `torch`, never `jax` and nothing of `romap_tpu`. It
keeps its own copies of the reference's numpy-only modules it needs
(`config`, `data/synthetic`, `data/formats`, `utils/camera`), changed only
in their imports. Its entry points (offline runner, online manager, socket
server) run on the card unless the caller asks for the CPU.

Layout:
  ops/      — MX-grid and hash-grid encodes and the optimizer's update
              (plain + CUDA kernels; `cuda_lib` is the CUDA runtime),
              geometry, MLP, render, loss, marching cubes
  csrc/     — the hand-written CUDA kernels (built at first CUDA use)
  models/   — the batched multi-object train step, ray render, density grid,
              slot re-initialization
  data/     — device-resident frame store, the synthetic world, dataset IO
  runtime/  — view renderer, evaluation artifacts, the offline runner + CLI,
              the online manager, its socket server, trace replay
  utils/    — mesh writers, camera math, checkpoints, device choice, the
              JAX <-> port train-state bridge (numpy only)
"""

__version__ = "0.1.0"
