"""Work of one train step by the frozen counts (`frozen/work.py`), from
the configuration file's sizes: the encode's least device time forward and
backward over every slot the step trains (by encoding kind), and the model
FLOPs of one object's step (2 in out a point for each matrix leaf of the
configuration's field, `train.is_matrix` over its `leaf_shapes`, forward
and both gradients, and the encode's counted operations both ways)."""

from __future__ import annotations

import torch

from portbench import registry
from portbench.frozen import work
from portbench.reference import encodings
from portbench.reference.train import is_matrix


def compute_dtype(cfg: dict, device) -> str:
    """The compute dtype the configuration states; "auto" is bfloat16 on a
    card, float32 on the CPU (the program's rule)."""
    cd = cfg["train"]["compute_dtype"]
    if cd == "auto":
        return "float32" if torch.device(device).type == "cpu" else "bfloat16"
    return cd


def of(cfg: dict, n_slots: int, device) -> dict:
    enc, train = cfg["encoding"], cfg["train"]
    dtype = compute_dtype(cfg, device)
    p = train["rays_per_batch"] * train["samples_per_ray"]
    if enc["kind"] == "hashgrid":
        h = encodings.hash_sizes(enc)
        fwd = work.hash_work("forward", len(h["levels"]), h["features"], h["total"], dtype,
                             n_slots, p)
        bwd = work.hash_work("backward", len(h["levels"]), h["features"], h["total"], dtype,
                             n_slots, p)
    else:
        s = encodings.mx_sizes(enc)
        sizes = work.Sizes(tuple(s["res"]), s["features"], tuple(s["planes"]), s["snap"])
        if s["snap"]:
            kf, kb = ("K1", "K2") if s["planes"] else ("K5", "K6")
        else:
            kf, kb = ("K3", "K4") if s["planes"] else ("K7", "K8")
        fwd = work.work(kf, sizes, dtype, n_slots, p)
        bwd = work.work(kb, sizes, dtype, n_slots, p)
    mlp = sum(2 * shape[0] * shape[1] * p * 3
              for name, shape in registry.reference(cfg).leaf_shapes(cfg).items()
              if is_matrix(name))
    return dict(encode_fwd_s=work.least_seconds(*fwd), encode_bwd_s=work.least_seconds(*bwd),
                flops_per_obj_step=mlp + (fwd[1] + bwd[1]) / n_slots,
                peak_flops=work.PEAK_BF16_PER_S)
