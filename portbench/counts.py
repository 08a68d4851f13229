"""Work of one train step by the frozen counts (`frozen/work.py`), from
the configuration file's sizes: the encode's least device time forward and
backward over every slot the step trains, and the model FLOPs of one
object's step (the MLP's matrix products, forward and both gradients, and
the encode's counted operations both ways)."""

from __future__ import annotations

import torch

from portbench.frozen import work
from portbench.reference import nerf as ref


def compute_dtype(cfg: dict, device) -> str:
    """The compute dtype the configuration states; "auto" is bfloat16 on a
    card, float32 on the CPU (the program's rule)."""
    cd = cfg["train"]["compute_dtype"]
    if cd == "auto":
        return "float32" if torch.device(device).type == "cpu" else "bfloat16"
    return cd


def of(cfg: dict, n_slots: int, device) -> dict:
    enc, net, train = cfg["encoding"], cfg["network"], cfg["train"]
    dtype = compute_dtype(cfg, device)
    p = train["rays_per_batch"] * train["samples_per_ray"]
    if enc["kind"] == "hashgrid":
        h = ref.hash_sizes(enc)
        fwd = work.hash_work("forward", len(h["levels"]), h["features"], h["total"], dtype,
                             n_slots, p)
        bwd = work.hash_work("backward", len(h["levels"]), h["features"], h["total"], dtype,
                             n_slots, p)
    else:
        s = ref.mx_sizes(enc)
        sizes = work.Sizes(tuple(s["res"]), s["features"], tuple(s["planes"]), s["snap"])
        if s["snap"]:
            kf, kb = ("K1", "K2") if s["planes"] else ("K5", "K6")
        else:
            kf, kb = ("K3", "K4") if s["planes"] else ("K7", "K8")
        fwd = work.work(kf, sizes, dtype, n_slots, p)
        bwd = work.work(kb, sizes, dtype, n_slots, p)
    dims = [ref.out_dims(cfg)] + [net["n_neurons"]] * net["n_hidden_layers"] + [net["output_dims"]]
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])) * p * 3
    return dict(encode_fwd_s=work.least_seconds(*fwd), encode_bwd_s=work.least_seconds(*bwd),
                flops_per_obj_step=mlp + (fwd[1] + bwd[1]) / n_slots,
                peak_flops=work.PEAK_BF16_PER_S)
