"""Frozen work counts of an SDF field's normal on the hash grid: H0, the
points' gradient that forms n = grad f in the forward pass, and H3, its
backward, by the rule of `frozen/work.py` (each input byte read once, each
output byte written once; a multiply and an add count as two operations).

Per point and level, with F features a level:
  H0   the cell's position (2 operations an axis), 8 corners' dot products
       <g_l, row_c> (2 F each), each corner's three weight slopes (a product
       of two weights) times that dot product added (3 each an axis), and
       the level's scale times the sum (2 an axis). Reads the points (12 B),
       g (L F in the compute dtype) and each object's table once; writes
       the fp32 gradient (12 B).
  H3   the cell's position, each corner's u_c = scale sum_d v_d slope_d
       (3 slopes of 1 product, 3 multiply-adds, the scale: 10 a corner),
       dg_l = sum_c u_c row_c (2 F a corner) and u_c g_l added to the
       table's gradient (2 F a corner). Reads the points, v (12 B, fp32), g
       and each object's table once; writes dg (L F) and the fp32 table
       gradient once.
"""

from __future__ import annotations

from portbench.frozen import work


def points_work(n_levels, n_features, table_rows, dtype, o, p):
    """(bytes, fp32 operations) of H0 on O x P points."""
    t = work._itemsize(dtype)
    n = o * p
    nbytes = 12 * n + n * n_levels * n_features * t + o * table_rows * n_features * t + 12 * n
    per_level = 3 * 2 + 8 * 2 * n_features + 8 * 3 * 3 + 3 * 2
    return nbytes, n * n_levels * per_level


def normal_backward_work(n_levels, n_features, table_rows, dtype, o, p):
    """(bytes, fp32 operations) of H3 on O x P points."""
    t = work._itemsize(dtype)
    n = o * p
    nbytes = (12 * n + 12 * n + 2 * n * n_levels * n_features * t
              + o * table_rows * n_features * t + o * table_rows * n_features * 4)
    per_level = 3 * 2 + 8 * 10 + 8 * 2 * n_features * 2
    return nbytes, n * n_levels * per_level


KERNELS = ("H0", "H1", "H2", "H3")


def least_seconds(cfg: dict, o: int, kernels) -> float:
    """The least time of the named kernels of `KERNELS` over one train step
    of O slots of the configuration's rays x samples, in the compute dtype
    it states on a card: each kernel's bytes over the memory rate or its
    operations over the fp32 peak, the larger (`work.least_seconds`),
    summed."""
    from portbench.counts import compute_dtype
    from portbench.reference import encodings

    h = encodings.hash_sizes(cfg["encoding"])
    p = cfg["train"]["rays_per_batch"] * cfg["train"]["samples_per_ray"]
    args = (len(h["levels"]), h["features"], h["total"], compute_dtype(cfg, "cuda"), o, p)
    count = {"H0": lambda: points_work(*args), "H1": lambda: work.hash_work("forward", *args),
             "H2": lambda: work.hash_work("backward", *args),
             "H3": lambda: normal_backward_work(*args)}
    return sum(work.least_seconds(*count[k]()) for k in kernels)


def config_of(metric: str) -> dict:
    """The configuration of the cells that a per-layer metric's entry in
    `BENCHMARK.json` lists under `workloads` (`ctx` names none), which must
    share one."""
    from portbench import registry

    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[metric]
    cfgs = [registry.cell(w)["config"] for w in entry["workloads"]]
    if any(c != cfgs[0] for c in cfgs):
        raise ValueError(f"{metric}'s cells run different configurations")
    return cfgs[0]
