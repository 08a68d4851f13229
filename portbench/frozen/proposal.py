"""Frozen work counts of nerfacto's encodes and networks at the points
each one runs at: the field's hash grid and networks at its samples, each
proposal field's hash grid and net at its own. The encodes by the rule of
`frozen/work.py` (`hash_work`: each input byte read once, each output byte
written once; a multiply and an add count as two operations), the
networks by `frozen/network.py`'s, at the published widths (the program's
padding of the 10- and 63-wide inputs is work the count leaves out).

A step of O slots of R rays encodes R x samples_per_ray points through the
field's grid and R x proposal_samples[k] points through proposal field k's
grid (5 levels x 2 features, 2^17 rows a level, base 16, up to its max
resolution at nerfacto's sizes); forward is H1, backward H2.
"""

from __future__ import annotations

from portbench.frozen import network, work


def _grids(cfg: dict) -> list[tuple[dict, int]]:
    """(encoding section, points a ray) of the field's grid and of each
    proposal field's."""
    net, tr = cfg["network"], cfg["train"]
    grids = [(cfg["encoding"], tr["samples_per_ray"])]
    for res, n in zip(net["proposal_max_resolutions"], tr["proposal_samples"]):
        enc = dict(kind="hashgrid", n_levels=net["proposal_levels"],
                   n_features_per_level=net["proposal_features"],
                   log2_hashmap_size=net["proposal_log2_hashmap_size"],
                   base_resolution=net["proposal_base_resolution"],
                   desired_resolution=float(res))
        grids.append((enc, n))
    return grids


def least_seconds(cfg: dict, o: int, direction: str) -> float:
    """The least time of every grid's encode `direction` ("forward": H1,
    "backward": H2) over one train step of O slots, in the compute dtype
    the configuration states on a card, each grid's bytes over the memory
    rate or its operations over the fp32 peak, the larger, summed."""
    from portbench.counts import compute_dtype
    from portbench.reference import encodings

    dtype = compute_dtype(cfg, "cuda")
    total = 0.0
    for enc, per_ray in _grids(cfg):
        h = encodings.hash_sizes(enc)
        p = cfg["train"]["rays_per_batch"] * per_ray
        total += work.least_seconds(*work.hash_work(direction, len(h["levels"]), h["features"],
                                                    h["total"], dtype, o, p))
    return total


def network_least_seconds(cfg: dict, o: int) -> float:
    """The least time of every matrix product of one train step of O slots,
    forward and backward (`network.least_seconds`): the field's density and
    colour networks at R x samples_per_ray points, proposal net k at R x
    proposal_samples[k], in the compute dtype the configuration states on a
    card."""
    from portbench.counts import compute_dtype
    from portbench.reference import nerfacto

    dtype = compute_dtype(cfg, "cuda")
    tr = cfg["train"]
    shapes = nerfacto.leaf_shapes(cfg)
    per_ray = {"density": tr["samples_per_ray"], "rgb": tr["samples_per_ray"],
               **{f"prop{k}": n for k, n in enumerate(tr["proposal_samples"])}}
    total = 0.0
    for net, n in per_ray.items():
        leaves = {k: v for k, v in shapes.items() if k.startswith(net + ".")}
        total += network.least_seconds(leaves, dtype, o, tr["rays_per_batch"] * n)
    return total
