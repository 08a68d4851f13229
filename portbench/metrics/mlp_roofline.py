"""MLP: the share of its roofline, in %: the frozen count's least time for
the field's networks, forward and backward over every slot
(`frozen/network.py`), divided by all device time under the program's
`mlp.fwd` and `mlp.bwd` spans, whatever kernels run there (the program's
spans inside `mlp.fwd` count toward it).

`ctx` names no configuration: the reader takes it from the cells its own
entry in `BENCHMARK.json` lists under `workloads`, which must share one."""

from portbench import counts, registry
from portbench.frozen import network

NAME = "mlp_roofline"


def config() -> dict:
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[NAME]
    cfgs = [registry.cell(w)["config"] for w in entry["workloads"]]
    if any(c != cfgs[0] for c in cfgs):
        raise ValueError(f"{NAME}'s cells run different configurations")
    return cfgs[0]


def read(ctx):
    p = ctx.get("profile")
    s = sum(p["span_s"].get(k, 0.0) for k in ("mlp.fwd", "mlp.bwd")) if p else 0.0
    if not s:
        return None
    cfg = config()
    shapes = registry.reference(cfg).leaf_shapes(cfg)
    points = cfg["train"]["rays_per_batch"] * cfg["train"]["samples_per_ray"]
    # device time exists only on a card: the compute dtype is the card's
    least = network.least_seconds(shapes, counts.compute_dtype(cfg, "cuda"), ctx["slots"],
                                  points)
    return 100.0 * least / (s / ctx["profiled_steps"])
