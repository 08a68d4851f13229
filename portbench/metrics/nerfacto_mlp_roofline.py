"""MLP: nerfacto's networks against their roofline, in %: the frozen
count's least time of every matrix product of the field's density and
colour networks at the field's samples and of each proposal net at its
own, forward and backward over every slot of a step
(`frozen/proposal.py`, by `frozen/network.py`'s rule), divided by all
device time under the program's `mlp.fwd` and `mlp.bwd` spans (the
field's and the proposal fields'), whatever kernels run there."""

from portbench.frozen import proposal, sdf

NAME = "nerfacto_mlp_roofline"


def read(ctx):
    p = ctx.get("profile")
    s = sum(p["span_s"].get(k, 0.0) for k in ("mlp.fwd", "mlp.bwd")) if p else 0.0
    if not s:
        return None
    least = proposal.network_least_seconds(sdf.config_of(NAME), ctx["slots"])
    return 100.0 * least / (s / ctx["profiled_steps"])
