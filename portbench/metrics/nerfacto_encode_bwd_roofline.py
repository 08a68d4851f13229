"""encode: nerfacto's encode backward (the tables' gradients) against its
roofline, in %: the frozen counts' least time of H2 over the field's grid
at its samples and both proposal grids at theirs, over every slot of a
step (`frozen/proposal.py`), divided by all device time under the
program's `encode.bwd` spans (the field's and the proposal fields'),
whatever kernels run there."""

from portbench.frozen import proposal, sdf

NAME = "nerfacto_encode_bwd_roofline"


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("encode.bwd") if p else None
    if not s:
        return None
    least = proposal.least_seconds(sdf.config_of(NAME), ctx["slots"], "backward")
    return 100.0 * least / (s / ctx["profiled_steps"])
