"""encode: nerfacto's encode forward against its roofline, in %: the
frozen counts' least time of H1 over the field's grid at its samples and
both proposal grids at theirs, over every slot of a step
(`frozen/proposal.py`), divided by all device time under the program's
`encode.fwd` spans (the field's and the proposal fields'), whatever
kernels run there."""

from portbench.frozen import proposal, sdf

NAME = "nerfacto_encode_fwd_roofline"


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("encode.fwd") if p else None
    if not s:
        return None
    least = proposal.least_seconds(sdf.config_of(NAME), ctx["slots"], "forward")
    return 100.0 * least / (s / ctx["profiled_steps"])
