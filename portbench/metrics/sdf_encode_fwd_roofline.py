"""encode: an SDF field's encode forward against its roofline, in %: the
frozen counts' least time of H1 (the features) and H0 (the normal's points
gradient) over every slot of a step (`frozen/sdf.py`), divided by all device
time under the program's `encode.fwd` spans (the features' and the one
inside `sdf.normal`), whatever kernels run there."""

from portbench.frozen import sdf

NAME = "sdf_encode_fwd_roofline"


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("encode.fwd") if p else None
    if not s:
        return None
    least = sdf.least_seconds(sdf.config_of(NAME), ctx["slots"], ("H1", "H0"))
    return 100.0 * least / (s / ctx["profiled_steps"])
