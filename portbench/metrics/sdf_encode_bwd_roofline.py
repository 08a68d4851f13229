"""encode: an SDF field's encode backward against its roofline, in %: the
frozen counts' least time of H2 (the features' table gradient) and H3 (the
normal's backward) over every slot of a step (`frozen/sdf.py`), divided by
all device time under the program's `encode.bwd` spans, whatever kernels
run there."""

from portbench.frozen import sdf

NAME = "sdf_encode_bwd_roofline"


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("encode.bwd") if p else None
    if not s:
        return None
    least = sdf.least_seconds(sdf.config_of(NAME), ctx["slots"], ("H2", "H3"))
    return 100.0 * least / (s / ctx["profiled_steps"])
