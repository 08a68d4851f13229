"""encode: the share of its roofline, in %: the frozen work count's least
time for the step's encode forward over every slot (`counts.of`) divided by
all device time under the program's `encode.fwd` span, whatever kernels run
there."""


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("encode.fwd") if p else None
    if not s:
        return None
    return 100.0 * ctx["work"]["encode_fwd_s"] / (s / ctx["profiled_steps"])
