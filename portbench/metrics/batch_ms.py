"""batch generation: device milliseconds a step under the program's `batch`
spans (the draws and the batch), from the profile."""


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("batch") if p else None
    return 1e3 * s / ctx["profiled_steps"] if s else None
