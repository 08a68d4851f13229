"""optimizer: device milliseconds a step under the program's
`optimizer.update` span (Adam, rate, EMA, the per-slot keep), from the
profile."""


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("optimizer.update") if p else None
    return 1e3 * s / ctx["profiled_steps"] if s else None
