"""optimizer: device milliseconds a step under the harness's `optimizer`
span(s), from the profile."""


def read(ctx):
    p = ctx.get("profile")
    s = p["span_s"].get("optimizer") if p else None
    return 1e3 * s / ctx["profiled_steps"] if s else None
