"""render + loss: device milliseconds a step under the program's
`loss.fwd` and `loss.bwd` spans, from the profile."""


def read(ctx):
    p = ctx.get("profile")
    s = sum(p["span_s"].get(k, 0.0) for k in ("loss.fwd", "loss.bwd")) if p else 0.0
    return 1e3 * s / ctx["profiled_steps"] if s else None
