"""device: the card's idle share, in %: 1 - (device busy a step, from the
profiled steps) / (seconds a step over the unprofiled window's whole units,
mesh rounds included)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / ctx["profiled_steps"] / ctx["step_s"])
