"""train loop: kernels launched a step, from the profile."""


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["launches"]:
        return None
    return p["launches"] / ctx["profiled_steps"]
