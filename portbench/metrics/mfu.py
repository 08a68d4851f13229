"""whole step: model FLOPs of the window's object steps a second over the
card's bf16 peak, in %: (MLP matrix FLOPs x 3 + the encode's counted
operations) per object step x obj-iters/s of the unprofiled window / 989e12."""


def read(ctx):
    w = ctx.get("work")
    if not w or not ctx.get("profile") or not ctx["profile"]["busy_s"]:
        return None
    return 100.0 * w["flops_per_obj_step"] * ctx["obj_iters_per_s"] / w["peak_flops"]
