"""encode: H3, the SDF normal's backward, against its roofline, in %: the
frozen count's least time of H3 over every slot of a step
(`frozen/sdf.py`), divided by H3's own device seconds a step, read from the
profile's largest device operations by its kernel's name
(`hash_normal_bwd`, csrc/hashgrid.cu). None where H3 did not run or is not
among them."""

from portbench.frozen import sdf

NAME = "h3_roofline"
KERNEL = "hash_normal_bwd"


def read(ctx):
    p = ctx.get("profile")
    s = sum(sec for name, sec in p["device_ops"] if KERNEL in name) if p else 0.0
    if not s:
        return None
    least = sdf.least_seconds(sdf.config_of(NAME), ctx["slots"], ("H3",))
    return 100.0 * least / (s / ctx["profiled_steps"])
