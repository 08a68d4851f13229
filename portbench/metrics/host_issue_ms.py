"""train loop: host milliseconds to issue one train step, from an idle
card, read before the synchronise; median over the unprofiled steps."""

import statistics


def read(ctx):
    s = ctx.get("host_issue_s")
    return 1e3 * statistics.median(s) if s else None
