"""device: the card's peak allocation over the window, in GiB
(`max_memory_allocated` after `reset_peak_memory_stats` at its opening)."""


def read(ctx):
    b = ctx.get("peak_window_bytes")
    return b / 2**30 if b else None
