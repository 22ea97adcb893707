"""Share of the traced replays' device span (the first replay's first
device interval's start to the last replay's last one's end, by the trace's
own clock) in which nothing ran on the device (the union of its kernels,
copies and fills), in %: idle inside the replays and between them
together."""


def read(ctx):
    p = ctx.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
