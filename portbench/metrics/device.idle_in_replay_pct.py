"""Share of the traced graph replays' own spans (each replay's first device
interval's start to its last one's end) in which nothing ran on the device,
in %: the gaps between the kernels of one replay, without the gaps between
replays."""


def read(ctx):
    p = ctx.profile
    if p is None or p["replay_s"] <= 0:
        return None
    return 100.0 * p["replay_idle_s"] / p["replay_s"]
