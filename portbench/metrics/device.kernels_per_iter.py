"""Kernels per train iteration in the traced window: the kernels of each
graph replay (copies and fills left out), averaged; nothing where the trace
lost a launch's kernels."""


def read(ctx):
    p = ctx.profile
    if p is None or p["lost"] or not p["per_replay"]:
        return None
    return sum(p["per_replay"]) / len(p["per_replay"])
