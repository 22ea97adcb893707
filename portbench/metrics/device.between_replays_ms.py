"""The mean idle gap on the device from the end of one traced graph replay
to the start of the next, in ms: what launching the next replay costs the
device, by the trace's own clock."""


def read(ctx):
    p = ctx.profile
    if p is None or not p["between_s"]:
        return None
    return 1e3 * sum(p["between_s"]) / len(p["between_s"])
