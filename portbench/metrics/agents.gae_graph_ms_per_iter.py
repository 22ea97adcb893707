"""Device ms of one train iteration in GAE (agents/common.py), read inside
the replayed CUDA graph: the iteration's `gae` span on the device's own
clock, the median over the untraced replays of the span call
(portbench/spans_call.py); nothing for a program without spans."""
from portbench import spans_call


def read(ctx):
    return spans_call.metric(ctx, "gae")
