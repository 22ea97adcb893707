"""Device ms of one train iteration in the policy's act steps (agents/),
read inside the replayed CUDA graph: the sum of the iteration's `act`
spans on the device's own clock, the median over the untraced replays of
the span call (portbench/spans_call.py); nothing for a program without
spans."""
from portbench import spans_call


def read(ctx):
    return spans_call.metric(ctx, "act")
