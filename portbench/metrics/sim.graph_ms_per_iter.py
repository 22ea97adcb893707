"""Device ms of one train iteration in the physics step (sim/, with the patch
kernel of ops/ inside it), read inside the replayed CUDA graph: the sum of
the iteration's `physics` spans on the device's own clock, the median over
the untraced replays of the span call (portbench/spans_call.py); nothing
for a program without spans."""
from portbench import spans_call


def read(ctx):
    return spans_call.metric(ctx, "physics")
