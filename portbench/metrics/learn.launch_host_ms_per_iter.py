"""Host ms per train iteration inside `learn`'s call of the step (the span
`learn.launch`, round the graph's replay, that is round cudaGraphLaunch),
on the host clock, the median over the untraced replays of the span call
(portbench/spans_call.py); nothing for a program without spans."""
from portbench import spans_call


def read(ctx):
    return spans_call.metric(ctx, "learn.launch")
