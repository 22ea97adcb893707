"""Device ms of one train iteration in the act step (the algorithm's act:
the encoders, the actor and the critic on every env): one eager iteration after
the window, traced with that call inside a profiler range
(trace.by_range; the eager kernels are those the graph captured);
nothing where the trace lost a launch's kernel."""


def read(ctx):
    a = ctx.attribution
    if a is None or a["lost"] or "act" not in a["ns"]:
        return None
    return a["ns"]["act"] / 1e6
