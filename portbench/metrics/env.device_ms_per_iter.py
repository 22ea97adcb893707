"""Device ms of one train iteration in the env step (env/), the physics step
inside it left out: one eager iteration after
the window, traced with that call inside a profiler range
(trace.by_range; the eager kernels are those the graph captured);
nothing where the trace lost a launch's kernel."""


def read(ctx):
    a = ctx.attribution
    if a is None or a["lost"] or "env" not in a["ns"]:
        return None
    return a["ns"]["env"] / 1e6
