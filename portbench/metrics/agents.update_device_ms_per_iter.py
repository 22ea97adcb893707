"""Device ms of one train iteration in the update (the algorithm's
update: minibatch forwards and backwards, Adam): one eager iteration after
the window, traced with that call inside a profiler range
(trace.by_range; the eager kernels are those the graph captured);
nothing where the trace lost a launch's kernel."""


def read(ctx):
    a = ctx.attribution
    if a is None or a["lost"] or "update" not in a["ns"]:
        return None
    return a["ns"]["update"] / 1e6
