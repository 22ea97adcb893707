"""Device ms of one train iteration in the physics step (sim/, with the patch
kernel of ops/ inside it), called from the env step: one eager iteration after
the window, traced with that call inside a profiler range
(trace.by_range; the eager kernels are those the graph captured);
nothing where the trace lost a launch's kernel."""


def read(ctx):
    a = ctx.attribution
    if a is None or a["lost"] or "sim" not in a["ns"]:
        return None
    return a["ns"]["sim"] / 1e6
