"""What the training loop adds beyond the card's work, per iteration of the
timed window: (the window's host wall time - the sum of each replay's
device time between the CUDA events around it) / iterations, in ms."""


def read(ctx):
    w = ctx.window
    if not w.iters:
        return None
    return (w.wall_s * 1e3 - sum(w.device_ms)) / w.iters
