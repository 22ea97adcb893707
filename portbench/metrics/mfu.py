"""The policy and value networks' matmul FLOPs of one train iteration
(counts.network_flops, from the configuration's widths) over the mean
iteration time of the timed window times the card's fp32 peak outside the
tensor cores (the configuration computes in fp32 with TF32 off), in %. The
physics is not counted."""
from portbench import counts


def read(ctx):
    peak = counts.PEAKS.get(ctx.device_name)
    w = ctx.window
    flops = counts.network_flops(ctx.cell.config, w.num_envs)
    if peak is None or flops is None or not w.intervals_ms:
        return None
    mean_s = sum(w.intervals_ms) / len(w.intervals_ms) / 1e3
    return 100.0 * flops / (mean_s * peak["fp32_flops"])
