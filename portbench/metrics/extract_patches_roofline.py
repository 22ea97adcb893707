"""The patch kernel's share of its roofline, in %: the least time its
traffic takes at the card's HBM rate (counts.patch_bytes: the windows
written plus the union of the grid cells read, at the origins of the
bases when the traced window opens) over its mean device time in the
traced window of graph replays."""
from portbench import counts

KERNEL = "extract_patches_kernel"


def read(ctx):
    peak = counts.PEAKS.get(ctx.device_name)
    p = ctx.profile
    if peak is None or p is None or ctx.patch_bytes is None:
        return None
    rows = [v for k, v in p["by_name"].items() if KERNEL in k]
    count = sum(r["count"] for r in rows)
    if not count:
        return None
    mean_s = sum(r["ns"] for r in rows) / count / 1e9
    return 100.0 * ctx.patch_bytes / peak["hbm_bytes_per_s"] / mean_s
