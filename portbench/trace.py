"""The device trace of a short window of replays, read in memory.

`profiled(fn, n)` calls `fn` (one replay of the train iteration's graph)
`n` times under the profiler's device tracing and reduces the trace at
once; nothing is written to disk. The window is opened as the port's
`tools/profile_rollout.window` opens it (copied here): the device tracing
is prepared, one more call runs as the lead-in (its kernels fall before the
window), the window opens, and the body starts PAD_S later. On an H100 a
window opened at once lost the kernels of its first milliseconds after
profiled graph replays in the same process; this one lost none.

The trace is read from the profiler's raw events, without building its
per-op tables (which take minutes for the ~190k kernels of a replay):

- `busy_s`: the union of the device's kernel, copy and fill intervals;
- `window_s`: the device's own span of the replays: from the start of the
  first replay's first interval to the end of the last replay's last
  (without replays, of all intervals), so that neither the lead-in nor the
  host's first launch is in it; `busy_s` is then the union inside that
  span; `host_s` is the host clock from the first call to the synchronize
  after the last, kept for comparison;
- `replay_s` and `replay_idle_s`: the summed span of each graph replay's
  device work (its first interval's start to its last one's end), and the
  idle time inside those spans; `between_s`: the idle gap from each
  replay's end to the next one's start;
- `per_replay`: kernels (copies and fills left out) per graph launch
  (their correlation id is the launch's); `lost`: launches whose kernels
  the trace lacks;
- `by_name`: device time and count per kernel name; `gaps`: the longest
  idle intervals between device work, each named after the host call that
  was running across it.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Sequence, Tuple

import torch

PAD_S = 0.1
# device activities that are copies and fills, not kernels
COPIES = ("Memcpy", "Memset")


def _raw_events(body: Callable[[], object], lead_in: Callable[[], object],
                device: torch.device):
    """(raw profiler events of `body`, its host seconds), the window opened
    after `lead_in` and PAD_S (see the module docstring)."""
    from torch.autograd import profiler as autograd_profiler

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.prepare_trace()
    lead_in()
    _sync(device)
    prof.start_trace()
    time.sleep(PAD_S)
    t0 = time.perf_counter()
    body()
    _sync(device)
    host_s = time.perf_counter() - t0
    # the raw events, without the profiler's own per-op processing
    return autograd_profiler._disable_profiler().events(), host_s


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn: Callable[[], object], n: int, device: torch.device) -> Dict:
    """Trace `n` calls of `fn` on `device` (see the module docstring; on
    the CPU the trace holds no device work)."""
    def body():
        for _ in range(n):
            fn()
    events, host_s = _raw_events(body, fn, device)
    return reduce(events, host_s, n)


RANGE = "portbench."


@contextlib.contextmanager
def ranges(targets: Sequence[Tuple[object, str, str]]):
    """Wrap each (object, method name, range name) so that its calls run
    inside a profiler range RANGE + range name; unwrapped on exit."""
    def wrapped(f, name):
        def g(*args, **kwargs):
            with torch.profiler.record_function(RANGE + name):
                return f(*args, **kwargs)
        return g
    saved = [(obj, attr, obj.__dict__.get(attr)) for obj, attr, _ in targets]
    for obj, attr, name in targets:
        setattr(obj, attr, wrapped(getattr(obj, attr), name))
    try:
        yield
    finally:
        for obj, attr, before in reversed(saved):
            if before is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, before)


def by_range(call: Callable[[], object], device: torch.device) -> Dict:
    """Device time of one eager `call` by the innermost RANGE range that
    was open on the host when each kernel (or copy) was launched: its
    launch call and it share a correlation id. Kernels launched outside
    every range count as "other". Returns {"ns": {range: ns}, "lost":
    launches whose kernel the trace lacks}; the window opens after a small
    kernel as its lead-in (`profile_rollout.lead_in_on`)."""
    def lead_in():
        torch.ones(1, device=device).add_(1)
    events, _ = _raw_events(call, lead_in, device)
    return attribute(events)


def attribute(events) -> Dict:
    """`by_range`'s reduction of raw profiler events (objects with name(),
    device_type(), start_ns(), duration_ns(), correlation_id() and
    is_user_annotation())."""
    cpu = torch.autograd.DeviceType.CPU
    dev_ns = defaultdict(int)
    spans, launches = [], []
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                dev_ns[e.correlation_id()] += e.duration_ns()
        elif name.startswith(RANGE):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name[len(RANGE):]))
        elif name.startswith("cuda") and ("Launch" in name
                                          or "Memcpy" in name
                                          or "Memset" in name):
            launches.append((e.start_ns(), e.correlation_id(), name))
    launches.sort()
    times = [t for t, _, _ in launches]
    owner = [None] * len(launches)
    width = [None] * len(launches)
    for s, e, name in spans:
        for i in range(bisect.bisect_left(times, s),
                       bisect.bisect_right(times, e)):
            if width[i] is None or e - s < width[i]:
                owner[i], width[i] = name, e - s
    out = defaultdict(int)
    lost = 0
    for (_, corr, name), who in zip(launches, owner):
        if corr in dev_ns:
            out[who or "other"] += dev_ns[corr]
        elif "Kernel" in name:
            lost += 1
    return {"ns": dict(out), "lost": lost}


def _union(intervals):
    """Merged (start, end) intervals of a list of them."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(events, host_s: float, n: int) -> Dict:
    """The trace's readings (see the module docstring) from raw profiler
    events (objects with name(), device_type(), start_ns(), duration_ns(),
    correlation_id() and is_user_annotation()) and the window's host
    seconds."""
    cpu = torch.autograd.DeviceType.CPU
    device, host = [], []
    for e in events:
        if e.device_type() == cpu:
            host.append(e)
        elif not e.is_user_annotation():
            device.append(e)
    by_name = defaultdict(lambda: [0, 0])
    by_corr = defaultdict(int)
    spans = []
    of_launch = defaultdict(list)
    for e in device:
        s = e.start_ns()
        d = e.duration_ns()
        spans.append((s, s + d))
        of_launch[e.correlation_id()].append((s, s + d))
        row = by_name[e.name()]
        row[0] += d
        row[1] += 1
        if not e.name().startswith(COPIES):
            by_corr[e.correlation_id()] += 1
    merged = _union(spans)
    launches = [e for e in host if e.name().startswith("cuda")
                and "Launch" in e.name()]
    graphs = [e for e in launches if "Graph" in e.name()]
    per_replay = [by_corr.get(e.correlation_id(), 0) for e in graphs]
    lost = sum(1 for e in launches if "Kernel" in e.name()
               and e.correlation_id() not in by_corr)
    if per_replay:
        lost += sum(max(per_replay) - k for k in per_replay)
    # each replay's device work, in the order the device ran it
    replays = []
    for e in graphs:
        own = _union(of_launch.get(e.correlation_id(), []))
        if own:
            replays.append((own[0][0], own[-1][1],
                            sum(b - a for a, b in own)))
    replays.sort()
    lo, hi = ((replays[0][0], replays[-1][1]) if replays else
              (merged[0][0], merged[-1][1]) if merged else (0, 0))
    busy_ns = sum(min(e, hi) - max(s, lo) for s, e in merged
                  if e > lo and s < hi)
    runtime = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name()) for e in host if e.name().startswith("cuda"))

    def doing(s, e):
        mid = (s + e) // 2
        names = [(b - a, name) for a, b, name in runtime if a <= mid <= b]
        return min(names)[1] if names else "host (no runtime call)"

    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    return {
        "window_s": (hi - lo) / 1e9,
        "host_s": host_s,
        "busy_s": busy_ns / 1e9,
        "replays": n,
        "replay_s": sum(b - a for a, b, _ in replays) / 1e9,
        "replay_idle_s": sum(b - a - w for a, b, w in replays) / 1e9,
        "between_s": [(replays[i + 1][0] - replays[i][1]) / 1e9
                      for i in range(len(replays) - 1)],
        "kernels": sum(by_corr.values()),
        "per_replay": per_replay,
        "lost": lost,
        "by_name": {k: {"ns": v[0], "count": v[1]}
                    for k, v in by_name.items()},
        "gaps": [[doing(s, e), g / 1e9] for g, s, e in gaps],
    }
