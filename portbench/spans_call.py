"""The span call of a traced run, read by the per-layer metrics
`*_graph_ms_per_iter` and `learn.launch_host_ms_per_iter`.

The program stamps the phases of each train iteration on the device's own
clock, inside its CUDA graph (`go2_rl_gym_tpu_torch/utils/spans.py`). The
first of those readers to run (after every other reading of the run, the
memory peak and the reference's) makes one more `learn` call of CALL_ITERS
iterations with a span recorder on, on a runner of its own built as the
harness builds the run's (the cell's configuration, the run's `--seed`):
the eager warm-up, the capture of the graph with its stamps, then replays,
each call wrapped as the harness wraps the window's (`harness.Timed`: CUDA
events before and after) and the ring's cursor copied on the device after
each. Then TRACED replays go through `learn` under the profiler
(`trace._raw_events`, after a small kernel as the lead-in). Each call's
stamps are decoded by position (`spans.decode`); the metrics are medians
over the untraced replays (calls 1 to CALL_ITERS - 1).

The stderr line `spans_ms` holds, per span, [median, min, max] ms over the
untraced and over the traced replays and their ratio (what the profiler
stretches), the stamps per replay, the cursor's step per call (each has to
be the schedule's length: no stamp lost), each replay's `train_step` span
over its CUDA-event ms (the stamps span the replay), `learn.launch`'s host
ms, and the TOP longest idle gaps of the traced replays, each named by the
innermost device span it lies in (the i-th stamp kernel of a replay is
schedule edge i, on the trace's own clock) and by the innermost `go2.*`
host range, else the CUDA runtime call, open at its midpoint.

A program without spans (no `utils/spans.py`) gives nothing: every reader
returns None, and no call is made.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from portbench import harness, spec, trace

CALL_ITERS = 10
TRACED = 2
TOP = 10
OUTSIDE = "outside the spans"


def of(ctx) -> Optional[Dict]:
    """The span call's readings for the run of `ctx`: made at the first
    call and kept on ctx; None where the program has no spans."""
    if "spans_call" not in vars(ctx):
        ctx.spans_call = measure(ctx)
    return ctx.spans_call


def metric(ctx, name: str) -> Optional[float]:
    """The median ms of the span `name` (or `learn.launch`, host ms) per
    untraced replay of the span call; None where there is none."""
    got = of(ctx)
    if got is None or name not in got["median"]:
        return None
    return got["median"][name]


def run_seed() -> int:
    """The run's --seed, as the harness takes it (0 outside the command)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0].seed % 2 ** 63


def _stats(values: List[float]) -> List[float]:
    return [statistics.median(values), min(values), max(values)]


def measure(ctx) -> Optional[Dict]:
    """The span call (see the module docstring); prints `spans_ms`."""
    try:
        spans = importlib.import_module("go2_rl_gym_tpu_torch.utils.spans")
    except ImportError:
        return None
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
    from go2_rl_gym_tpu_torch.utils import registry

    t0 = time.perf_counter()
    dev = torch.device("cpu" if ctx.device_name == "cpu" else "cuda")
    clock = harness.Clock(dev)
    calls = CALL_ITERS + 1 + TRACED
    cursors = torch.zeros(calls, dtype=torch.int64, device=dev)

    class Runner(OnPolicyRunner):
        timed = None

        def compiled_step(self, rs):
            run = super().compiled_step(rs)
            if self.timed is None or self.timed.run is not run:
                self.timed = harness.Timed(run, clock)
                self.timed.after = lambda k, out: cursors[k].copy_(
                    rec.buf[0])
            return self.timed

    cell, seed = ctx.cell, run_seed()
    env_cfg, train_cfg = spec.build_cfgs(registry, cell)
    env = Go2Env(env_cfg, num_steps_per_env=train_cfg.runner.num_steps_per_env,
                 terrain_seed=seed, device=dev)
    runner = Runner(env, train_cfg, log_dir=None, device=dev)
    rs = runner.init_runner_state(
        seed, init_at_random_ep_len=bool(cell.traffic["random_start"]))
    quiet = dict(print_every=10 ** 9)
    with spans.recording(dev) as rec:
        rs = runner.learn(rs, CALL_ITERS, **quiet)
        step = runner.timed

        def lead_in():
            torch.ones(1, device=dev).add_(1)
            step()

        events, _ = trace._raw_events(
            lambda: runner.learn(rs, TRACED, **quiet), lead_in, dev)
        trace._sync(dev)
        ring = rec.copy()
        launch_ms = rec.host_ms("learn.launch", CALL_ITERS + TRACED)
        schedule = rec.schedule
    trace._sync(dev)
    ring, cursor = ring.numpy(), cursors.cpu().tolist()
    L = len(schedule)
    steps = [b - a for a, b in zip([0] + cursor[:-1], cursor)]
    per_call = [spans.decode(ring[1:], c, L, schedule)[0] for c in cursor]
    event_ms = [clock.ms(a, b) for a, b in step.marks]
    untraced = range(1, CALL_ITERS)
    traced = range(CALL_ITERS + 1, calls)
    names = list(per_call[0])
    out = {
        "untraced": {n: _stats([per_call[k][n] for k in untraced])
                     for n in names},
        "traced": {n: _stats([per_call[k][n] for k in traced])
                   for n in names},
        "learn.launch": _stats(launch_ms[1:CALL_ITERS]),
        "stamps_per_replay": L,
        "cursor_steps": steps,
        "span_over_event": [per_call[k]["train_step"] / event_ms[k]
                            for k in range(1, calls)],
        "event_ms": event_ms[1:],
    }
    out["stretch"] = {n: out["traced"][n][0] / out["untraced"][n][0]
                      for n in names if out["untraced"][n][0] > 0}
    replays = device_spans(events, schedule, spans)
    out["traced_replays_paired"] = len(replays)
    out["gaps"] = idle_gaps(events, replays)
    del runner, env, rs, step
    out["seconds"] = time.perf_counter() - t0
    print("spans_ms " + json.dumps(out), file=sys.stderr, flush=True)
    median = {n: out["untraced"][n][0] for n in names}
    median["learn.launch"] = out["learn.launch"][0]
    if any(s != L for s in steps):
        # a lost stamp shifts every later one: nothing is read
        median = {}
    return {"median": median, "line": out}


def device_spans(events, schedule, spans) -> List[List]:
    """Per traced graph replay, [(span name, start ns, end ns)] on the
    trace's own clock: the replay's stamp kernels (spans.STAMP_KERNEL, its
    launch's correlation id) in order of start are the schedule's edges in
    order. A replay whose stamps the trace does not hold one for one is
    left out."""
    cpu = torch.autograd.DeviceType.CPU
    stamps = defaultdict(list)
    launches = []
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            if spans.STAMP_KERNEL in name and not e.is_user_annotation():
                stamps[e.correlation_id()].append(e.start_ns())
        elif name.startswith("cuda") and "Graph" in name \
                and "Launch" in name:
            launches.append(e.correlation_id())
    edges = spans.pairs(schedule)
    out = []
    for corr in launches:
        t = sorted(stamps.get(corr, ()))
        if len(t) == len(schedule):
            out.append([(name, t[b], t[e]) for name, b, e, _ in edges])
    return out


def idle_gaps(events, replays: List[List], top: int = TOP) -> List[List]:
    """The `top` longest idle gaps of the device between the first traced
    replay's first stamp and the last one's last, longest first, each
    [ms, the innermost device span at its midpoint (OUTSIDE in none), the
    innermost `go2.*` host range open then, else the innermost CUDA
    runtime call, else "host (no runtime call)"]."""
    if not replays:
        return []
    cpu = torch.autograd.DeviceType.CPU
    lo = min(s for r in replays for _, s, _ in r)
    hi = max(e for r in replays for _, _, e in r)
    busy, ranges, runtime = [], [], []
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                busy.append((s, s + d))
        elif name.startswith("go2."):
            ranges.append((s, s + d, name))
        elif name.startswith("cuda"):
            runtime.append((s, s + d, name))
    merged = trace._union(busy)
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])
                   if a[1] >= lo and b[0] <= hi), reverse=True)[:top]
    device = [span for r in replays for span in r]

    def innermost(spans_, mid):
        inside = [(e - s, name) for s, e, name in spans_ if s <= mid <= e]
        return min(inside)[1] if inside else None

    out = []
    for g, s, e in gaps:
        mid = (s + e) // 2
        dev = innermost([(a, b, n) for n, a, b in device], mid) or OUTSIDE
        host = (innermost(ranges, mid) or innermost(runtime, mid)
                or "host (no runtime call)")
        out.append([g / 1e6, dev, host])
    return out
