"""Do profiler traces keep every kernel after profiled CUDA-graph replays?

The check behind `profile_rollout.window`. It builds the physics setup of
tools/profile_rollout.py (Go2Cfg() at `--num_envs` envs, init_state(0),
zero PD targets) and a go2_moe_cts runner on the same env, captures its
train iteration as a CUDA graph with deterministic algorithms on
(`capture`: the graph after whose profiled replays the op tables lost the
patch kernel), and then, for each of REPLAYS rounds, profiles one replay
of that graph (`profile_replay`, after one more as its lead-in) and
traces WINDOWS windows of 3 physics steps each in two ways:

- "at once": torch.profiler.profile's own window, opened with the tracing;
- "lead-in": `profile_rollout.window`, opened after one physics step made
  with the tracing on, its body started WINDOW_PAD_S later.

For every window it counts the launch calls whose kernel the trace lacks
(`profile_rollout.launches_without_kernel`), the first one's time into the
window, and the patch kernels in the trace (3 are launched). Prints one
JSON line per replay and per window and a summary as the last line; exits
with 1 when a "lead-in" window lost a kernel. On the CPU there are no
kernels to lose.

Usage:
    python -m go2_rl_gym_tpu_torch.tools.trace_window [--num_envs 4096]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from go2_rl_gym_tpu_torch.tools import profile_rollout as pr

STEPS = 3           # physics steps traced per window
REPLAYS = 3         # profiled replays of the graph
WINDOWS = 3         # windows of each kind after each replay


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def capture(setup):
    """The go2_moe_cts train iteration on `setup`'s env (`build("train",
    like=setup)`) as a CUDA graph captured with deterministic algorithms
    on, called twice (on the card: the warm-up and the capture, then a
    replay). Returns (the compiled step, its runner)."""
    train = pr.build("train", like=setup)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step = train.runner.compiled_step(train.rs)
        step()
        step()
    finally:
        torch.use_deterministic_algorithms(False)
    pr._sync(setup.env.device)
    return step, train.runner


def profile_replay(step, device):
    """One call of `step` under torch.profiler (`profile_rollout.window`,
    one more call as its lead-in): {"kernels": the kernels in the trace,
    "lost": the launches in it whose kernel it lacks}."""
    def lead_in():
        step()
        pr._sync(device)
    with pr.window(_activities(device), lead_in) as prof:
        step()
        pr._sync(device)
    return {"kernels": sum(e.count for e in pr._kernels(prof)),
            "lost": len(pr.launches_without_kernel(prof.events()))}


def trace(setup, kind):
    """Trace STEPS physics steps in a window of `kind`; returns its row."""
    dev = setup.env.device
    acts = _activities(dev)

    def step():
        setup.fn(*setup.args)
        pr._sync(dev)

    if kind == "at once":
        step()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(STEPS):
                setup.fn(*setup.args)
            pr._sync(dev)
    else:
        with pr.window(acts, step) as prof:
            for _ in range(STEPS):
                setup.fn(*setup.args)
            pr._sync(dev)
    events = prof.events()
    lost = pr.launches_without_kernel(events)
    cpu = torch.autograd.DeviceType.CPU
    return {"window": kind, "lost": len(lost),
            "first_lost_us": lost[0].time_range.start if lost else None,
            "patch_kernels": sum(1 for e in events if e.device_type != cpu
                                 and not e.is_user_annotation
                                 and "extract_patches" in e.name)}


def run(num_envs=None, device="cuda"):
    """The check (see the module docstring). Returns the summary."""
    # cuBLAS's deterministic workspace, set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    setup = pr.build("physics", num_envs, device)
    dev = setup.env.device
    graph, _ = capture(setup)
    rows = []
    for r in range(REPLAYS):
        print(json.dumps({"replay": r, **profile_replay(graph, dev)}),
              flush=True)
        for w in range(WINDOWS):
            for kind in ("at once", "lead-in"):
                row = {"replay": r, "n": w, **trace(setup, kind),
                       "age_s": time.perf_counter() - t0}
                rows.append(row)
                print(json.dumps(row), flush=True)
    summary = {kind: {"windows": sum(1 for x in rows if x["window"] == kind),
                      "with_loss": sum(1 for x in rows
                                       if x["window"] == kind and x["lost"]),
                      "lost": sum(x["lost"] for x in rows
                                  if x["window"] == kind),
                      "without_all_patch_kernels": sum(
                          1 for x in rows if x["window"] == kind
                          and x["patch_kernels"] != STEPS)}
               for kind in ("at once", "lead-in")}
    summary.update(num_envs=setup.env.num_envs,
                   pad_s=pr.WINDOW_PAD_S,
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    summary = run(args.num_envs, args.device)
    print(json.dumps(summary), flush=True)
    if summary["lead-in"]["with_loss"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
