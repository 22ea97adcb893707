"""One run of one cell: set-up, the timed window through `learn`, the
traced window (with --trace 1), then the comparison with the plain
reference; returns the contract's result object.

The system under test is `go2_rl_gym_tpu_torch`'s training loop as
`scripts.train` runs it: `OnPolicyRunner.learn`, which replays one CUDA
graph of `train_step` (made by `compiled_step`) in chunks.

- Set-up (`setup_s`: process start to the window's start): import, the
  task's terrain and env from the seed, `init_runner_state(seed)`, and one
  `learn` call of `compare.STEPS` iterations: the eager warm-up and the
  capture, then replays. Those first iterations are the ones compared:
  the callable `learn` replays is wrapped (`Timed`) and, during set-up,
  reads after each iteration its losses, the Adam state, the parameters and
  the observations (`compare.iteration`), and the state that the next
  iteration starts from (`compare.snapshot`).
- The window: one further `learn` call on the same runner (no new capture)
  of as many iterations as fill `--seconds` at the set-up replays' pace,
  its checkpoints under TMPDIR at the task's save interval. The wrapper
  records a CUDA event before and after each iteration and copies its
  metric row; nothing synchronizes until `learn` returns.
- With --trace 1: PROFILE_REPLAYS replays of the same graph under the
  profiler (`trace.profiled`), then one eager iteration with the physics
  step, the env step, the act step and the update each inside a range
  (`trace.by_range`), both read in memory, for the per-layer metrics;
  each taken again (`whole`) while its trace lost a launch's kernels.
- Then the program is freed and the reference (`follow.run`) runs its
  STEPS iterations from the same seed, each after the first from the
  program's state at its start; `compare.numbers` against the cell's limits
  decides `correct`.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from portbench import compare, follow, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "go2_rl_gym_tpu")
PROFILE_REPLAYS = 3
# traced windows taken in all, at most, while one loses a launch's kernels
TRACE_TRIES = 3


def whole(read):
    """(`read()`, the number of calls): `read` (a traced window, with a
    `lost` count) called again while its trace lost a launch's kernels, at
    most TRACE_TRIES times in all; the last reading."""
    for tries in range(1, TRACE_TRIES + 1):
        got = read()
        if not got["lost"]:
            break
    return got, tries


def forbidden_modules() -> List[str]:
    """The top-level names of `FORBIDDEN` that sys.modules holds, compared
    whole (`go2_rl_gym_tpu_torch` is not `go2_rl_gym_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Clock:
    """Marks in the device's stream (CUDA events) on the card; the host
    clock on the CPU, where every op has finished when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Timed:
    """The callable that `learn` replays, with a mark before and after each
    call and `after(k, out)` called after call k, if set."""

    def __init__(self, run, clock: Clock):
        self.run = run
        self.clock = clock
        self.marks = []
        self.after = None
        self.calls = 0

    @property
    def state(self):
        return self.run.state

    def __call__(self):
        before = self.clock.mark()
        out = self.run()
        self.marks.append((before, self.clock.mark()))
        if self.after is not None:
            self.after(self.calls, out)
        self.calls += 1
        return out


def p90(values: List[float]) -> float:
    """The 90th percentile by nearest rank: the smallest value with at
    least 90% of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def card(device: torch.device):
    """(name, power limit) of the card as nvidia-smi prints them."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    smi_id = visible.split(",")[index] if visible else str(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", smi_id, "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return torch.cuda.get_device_name(device), f"unread ({e})"
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _losses(runner, vec) -> Dict[str, float]:
    """An iteration's metric vector as {name: value} for its scalars."""
    out, off = {}, 0
    host = vec.detach().cpu().tolist()
    for k, n in zip(runner.metric_keys, runner.metric_sizes):
        if n == 1:
            out[k] = host[off]
        off += n
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0: Optional[float] = None,
             fault: Optional[str] = None) -> Dict:
    """One run (see the module docstring). `t0` is the process's start on
    the perf_counter clock; `fault` plants one of `faults.PLANT` in the
    program (the tests' broken runs). Returns the result object."""
    t0 = time.perf_counter() if t0 is None else t0
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
    from go2_rl_gym_tpu_torch.utils import registry

    from portbench import faults

    dev = torch.device(device)
    clock = Clock(dev)
    phases = {"import": time.perf_counter() - t0}

    def phase(name):
        phases[name] = time.perf_counter() - t0 - sum(phases.values())

    class Runner(OnPolicyRunner):
        timed: Optional[Timed] = None

        def compiled_step(self, rs):
            run = super().compiled_step(rs)
            if self.timed is None or self.timed.run is not run:
                self.timed = Timed(run, clock)
            return self.timed

    env_cfg, train_cfg = spec.build_cfgs(registry, cell)
    T = train_cfg.runner.num_steps_per_env
    N = env_cfg.env.num_envs
    env = Go2Env(env_cfg, num_steps_per_env=T, terrain_seed=seed, device=dev)
    phase("terrain_env")
    log_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        runner = Runner(env, train_cfg, log_dir=log_dir, device=dev)
        if fault is not None:
            faults.PLANT[fault](runner.alg, env)
        rs = runner.init_runner_state(
            seed, init_at_random_ep_len=bool(cell.traffic["random_start"]))
        phase("init_state")

        # ---- set-up: the first STEPS iterations, read for the comparison
        prog, starts = [], []
        before = [compare.params(runner.alg)]

        def read_first(k, out):
            prog.append(compare.iteration(runner.alg, _losses(runner, out),
                                          before[0], step.state.obs))
            if k < compare.STEPS - 1:
                starts.append(compare.snapshot(step.state, runner.alg))
                before[0] = compare.params(runner.alg)

        step = runner.compiled_step(rs)
        step.after = read_first
        rs = runner.learn(rs, compare.STEPS)
        _sync(dev)
        phase("first_iterations")
        del before
        # the pace of the last replay: the first after a capture also
        # uploads the graph
        a, b = step.marks[-1]
        pace = clock.ms(a, b)
        n = max(2, math.ceil(seconds * 1e3 / pace))

        # ---- the window
        rows = torch.empty((n, sum(runner.metric_sizes)), device=dev)
        base = step.calls
        step.after = lambda k, out: rows[k - base].copy_(out)
        step.marks.clear()
        _sync(dev)
        start = clock.mark()
        t_start = time.perf_counter()
        setup_s = t_start - t0
        rs = runner.learn(rs, n)
        _sync(dev)
        wall_s = time.perf_counter() - t_start
        step.after = None
        intervals, busy = [], []
        prev = start
        for a, b in step.marks:
            intervals.append(clock.ms(prev, b))
            busy.append(clock.ms(a, b))
            prev = b
        failed = int((~torch.isfinite(rows).all(dim=1)).sum())

        # ---- the traced window: replays of the same graph, no learn loop
        profile = patch_bytes = attribution = None
        if traced:
            from portbench import counts
            t = env.terrain
            if t.channels is not None and not t.is_flat:
                origins = counts.origins_of(
                    step.state.env_state.sim.base_pos, t.border_offset,
                    t.horizontal_scale, t.channels.shape)
                patch_bytes = counts.patch_bytes(t.channels.shape, origins)
            step.marks.clear()
            profile, tries = whole(
                lambda: trace.profiled(step, PROFILE_REPLAYS, dev))
            # one eager iteration by phase: the kernels the graph captured
            from go2_rl_gym_tpu_torch.utils import graphs
            state = graphs.copy_tree(step.state)
            with trace.ranges([(env, "physics_step", "sim"),
                               (env, "step", "env"),
                               (runner.alg, "act", "act"),
                               (runner.alg, "update", "update")]):
                attribution, tries_eager = whole(lambda: trace.by_range(
                    lambda: runner.train_step(state), dev))
            del state
        if dev.type == "cuda":
            # what the process held at its fullest: the caching allocator's
            # reserve, the graph's private pool in it
            peak = torch.cuda.max_memory_reserved(dev)
            name, power_limit = card(dev)
        else:
            peak, name, power_limit = 0, "cpu", None
        window = SimpleNamespace(wall_s=wall_s, iters=n,
                                 intervals_ms=intervals, device_ms=busy,
                                 num_envs=N)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    # ---- free the program, then the reference follows from the seed
    del runner, env, rs, step, rows
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref, _ = follow.run(cell, seed, dev, starts=starts)
    phases["reference_after_window"] = time.perf_counter() - t_ref
    print("phases_s " + json.dumps(phases), file=sys.stderr, flush=True)
    if traced:
        print("trace_s " + json.dumps(dict({k: profile[k] for k in (
            "host_s", "window_s", "busy_s", "replay_s", "replay_idle_s",
            "between_s", "lost")}, tries=tries, lost_eager=attribution["lost"],
            tries_eager=tries_eager)), file=sys.stderr, flush=True)
    ordered = sorted(intervals)
    print("window_ms " + json.dumps({
        "pace": pace, "iters": n, "wall": wall_s * 1e3,
        "min": ordered[0], "median": ordered[len(ordered) // 2],
        "p90": p90(intervals), "max": ordered[-1],
        "over_1.05_median": sum(v > 1.05 * ordered[len(ordered) // 2]
                                for v in intervals),
        "first": intervals[:3], "last": intervals[-3:],
        "replay_ms": [round(x, 1) for x in busy[:12]]}),
        file=sys.stderr, flush=True)
    values = compare.numbers(prog, ref, cell.limits["losses"])
    checks = compare.check(values, cell.limits["numbers"])

    e2e = {
        "env_steps_per_s": T * N * n / wall_s,
        "iter_ms_p90": p90(intervals),
        "setup_s": setup_s,
    }
    ctx = SimpleNamespace(cell=cell, window=window, profile=profile,
                          attribution=attribution,
                          patch_bytes=patch_bytes, device_name=name,
                          power_limit=power_limit)
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(cell, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": name, "count": cell.workload["chips"],
                   "memory_peak_bytes": int(peak)}
    result = {"correct": all(ok for *_, ok in checks) and failed == 0,
              "attempted": n, "failed": failed, "metrics": metrics,
              "device": device_info, "power_limit": power_limit}
    if traced:
        device_info["busy_s"] = profile["busy_s"]
        device_info["window_s"] = profile["window_s"]
        top = sorted(profile["by_name"].items(), key=lambda kv: -kv[1]["ns"])
        result["breakdown"] = {
            "device_ops": [[k, v["ns"] / 1e9] for k, v in top[:10]],
            "idle_gaps": profile["gaps"][:10]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in checks}
    result["checks"]["failed_iterations"] = {"value": failed, "limit": 0}
    return result


def check_program(root: str):
    """Import the program and raise unless it is the copy inside the
    checkout at `root`: a checkout without it does not measure another."""
    import go2_rl_gym_tpu_torch
    where = os.path.realpath(os.path.dirname(go2_rl_gym_tpu_torch.__file__))
    if os.path.dirname(where) != os.path.realpath(root):
        raise RuntimeError(f"go2_rl_gym_tpu_torch was imported from {where}"
                           f", not from the checkout at {root}")


def main(argv=None, t0: Optional[float] = None, root: Optional[str] = None
         ) -> int:
    """The command: one run of one cell on the card. Prints the comparison
    as the last lines of standard error and the result object as the last
    line of standard output; returns the exit code."""
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = root or os.path.dirname(spec.BENCH_DIR)
    cell = spec.load_cell(root, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this "
              f"machine has {have}", file=sys.stderr)
        return 2
    check_program(root)
    result = run_cell(cell, args.seed % 2 ** 63, args.seconds,
                      bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
