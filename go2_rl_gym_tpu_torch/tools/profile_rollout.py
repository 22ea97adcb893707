"""Where the port's time goes on the card: by layer, by op and by stage.

Four modes. The first two split a rollout step or a train iteration of a
task into its layers; `--ops` and `--decompose` are the port's twins of
the JAX package's `tools/profile_physics.py` and `tools/bench_decompose.py`.

The default builds a task's env and runner through the registry (`--task`,
the flagship go2_moe_cts on the full rough terrain by default; `go2` and
`go2_lstm` run on the same terrain), warms up, then:

1. times one policy step's parts with CUDA events, each alone and back to
   back: the algorithm's act, the physics step (env.physics_step: patch
   extraction + 4 substeps), and the whole env.step;
2. times `--steps` rollout steps on the host clock without the profiler
   (`rollout_step_ms`);
3. profiles `--steps` more rollout steps with torch.profiler (`window`,
   after one more rollout as the lead-in): device busy time against wall
   time in that window (`device_idle_share_profiled`; the profiler's host
   overhead stretches the wall time), kernel launches per step, the
   launches whose kernel the trace lacks (`lost_launches`: nonzero means
   the launch and busy figures are short), and the kernels that take the
   most device time.

`device_idle_share_est` is an estimate across two windows: the busy time
per step of window 3 over the unprofiled step time of window 2. No single
window measures the idle share of an unprofiled step.

With `--train`, it splits whole train iterations instead (after one
untimed iteration):

1. one iteration's rollout / GAE / update by CUDA events recorded between
   the phases (`*_event_ms`, at the ends of the spans `rollout`, `gae` and
   `update` that a span listener sees, utils/spans.py), and the host clock
   around the iteration;
2. one iteration under torch.profiler: its kernel launches and device busy
   time over its wall time;
3. one more iteration with the profiler on for the update only: the
   update's launches and its device busy share (busy time over the
   update's wall time).

The window of 2 opens after one more iteration as its lead-in (`window`),
that of 3 at the end of the `gae` span after a small kernel as its lead-in
(`open_window`, `lead_in_on`); the wall clocks start after the pad.
`lost_launches` counts, for each, the launches whose kernel the trace
lacks (nonzero: its launch and busy figures are short).

`--ops` and `--decompose` build what the JAX tools build (`build`): Go2Cfg()
at `--num_envs` envs (default: the BENCH_NUM_ENVS variable, else 4096),
go2_moe_cts_train_cfg(), Go2Env with the runner's steps per env, the state
of init_state(0), and per mode:

- `physics`: env.physics_step from that state with zero targets (4, N,
  12), kp 20, kd 0.5, motor strength 1 and offset 0;
- `env`: env.step from that state with zero actions;
- `rollout` / `train`: OnPolicyRunner(env, tc, log_dir=None) from
  init_runner_state(0, init_at_random_ep_len=True), then runner.rollout /
  runner.train_step;
- `substep` (the port's own): one substep of the N-major reference engine
  (sim/engine.py make_batched_substep) on the global heightfield from that
  state, zero torque, implicit damping 0.5, beside tengine's `physics`.

With `--ops MODE` (twin of tools/profile_physics.py), one warm-up call,
then `--iters` calls (3; 1 for train) under torch.profiler, whose window
opens after the warm-up call has run with its device tracing on, the
traced calls starting WINDOW_PAD_S later (`window`: a trace can lack the
kernels launched in the first milliseconds of its window; a table whose
trace lacks the kernel of a launch raises). Every op that
launched device work gets its self device time: each kernel counts once,
at the op around its launch call, so nothing nested is counted twice
(aten::einsum -> aten::bmm -> kernel counts at aten::bmm). Each op is
attributed to the innermost frame in a file of this package that called into torch, e.g.
`sim/tengine.py:412`: `SourceLines` names a profiler range after that
line around every torch call. torch.profiler's `with_stack` does not serve
here: its frames name a Python function by the line of its def, not of
the call, and their order differs between torch versions. Ops of a
backward pass take the line of the forward op that recorded them. The
patch kernel, launched through ctypes and not by an op of torch, counts
at its own range (`extract_patches`). Prints the JAX tool's header and rows (ms per call,
percent, op, source), then one JSON line: the rows, the total, the share
of it with a source line, the sum of the profiler's kernel times, the
kernel launches per call, the patch kernel's launches, the seconds of the
traced calls (`trace_s`: from the first traced call to the synchronize
after the last, without the profiler's start, pad and flush) and of the
reduction (`reduce_s`). With `--device cpu` there is no device activity:
the table then ranks self CPU time, and the JSON says so
(`"time": "host"`).

With `--decompose [physics env rollout train]` (twin of
tools/bench_decompose.py; default `env physics`), each stage runs once
untimed, then `--iters` calls (10; 5 for rollout and train) on the host
clock, closed by torch.cuda.synchronize() on the card: ms per call and
env-steps/s (T * N for rollout and train). The JAX tool builds a rollout
but times nothing under that name; here the rollout is a line of its own,
as it takes most of the train iteration.

Every mode prints one JSON object as its last line. `--device` defaults to
the card and raises without one (`--ops` and `--decompose` run on the CPU
with `--device cpu`).

Usage:
    python -m go2_rl_gym_tpu_torch.tools.profile_rollout [--task go2_moe_cts]
        [--num_envs 4096] [--steps 3] [--train]
    python -m go2_rl_gym_tpu_torch.tools.profile_rollout
        --ops {physics,env,train,substep} [--iters 3] [--top 40]
        [--num_envs 4096] [--device cuda]
    python -m go2_rl_gym_tpu_torch.tools.profile_rollout
        --decompose [physics env rollout train] [--iters 10]
        [--num_envs 4096] [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.overrides import TorchFunctionMode

from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.env.config import Go2Cfg, go2_moe_cts_train_cfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.sim import engine
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
from go2_rl_gym_tpu_torch.utils import registry, spans

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("physics", "env", "rollout", "train", "substep")
OPS_MODES = ("physics", "env", "train", "substep")
STAGES = ("physics", "env", "rollout", "train")
# the JAX tools' lines, in their order
STAGE_LINES = {"physics": "physics 4-substep:  ", "env": "full env.step:      ",
               "rollout": "rollout:            ",
               "train": "full train step:    "}


def _event_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernels(prof):
    """The kernels of a trace, averaged by name (the device-side copies of
    profiler ranges, such as the patch kernel's, are not kernels)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, iters, device=torch.device("cuda")):
    """Host ms per call of fn() over `iters` calls after one untimed call,
    closed by a synchronize on the card (tools/bench_decompose.py
    `timeit`)."""
    fn()
    _sync(device)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t) * 1e3 / iters


# host seconds between the opening of a trace window and its first call
WINDOW_PAD_S = 0.1


@contextlib.contextmanager
def window(acts, lead_in: Callable[[], None]):
    """torch.profiler over the body of the `with`, its trace window opened
    only after `lead_in()` has run with the profiler's device tracing
    already on (the profiler's own warm-up, `prepare_trace`; what the
    lead-in launches lies before the window and is dropped), and the body
    started WINDOW_PAD_S after the opening.

    A trace can hold the launch calls of the kernels launched in the first
    milliseconds of its window but not the kernels: on an H100, after
    profiled replays of a CUDA graph of the train iteration in the same
    process, a window opened with the tracing, as torch.profiler.profile
    opens it, lacked the first kernels of a traced physics step, the patch
    kernel among them, and one opened after a lead-in but with no pad
    still did at times (tools/trace_window.py compares this window with
    one opened at once). Check a trace with
    `launches_without_kernel`. Yields the profiler; its events are read
    after the `with`."""
    prof = torch.profiler.profile(activities=acts)
    open_window(prof, lead_in)
    try:
        yield prof
    finally:
        prof.stop_trace()


def open_window(prof, lead_in: Callable[[], None]):
    """Open the trace window of `prof`, a torch.profiler.profile not yet
    started, as `window` does: the device tracing on (`prepare_trace`),
    `lead_in()`, the window opened, WINDOW_PAD_S of sleep. A window that
    starts inside a call, at a phase mark, opens here with `lead_in_on`;
    it ends with `prof.stop_trace()`. Wall clocks start after it
    returns."""
    prof.prepare_trace()
    lead_in()
    prof.start_trace()
    time.sleep(WINDOW_PAD_S)


def lead_in_on(device) -> Callable[[], None]:
    """The lead-in of a window that opens inside a call (at a phase mark),
    where the call itself cannot run again: one small kernel on `device`,
    then a synchronize."""
    def lead_in():
        torch.ones(1, device=device).add_(1)
        _sync(device)
    return lead_in


def launches_without_kernel(events):
    """The kernel launch calls of a trace (cudaLaunchKernel and kin, made
    inside its window) whose kernel the trace lacks: no device event
    carries their correlation id."""
    cpu = torch.autograd.DeviceType.CPU
    ids = {e.id for e in events
           if e.device_type != cpu and not e.is_user_annotation}
    return [e for e in events if e.device_type == cpu
            and e.name.startswith("cu") and "Launch" in e.name
            and "Kernel" in e.name and e.time_range.start >= 0
            and e.id not in ids]


def profiled(fn, reps=5):
    """(host ms per call, kernel launches per call, device-busy ms per call)
    on the card: the host clock over `reps` calls ended by a synchronize,
    after one warm-up call; then one call under torch.profiler (`window`,
    one more call as its lead-in)."""
    ms = host_ms(fn, reps)

    def lead_in():
        fn()
        torch.cuda.synchronize()
    with window([torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA], lead_in) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _kernels(prof)
    return (ms, sum(e.count for e in kernels),
            sum(_device_us(e) for e in kernels) / 1e3)


def default_num_envs():
    return int(os.environ.get("BENCH_NUM_ENVS", 4096))


class Setup(NamedTuple):
    """What `build` made: `fn(*args)` is one call of the mode."""
    mode: str
    fn: Callable
    args: tuple
    env: Go2Env
    tc: object                  # the TrainCfg
    state: object               # the EnvState of init_state(0)
    runner: Optional[OnPolicyRunner] = None
    rs: object = None           # the RunnerState the runner starts from


def build(mode, num_envs=None, device="cuda", cfg=None,
          like: Optional[Setup] = None) -> Setup:
    """The setup of the JAX tools' `mode` (see the module docstring).

    `cfg` replaces Go2Cfg() (the tests pass a smaller terrain); `num_envs`
    (default: BENCH_NUM_ENVS, else 4096) sets its env count. `like`, a
    Setup built before, lends its env, state and runner, so that several
    modes share one terrain."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if like is None:
        if cfg is None:
            cfg = Go2Cfg()
            cfg.env.num_envs = num_envs or default_num_envs()
        elif num_envs:
            cfg.env.num_envs = num_envs
        tc = go2_moe_cts_train_cfg()
        env = Go2Env(cfg, num_steps_per_env=tc.runner.num_steps_per_env,
                     device=device)
        like = Setup(mode, None, (), env, tc, env.init_state(0))
    env, state = like.env, like.state
    N, dev = env.num_envs, env.device
    zeros = torch.zeros((N, 12), device=dev)
    if mode == "physics":
        targets = torch.zeros((env.cfg.control.decimation, N, 12), device=dev)
        kp = torch.full((N, 12), 20.0, device=dev)
        kd = torch.full((N, 12), 0.5, device=dev)
        ones = torch.ones((N, 12), device=dev)
        fn = torch.no_grad()(lambda d, s: env.physics_step(
            d, s, targets, kp, kd, ones, zeros))
        return like._replace(mode=mode, fn=fn, args=(state.dyn, state.sim))
    if mode == "env":
        return like._replace(mode=mode, fn=torch.no_grad()(env.step),
                             args=(state, zeros))
    if mode == "substep":
        step = engine.make_batched_substep(
            env.model, env.sim_params, env.terrain._replace(channels=None),
            device=dev)
        kd = torch.full((N, 12), 0.5, device=dev)
        fn = torch.no_grad()(lambda d, s: step(d, s, zeros, kd))
        return like._replace(mode=mode, fn=fn, args=(state.dyn, state.sim))
    runner, rs = like.runner, like.rs
    if runner is None:
        runner = OnPolicyRunner(env, like.tc, log_dir=None, device=dev)
        rs = runner.init_runner_state(0, init_at_random_ep_len=True)
    fn = runner.rollout if mode == "rollout" else runner.train_step
    return like._replace(mode=mode, fn=fn, args=(rs,), runner=runner, rs=rs)


def _package_path(filename):
    """`filename` relative to this package, or None for a file outside it
    and for this tool."""
    path = os.path.abspath(filename)
    if path == os.path.abspath(__file__) or not path.startswith(
            PACKAGE_DIR + os.sep):
        return None
    return os.path.relpath(path, PACKAGE_DIR)


class SourceLines(TorchFunctionMode):
    """Runs every torch call made from Python inside a profiler range named
    after the innermost frame in a file of this package, as
    "sim/tengine.py:412" (the calls that torch makes inside one are not
    seen again). A function of this package that dispatches itself as a
    torch function (ops/terrain_patches.py `extract_patches`) is named after
    its caller. `names` holds every name given."""

    def __init__(self):
        super().__init__()
        self.names = set()
        self._paths = {}

    def _where(self, func):
        f = sys._getframe(2)
        code = getattr(func, "__code__", None)
        while f is not None:
            name = f.f_code.co_filename
            if f.f_code is code:        # a function of this package that
                f = f.f_back            # dispatched itself as a torch one
                continue
            if name not in self._paths:
                self._paths[name] = _package_path(name)
            if self._paths[name]:
                return f"{self._paths[name]}:{f.f_lineno}"
            f = f.f_back
        return None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # attribute reads (tensor.shape) launch nothing
        where = (None if getattr(func, "__name__", "") == "__get__"
                 else self._where(func))
        if where is None:
            return func(*args, **kwargs)
        self.names.add(where)
        with torch.profiler.record_function(where):
            return func(*args, **kwargs)


_BACKWARD = 1       # RecordScope.BACKWARD_FUNCTION


def _attribute(events, names):
    """id(event) -> its source: the nearest enclosing range of `names`; for
    an op of a backward pass, the source of the forward op that recorded
    the backward function, with " (backward)"; "" where there is none."""
    near = {}

    def nearest(e):
        chain = []
        while e is not None and id(e) not in near:
            chain.append(e)
            if e.name in names or e.scope == _BACKWARD:
                near[id(e)] = e
                break
            e = e.cpu_parent
        found = near.get(id(e)) if e is not None else None
        for c in chain:
            near[id(c)] = found
        return found

    fwd = {}
    for e in events:
        n = nearest(e)
        if n is not None and n.name in names and e.sequence_nr >= 0:
            fwd.setdefault((e.sequence_nr, e.thread), n.name)
    src = {}
    for e in events:
        n = nearest(e)
        if n is None:
            src[id(e)] = ""
        elif n.name in names:
            src[id(e)] = n.name
        else:
            key = (n.sequence_nr, n.fwd_thread)
            src[id(e)] = fwd[key] + " (backward)" if key in fwd else ""
    return src


def op_rows(events, names, device_time):
    """Rows of self time by (op, source): {(op, source): [us, ops,
    launches]}, and the profiler's kernel time and count.

    Device time: every kernel (or copy) of the trace at the op that
    launched it, the CPU event around its launch call in the CUDA runtime
    (the launch and the kernel share a correlation id), so a kernel counts
    once, at the innermost op. torch's own kernel lists of an op miss a
    kernel launched through ctypes (the patch kernel): its launch lands on
    its profiler range. A launch outside any op is the row "(no op)"; a
    kernel without a launch event stays out of the rows. The profiler's
    device-side copies of its ranges are not kernels. Host time (no device
    activity): each op's self CPU time. The ranges of `names` are the
    attribution's, not ops."""
    cpu = torch.autograd.DeviceType.CPU
    src = _attribute(events, names)
    kernels = {}
    for e in events:
        if e.device_type != cpu and not e.is_user_annotation:
            kernels.setdefault(e.id, []).append(e)
    rows = {}

    def add(name, where, op, us, launches):
        row = rows.setdefault((name, where), [0.0, set(), 0])
        row[0] += us
        row[1].add(op)
        row[2] += launches

    for e in events:
        if e.device_type != cpu:
            continue
        if device_time:
            if e.id in kernels and e.name.startswith("cu"):
                op = e.cpu_parent
                add(op.name if op else "(no op)", src[id(op)] if op else "",
                    id(op), sum(k.time_range.elapsed_us()
                                for k in kernels[e.id]), len(kernels[e.id]))
        elif e.name not in names:
            add(e.name, src[id(e)], id(e), e.self_cpu_time_total, 0)
    device = [k for ks in kernels.values() for k in ks]
    return ({k: [us, len(ops), n] for k, (us, ops, n) in rows.items()},
            sum(k.time_range.elapsed_us() for k in device), len(device))


def ranked(rows, iters):
    """`op_rows`'s rows as the table's, heaviest first: ms, percent of the
    total, calls and launches per call of `iters` calls."""
    total = sum(r[0] for r in rows.values())
    return [dict(ms=us / iters / 1e3, pct=100 * us / total if total else 0.0,
                 name=name, source=where, calls=n / iters,
                 launches=k / iters)
            for (name, where), (us, n, k) in sorted(
                rows.items(), key=lambda kv: -kv[1][0])]


def op_table(setup: Setup, iters=None, top=40):
    """The op table of `setup`'s mode (see the module docstring): one
    warm-up call as the lead-in of the profiler's `window`, then `iters`
    calls (3; 1 for train) under torch.profiler and `SourceLines`. Raises
    if the trace lacks the kernel of a launch it holds (see `window`),
    rather than return a table that has lost it. Returns the JSON object,
    with every row; its `trace_s` covers the traced calls only, not the
    profiler's start, pad and flush."""
    dev = setup.env.device
    on_card = dev.type == "cuda"
    iters = iters or (1 if setup.mode == "train" else 3)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def warm_up():
        setup.fn(*setup.args)
        _sync(dev)
    lines = SourceLines()
    with window(acts, warm_up) as prof:
        patch0 = tp.LAUNCHES["extract_patches"]
        t0 = time.perf_counter()
        with lines:
            for _ in range(iters):
                setup.fn(*setup.args)
        _sync(dev)
        trace_s = time.perf_counter() - t0
        patch = tp.LAUNCHES["extract_patches"] - patch0
    t0 = time.perf_counter()
    events = prof.events()
    lost = launches_without_kernel(events)
    if lost:
        first = [(e.name, e.time_range.start) for e in lost[:3]]
        raise RuntimeError(f"op_table {setup.mode}: the trace lacks the "
                           f"kernels of {len(lost)} launches, the first "
                           f"{first} (us into the window)")
    rows, kernel_us, kernel_n = op_rows(events, lines.names, on_card)
    reduce_s = time.perf_counter() - t0
    total = sum(r[0] for r in rows.values())
    with_src = sum(r[0] for (_, where), r in rows.items() if where)
    out = ranked(rows, iters)
    kind = "device" if on_card else "host"
    res = dict(
        mode=setup.mode, time=kind, num_envs=setup.env.num_envs,
        iters=iters, total_ms=total / iters / 1e3,
        kernel_ms=kernel_us / iters / 1e3 if on_card else None,
        attributed_share=with_src / total if total else 0.0,
        launches_per_call=kernel_n / iters,
        patch_kernel_launches=patch, trace_s=trace_s, reduce_s=reduce_s,
        device=torch.cuda.get_device_name(dev) if on_card else "cpu",
        rows=out)
    print(f"total {kind} self time: {res['total_ms']:.2f} ms/iter "
          f"({iters} iters)")
    for r in out[:top]:
        print(f"{r['ms']:9.3f} ms  {r['pct']:5.1f}%  {r['name'][:60]:60s} "
              f"{r['source'][-60:]}")
    return res


def decompose(stages, num_envs=None, device="cuda", iters=None, like=None):
    """Host ms per call of each stage in `stages` (see the module
    docstring), printed as the JAX tool prints them. `iters` maps a stage
    to its calls (10; 5 for rollout and train). Returns the JSON object."""
    iters = {**{"physics": 10, "env": 10, "rollout": 5, "train": 5},
             **(iters or {})}
    out = {}
    for stage in STAGES:
        if stage not in stages:
            continue
        like = build(stage, num_envs, device, like=like)
        ms = host_ms(lambda: like.fn(*like.args), iters[stage],
                     like.env.device)
        N = like.env.num_envs
        T = like.tc.runner.num_steps_per_env
        steps = N * T if stage in ("rollout", "train") else N
        out[stage] = dict(ms=ms, env_steps_per_s=steps / ms * 1e3,
                          iters=iters[stage])
        print(f"{STAGE_LINES[stage]}{ms:8.2f} ms  "
              f"({steps / ms * 1e3:,.0f} env-steps/s)"
              + (f"  [T={T}]" if steps != N else ""))
    dev = like.env.device
    return dict(decompose=out, num_envs=like.env.num_envs,
                device=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"))


def profile_train(runner, rs, top, task):
    """See the module docstring, `--train`."""
    N, T = runner.env.num_envs, runner.num_steps
    rs, _ = runner.train_step(rs)        # untimed: first-call costs
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    # 1. CUDA events between the phases, host clock around the iteration
    events = []

    def record():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    def phase_end(name, kind):
        if kind == spans.END and name in ("rollout", "gae", "update"):
            record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record()
    with spans.recording(runner.device), spans.listen(phase_end):
        rs, _ = runner.train_step(rs)
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3
    parts = {f"{name}_event_ms": events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("rollout", "gae", "update"))}

    # 2. the whole iteration under the profiler, its window opened after
    # one more iteration as the lead-in
    def lead_in():
        nonlocal rs
        rs, _ = runner.train_step(rs)
        torch.cuda.synchronize()
    with window(acts, lead_in) as prof:
        tp.LAUNCHES["extract_patches"] = 0
        t0 = time.perf_counter()
        rs, _ = runner.train_step(rs)
        torch.cuda.synchronize()
        wall = {"iteration": (time.perf_counter() - t0) * 1e3}
        patch_launches = tp.LAUNCHES["extract_patches"]
    lost = {"iteration": len(launches_without_kernel(prof.events()))}

    # 3. the update alone under the profiler, in one more iteration: its
    # window opens at the end of the `gae` span (`open_window`) and closes
    # at the end of the `update` span
    prof_up = torch.profiler.profile(activities=acts)
    clock = {}

    def mark(name, kind):
        if kind != spans.END or name not in ("rollout", "gae", "update"):
            return
        torch.cuda.synchronize()
        if name == "gae":
            open_window(prof_up, lead_in_on(runner.device))
        clock[name] = time.perf_counter()
        if name == "update":
            prof_up.stop_trace()
    with spans.recording(runner.device), spans.listen(mark):
        runner.train_step(rs)
    wall["update"] = (clock["update"] - clock["gae"]) * 1e3
    lost["update"] = len(launches_without_kernel(prof_up.events()))

    kernels = {"iteration": _kernels(prof), "update": _kernels(prof_up)}
    busy = {k: sum(_device_us(e) for e in v) / 1e3 for k, v in kernels.items()}
    top_up = sorted(kernels["update"], key=_device_us, reverse=True)[:top]
    result = dict(
        device=torch.cuda.get_device_name(0), task=task, num_envs=N,
        steps=T,
        iteration_ms=iter_ms, env_steps_per_s=N * T / iter_ms * 1e3, **parts,
        profiled_wall_ms=wall, device_busy_ms=busy,
        device_busy_share={k: busy[k] / wall[k] for k in wall},
        kernel_launches={k: sum(e.count for e in v)
                         for k, v in kernels.items()},
        lost_launches=lost,
        patch_kernel_launches_per_iteration=patch_launches,
        top_update_kernels=[dict(name=e.key[:90], calls=e.count,
                                 device_ms=_device_us(e) / 1e3)
                            for e in top_up])
    for k in result["top_update_kernels"]:
        print(f"{k['device_ms']:9.3f} ms  {k['calls']:6d}  {k['name']}")
    print(json.dumps(result))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="go2_moe_cts",
                   choices=registry.task_names())
    p.add_argument("--num_envs", type=int, default=default_num_envs())
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=None,
                   help="rows printed (15; 40 with --ops)")
    p.add_argument("--train", action="store_true",
                   help="split whole train iterations instead of steps")
    p.add_argument("--ops", choices=OPS_MODES,
                   help="rank ops by self time, with source lines "
                        "(tools/profile_physics.py)")
    p.add_argument("--decompose", nargs="*", choices=STAGES,
                   help="time the stages (tools/bench_decompose.py; "
                        "default env physics)")
    p.add_argument("--iters", type=int, default=None,
                   help="calls per mode or stage (--ops 3, 1 for train; "
                        "--decompose 10, 5 for rollout and train)")
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for --ops and --decompose")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ops or args.decompose is not None:
        if args.ops:
            res = op_table(build(args.ops, args.num_envs, dev),
                           args.iters, args.top or 40)
            res["rows"] = res["rows"][:args.top or 40]
        else:
            stages = args.decompose or ["env", "physics"]
            res = decompose(stages, args.num_envs, dev, iters=(
                dict.fromkeys(stages, args.iters) if args.iters else None))
        print(json.dumps(res))
        return res
    if dev.type != "cuda":
        p.error("the rollout and --train modes run on the card only")
    args.top = args.top or 15

    cfg, tc = registry.get_cfgs(args.task)
    env = registry.make_env(args.task, cfg, num_envs=args.num_envs,
                            num_steps_per_env=tc.runner.num_steps_per_env)
    runner = registry.make_runner(args.task, env, tc)
    rs = runner.init_runner_state(seed=0)
    if args.train:
        return profile_train(runner, rs, args.top, args.task)
    N = env.num_envs
    state = rs.env_state

    def act():
        return runner.act(rs.obs, rs.priv_obs, rs.history, rs.memory,
                          gen=rs.gen)

    actions = act()[0]
    kp = (env.p_gains * state.kp_mult).expand(N, 12)
    kd = (env.d_gains * state.kd_mult).expand(N, 12)
    targets = (actions * cfg.control.action_scale + env.default_dof_pos)[None]
    targets = targets.expand(cfg.control.decimation, N, 12).contiguous()

    def physics():
        return env.physics_step(state.dyn, state.sim, targets, kp, kd,
                                state.motor_strength, state.motor_offset)

    def env_step():
        return env.step(state, actions)

    with torch.no_grad():
        for fn in (act, physics, env_step):     # warm-up
            fn()
        parts = {name: _event_ms(fn, 5) for name, fn in
                 (("act_ms", act), ("physics_step_ms", physics),
                  ("env_step_ms", env_step))}

        # host clock around whole rollout steps (act + env.step + history)
        runner.num_steps = args.steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs, _ = runner.rollout(rs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / args.steps * 1e3

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

        def lead_in():
            nonlocal rs
            rs, _ = runner.rollout(rs)
            torch.cuda.synchronize()
        with window(acts, lead_in) as prof:
            tp.LAUNCHES["extract_patches"] = 0
            t0 = time.perf_counter()
            rs, _ = runner.rollout(rs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = _kernels(prof)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:args.top]
    result = dict(
        device=torch.cuda.get_device_name(0), task=args.task, num_envs=N,
        profiled_steps=args.steps, rollout_step_ms=step_ms,
        env_steps_per_s=N / step_ms * 1e3, **parts,
        profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share_profiled=1.0 - busy_ms / wall_ms,
        device_idle_share_est=1.0 - busy_ms / args.steps / step_ms,
        kernel_launches_per_step=launches / args.steps,
        lost_launches=len(launches_without_kernel(prof.events())),
        patch_kernel_launches=dict(tp.LAUNCHES),
        top_kernels=[dict(name=e.key[:90], calls=e.count,
                          device_ms=_device_us(e) / 1e3) for e in top])
    for k in result["top_kernels"]:
        print(f"{k['device_ms']:9.3f} ms  {k['calls']:6d}  {k['name']}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
