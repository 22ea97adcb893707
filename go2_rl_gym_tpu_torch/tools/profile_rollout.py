"""Where the time of one rollout step goes, on the card.

Builds a task's env and runner through the registry (`--task`, the flagship
go2_moe_cts on the full rough terrain by default; `go2` and `go2_lstm` run
on the same terrain) at 4096 envs, warms up, then:

1. times one policy step's parts with CUDA events, each alone and back to
   back: the algorithm's act, the physics step (env.physics_step: patch
   extraction + 4 substeps), and the whole env.step;
2. times `--steps` rollout steps on the host clock without the profiler
   (`rollout_step_ms`);
3. profiles `--steps` more rollout steps with torch.profiler: device busy
   time against wall time in that window (`device_idle_share_profiled`;
   the profiler's host overhead stretches the wall time), kernel launches
   per step, and the kernels that take the most device time.

`device_idle_share_est` is an estimate across two windows: the busy time
per step of window 3 over the unprofiled step time of window 2. No single
window measures the idle share of an unprofiled step.

With `--train`, it splits whole train iterations instead (after one
untimed iteration):

1. one iteration's rollout / GAE / update by CUDA events recorded between
   the phases (`*_event_ms`), and the host clock around the iteration;
2. one iteration under torch.profiler: its kernel launches and device busy
   time over its wall time;
3. one more iteration with the profiler on for the update only: the
   update's launches and its device busy share (busy time over the
   update's wall time).

Prints one JSON object as its last line.

Usage:
    python -m go2_rl_gym_tpu_torch.tools.profile_rollout [--task go2_moe_cts]
        [--num_envs 4096] [--steps 3] [--train]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.utils import registry


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
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_train(runner, rs, top, task):
    """See the module docstring, `--train`."""
    N, T = runner.env.num_envs, runner.num_steps
    rs, _ = runner.train_step(rs)        # untimed: first-call costs
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    # 1. CUDA events between the phases, host clock around the iteration
    events = []

    def record(_):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record("start")
    rs, _ = runner.train_step(rs, mark=record)
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3
    parts = {f"{name}_event_ms": events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("rollout", "gae", "update"))}

    # 2. the whole iteration under the profiler
    tp.LAUNCHES["extract_patches"] = 0
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs, _ = runner.train_step(rs)
        torch.cuda.synchronize()
        wall = {"iteration": (time.perf_counter() - t0) * 1e3}
    patch_launches = tp.LAUNCHES["extract_patches"]

    # 3. the update alone under the profiler, in one more iteration (the
    # profiler starts and stops at the phase marks)
    prof_up = torch.profiler.profile(activities=acts)
    clock = {}

    def mark(name):
        torch.cuda.synchronize()
        clock[name] = time.perf_counter()
        if name == "gae":
            prof_up.start()
        elif name == "update":
            prof_up.stop()
    runner.train_step(rs, mark=mark)
    wall["update"] = (clock["update"] - clock["gae"]) * 1e3

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
        patch_kernel_launches_per_iteration=patch_launches,
        top_update_kernels=[dict(name=e.key[:90], calls=e.count,
                                 device_ms=_device_us(e) / 1e3)
                            for e in top_up])
    for k in result["top_update_kernels"]:
        print(f"{k['device_ms']:9.3f} ms  {k['calls']:6d}  {k['name']}")
    print(json.dumps(result))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="go2_moe_cts",
                   choices=registry.task_names())
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--train", action="store_true",
                   help="split whole train iterations instead of steps")
    args = p.parse_args()

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
        tp.LAUNCHES["extract_patches"] = 0
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
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
        patch_kernel_launches=dict(tp.LAUNCHES),
        top_kernels=[dict(name=e.key[:90], calls=e.count,
                          device_ms=_device_us(e) / 1e3) for e in top])
    for k in result["top_kernels"]:
        print(f"{k['device_ms']:9.3f} ms  {k['calls']:6d}  {k['name']}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
