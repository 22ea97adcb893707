"""Training entry point (PyTorch port of scripts/train.py).

Counterpart of reference legged_gym/scripts/train.py + the CLI flag schema
of legged_gym/utils/helpers.py:128-157. Builds the task's env and runner on
`--device` (the card by default), starts every env at a random episode
length, optionally resumes the latest (or a named) checkpoint of the
experiment, and runs `learn`. Every registered task trains (PPO `go2`,
recurrent PPO `go2_lstm`, the six CTS tasks, the three ablation variants;
`utils.registry.task_names()`).

Usage:
    python -m go2_rl_gym_tpu_torch.scripts.train --task go2_moe_cts \
        --num_envs 4096 --max_iterations 150000 [--resume] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="go2_moe_cts", help="task name")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--run_name", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load_run", default=-1)
    p.add_argument("--checkpoint", type=int, default=-1)
    p.add_argument("--log_root", default=os.path.join(ROOT, "logs"))
    p.add_argument("--terrain", default=None,
                   choices=[None, "plane", "heightfield"],
                   help="override terrain mesh type")
    p.add_argument("--device", default="cuda",
                   help="torch device of the env, the policy and the update")
    p.add_argument("--headless", action="store_true", help="accepted for CLI "
                   "parity with the reference; rendering is always off")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of iterations 10-12")
    p.add_argument("--eval_interval", type=int, default=0,
                   help="async sim2sim eval every N iterations (not ported)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.eval_interval:
        raise NotImplementedError(
            "--eval_interval: the sim2sim eval hook is not ported to "
            "go2_rl_gym_tpu_torch yet")
    from go2_rl_gym_tpu_torch.utils import registry
    from go2_rl_gym_tpu_torch.utils.helpers import (get_load_path,
                                                    update_cfg_from_args)

    env_cfg, train_cfg = registry.get_cfgs(args.task)
    update_cfg_from_args(env_cfg, train_cfg, args)
    env = registry.make_env(
        args.task, env_cfg,
        num_steps_per_env=train_cfg.runner.num_steps_per_env,
        device=args.device)
    runner = registry.make_runner(args.task, env, train_cfg,
                                  log_root=args.log_root,
                                  run_name=args.run_name, device=args.device)
    rs = runner.init_runner_state(train_cfg.seed, init_at_random_ep_len=True)
    if args.resume:
        path = get_load_path(os.path.join(args.log_root,
                                          train_cfg.runner.experiment_name),
                             args.load_run, args.checkpoint)
        print(f"resuming from {path}")
        rs = runner.load(rs, path)

    iters = train_cfg.runner.max_iterations
    if args.profile_dir:
        rs = runner.learn(rs, 10)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            rs = runner.learn(rs, 3)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        iters -= 13
    return runner, runner.learn(rs, iters)


if __name__ == "__main__":
    main()
