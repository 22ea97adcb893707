"""Training entry point (PyTorch port of scripts/train.py).

Counterpart of reference legged_gym/scripts/train.py + the CLI flag schema
of legged_gym/utils/helpers.py:128-157. Builds the task's env and runner on
`--device` (the card by default), starts every env at a random episode
length, optionally resumes the latest (or a named) checkpoint of the
experiment, and runs `learn` (on the card: one CUDA graph of the train
iteration, replayed in chunks, one graph per rank under torch.distributed.run
with NCCL; `learn` prints which as `learn: graph (...)` or `learn: eager
(...)`; `--debug_nans` runs it eagerly and raises at the first non-finite
value). Every registered task trains (PPO `go2`,
recurrent PPO `go2_lstm`, the six CTS tasks, the three ablation variants;
`utils.registry.task_names()`). With `--eval_interval N`, rank 0 exports
the policy every N iterations and scores it in MuJoCo in the background
(CTS tasks; `train/eval_hook.py`), logging `Eval/*`.

Data-parallel over W ranks, one process per card (NCCL; gloo with
`--device cpu`), each stepping num_envs / W of the envs (scripts/train.py:
43-47, 85-91 of the JAX package): launch the same command under
torch.distributed.run. Rank r runs on cuda:<LOCAL_RANK>; only rank 0 logs,
prints and writes checkpoints. The script refuses, rather than runs on fewer
ranks or on the CPU, when W does not divide num_envs, `--num_devices`
differs from W, or a rank has no card.

Usage:
    python -m go2_rl_gym_tpu_torch.scripts.train --task go2_moe_cts \
        --num_envs 4096 --max_iterations 150000 [--resume] [--device cuda]
    python -m torch.distributed.run --nproc_per_node 4 \
        -m go2_rl_gym_tpu_torch.scripts.train --task go2_moe_cts \
        --num_envs 4096 [--num_devices 4]
"""
from __future__ import annotations

import argparse
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="go2", help="task name")
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
    p.add_argument("--debug_nans", action="store_true",
                   help="run learn eagerly under autograd anomaly detection "
                        "and raise at the first iteration with a non-finite "
                        "metric, state or parameter (slow; for debugging)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of iterations 10-12")
    p.add_argument("--eval_interval", type=int, default=0,
                   help="run async MuJoCo sim2sim eval every N iterations")
    p.add_argument("--multihost", action="store_true",
                   help="initialise torch.distributed from the launcher's "
                        "environment (implied under torch.distributed.run)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="shard the envs over this many ranks; must equal "
                        "the launcher's world size")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from go2_rl_gym_tpu_torch.utils import registry
    from go2_rl_gym_tpu_torch.utils.helpers import (get_load_path,
                                                    update_cfg_from_args)

    env_cfg, train_cfg = registry.get_cfgs(args.task)
    update_cfg_from_args(env_cfg, train_cfg, args)
    device, mesh = args.device, None
    if args.multihost or args.num_devices or "WORLD_SIZE" in os.environ:
        # before any CUDA work: make_env uploads the terrain
        from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
        world = int(os.environ.get("WORLD_SIZE", 0))
        if args.num_devices and args.num_devices != world:
            raise RuntimeError(
                f"--num_devices {args.num_devices}, but the launcher started "
                f"{world or 'no'} ranks: launch with python -m "
                f"torch.distributed.run --nproc_per_node {args.num_devices}")
        device = mesh_lib.initialize_multihost(device=args.device)
        mesh = mesh_lib.make_mesh(env_cfg.env.num_envs, device)
        print(f"data-parallel over {mesh.world} ranks: rank {mesh.rank} on "
              f"{device}, envs [{mesh.env_slice.start}, "
              f"{mesh.env_slice.stop}) of {mesh.num_envs}", flush=True)
    env = registry.make_env(
        args.task, env_cfg,
        num_steps_per_env=train_cfg.runner.num_steps_per_env,
        device=device, mesh=mesh)
    runner = registry.make_runner(args.task, env, train_cfg,
                                  log_root=args.log_root,
                                  run_name=args.run_name, device=device,
                                  eval_interval=args.eval_interval)
    runner.debug_nans = args.debug_nans
    rs = runner.init_runner_state(train_cfg.seed, init_at_random_ep_len=True)
    if args.resume:
        path = get_load_path(os.path.join(args.log_root,
                                          train_cfg.runner.experiment_name),
                             args.load_run, args.checkpoint)
        if runner.is_main:
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
    from go2_rl_gym_tpu_torch.distributed.mesh import shutdown
    try:
        main()
    finally:
        shutdown()
