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
`--device cpu`), each stepping num_envs / W of the envs, as the JAX script
shards its envs over a mesh of devices (scripts/train.py:43-47, 98-104 of
the JAX package). Who trains (`own_ranks`):

* under a launcher (torch.distributed.run, WORLD_SIZE set) or with
  `--multihost`, this process is one rank of the launcher's world, rank r
  on cuda:<LOCAL_RANK>; `--num_devices` must equal the world;
* otherwise W is `--num_devices` when given, else every visible card when
  `--device` is cuda and more than one is visible: with W > 1 the script
  becomes `python -m torch.distributed.run --standalone --nproc_per_node
  W` of itself with the same arguments (`launch`), which starts the W
  ranks, passes Ctrl-C and SIGTERM on to them and exits non-zero when one
  fails; `--num_devices 1` trains in this process on a mesh of one rank
  (the JAX script's `attach_mesh(n_devices=1)`);
* otherwise one process trains, without a mesh.

Only rank 0 logs, prints and writes checkpoints. The script refuses, rather
than runs on fewer ranks or on the CPU, when W does not divide num_envs,
`--num_devices` differs from a launcher's world, or a rank has no card.

`--profile_dir` traces iterations 10-12 with torch.profiler, as the JAX
script traces them with jax.profiler (scripts/train.py:113-118): the
window opens after a small kernel as its lead-in and a pad
(`tools/profile_rollout.py` `window`), the three iterations are one
range `learn iterations 10-12`, and each rank writes its trace (rank 0
`trace.json`, rank r `trace_rank<r>.json`) and prints its kernel launches
and the launches whose kernel the trace lacks (`lost_launches`).

`--spans` turns the span recorder on (utils/spans.py) before the first
capture: each iteration's phases are stamped on the device's own clock,
inside the CUDA graph, and `learn` logs, for each logged iteration,
`Perf/phase/<span>_ms` next to the other `Perf/*` scalars (`train_step`,
`rollout`, `act`, `env` without its physics, `physics`, `gae`, `update`,
`uncovered`: the iteration less those phases, and `learn.launch`: host ms
in the call that launches the graph); with `--profile_dir` the trace then
holds the `go2.*` host ranges (`go2.learn.launch` round each graph launch)
and the stamps as kernels `go2_span_stamp`. Under a mesh each rank records
its own spans and rank 0 logs them.

Each rank ends by printing its launches of the hand-written kernels
(`terrain_patches.LAUNCHES`) as `launches: {"rank": r, ...}`.

Usage:
    python -m go2_rl_gym_tpu_torch.scripts.train --task go2_moe_cts \
        --num_envs 4096 --max_iterations 150000 [--resume] [--device cuda] \
        [--num_devices W] [--profile_dir DIR] [--spans]
    python -m torch.distributed.run --nproc_per_node 4 \
        -m go2_rl_gym_tpu_torch.scripts.train --task go2_moe_cts \
        --num_envs 4096 [--num_devices 4]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

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
    p.add_argument("--spans", action="store_true",
                   help="stamp each iteration's phases on the device and "
                        "log them as Perf/phase/<span>_ms")
    p.add_argument("--eval_interval", type=int, default=0,
                   help="run async MuJoCo sim2sim eval every N iterations")
    p.add_argument("--multihost", action="store_true",
                   help="initialise torch.distributed from the launcher's "
                        "environment (implied under torch.distributed.run)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="shard the envs over this many ranks (default: "
                        "every card when more than one is visible); under "
                        "a launcher it must equal the launcher's world size")
    return p.parse_args(argv)


# iterations before the traced ones, and the traced ones, of --profile_dir
PROFILE_START = 10
PROFILE_ITERS = 3


def own_ranks(args) -> int:
    """How many ranks this command starts itself (see the module
    docstring): 0 under a launcher or with --multihost; else
    `--num_devices` when given; else every visible card when `--device` is
    cuda (no index) and more than one is visible; else 0."""
    if "WORLD_SIZE" in os.environ or args.multihost:
        return 0
    if args.num_devices:
        return args.num_devices
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() > 1:
        return torch.cuda.device_count()
    return 0


def launch(args, argv, num_envs: int):
    """Replace this process with torch.distributed.run starting `args`'s W
    ranks of this script with the arguments `argv`, after the checks each
    rank would make."""
    world = own_ranks(args)
    if num_envs % world:
        raise ValueError(f"{world} ranks do not divide num_envs={num_envs}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"--num_devices {world}, but "
                           f"{torch.cuda.device_count()} cards are visible")
    print(f"scripts.train: starting {world} ranks on {dev.type}", flush=True)
    os.execv(sys.executable, [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(world), "-m",
        "go2_rl_gym_tpu_torch.scripts.train", *argv])


def profile(runner, rs, profile_dir, rank: int):
    """PROFILE_ITERS iterations of `learn` under torch.profiler (see the
    module docstring); returns the state after them."""
    from go2_rl_gym_tpu_torch.tools import profile_rollout as pr
    acts = [torch.profiler.ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    first = runner.current_iteration
    with pr.window(acts, pr.lead_in_on(runner.device)) as prof:
        with torch.profiler.record_function(
                f"learn iterations {first}-{first + PROFILE_ITERS - 1}"):
            rs = runner.learn(rs, PROFILE_ITERS)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{rank}.json" if rank
                        else "trace.json")
    prof.export_chrome_trace(path)
    print("profile: " + json.dumps({
        "rank": rank, "trace": path,
        "iterations": [first, runner.current_iteration - 1],
        "kernel_launches": sum(e.count for e in pr._kernels(prof)),
        "lost_launches": len(pr.launches_without_kernel(prof.events()))}),
        flush=True)
    return rs


def main(argv=None):
    args = get_args(argv)
    from go2_rl_gym_tpu_torch.ops import terrain_patches
    from go2_rl_gym_tpu_torch.utils import registry, spans
    from go2_rl_gym_tpu_torch.utils.helpers import (get_load_path,
                                                    update_cfg_from_args)

    env_cfg, train_cfg = registry.get_cfgs(args.task)
    update_cfg_from_args(env_cfg, train_cfg, args)
    world = own_ranks(args)
    if world > 1:
        launch(args, sys.argv[1:] if argv is None else list(argv),
               env_cfg.env.num_envs)
    device, mesh = args.device, None
    if world or args.multihost or "WORLD_SIZE" in os.environ:
        # before any CUDA work: make_env uploads the terrain
        from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
        if world:       # --num_devices 1: a mesh of this process alone
            device = mesh_lib.initialize_multihost(
                f"localhost:{mesh_lib.free_port()}", 1, 0,
                device=args.device)
        else:
            launched = int(os.environ.get("WORLD_SIZE", 0))
            if args.num_devices and args.num_devices != launched:
                raise RuntimeError(
                    f"--num_devices {args.num_devices}, but the launcher "
                    f"started {launched or 'no'} ranks: launch with python "
                    f"-m torch.distributed.run --nproc_per_node "
                    f"{args.num_devices}, or without a launcher")
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
    rank = mesh.rank if mesh else 0
    with (spans.recording(runner.device) if args.spans
          else contextlib.nullcontext()):
        if args.profile_dir:
            rs = runner.learn(rs, PROFILE_START)
            rs = profile(runner, rs, args.profile_dir, rank)
            iters -= PROFILE_START + PROFILE_ITERS
        rs = runner.learn(rs, iters)
    print("launches: " + json.dumps({"rank": rank,
                                     **terrain_patches.LAUNCHES}),
          flush=True)
    return runner, rs


if __name__ == "__main__":
    from go2_rl_gym_tpu_torch.distributed.mesh import shutdown
    try:
        main()
    finally:
        shutdown()
