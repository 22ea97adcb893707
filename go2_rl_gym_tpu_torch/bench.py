"""Headline benchmark of the port: train-iteration throughput on one card
(the PyTorch twin of the JAX package's bench.py).

Runs the complete go2_moe_cts training iteration (24-step rollout with
4x-decimation physics on the full rough terrain + the 5 x 4-minibatch PPO +
distillation update) at `BENCH_NUM_ENVS` envs (4096) on one card and
reports environment steps per second. The configuration is bench.py's:
Go2Cfg(), go2_moe_cts_train_cfg(), Go2Env with the runner's steps per env,
OnPolicyRunner(log_dir=None), init_runner_state(0,
init_at_random_ep_len=True).

Method (bench.py:49-81):
* Warm up with two calls of the compiled step
  (`OnPolicyRunner.compiled_step`). On the card the first call is the eager
  warm-up plus the capture of one CUDA graph of the iteration (its time is
  `capture_s`, the counterpart of XLA's compile), the second a replay.
* The guard, the twin of "the jit cache stays at 1 entry":
  `graphs.CAPTURES["train_step"]` went up by exactly 1 over the warm-up
  and stays there after every timed dispatch, and no hand-written kernel's
  launch count (`ops.launch_counts()`: the patch and rigid-body kernels)
  grows during any replay (growth would mean that the rollout runs from
  the host). On the
  CPU the step is eager and captures nothing: the guard then holds the
  captures at 0, and the output says so.
* A dispatch (`run_k`) enqueues BENCH_ITERS (10) calls of the step, each
  writing its iteration's value_loss into one (iters,) device buffer, as
  `learn`'s chunk writes its metrics; it ends in torch.cuda.synchronize()
  and reads the buffer once. The JAX bench fuses the K iterations into one
  program (a lax.scan); here K replays of the one graph go out back to
  back. A replay's call returns long before the card finishes it, so the
  host adds no gap between them, and a graph K iterations deep would cost
  K times the capture and the memory pool.
* The first dispatch is timed as `first_dispatch_s`; then BENCH_REPS (3)
  timed dispatches, and `median_dispatch_s` is their median.

The graph is captured as `learn` captures it, with deterministic algorithms
off; the run refuses to start with them on.

Prints one JSON line with bench.py's keys except `vs_baseline`: that one
divides by a per-chip target set for a 16-chip TPU v5p slice, a number of
another machine, and the port has no baseline of its own yet. Added:
`num_envs`, `task`, `capture_s`, the card's `name` and `power_limit` as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
them, and `guard`, what the guard held. Numbers are not rounded. A guard
breach prints bench.py's error line (`value` 0.0 and an `error`) and exits
with 1, where bench.py returns with 0. Without a card the entry point
raises; `--device cpu` runs it on the CPU (the tests do).

Usage:
    python -m go2_rl_gym_tpu_torch.bench
    BENCH_NUM_ENVS=8192 BENCH_ITERS=10 BENCH_REPS=3 \\
        python -m go2_rl_gym_tpu_torch.bench [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.env.config import (Go2Cfg, TrainCfg,
                                             go2_moe_cts_train_cfg)
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch import ops
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
from go2_rl_gym_tpu_torch.utils import graphs

METRIC = "env_steps_per_s_per_chip"
UNIT = "env-steps/s"
TASK = "go2_moe_cts"


class GuardError(RuntimeError):
    """The timed step was not the one captured graph: it was captured again,
    or the rollout launched a hand-written kernel from the host."""


def card(device: torch.device):
    """(name, power limit) of the card as nvidia-smi prints them;
    ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    smi_id = visible.split(",")[index] if visible else str(index)
    out = subprocess.run(
        ["nvidia-smi", "-i", smi_id, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def metric_offset(runner: OnPolicyRunner, key: str) -> int:
    """Where metric `key` starts in the compiled step's metric vector
    (`runner.metric_keys`, `metric_sizes`: known after the first call)."""
    return sum(runner.metric_sizes[:runner.metric_keys.index(key)])


def run_k(runner: OnPolicyRunner, step, out: torch.Tensor) -> list:
    """One dispatch (the twin of bench.py:63-67's `run_k`): len(out) calls
    of the compiled step `step`, each writing its iteration's value_loss
    into `out`, a buffer on the runner's device (as `learn`'s chunk writes
    its metrics); ends in a synchronize and reads `out` once. Returns the
    value_loss of each iteration."""
    for j in range(len(out)):
        vec = step()
        out[j].copy_(vec[metric_offset(runner, "value_loss")])
    _sync(out.device)
    return out.tolist()


def run(num_envs: int = 4096, iters: int = 10, reps: int = 3,
        device="cuda", cfg: Optional[Go2Cfg] = None,
        tc: Optional[TrainCfg] = None) -> dict:
    """The benchmark (see the module docstring): returns its JSON object.
    `cfg` replaces Go2Cfg() (the tests pass a smaller terrain) and `tc`
    go2_moe_cts_train_cfg(); `num_envs` sets the env count either way.
    Raises GuardError when the guard fails."""
    dev = resolve_device(device)
    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError("deterministic algorithms are on: the bench "
                           "captures the train step as learn does, with "
                           "them off")
    cfg = cfg or Go2Cfg()
    cfg.env.num_envs = num_envs
    tc = tc or go2_moe_cts_train_cfg()
    steps = tc.runner.num_steps_per_env
    env = Go2Env(cfg, num_steps_per_env=steps, device=dev)
    runner = OnPolicyRunner(env, tc, log_dir=None, device=dev)
    rs = runner.init_runner_state(0, init_at_random_ep_len=True)
    want = 1 if dev.type == "cuda" else 0       # captures of the warm-up

    # warm-up: two calls; on the card the capture, then a replay
    caps0 = graphs.CAPTURES["train_step"]
    _sync(dev)
    t = time.perf_counter()
    step = runner.compiled_step(rs)
    step()
    _sync(dev)
    capture_s = time.perf_counter() - t
    launches0 = ops.launch_counts()
    step()
    _sync(dev)

    def guard(when):
        caps = graphs.CAPTURES["train_step"] - caps0
        grown = {k: v - launches0[k]
                 for k, v in ops.launch_counts().items()}
        if caps != want or any(grown.values()):
            raise GuardError(
                f"{when}: {caps} captures of the train step (want {want}), "
                f"{grown['extract_patches']} patch launches from the host "
                f"after the warm-up (want 0), {grown['rigid_body']} "
                f"rigid-body launches from the host (want 0)")

    guard("after the warm-up")
    value_loss = torch.empty(iters, device=dev)

    def dispatch():
        t = time.perf_counter()
        vl = run_k(runner, step, value_loss)
        return time.perf_counter() - t, vl

    first_s, vl = dispatch()
    guard("after the first dispatch")
    times = []
    for r in range(reps):
        dt, vl = dispatch()
        guard(f"after timed dispatch {r}")
        times.append(dt)
    if not all(math.isfinite(v) for v in vl):
        raise RuntimeError(f"non-finite value_loss {vl}")
    dt = sorted(times)[len(times) // 2]
    name, power_limit = card(dev)
    held = (f"{want} capture of the train step" if want else
            f"eager on the {dev.type}: 0 captures of the train step")
    held += (f"; 0 kernel launches from the host in the warm-up's second "
             f"call and {1 + reps} dispatches of {iters}")
    return {
        "metric": METRIC,
        "value": iters * steps * num_envs / dt,
        "unit": UNIT,
        "median_dispatch_s": dt,
        "all_dispatch_s": times,
        "first_dispatch_s": first_s,
        "iters_per_dispatch": iters,
        "num_envs": num_envs,
        "task": TASK,
        "capture_s": capture_s,
        "name": name,
        "power_limit": power_limit,
        "guard": held,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (the card by default)")
    args = p.parse_args(argv)
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 4096))
    iters = int(os.environ.get("BENCH_ITERS", 10))
    reps = int(os.environ.get("BENCH_REPS", 3))
    try:
        res = run(num_envs, iters, reps, device=args.device)
    except GuardError as e:
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT,
                          "error": str(e)}), flush=True)
        sys.exit(1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
