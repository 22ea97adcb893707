"""What the span recorder (utils/spans.py) costs a replay: the mean replay
ms of the train iteration's CUDA graph captured with spans off and of the
one captured with spans on, in one process, on one runner, in turns (off,
on, on, off in each of ROUNDS rounds; CUDA events round REPLAYS replays a
turn).
Both graphs train the same parameters, each from its own copy of the
state; each is replayed once before the turns (the first replay after a
capture uploads the graph). The stamps of the on turns are decoded into
each span's ms. On the CPU the same turns run the eager step (stamps on
the host).

    python -m go2_rl_gym_tpu_torch.tools.span_cost --task go2_moe_cts \
        --num_envs 8192 [--seed 0] [--device cuda]

Prints one JSON line: the card, the task and env count, the stamps per
replay, each turn's mean replay ms and, per graph, the median of its
turns, the cost (on over off less 1, in %, of those medians), and per span
[median, min, max] ms over the replays of the on turns.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.utils import registry, spans

ROUNDS = 3
REPLAYS = 3


def _turn(step, replays: int, device) -> float:
    """Mean ms of `replays` calls of `step`: CUDA events round them on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            step()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / replays
    t = time.perf_counter()
    for _ in range(replays):
        step()
    return (time.perf_counter() - t) * 1e3 / replays


def measure(runner, rs, rounds: int = ROUNDS, replays: int = REPLAYS
            ) -> dict:
    """The turns (see the module docstring) on a runner and its state."""
    dev = runner.device
    off = runner.compiled_step(rs)
    off()                                   # warm-up and capture
    with spans.recording(dev) as rec:
        on = runner.compiled_step(rs)
        on()
        _turn(off, 1, dev)
        _turn(on, 1, dev)
        ms = {"off": [], "on": []}
        phases = []
        for _ in range(rounds):
            for name in ("off", "on", "on", "off"):
                step = on if name == "on" else off
                ms[name].append(_turn(step, replays, dev))
                if name == "on":
                    copied = rec.copy()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    phases += rec.iterations(copied, replays)
    median = {k: statistics.median(v) for k, v in ms.items()}
    return {"stamps_per_replay": len(rec.schedule), "turn_ms": ms,
            "median_ms": median,
            "cost_pct": 100.0 * (median["on"] / median["off"] - 1.0),
            "span_ms": {k: [statistics.median(p[k] for p in phases),
                            min(p[k] for p in phases),
                            max(p[k] for p in phases)]
                        for k in phases[0]}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="go2_moe_cts",
                   choices=registry.task_names())
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    env_cfg, tc = registry.get_cfgs(args.task)
    env = registry.make_env(args.task, env_cfg, num_envs=args.num_envs,
                            num_steps_per_env=tc.runner.num_steps_per_env,
                            terrain_seed=args.seed, device=dev)
    runner = registry.make_runner(args.task, env, tc, device=dev)
    rs = runner.init_runner_state(args.seed, init_at_random_ep_len=True)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "task": args.task, "num_envs": env.num_envs,
           **measure(runner, rs)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
