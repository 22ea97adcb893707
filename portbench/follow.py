"""The plain reference's side of the comparison: the frozen copy of the
port's iteration (`portbench/reference`) run eagerly from the seed for
`compare.STEPS` iterations, read as the program's side is read.

It rebuilds the terrain, the env state and the weights from the same seed,
configuration file and traffic as the program. Its first iteration starts
from that state of its own; a later one starts from the other side's state
at the start of that iteration where `starts` gives it (the snapshots
`compare.snapshot` took of the program, see `compare`). `tf32` turns TF32
on for its matmuls (the control: the nearest precision below the
configuration's fp32 with TF32 off); `fault` plants one of `faults.PLANT`
in it; with `keep` it returns snapshots of its own starts, so that it can
stand in the program's place.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from portbench import compare, faults, spec


def run(cell: spec.Cell, seed: int, device, starts: Optional[List] = None,
        tf32: bool = False, fault=None, keep: bool = False
        ) -> Tuple[List[compare.Iteration], List]:
    """(an `Iteration` per iteration, snapshots of the starts of iterations
    2..STEPS where `keep`, else [])."""
    from portbench.reference.env.go2_env import Go2Env
    from portbench.reference.train.runner import OnPolicyRunner
    from portbench.reference.utils import registry

    env_cfg, train_cfg = spec.build_cfgs(registry, cell)
    steps = train_cfg.runner.num_steps_per_env
    env = Go2Env(env_cfg, num_steps_per_env=steps, terrain_seed=seed,
                 device=device)
    runner = OnPolicyRunner(env, train_cfg, device=device)
    if fault is not None:
        faults.PLANT[fault](runner.alg, env)
    # Go2Env and the runner turn TF32 off, as the port does; the control
    # turns it on for its own iterations
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        rs = runner.init_runner_state(
            seed, init_at_random_ep_len=bool(cell.traffic["random_start"]))
        out, snaps = [], []
        for k in range(compare.STEPS):
            if k > 0 and keep:
                snaps.append(compare.snapshot(rs, runner.alg))
            if k > 0 and starts is not None:
                rs = compare.fill(rs, starts[k - 1]["state"])
                runner.alg.load_train_state_dict(starts[k - 1]["train"])
            before = compare.params(runner.alg)
            rs, m = runner.train_step(rs)
            out.append(compare.iteration(
                runner.alg, {n: float(v) for n, v in m.items()
                             if v.numel() == 1}, before, rs.obs))
        return out, snaps
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
