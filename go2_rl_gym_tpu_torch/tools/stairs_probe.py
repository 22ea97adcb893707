"""Stairs-ascent probe: the riser snap's effect on a trained policy.

Twin of tools/stairs_probe.py. Runs a trained policy (default: the
committed flagship artifact doc/evidence/go2_moe_cts_r5_75k.pt, through
the port's importer) inside the port's training env (env/go2_env.py +
sim/tengine.py) on pure stairs_up terrain at FIXED terrain levels, with a
constant forward command, and reports per-level survival and forward
progress. `--ab` also runs with the riser snap off (a riser threshold of
inf: the tilted central-difference contact normal of a riser) so that the
snap's effect is measured directly. The threshold is passed to the env's
terrain build as a parameter; no module global changes.

Background: a stair riser in the heightfield presents a central-difference
contact normal tilted by atan(step/0.2) (level 5: 40 deg, level 7: 47 deg),
so ascent contacts fight a tilted friction cone that the reference's PhysX
trimesh (vertical risers + flat treads, slope_treshold=0.75 correction,
legged_robot_config.py:40) never produces. The snap restores tread-normal
contact at risers.

Usage:
    python -m go2_rl_gym_tpu_torch.tools.stairs_probe [--levels 2 4 6 8] \\
        [--steps 400] [--num_envs 128] [--ab] [--out results.jsonl] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from go2_rl_gym_tpu_torch.ops.terrain_patches import RISER_SLOPE_THRESHOLD

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_POLICY = os.path.join(ROOT, "doc", "evidence",
                              "go2_moe_cts_r5_75k.pt")
MODES = (("riser_snap", RISER_SLOPE_THRESHOLD), ("no_snap", float("inf")))


def probe_cfgs(task: str, n_envs: int):
    """The task's configs on pure stairs_up columns (10 rows x 4 columns,
    difficulty = row / num_rows, so a terrain level selects the riser
    height) with deterministic contact conditions (play-mode overrides,
    play.py:43-50)."""
    from go2_rl_gym_tpu_torch.utils import registry
    env_cfg, train_cfg = registry.get_cfgs(task)
    env_cfg.env.num_envs = n_envs
    env_cfg.terrain.mesh_type = "heightfield"
    env_cfg.terrain.terrain_proportions = (0.0, 0.0, 0.0, 1.0, 0.0,
                                           0.0, 0.0, 0.0, 0.0)
    env_cfg.terrain.curriculum = True
    env_cfg.terrain.num_rows = 10
    env_cfg.terrain.num_cols = 4
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.randomize_action_delay = False
    return env_cfg, train_cfg


def build_env(task, n_envs, riser_threshold=RISER_SLOPE_THRESHOLD,
              device="cuda"):
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    env_cfg, train_cfg = probe_cfgs(task, n_envs)
    env = Go2Env(env_cfg, num_steps_per_env=train_cfg.runner.num_steps_per_env,
                 device=device, riser_threshold=riser_threshold)
    return env, train_cfg


def load_policy(env, train_cfg, pt_path):
    """The task's CTS model with the `.pt` policy's student and actor
    loaded (the rest keeps a seeded init); returns (model, history
    length)."""
    from go2_rl_gym_tpu_torch.agents.cts import ALGO_TO_FAMILY
    from go2_rl_gym_tpu_torch.agents.networks import (init_params,
                                                      make_cts_model)
    from go2_rl_gym_tpu_torch.export.importer import load_pt_policy

    family = ALGO_TO_FAMILY[train_cfg.runner.algorithm_class_name]
    model = make_cts_model(family, env.num_obs, env.num_privileged_obs, 12,
                           train_cfg.policy, train_cfg.history_length,
                           device=env.device)
    init_params(model, torch.Generator(device=env.device).manual_seed(0))
    return load_pt_policy(pt_path, model), train_cfg.history_length


@torch.no_grad()
def probe_level(env, model, hist_len, level, steps, vx, seed=0, state=None):
    """Fixed-level rollout from `state` (the env's init from `seed` when
    None); returns survival fraction and x-progress stats. As in the JAX
    tool, an env that ends at a step records that step's x, which is its
    reset position's."""
    N = env.num_envs
    dev = env.device
    lvl_arr = torch.full((N,), level, dtype=torch.int32, device=dev)

    def origins(state):
        return env.terrain_origins[lvl_arr.long(), state.terrain_types.long()]

    def roll(state, obs, history):
        cmd = state.commands
        state = state._replace(
            terrain_levels=lvl_arr, env_origins=origins(state),
            commands=torch.cat([torch.full_like(cmd[:, :1], vx),
                                torch.zeros_like(cmd[:, 1:])], dim=1))
        latent, _ = model.s_latent(history.reshape(N, -1))
        mu, _, _ = model.dist(latent, obs)
        state, out = env.step(state, mu)
        history = torch.where(out.done[:, None, None], 0.0, history)
        history = torch.cat([history[:, 1:], out.obs[:, None]], dim=1)
        x_rel = state.sim.base_pos[:, 0] - state.env_origins[:, 0]
        return state, out.obs, history, out.done, x_rel

    if state is None:
        state = env.init_state(seed)
    # teleport every robot onto the target row (init_state spreads spawns
    # over the init-curriculum levels), keeping the spawn offset
    new_org = origins(state)
    delta = new_org - state.env_origins
    state = state._replace(
        terrain_levels=lvl_arr, env_origins=new_org,
        sim=state.sim._replace(base_pos=state.sim.base_pos + delta))
    obs = torch.zeros((N, env.num_obs), device=dev)
    history = torch.zeros((N, hist_len, env.num_obs), device=dev)
    state, obs, history, _, _ = roll(state, obs, history)

    ever_done = np.zeros(N, bool)
    best_x = np.zeros(N, np.float32)
    for _ in range(steps):
        state, obs, history, done, x_rel = roll(state, obs, history)
        d = done.cpu().numpy()
        x = x_rel.cpu().numpy()
        alive = ~ever_done
        best_x[alive] = np.maximum(best_x[alive], x[alive])
        ever_done |= d
    return dict(level=int(level),
                survival=float((~ever_done).mean()),
                mean_progress_m=float(best_x.mean()),
                p90_progress_m=float(np.percentile(best_x, 90)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", default="go2_moe_cts")
    ap.add_argument("--policy", default=DEFAULT_POLICY)
    ap.add_argument("--levels", type=int, nargs="+", default=[2, 4, 6, 8])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--num_envs", type=int, default=128)
    ap.add_argument("--vx", type=float, default=0.6)
    ap.add_argument("--ab", action="store_true",
                    help="also run with the riser snap off (tilted-normal "
                         "riser contact) for an A/B comparison")
    ap.add_argument("--out", default=None, help="write results jsonl here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from go2_rl_gym_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    results = []
    for mode, thresh in MODES[:2 if args.ab else 1]:
        env, train_cfg = build_env(args.task, args.num_envs, thresh, device)
        model, hist_len = load_policy(env, train_cfg, args.policy)
        for lvl in args.levels:
            r = probe_level(env, model, hist_len, lvl, args.steps, args.vx)
            r["mode"] = mode
            results.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
