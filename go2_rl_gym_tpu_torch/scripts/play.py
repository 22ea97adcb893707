"""Roll a trained policy's deterministic student on the env; export a
checkpoint's policy.

Counterpart of scripts/play.py of the JAX package. Two modes:

On the card `env.step` runs as one CUDA graph (`utils/graphs.py`
`EnvStep`, the JAX play's `jax.jit(env.step)`); the policy runs eagerly.

* a checkpoint of the port (`play_checkpoint`; the default, as in the JAX
  script: `--task` go2_moe_cts, `--steps` 250): the task's env at most 16
  envs on a 5 x 5 terrain grid without curriculum, noise, friction DR,
  pushes or action delay (play.py:43-50); the run's latest (or the named)
  model_<it>.pt under `--log_root` loads with `runner.load_params`; the
  policy is exported to <run>/exported/policies/ as policy_jit.pt and
  policy.onnx (CTS algorithms) and policy.pkl (CTS and PPO), then rolled
  with the command held at [1, 0, 0] (PPO: the actor's mean on the obs).
  Recurrent PPO is refused: the JAX package's play has no export for it
  either. The last line is a JSON object: the checkpoint, the exported
  files, whether every obs and reward was finite, and the process's
  kernel launches (`ops.launch_counts()`: the patch and rigid-body
  kernels).
* the committed policy (`play`, with `--policy`; a bare `--policy` is
  doc/evidence/go2_moe_cts_r5_75k.pt): the student
  encoder reads the obs history, the actor's mean `mu` drives `env.step`,
  the history is zeroed on done and shifted, and the command is held at
  [1, 0, 0] (play.py:82-104). Play-mode overrides (play.py:43-50) turn off
  noise, friction DR, pushes and the action delay; the terrain stays the
  full configured grid (4096 envs by default). Prints the mean reward and
  the share of envs done at each step, and env-steps/s of the loop.

Usage:
    python -m go2_rl_gym_tpu_torch.scripts.play [--task go2_moe_cts] \
        [--experiment_name NAME] [--load_run RUN] [--checkpoint IT] \
        [--log_root logs] [--steps 250] [--device cuda]
    python -m go2_rl_gym_tpu_torch.scripts.play --policy [P.pt] \
        [--num_envs 4096] [--steps 250] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from go2_rl_gym_tpu_torch.agents.cts import ALGO_TO_FAMILY
from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.env.config import Go2Cfg, go2_moe_cts_train_cfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch.export import exporter
from go2_rl_gym_tpu_torch.export.importer import load_pt_policy
from go2_rl_gym_tpu_torch import ops
from go2_rl_gym_tpu_torch.utils import graphs
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
from go2_rl_gym_tpu_torch.utils import registry
from go2_rl_gym_tpu_torch.utils.helpers import get_load_path

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_POLICY = os.path.join(ROOT, "doc", "evidence", "go2_moe_cts_r5_75k.pt")


# the fixed play command [lin_vel_x, lin_vel_y, ang_vel_yaw] (play.py:54-62)
COMMAND = (1.0, 0.0, 0.0)


def play_cfg(num_envs: int) -> Go2Cfg:
    cfg = Go2Cfg()
    cfg.env.num_envs = num_envs
    cfg.noise.add_noise = False
    cfg.domain_rand.randomize_friction = False
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.randomize_action_delay = False
    return cfg


@torch.no_grad()
def policy_step(model, env: Go2Env, state, obs, history, step=None):
    """One deterministic step: hold the command, mu -> env.step (or `step`,
    a `graphs.EnvStep` of it), zero the history on done and append the new
    obs. `mu` is the CTS student's (`s_latent` on the history, then `dist`)
    or, for PPO's `ActorCritic`, the actor's on the obs."""
    N = env.num_envs
    cmd = torch.tensor(COMMAND, dtype=torch.float32, device=env.device)
    state = state._replace(commands=torch.cat(
        [cmd.expand(N, 3), state.commands[:, 3:]], dim=1))
    if hasattr(model, "s_latent"):
        latent, _ = model.s_latent(history.reshape(N, -1))
        mu, _, _ = model.dist(latent, obs)
    else:
        mu, _ = model.actor_dist(obs)
    state, out = (step or env.step)(state, mu)
    history = torch.where(out.done[:, None, None], 0.0, history)
    history = torch.cat([history[:, 1:], out.obs[:, None]], dim=1)
    return state, out, history


def play(policy: str = DEFAULT_POLICY, num_envs: int = 4096, steps: int = 24,
         seed: int = 0, device="cuda"):
    """Build the env and runner, load `policy`, roll `steps` policy steps.

    Returns dict(mean_reward=[per step], done_share=[per step],
    env_steps_per_s, finite) where `finite` says whether every obs and
    reward of the run was finite."""
    device = resolve_device(device)
    cfg = play_cfg(num_envs)
    train_cfg = go2_moe_cts_train_cfg()
    env = Go2Env(cfg, num_steps_per_env=train_cfg.runner.num_steps_per_env,
                 device=device)
    runner = OnPolicyRunner(env, train_cfg, device=device)
    rs = runner.init_runner_state(seed)
    model = load_pt_policy(policy, runner.alg.model)

    state, obs, history = rs.env_state, rs.obs, rs.history
    # one untimed call of the policy: the env already stepped once in
    # init_runner_state, so the timed loop leaves out both first-call costs
    with torch.no_grad():
        latent, _ = model.s_latent(history.reshape(env.num_envs, -1))
        model.dist(latent, obs)
    rews, dones, finite = [], [], []
    step = graphs.EnvStep(env)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out, history = policy_step(model, env, state, obs, history,
                                          step)
        obs = out.obs
        rews.append(out.rew.mean())
        dones.append(out.done.to(torch.float32).mean())
        finite.append(torch.isfinite(out.obs).all()
                      & torch.isfinite(out.rew).all())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    return dict(mean_reward=torch.stack(rews).tolist(),
                done_share=torch.stack(dones).tolist(),
                env_steps_per_s=steps * env.num_envs / elapsed,
                finite=bool(torch.stack(finite).all()))


def play_checkpoint_cfgs(task: str, num_envs: int = 16):
    """The task's configs with the play-mode overrides (play.py:43-50)."""
    env_cfg, train_cfg = registry.get_cfgs(task)
    env_cfg.env.num_envs = min(env_cfg.env.num_envs, num_envs)
    env_cfg.terrain.num_rows = 5
    env_cfg.terrain.num_cols = 5
    env_cfg.terrain.curriculum = False
    env_cfg.noise.add_noise = False
    env_cfg.domain_rand.randomize_friction = False
    env_cfg.domain_rand.push_robots = False
    env_cfg.domain_rand.randomize_action_delay = False
    return env_cfg, train_cfg


def play_checkpoint(task: str = "go2_moe_cts", experiment_name=None,
                    load_run=-1, checkpoint: int = -1,
                    log_root: str = os.path.join(ROOT, "logs"),
                    num_envs: int = 16, steps: int = 250, seed: int = 0,
                    device="cuda"):
    """Load a checkpoint of the port, export its policy, roll it (see the
    module docstring). Returns dict(checkpoint, exported={kind: path},
    mean_reward=[per step], finite); prints its summary as a JSON line."""
    env_cfg, train_cfg = play_checkpoint_cfgs(task, num_envs)
    algo = train_cfg.runner.algorithm_class_name
    if algo != "PPO" and algo not in ALGO_TO_FAMILY:
        raise ValueError(f"play exports the CTS algorithms and PPO; task "
                         f"{task!r} trains {algo}")
    device = resolve_device(device)
    env = registry.make_env(
        task, env_cfg, num_steps_per_env=train_cfg.runner.num_steps_per_env,
        device=device)
    runner = registry.make_runner(task, env, train_cfg, device=device)
    rs = runner.init_runner_state(seed)
    run_root = os.path.join(log_root, experiment_name
                            or train_cfg.runner.experiment_name)
    path = get_load_path(run_root, load_run, checkpoint)
    print(f"loading {path}")
    # parameters only: the training checkpoint's env count does not
    # constrain the play session (play.py:38-40)
    runner.load_params(path)
    model = runner.alg.model
    export_dir = os.path.join(os.path.dirname(path), "exported", "policies")
    kinds = ["pkl"] if algo == "PPO" else ["jit", "onnx", "pkl"]
    exported = {kind: exporter.export_model(
        model, kind, ALGO_TO_FAMILY.get(algo, "ppo"), export_dir,
        meta={"task": task, "algorithm": algo}) for kind in kinds}
    for kind, p in exported.items():
        print(f"exported {kind}: {p}")

    # inference rollout with the command held at [1, 0, 0] (play.py:54-62)
    state, obs, history = rs.env_state, rs.obs, rs.history
    rews, finite = [], []
    step = graphs.EnvStep(env)
    for _ in range(steps):
        state, out, history = policy_step(model, env, state, obs, history,
                                          step)
        obs = out.obs
        rews.append(out.rew.mean())
        finite.append(torch.isfinite(out.obs).all()
                      & torch.isfinite(out.rew).all())
    mean_reward = torch.stack(rews).tolist()
    print(f"{steps}-step rollout: mean reward/step "
          f"{sum(mean_reward) / steps:.4f}")
    res = dict(checkpoint=path, exported=exported, mean_reward=mean_reward,
               finite=bool(torch.stack(finite).all()))
    print(json.dumps({"checkpoint": path, "exported": exported,
                      "finite": res["finite"],
                      "launches": ops.launch_counts()}))
    return res


def get_parser():
    """The flags; those shared with scripts/play.py have its defaults."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", default="go2_moe_cts",
                   help="roll and export a checkpoint of this task's runs")
    p.add_argument("--experiment_name", default=None,
                   help="the experiment directory under --log_root (the "
                        "task's by default)")
    p.add_argument("--load_run", default=-1)
    p.add_argument("--checkpoint", type=int, default=-1)
    p.add_argument("--log_root", default=os.path.join(ROOT, "logs"))
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--policy", nargs="?", const=DEFAULT_POLICY, default=None,
                   help="roll this .pt policy instead of a checkpoint "
                        "(bare: the committed one)")
    p.add_argument("--num_envs", type=int, default=None,
                   help="at most 16 (the default) for a checkpoint; 4096 "
                        "for --policy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.policy is None:
        return play_checkpoint(
            args.task, args.experiment_name, args.load_run, args.checkpoint,
            args.log_root, args.num_envs or 16, args.steps, args.seed,
            args.device)
    res = play(args.policy, args.num_envs or 4096, args.steps, args.seed,
               args.device)
    for i, (r, d) in enumerate(zip(res["mean_reward"], res["done_share"])):
        print(f"step {i:3d}  mean reward {r:+.5f}  done share {d:.4f}")
    print(json.dumps({"env_steps_per_s": res["env_steps_per_s"],
                      "finite": res["finite"]}))
    return res


if __name__ == "__main__":
    main()
