"""The train iteration of the port's on-policy runner, frozen for the
benchmark's reference (copy of go2_rl_gym_tpu_torch/train/runner.py with
`learn`, the compiled step, logging, checkpoints, recurrent PPO and the
mesh taken out).

One train iteration (`train_step`) is the 24-step rollout (with the
student's obs-history buffer for CTS), GAE, and the update, run eagerly. Everything the env and the rollout carry
is in `RunnerState`; the train state (the parameters, the Adam states, the
adaptive learning rate) lives in `runner.alg`, updated in place.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from portbench.reference.agents import common
from portbench.reference.agents import cts as cts_lib
from portbench.reference.agents import ppo as ppo_lib
from portbench.reference.agents.networks import init_params
from portbench.reference.device import resolve_device
from portbench.reference.env.config import TrainCfg
from portbench.reference.env.go2_env import EnvState, Go2Env


class RunnerState(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor
    priv_obs: torch.Tensor
    history: torch.Tensor            # (N, L, num_obs); L = 1 if not CTS
    gen: torch.Generator             # action noise
    # episode bookkeeping (reference on_policy_runner.py:142-143)
    cur_reward_sum: torch.Tensor     # (N,)
    cur_episode_length: torch.Tensor  # (N,)
    # the update's shuffle
    perm_gen: Optional[torch.Generator] = None


class Rollout(NamedTuple):
    traj: NamedTuple                 # stacked (T, N, ...) Transition
    last_values: torch.Tensor        # (N,) value of the state after step T
    # CTS: [teacher reward sum, teacher length sum, teacher episodes,
    #       student reward sum, student length sum, student episodes];
    # PPO: [reward sum, length sum, episodes]
    ep_stats: torch.Tensor           # (6,) or (3,) over episodes ended
    metrics: Dict[str, torch.Tensor]  # env metrics, (T,) per name


def _split_seed(seed: int, n: int):
    g = torch.Generator()
    g.manual_seed(seed)
    return [int(s) for s in torch.randint(0, 2 ** 62, (n,), generator=g)]


class OnPolicyRunner:
    """Runner for PPO and the CTS variants (selected by
    train_cfg.runner.algorithm_class_name).

    `device` defaults to the card and must be the env's device."""

    def __init__(self, env: Go2Env, train_cfg: TrainCfg, device="cuda"):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env lives on {env.device}, runner on "
                             f"{self.device}")
        self.env = env
        self.cfg = train_cfg
        self.num_steps = train_cfg.runner.num_steps_per_env
        self.save_interval = train_cfg.runner.save_interval
        alg_name = train_cfg.runner.algorithm_class_name
        self.is_cts = alg_name != "PPO"
        self.history_length = train_cfg.history_length if self.is_cts else 1
        num_critic_obs = env.num_privileged_obs or env.num_obs
        if self.is_cts:
            self.alg = cts_lib.CTS(
                alg_name, env.num_obs, num_critic_obs, env.num_actions,
                env.num_envs_global, train_cfg.history_length,
                train_cfg.policy, train_cfg.algorithm, device=self.device)
        else:
            self.alg = ppo_lib.PPO(env.num_obs, num_critic_obs, env.num_actions,
                           train_cfg.policy, train_cfg.algorithm,
                           device=self.device)
        self.current_iteration = 0
        self.tot_timesteps = 0
        self.tot_time = 0.0

    def init_runner_state(self, seed: int = 0,
                          init_at_random_ep_len=False) -> RunnerState:
        """Seeded env state, policy weights (with a fresh train state), noise
        and shuffle generators, then the first observation via a
        zero-action step (reference BaseTask.reset, base_task.py:72-77)."""
        env = self.env
        N = env.num_envs
        s_env, s_alg, s_run, s_perm = _split_seed(seed, 4)
        alg_gen = torch.Generator(device=self.device)
        alg_gen.manual_seed(s_alg)
        init_params(self.alg.model, alg_gen)
        self.alg.reset_train_state()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(s_run)
        perm_gen = torch.Generator(device=self.device)
        perm_gen.manual_seed(s_perm)

        with torch.no_grad():
            env_state = env.init_state(s_env)
            if init_at_random_ep_len:
                # reference on_policy_runner.py:127-128
                rand_len = torch.randint(
                    0, env.max_episode_length, (N,), generator=gen,
                    device=self.device, dtype=torch.int32)
                env_state = env_state._replace(episode_length=rand_len)
            env_state, out = env.step(
                env_state, torch.zeros((N, env.num_actions), device=self.device))
            history = torch.zeros((N, self.history_length, env.num_obs),
                                  device=self.device)
            history = torch.cat([history[:, 1:], out.obs[:, None]], dim=1)
        return RunnerState(
            env_state=env_state, obs=out.obs, priv_obs=out.privileged_obs,
            history=history, gen=gen,
            cur_reward_sum=torch.zeros(N, device=self.device),
            cur_episode_length=torch.zeros(N, device=self.device),
            perm_gen=perm_gen)

    # ------------------------------------------------------------------

    def act(self, obs, priv, history, gen=None, noise=None):
        """One policy step of the runner's algorithm on the obs, privileged
        obs and obs history (N, L, num_obs). Returns (actions, values, logp,
        mu, std)."""
        if self.is_cts:
            return self.alg.act(obs, priv, history.reshape(len(obs), -1),
                                gen=gen, noise=noise)
        return self.alg.act(obs, priv, gen=gen, noise=noise)

    def value(self, obs, priv, history):
        """The value of the runner's algorithm on the same inputs as act."""
        if self.is_cts:
            return self.alg.value(obs, priv, history.reshape(len(obs), -1))
        return self.alg.value(priv)

    @torch.no_grad()
    def rollout(self, rs: RunnerState,
                noise: Optional[torch.Tensor] = None):
        """num_steps_per_env policy steps (JAX runner.py:192-262). `noise`
        (T, N, A), if given, replaces the standard-normal action noise drawn
        from rs.gen. Returns (RunnerState after the rollout, Rollout)."""
        env, alg = self.env, self.alg
        gamma = self.cfg.algorithm.gamma
        N = env.num_envs
        if self.is_cts:
            is_student = alg.is_student.to(torch.float32)
        obs, priv, history = rs.obs, rs.priv_obs, rs.history
        env_state = rs.env_state
        rew_sum, ep_len = rs.cur_reward_sum, rs.cur_episode_length
        steps, ep_stats, metrics = [], [], []
        for t in range(self.num_steps):
            hist_flat = history.reshape(N, -1)
            actions, values, logp, mu, std = self.act(
                obs, priv, history, gen=rs.gen,
                noise=None if noise is None else noise[t])
            env_state, out = env.step(env_state, actions)
            rewards = alg.process_rewards(out.rew, values, out.time_outs, gamma)
            if self.is_cts:
                steps.append(cts_lib.Transition(
                    obs=obs, critic_obs=priv, history=hist_flat,
                    actions=actions, rewards=rewards, dones=out.done,
                    values=values, log_probs=logp, mu=mu, sigma=std))
            else:
                steps.append(ppo_lib.Transition(
                    obs=obs, critic_obs=priv, actions=actions,
                    rewards=rewards, dones=out.done, values=values,
                    log_probs=logp, mu=mu, sigma=std))
            # history: zero on done, then append the new obs
            # (on_policy_runner_cts.py:155-156)
            history = torch.where(out.done[:, None, None], 0.0, history)
            history = torch.cat([history[:, 1:], out.obs[:, None]], dim=1)
            # episode statistics
            rew_sum = rew_sum + out.rew
            ep_len = ep_len + 1.0
            done_f = out.done.to(torch.float32)
            if self.is_cts:
                sd = done_f * is_student
                td = done_f * (1.0 - is_student)
                ep_stats.append(torch.stack([
                    torch.sum(rew_sum * td), torch.sum(ep_len * td),
                    torch.sum(td), torch.sum(rew_sum * sd),
                    torch.sum(ep_len * sd), torch.sum(sd)]))
            else:
                ep_stats.append(torch.stack([
                    torch.sum(rew_sum * done_f), torch.sum(ep_len * done_f),
                    torch.sum(done_f)]))
            rew_sum = rew_sum * (1.0 - done_f)
            ep_len = ep_len * (1.0 - done_f)
            obs, priv = out.obs, out.privileged_obs
            metrics.append(out.metrics)

        last_values = self.value(obs, priv, history)
        traj = type(steps[0])(*[torch.stack(xs) for xs in zip(*steps)])
        new_rs = rs._replace(env_state=env_state, obs=obs, priv_obs=priv,
                             history=history, cur_reward_sum=rew_sum,
                             cur_episode_length=ep_len)
        return new_rs, Rollout(
            traj=traj, last_values=last_values,
            ep_stats=torch.stack(ep_stats).sum(dim=0),
            metrics={k: torch.stack([m[k] for m in metrics])
                     for k in metrics[0]})

    def train_step(self, rs: RunnerState,
                   noise: Optional[torch.Tensor] = None, perms=None,
                   mark: Optional[Callable[[str], None]] = None):
        """One train iteration: rollout, GAE, update (JAX runner.py:182-295).

        `noise` is passed to `rollout` (drawn from rs.gen when not given)
        and `perms` to the algorithm's `update` (drawn from rs.perm_gen when
        not given). `mark`, if given, is called with "rollout", "gae" and
        "update" as each phase has been issued, for timing (it may
        synchronize the device). Returns (RunnerState, metrics as tensors on
        the device): env metrics, `rew_*` and `done_count` summed over the
        rollout and the others averaged, `ep_stats` summed, the update's
        losses and learning rate, and `mean_noise_std` where the model has a
        `std` parameter."""
        mark = mark or (lambda phase: None)
        rs, ro = self.rollout(rs, noise)
        mark("rollout")
        traj = ro.traj
        cfg = self.cfg.algorithm
        returns, advantages = common.compute_gae(
            traj.rewards, traj.values, traj.dones, ro.last_values, cfg.gamma,
            cfg.lam)
        mark("gae")
        loss_metrics = self.alg.update(traj, returns, advantages,
                                       gen=rs.perm_gen, perms=perms)
        mark("update")

        agg = {}
        for name, vals in ro.metrics.items():
            if name.startswith("rew_") or name == "done_count":
                agg[name] = torch.sum(vals, dim=0)
            else:
                agg[name] = torch.mean(vals, dim=0)
        agg["ep_stats"] = ro.ep_stats
        agg.update(loss_metrics)
        if hasattr(self.alg.model, "std"):
            agg["mean_noise_std"] = torch.mean(self.alg.model.std.detach())
        return rs, agg
