"""Recurrent PPO: LSTM/GRU actor-critic trained with sequence replay
(PyTorch port of go2_rl_gym_tpu/agents/recurrent_ppo.py).

Counterpart of the reference's recurrent path (rsl_rl
actor_critic_recurrent.py:40-116 + rollout_storage.py:186-235 + ppo.py with
hidden-state plumbing), as the JAX package designs it:

* The update replays each env's whole T-step window through both RNNs from
  the window-start memory, zeroing the memory at done flags: the same
  computation on the same samples as the reference's split-and-pad
  minibatches, with static shapes.
* The memory is carried in the runner's RunnerState; the runner snapshots
  the rollout-start memory once per iteration for the replay.
* Minibatches are env slices (sequences stay whole), shuffled once per
  update; under a data-parallel mesh the envs' windows and rollout-start
  memories are gathered once per update, and each rank replays a static
  share of the envs of each global slice (padded with weight 0).

The train state lives in this object, as in agents/ppo.py.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from go2_rl_gym_tpu_torch.agents import common
from go2_rl_gym_tpu_torch.agents.ppo import MB_FIELDS, PPO, Transition
from go2_rl_gym_tpu_torch.agents.recurrent import (ActorCriticRecurrent,
                                                   LSTMState)
from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
from go2_rl_gym_tpu_torch.env.config import AlgorithmCfg, PolicyCfg


class Memory(NamedTuple):
    """Carried RNN state of both heads."""
    a: LSTMState
    c: LSTMState


class RecurrentPPO(PPO):
    """PPO's train state and surface, plus memory threading."""

    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 policy_cfg: PolicyCfg, alg_cfg: AlgorithmCfg, device):
        self.hidden = policy_cfg.rnn_hidden_size
        super().__init__(num_obs, num_critic_obs, num_actions, policy_cfg,
                         alg_cfg, device)

    def make_model(self, num_obs, num_critic_obs, num_actions,
                   policy_cfg: PolicyCfg):
        return ActorCriticRecurrent(
            num_obs, num_critic_obs, num_actions,
            actor_hidden_dims=tuple(policy_cfg.actor_hidden_dims),
            critic_hidden_dims=tuple(policy_cfg.critic_hidden_dims),
            rnn_hidden_size=policy_cfg.rnn_hidden_size,
            rnn_type=policy_cfg.rnn_type, activation=policy_cfg.activation,
            init_noise_std=policy_cfg.init_noise_std, device=self.device)

    def zero_memory(self, batch: int) -> Memory:
        z = torch.zeros((batch, self.hidden), device=self.device)
        return Memory(a=LSTMState(h=z, c=z), c=LSTMState(h=z, c=z))

    # ------------------------------------------------------------------
    # Rollout side
    # ------------------------------------------------------------------

    @torch.no_grad()
    def act(self, obs, critic_obs, mem: Memory,
            gen: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
        """Sample actions (as PPO.act) and step both memories. Returns
        (actions, values, logp, mu, std, new memory)."""
        mu, std, sa = self.model.actor_dist(obs, mem.a)
        std = std.detach()      # a view of the parameter keeps requires_grad
        actions = mu + std * common.draw_noise(mu, gen, noise)
        logp = common.gaussian_log_prob(mu, std, actions)
        values, sc = self.model.value(critic_obs, mem.c)
        return actions, values, logp, mu, std, Memory(a=sa, c=sc)

    def reset_memory(self, mem: Memory, dones) -> Memory:
        return Memory(a=ActorCriticRecurrent.reset_state(mem.a, dones),
                      c=ActorCriticRecurrent.reset_state(mem.c, dones))

    @torch.no_grad()
    def value(self, critic_obs, mem: Memory):
        return self.model.value(critic_obs, mem.c)[0]

    # ------------------------------------------------------------------
    # Update
    # ------------------------------------------------------------------

    def _replay(self, obs, critic_obs, dones, mem0: Memory):
        """Step the whole (T, n, ...) window through both RNNs from the
        window-start memory, zeroing at dones (JAX recurrent_ppo.py:104-118):
        for the same parameters, the rollout's mu, std and values. Returns
        them stacked (T, n, ...)."""
        model = self.model
        fa, fc = model.memory_a.cell.fused(), model.memory_c.cell.fused()
        mem, mus, stds, values = mem0, [], [], []
        for t in range(obs.shape[0]):
            mu, std, sa = model.actor_dist(obs[t], mem.a, fa)
            v, sc = model.value(critic_obs[t], mem.c, fc)
            mem = self.reset_memory(Memory(a=sa, c=sc),
                                    dones[t].to(torch.bool))
            mus.append(mu)
            stds.append(std)
            values.append(v)
        return torch.stack(mus), torch.stack(stds), torch.stack(values)

    def update(self, batch: Transition, returns, advantages, mem0: Memory,
               gen: Optional[torch.Generator] = None, perms=None):
        """Epochs x env-sliced minibatches of clipped PPO with sequence
        replay from `mem0`, the rollout-start memory (JAX
        recurrent_ppo.py:120-184). The envs are shuffled once per update, by
        `perms` (a permutation of range(N)) if given, else by torch.randperm
        from `gen`; each minibatch is (T, N // num_mini_batches, ...), and
        its KL for the adaptive LR spans all its T * N // nmb samples.
        Returns the metrics as 0-d tensors (under a mesh, this rank's
        shares)."""
        T, N = batch.rewards.shape          # N: this rank's envs
        n_all = self._n_global(N)
        nmb = self.cfg.num_mini_batches
        mb_envs = n_all // nmb
        perm = self._perm(n_all, nmb * mb_envs, gen, perms).reshape(
            nmb, mb_envs)
        cols, weight = mesh_lib.share_index(self.mesh, mb_envs, self.device)
        envs = perm[:, cols]                # (nmb, share) global env ids
        fields = {k: getattr(batch, k) for k in MB_FIELDS + ("dones",)}
        fields.update(returns=returns, advantages=advantages)
        samples, layout = common.gather_fields(self.mesh, fields, 2)
        t = torch.arange(T, device=self.device)[:, None, None]
        pools = common.split_fields(
            samples[mesh_lib.sample_rows(envs, t, T, N)], layout)
        # the rollout-start memory of the share's envs, gathered in global
        # env order (a one-step sample per env)
        mem_all = mesh_lib.gather_samples(
            self.mesh, torch.cat([x for s in mem0 for x in s], dim=1))
        mem = mem_all[envs].chunk(4, dim=-1)     # a.h, a.c, c.h, c.c

        def forward(slot):
            mb = {k: v[:, slot] for k, v in pools.items()}
            mem_mb = Memory(LSTMState(mem[0][slot], mem[1][slot]),
                            LSTMState(mem[2][slot], mem[3][slot]))
            return (mb, *self._replay(mb["obs"], mb["critic_obs"],
                                      mb["dones"], mem_mb))
        return self._epochs(nmb, T * mb_envs, forward,
                            None if weight is None else weight[None])
