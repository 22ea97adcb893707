"""PPO: clipped surrogate, GAE, adaptive-KL LR
(PyTorch port of go2_rl_gym_tpu/agents/ppo.py).

Counterpart of reference rsl_rl/rsl_rl/algorithms/ppo.py:38-187. As in
agents/cts.py, the train state (the model's parameters, one Adam state and
the learning rate as a 0-d fp32 tensor) lives in this object; the parameters
are the model's, updated in place, and `update` reads nothing back to the
host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from portbench.reference.agents import common
from portbench.reference.agents.networks import ActorCritic
from portbench.reference.env.config import AlgorithmCfg, PolicyCfg


class Transition(NamedTuple):
    """One rollout step, (N, ...); stacked to (T, N, ...) by the rollout
    (reference rollout_storage.py:37-51)."""
    obs: torch.Tensor
    critic_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


# the fields a minibatch reads (rewards and dones only feed GAE)
MB_FIELDS = ("obs", "critic_obs", "actions", "values", "log_probs", "mu",
             "sigma")


def ppo_loss(cfg: AlgorithmCfg, mu, std, values, mb, count, weight=None):
    """The clipped PPO loss of one minibatch of `count` samples (JAX
    ppo.py:114-126), of which `mb` (MB_FIELDS, returns and advantages)
    holds this rank's share, its padding weighted 0 by `weight`: each term
    is their weighted sum over `count`. Returns (loss, (value loss,
    surrogate, mean entropy))."""
    wsum = common.weighted_sum
    logp = common.gaussian_log_prob(mu, std, mb["actions"])
    entropy = wsum(common.gaussian_entropy(std), weight) / count
    surr = wsum(common.surrogate_loss(logp, mb["log_probs"],
                                      mb["advantages"], cfg.clip_param),
                weight) / count
    vloss = wsum(common.clipped_value_loss(values, mb["values"],
                                           mb["returns"], cfg.clip_param,
                                           cfg.use_clipped_value_loss),
                 weight) / count
    loss = surr + cfg.value_loss_coef * vloss - cfg.entropy_coef * entropy
    return loss, (vloss, surr, entropy)


class PPO:
    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 policy_cfg: PolicyCfg, alg_cfg: AlgorithmCfg, device):
        self.cfg = alg_cfg
        self.device = torch.device(device)
        self.model = self.make_model(num_obs, num_critic_obs, num_actions,
                                     policy_cfg)
        self.num_obs = num_obs
        self.num_critic_obs = num_critic_obs
        self.num_actions = num_actions
        self.reset_train_state()

    def make_model(self, num_obs, num_critic_obs, num_actions,
                   policy_cfg: PolicyCfg):
        return ActorCritic(
            num_obs, num_critic_obs, num_actions,
            actor_hidden_dims=tuple(policy_cfg.actor_hidden_dims),
            critic_hidden_dims=tuple(policy_cfg.critic_hidden_dims),
            activation=policy_cfg.activation,
            init_noise_std=policy_cfg.init_noise_std, device=self.device)

    # ------------------------------------------------------------------
    # Train state
    # ------------------------------------------------------------------

    def reset_train_state(self):
        """A fresh Adam state and the configured learning rate (JAX
        PPO.init, ppo.py:58-63); the parameters are left as they are.
        The train state is made on the first call and written in place
        after that, as `update` writes it: it keeps its storage, so a
        captured graph of the update goes on reading it."""
        if not hasattr(self, "opt"):
            self.opt = common.adam_init(self.model.parameters())
            self.lr = torch.empty((), dtype=torch.float32,
                                  device=self.device)
        common.adam_reset(self.opt)
        self.lr.fill_(self.cfg.learning_rate)

    def train_state_dict(self) -> Dict:
        """Everything the update carries: model weights, the Adam state, the
        learning rate."""
        return {"model": self.model.state_dict(), "opt": self.opt._asdict(),
                "lr": self.lr}

    def load_train_state_dict(self, sd: Dict):
        """`train_state_dict`'s values, copied into the train state's
        storage (as `reset_train_state` writes it)."""
        self.model.load_state_dict(sd["model"])
        common.adam_load(self.opt, sd["opt"])
        self.lr.copy_(sd["lr"])

    # ------------------------------------------------------------------
    # Rollout side
    # ------------------------------------------------------------------

    @torch.no_grad()
    def act(self, obs, critic_obs, gen: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
        """Sample actions: mu + std * noise (common.draw_noise). Returns
        (actions, values, logp, mu, std) without gradient history."""
        mu, std = self.model.actor_dist(obs)
        std = std.detach()      # a view of the parameter keeps requires_grad
        actions = mu + std * common.draw_noise(mu, gen, noise)
        logp = common.gaussian_log_prob(mu, std, actions)
        return actions, self.model.value(critic_obs), logp, mu, std

    @torch.no_grad()
    def value(self, critic_obs):
        return self.model.value(critic_obs)

    def process_rewards(self, rewards, values, time_outs, gamma):
        """Bootstrap on time-outs (reference ppo.py:104-110)."""
        return rewards + gamma * values * time_outs.to(torch.float32)

    # ------------------------------------------------------------------
    # Update
    # ------------------------------------------------------------------

    def update(self, batch: Transition, returns, advantages,
               gen: Optional[torch.Generator] = None, perms=None):
        """`num_learning_epochs` x `num_mini_batches` clipped-PPO steps
        (JAX ppo.py:84-147). The (T, N) batch is flattened t-major (row
        t*N + n of the global batch) and shuffled once per update, by
        `perms` (a permutation of range(T * N)) if given, else by
        torch.randperm from `gen`; the same minibatches are replayed in
        every epoch. Returns the metrics as 0-d tensors."""
        T, N = batch.rewards.shape
        total = T * N
        nmb = self.cfg.num_mini_batches
        mb_size = total // nmb
        rows = self._perm(total, nmb * mb_size, gen, perms).reshape(
            nmb, mb_size)                   # t*N + n
        fields = {k: getattr(batch, k) for k in MB_FIELDS}
        fields.update(returns=returns, advantages=advantages)
        samples, layout = common.gather_fields(fields, 2)
        pools = common.split_fields(samples[rows], layout)

        def forward(slot):
            mb = {k: v[slot] for k, v in pools.items()}
            mu, std = self.model.actor_dist(mb["obs"])
            return mb, mu, std, self.model.value(mb["critic_obs"])
        return self._epochs(nmb, mb_size, forward)

    def _perm(self, n, keep, gen, perms):
        """The update's one shuffle: `perms` if given, else a permutation of
        range(n) from `gen`; its first `keep` entries, on the device."""
        if perms is None:
            if gen is None:
                raise ValueError("update shuffles with an explicit generator:"
                                 " pass gen or perms")
            perms = torch.randperm(n, generator=gen, device=self.device)
        return torch.as_tensor(perms, device=self.device).long()[:keep]

    def _epochs(self, nmb, count, forward, weight=None):
        """The minibatch loop: epochs x the `nmb` minibatches of `count`
        samples each, each one clipped-PPO Adam step on all parameters.
        `forward(slot)` gives (mb, mu, std, values): minibatch `slot` (a
        dict of MB_FIELDS, returns and advantages) and the model's outputs
        on it; `weight`, if given, zeroes padding samples. The adaptive-KL LR is set from each minibatch's KL before
        its step. Returns the means of the losses and the final LR."""
        cfg = self.cfg
        params = list(self.model.parameters())
        adaptive = cfg.schedule == "adaptive" and cfg.desired_kl is not None
        lr, opt, stats = self.lr, self.opt, []
        for _ in range(cfg.num_learning_epochs):
            for slot in range(nmb):
                mb, mu, std, values = forward(slot)
                loss, st = ppo_loss(cfg, mu, std, values, mb, count, weight)
                # the KL over all samples of the minibatch
                kl_sum = (common.weighted_sum(common.kl_divergence(
                    mu.detach(), std.detach(), mb["mu"], mb["sigma"]),
                    weight) if adaptive else None)
                opt, lr = common.minibatch_step(
                    loss, params, opt, lr, cfg.max_grad_norm, kl_sum, count,
                    cfg.desired_kl)
                stats.append(torch.stack(st).detach())
        self.lr.copy_(lr)          # the Adam state advanced in place
        s = torch.stack(stats).mean(dim=0)
        return {"value_loss": s[0], "surrogate_loss": s[1], "entropy": s[2],
                "learning_rate": lr}
