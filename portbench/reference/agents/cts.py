"""Concurrent Teacher-Student PPO, all six variants
(PyTorch port of go2_rl_gym_tpu/agents/cts.py).

The variant differences live in the model (`CTSFamily`); this file holds
the shared training skeleton:

* Static teacher/student env split by the reference's stride rule (env i is
  a student iff ``i % int(1/(1-teacher_env_ratio)) == 0``, cts.py:93-101);
  transitions stay in natural env order and minibatches gather through
  static teacher/student flat index arrays, teacher samples first
  (rollout_storage_cts.py:153-216).
* Update pass 1 (optimizer 1 = teacher encoder + actor + critic [+ std]):
  clipped PPO with surrogate = teacher mean + student mean
  (cts.py:222-231), adaptive-KL LR, grad clip.
* Update pass 2 (optimizer 2 = student encoder): latent distillation MSE
  against the detached teacher latent (+ MoE load balance,
  moe_cts.py:205-216) over student samples only.

The train state (the model's two parameter groups, two Adam states and the
learning rate as a 0-d fp32 tensor) lives in this object; the parameters are
the model's, updated in place. Nothing in `update` reads a value back to
the host: its metrics are tensors on the device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.agents import common
from portbench.reference.agents.networks import CTSFamily, make_cts_model
from portbench.reference.env.config import AlgorithmCfg, PolicyCfg

STUDENT_PARAM_KEYS = ("student_encoder",)

# which algorithm name maps to which model family + loss extras
ALGO_TO_FAMILY = {
    "CTS": "cts",
    "MoECTS": "moe_cts",
    "MoENGCTS": "moe_ng_cts",
    "MCPCTS": "mcp_cts",
    "ACMoECTS": "ac_moe_cts",
    "DualMoECTS": "dual_moe_cts",
}
# variants whose student encoder is a MoE (load-balance in the distill pass)
STUDENT_MOE = ("moe_cts", "moe_ng_cts", "dual_moe_cts")
# variants with actor-critic MoE (load-balance joins the PPO pass)
ACTOR_MOE = ("ac_moe_cts", "dual_moe_cts")


def split_params(model: CTSFamily):
    """(names1, params1), (names2, params2): the student encoder's
    parameters form group 2, every other parameter group 1 (reference
    cts.py:73-80), each in `named_parameters` order."""
    g1, g2 = [], []
    for name, p in model.named_parameters():
        (g2 if name.split(".")[0] in STUDENT_PARAM_KEYS else g1).append(
            (name, p))
    return tuple(zip(*g1)), tuple(zip(*g2))


class Transition(NamedTuple):
    """(N, ...) per step; stacked to (T, N, ...) by the rollout."""
    obs: torch.Tensor
    critic_obs: torch.Tensor
    history: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


# the fields a minibatch reads (rewards and dones only feed GAE)
_MB_FIELDS = ("obs", "critic_obs", "history", "actions", "values",
              "log_probs", "mu", "sigma")


class CTS:
    def __init__(self, algorithm: str, num_obs: int, num_critic_obs: int,
                 num_actions: int, num_envs: int, history_length: int,
                 policy_cfg: PolicyCfg, alg_cfg: AlgorithmCfg, device):
        if algorithm not in ALGO_TO_FAMILY:
            raise ValueError(f"unknown algorithm {algorithm!r}; "
                             f"known: {sorted(ALGO_TO_FAMILY)}")
        self.cfg = alg_cfg
        self.family = ALGO_TO_FAMILY[algorithm]
        self.algorithm = algorithm
        self.device = torch.device(device)
        self.model: CTSFamily = make_cts_model(
            self.family, num_obs, num_critic_obs, num_actions, policy_cfg,
            history_length, device=self.device)
        self.num_obs = num_obs
        self.num_critic_obs = num_critic_obs
        self.num_actions = num_actions
        self.num_envs = num_envs
        self.history_length = history_length

        # static env split over the global env ids (reference cts.py:93-101)
        ratio = alg_cfg.teacher_env_ratio
        stride = int(round(1.0 / (1.0 - ratio)))
        self.student_envs = np.array(
            [i for i in range(num_envs) if i % stride == 0], np.int64)
        self.teacher_envs = np.array(
            [i for i in range(num_envs) if i % stride != 0], np.int64)
        self.num_teacher = len(self.teacher_envs)
        self.num_student = len(self.student_envs)
        is_student = np.zeros(num_envs, bool)
        is_student[self.student_envs] = True
        # the rollout's mask
        self.is_student = torch.as_tensor(
            is_student, device=self.device)
        self._envs_t = tuple(torch.as_tensor(e, device=self.device)
                             for e in (self.teacher_envs, self.student_envs))
        self._flat_idx = {}
        self.reset_train_state()

    # ------------------------------------------------------------------
    # Train state
    # ------------------------------------------------------------------

    def param_groups(self):
        """(params1, params2) of the current model (split_params)."""
        (_, p1), (_, p2) = split_params(self.model)
        return p1, p2

    def reset_train_state(self):
        """Fresh Adam states and the configured learning rate (JAX
        CTS.init, cts.py:121-131); the parameters are left as they are.
        The train state is made on the first call and written in place
        after that, as `update` writes it: it keeps its storage, so a
        captured graph of the update goes on reading it."""
        if not hasattr(self, "opt1"):
            p1, p2 = self.param_groups()
            self.opt1 = common.adam_init(p1)
            self.opt2 = common.adam_init(p2)
            self.lr = torch.empty((), dtype=torch.float32,
                                  device=self.device)
            # optimizer 2's learning rate is constant
            self.lr2 = torch.empty((), dtype=torch.float32,
                                   device=self.device)
        common.adam_reset(self.opt1)
        common.adam_reset(self.opt2)
        self.lr.fill_(self.cfg.learning_rate)
        self.lr2.fill_(self.cfg.student_encoder_learning_rate)

    def train_state_dict(self) -> Dict:
        """Everything the update carries: model weights, both Adam states,
        the learning rate."""
        return {"model": self.model.state_dict(),
                "opt1": self.opt1._asdict(), "opt2": self.opt2._asdict(),
                "lr": self.lr}

    def load_train_state_dict(self, sd: Dict):
        """`train_state_dict`'s values, copied into the train state's
        storage (as `reset_train_state` writes it)."""
        self.model.load_state_dict(sd["model"])
        common.adam_load(self.opt1, sd["opt1"])
        common.adam_load(self.opt2, sd["opt2"])
        self.lr.copy_(sd["lr"])

    # ------------------------------------------------------------------
    # Rollout side
    # ------------------------------------------------------------------

    def _latent(self, obs, priv, history):
        """Merged latent: teacher envs use the privileged encoder, student
        envs their (detached) history encoder (actor_critic_cts.py:150-157)."""
        t_lat = self.model.t_latent(priv)
        s_lat, _ = self.model.s_latent(history)
        return torch.where(self.is_student[:, None], s_lat.detach(), t_lat)

    @torch.no_grad()
    def act(self, obs, priv, history, gen: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
        """Sample actions: mu + std * noise, the standard normal `noise`
        drawn from `gen` unless given (common.draw_noise). Returns (actions,
        values, logp, mu, std), all rollout data without gradient history."""
        latent = self._latent(obs, priv, history)
        mu, std, _ = self.model.dist(latent, obs)
        std = std.detach()      # a view of the parameter keeps requires_grad
        actions = mu + std * common.draw_noise(mu, gen, noise)
        logp = common.gaussian_log_prob(mu, std, actions)
        values = self._value(latent, priv, obs)
        return actions, values, logp, mu, std

    def _value(self, latent, priv, obs):
        # obs feeds the actor-MoE families' gating; the others ignore it
        v, _ = self.model.val(latent.detach(), priv, obs)
        return v

    @torch.no_grad()
    def value(self, obs, priv, history):
        return self._value(self._latent(obs, priv, history), priv, obs)

    def process_rewards(self, rewards, values, time_outs, gamma):
        """Bootstrap on time-outs (reference ppo.py:97-100)."""
        return rewards + gamma * values * time_outs.to(torch.float32)

    # ------------------------------------------------------------------
    # Update
    # ------------------------------------------------------------------

    def _flat_indices(self, T):
        """Static flat positions of teacher/student samples in env-major
        (N, T) flattened storage of the global batch, on the device (made
        once per T, from the env split already there: a copy from the host
        would wait for the device)."""
        if T not in self._flat_idx:
            ar = torch.arange(T, device=self.device)[None, :]
            self._flat_idx[T] = tuple((envs[:, None] * T + ar).reshape(-1)
                                      for envs in self._envs_t)
        return self._flat_idx[T]

    def _load_balance(self, gate, count, weight=None):
        """The MoE load-balance term of a minibatch of `count` samples of
        whose gate weights `gate` holds (padding weighted 0 by `weight`):
        mean((mean usage - 1/E)^2)."""
        usage = common.weighted_sum(gate, weight, dim=0)
        return torch.mean(torch.square(usage / count
                                       - 1.0 / self.model.expert_num))

    def _ppo_loss(self, mb, tc, tmb, smb, weight=None):
        """Pass-1 loss on this rank's share of one minibatch of `tmb`
        teacher and `smb` student samples: its `tc` teacher rows first,
        then its student rows, padding weighted 0 by `weight`. Returns
        (loss, (value loss, surrogate, entropy, actor load balance), mu,
        std), each this rank's share."""
        cfg, model = self.cfg, self.model
        wsum = common.weighted_sum
        with torch.no_grad():
            lat_s, _ = model.s_latent(mb["history"][tc:])
        lat_t = model.t_latent(mb["critic_obs"][:tc])
        latent = torch.cat([lat_t, lat_s], dim=0)
        mu, std, _ = model.dist(latent, mb["obs"])
        logp = common.gaussian_log_prob(mu, std, mb["actions"])
        lat_sg = latent.detach()
        values, ac_w = model.val(lat_sg, mb["critic_obs"], mb["obs"])
        entropy = wsum(common.gaussian_entropy(std), weight) / (tmb + smb)
        surr = common.surrogate_loss(logp, mb["log_probs"], mb["advantages"],
                                     cfg.clip_param)
        w_t, w_s = (None, None) if weight is None else (weight[:tc],
                                                        weight[tc:])
        surr_loss = wsum(surr[:tc], w_t) / tmb + wsum(surr[tc:], w_s) / smb
        vloss = wsum(common.clipped_value_loss(
            values, mb["values"], mb["returns"], cfg.clip_param,
            cfg.use_clipped_value_loss), weight) / (tmb + smb)
        loss = surr_loss + cfg.value_loss_coef * vloss \
            - cfg.entropy_coef * entropy
        ac_lb = torch.zeros((), device=loss.device)
        if self.family in ACTOR_MOE:
            ac_lb = self._load_balance(ac_w, tmb + smb, weight)
            loss = loss + cfg.load_balance_coef * ac_lb
        return loss, (vloss, surr_loss, entropy, ac_lb), mu, std

    def _distill_loss(self, hist, priv, smb, weight=None):
        """Pass-2 loss on this rank's share of the student samples of one
        minibatch of `smb` student samples, padding weighted 0 by
        `weight`. Returns (loss, (latent loss, student load balance)), each
        this rank's share."""
        model = self.model
        s_lat, gate = model.s_latent(hist)
        with torch.no_grad():
            t_lat = model.t_latent(priv)
        latent_loss = common.weighted_sum(
            torch.square(t_lat - s_lat), weight) / (smb * s_lat.shape[-1])
        loss, lb = latent_loss, torch.zeros((), device=latent_loss.device)
        if self.family in STUDENT_MOE:
            lb = self._load_balance(gate, smb, weight)
            loss = loss + self.cfg.load_balance_coef * lb
        return loss, (latent_loss, lb)

    def update(self, batch: Transition, returns, advantages,
               gen: Optional[torch.Generator] = None, perms=None):
        """One PPO pass on optimizer 1, then one distillation pass on
        optimizer 2, over `num_learning_epochs` x `num_mini_batches`
        minibatches (JAX cts.py:181-313).

        The teacher and student sample pools are shuffled once per update:
        by `perms` = (teacher permutation, student permutation) of
        range(num_teacher * T) and range(num_student * T) if given, else by
        torch.randperm from `gen`. Nothing is read back and every shape is
        fixed. Returns the metrics as 0-d tensors."""
        cfg = self.cfg
        T, N = batch.rewards.shape
        nmb = cfg.num_mini_batches
        tmb = self.num_teacher * T // nmb
        smb = self.num_student * T // nmb
        dev = self.device

        t_pos, s_pos = self._flat_indices(T)
        if perms is None:
            if gen is None:
                raise ValueError("update shuffles with an explicit generator:"
                                 " pass gen or perms")
            perms = (torch.randperm(len(t_pos), generator=gen, device=dev),
                     torch.randperm(len(s_pos), generator=gen, device=dev))
        t_perm, s_perm = (torch.as_tensor(p, device=dev).long() for p in perms)
        # one shuffle reused across epochs, teacher-first per minibatch
        tc = tmb
        idx = torch.cat([t_pos[t_perm].reshape(nmb, tmb),
                         s_pos[s_perm].reshape(nmb, smb)], dim=1)
        # the samples a minibatch reads in one buffer; env-major position
        # n*T + t (rollout_storage_cts.py:175-192) -> its row t*N + n: no
        # transposed copy
        fields = {k: getattr(batch, k) for k in _MB_FIELDS}
        fields.update(returns=returns, advantages=advantages)
        samples, layout = common.gather_fields(fields, 2)
        rows = (idx % T) * N + idx // T
        # the shuffled shares gathered once, minibatches are slices
        pools = common.split_fields(samples[rows], layout)
        slots = [s for _ in range(cfg.num_learning_epochs) for s in range(nmb)]
        p1, p2 = self.param_groups()
        adaptive = cfg.schedule == "adaptive" and cfg.desired_kl is not None

        # ---------------- pass 1: PPO on optimizer 1 ----------------
        lr, opt1, stats1 = self.lr, self.opt1, []
        for slot in slots:
            mb = {k: v[slot] for k, v in pools.items()}
            loss, stats, mu, std = self._ppo_loss(mb, tc, tmb, smb)
            # this minibatch's KL sets the step's lr
            kl_sum = (common.weighted_sum(common.kl_divergence(
                mu.detach(), std.detach(), mb["mu"], mb["sigma"]))
                      if adaptive else None)
            opt1, lr = common.minibatch_step(
                loss, p1, opt1, lr, cfg.max_grad_norm, kl_sum, tmb + smb,
                cfg.desired_kl)
            stats1.append(torch.stack(stats).detach())

        # ------- pass 2: distillation on optimizer 2 (updated teacher) -------
        opt2, stats2 = self.opt2, []
        for slot in slots:
            loss, stats = self._distill_loss(pools["history"][slot, tc:],
                                             pools["critic_obs"][slot, tc:],
                                             smb)
            opt2, _ = common.minibatch_step(loss, p2, opt2, self.lr2,
                                            cfg.max_grad_norm)
            stats2.append(torch.stack(stats).detach())
        self.lr.copy_(lr)          # the Adam states advanced in place

        s1 = torch.stack(stats1).mean(dim=0)
        s2 = torch.stack(stats2).mean(dim=0)
        metrics = {"value_loss": s1[0], "surrogate_loss": s1[1],
                   "entropy": s1[2], "latent_loss": s2[0],
                   "learning_rate": lr}
        if self.family in STUDENT_MOE:
            metrics["load_balance_loss"] = s2[1]
        if self.family in ACTOR_MOE:
            metrics["actor_load_balance_loss"] = s1[3]
        return metrics
