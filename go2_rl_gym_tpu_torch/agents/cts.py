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
the model's, updated in place. Nothing in `update` reads a value back to the
host: its metrics are tensors on the device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from go2_rl_gym_tpu_torch.agents import common
from go2_rl_gym_tpu_torch.agents.networks import CTSFamily, make_cts_model
from go2_rl_gym_tpu_torch.env.config import AlgorithmCfg, PolicyCfg

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

        # static env split (reference cts.py:93-101)
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
        self.is_student = torch.as_tensor(is_student, device=self.device)
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
        CTS.init, cts.py:121-131); the parameters are left as they are."""
        p1, p2 = self.param_groups()
        self.opt1 = common.adam_init(p1)
        self.opt2 = common.adam_init(p2)
        self.lr = torch.tensor(self.cfg.learning_rate, dtype=torch.float32,
                               device=self.device)
        # optimizer 2's learning rate is constant
        self.lr2 = torch.tensor(self.cfg.student_encoder_learning_rate,
                                dtype=torch.float32, device=self.device)

    def train_state_dict(self) -> Dict:
        """Everything the update carries: model weights, both Adam states,
        the learning rate."""
        return {"model": self.model.state_dict(),
                "opt1": self.opt1._asdict(), "opt2": self.opt2._asdict(),
                "lr": self.lr}

    def load_train_state_dict(self, sd: Dict):
        self.model.load_state_dict(sd["model"])
        dev = self.device
        self.opt1, self.opt2 = (
            common.AdamState(count=o["count"].to(dev),
                             mu=[t.to(dev) for t in o["mu"]],
                             nu=[t.to(dev) for t in o["nu"]])
            for o in (sd["opt1"], sd["opt2"]))
        self.lr = sd["lr"].to(dev)

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
        (N, T) flattened storage, on the device (made once per T: a copy
        from the host would wait for the device)."""
        if T not in self._flat_idx:
            ar = np.arange(T)[None, :]
            self._flat_idx[T] = tuple(
                torch.as_tensor((envs[:, None] * T + ar).reshape(-1),
                                device=self.device)
                for envs in (self.teacher_envs, self.student_envs))
        return self._flat_idx[T]

    def _ppo_loss(self, mb, tmb):
        """Pass-1 loss on one minibatch (teacher samples first). Returns
        (loss, (value loss, surrogate, entropy, actor load balance), mu,
        std)."""
        cfg, model = self.cfg, self.model
        with torch.no_grad():
            lat_s, _ = model.s_latent(mb["history"][tmb:])
        lat_t = model.t_latent(mb["critic_obs"][:tmb])
        latent = torch.cat([lat_t, lat_s], dim=0)
        mu, std, _ = model.dist(latent, mb["obs"])
        logp = common.gaussian_log_prob(mu, std, mb["actions"])
        lat_sg = latent.detach()
        values, ac_w = model.val(lat_sg, mb["critic_obs"], mb["obs"])
        entropy = common.gaussian_entropy(std).mean()
        surr = common.surrogate_loss(logp, mb["log_probs"], mb["advantages"],
                                     cfg.clip_param)
        surr_loss = surr[:tmb].mean() + surr[tmb:].mean()
        vloss = common.clipped_value_loss(
            values, mb["values"], mb["returns"], cfg.clip_param,
            cfg.use_clipped_value_loss).mean()
        loss = surr_loss + cfg.value_loss_coef * vloss \
            - cfg.entropy_coef * entropy
        ac_lb = torch.zeros((), device=loss.device)
        if self.family in ACTOR_MOE:
            mean_usage = torch.mean(ac_w, dim=0)
            ac_lb = torch.mean(torch.square(mean_usage
                                            - 1.0 / model.expert_num))
            loss = loss + cfg.load_balance_coef * ac_lb
        return loss, (vloss, surr_loss, entropy, ac_lb), mu, std

    def _distill_loss(self, hist, priv):
        """Pass-2 loss on the student samples of one minibatch. Returns
        (loss, (latent loss, student load balance))."""
        model = self.model
        s_lat, gate = model.s_latent(hist)
        with torch.no_grad():
            t_lat = model.t_latent(priv)
        latent_loss = torch.mean(torch.square(t_lat - s_lat))
        loss, lb = latent_loss, torch.zeros((), device=latent_loss.device)
        if self.family in STUDENT_MOE:
            mean_usage = torch.mean(gate, dim=0)
            lb = torch.mean(torch.square(mean_usage - 1.0 / model.expert_num))
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
        torch.randperm from `gen`. Returns the metrics as 0-d tensors."""
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
        # one shuffle reused across epochs, teacher-first per minibatch;
        # the shuffled pools are gathered once, minibatches are slices
        idx = torch.cat([t_pos[t_perm].reshape(nmb, tmb),
                         s_pos[s_perm].reshape(nmb, smb)], dim=1).reshape(-1)
        # env-major position n*T + t (rollout_storage_cts.py:175-192) ->
        # row t*N + n of the (T, N) storage: no transposed copy is made
        rows = (idx % T) * N + idx // T

        def shuffle(x):
            flat = x.reshape((T * N,) + x.shape[2:])
            return flat[rows].reshape((nmb, tmb + smb) + x.shape[2:])

        pools = {k: shuffle(getattr(batch, k)) for k in _MB_FIELDS}
        pools["returns"] = shuffle(returns)
        pools["advantages"] = shuffle(advantages)
        slots = [s for _ in range(cfg.num_learning_epochs) for s in range(nmb)]
        p1, p2 = self.param_groups()
        adaptive = cfg.schedule == "adaptive" and cfg.desired_kl is not None

        # ---------------- pass 1: PPO on optimizer 1 ----------------
        lr, opt1, stats1 = self.lr, self.opt1, []
        for slot in slots:
            mb = {k: v[slot] for k, v in pools.items()}
            loss, stats, mu, std = self._ppo_loss(mb, tmb)
            grads = torch.autograd.grad(loss, p1)
            if adaptive:     # this minibatch's KL sets the step's lr
                lr, _ = common.adaptive_kl_lr(lr, mu.detach(), std.detach(),
                                              mb["mu"], mb["sigma"],
                                              cfg.desired_kl)
            opt1 = common.adam_step(p1, grads, opt1, lr, cfg.max_grad_norm)
            stats1.append(torch.stack(stats).detach())

        # ------- pass 2: distillation on optimizer 2 (updated teacher) -------
        opt2, stats2 = self.opt2, []
        for slot in slots:
            loss, stats = self._distill_loss(pools["history"][slot][tmb:],
                                             pools["critic_obs"][slot][tmb:])
            grads = torch.autograd.grad(loss, p2)
            opt2 = common.adam_step(p2, grads, opt2, self.lr2,
                                    cfg.max_grad_norm)
            stats2.append(torch.stack(stats).detach())
        self.opt1, self.opt2, self.lr = opt1, opt2, lr

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
