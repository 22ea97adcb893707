"""Policy / value networks (PyTorch port of go2_rl_gym_tpu/agents/networks.py).

The plain PPO actor-critic ``ActorCritic`` (reference
rsl_rl/modules/actor_critic.py) and the six concurrent teacher-student
families:

* ``CTSFamily('cts')``          <- rsl_rl/modules/actor_critic_cts.py:18-223
* ``CTSFamily('moe_cts')``      <- rsl_rl/modules/actor_critic_moe_cts.py:20-141
* ``CTSFamily('moe_ng_cts')``   <- rsl_rl/modules/actor_critic_moe_ng_cts.py:18-288
* ``CTSFamily('mcp_cts')``      <- rsl_rl/modules/actor_critic_mcp_cts.py:18-292
* ``CTSFamily('ac_moe_cts')``   <- rsl_rl/modules/actor_critic_ac_moe_cts.py:21-146
* ``CTSFamily('dual_moe_cts')`` <- rsl_rl/modules/actor_critic_dual_moe_cts.py:20-149

Module names follow the JAX package's parameter tree (teacher_encoder /
student_encoder / actor / critic / std; MLP layers fc0, fc1, ...), so
export/importer.params_from_jax can carry weights across one to one. Linear
weights are torch's (out, in); the per-expert heads keep the JAX layout
(E, H, O) and run as one einsum.

Parameters are initialised like torch's nn.Linear (uniform +-1/sqrt(fan_in)),
but from an explicit torch.Generator (`init_params`), never the global RNG.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

ACTIVATIONS = {
    "elu": F.elu,
    "relu": F.relu,
    "selu": F.selu,
    "crelu": F.relu,
    "lrelu": F.leaky_relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

def l2norm(x, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def simnorm(x, dim=8):
    shp = x.shape
    return torch.softmax(x.reshape(shp[:-1] + (-1, dim)), dim=-1).reshape(shp)


def apply_norm(x, norm_type):
    if norm_type == "l2norm":
        return l2norm(x)
    if norm_type == "simnorm":
        return simnorm(x)
    raise ValueError(norm_type)


def _linear(fan_in, fan_out, device):
    # skip_init: parameters are filled by init_params from a generator
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, device=device)


class MLP(nn.Module):
    """Linear stack: activation between layers; optional trailing activation
    (reference rsl_rl/modules/utils.py:51-67). Layers are fc0, fc1, ..."""

    def __init__(self, in_dim: int, dims: Sequence[int], activation="elu",
                 last_activation=False, device=None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.last_activation = last_activation
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"fc{i}", _linear(in_dim, d, device))
            in_dim = d

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1 or self.last_activation:
                x = self.act(x)
        return x


class Experts(nn.Module):
    """Shared backbone -> per-expert heads (replaces the grouped Conv1d at
    reference utils.py:83-94). Returns (B, E, out)."""

    def __init__(self, in_dim, expert_num, backbone_hidden_dims,
                 expert_hidden_dim, output_dim, activation="elu", device=None):
        super().__init__()
        E, H, O = expert_num, expert_hidden_dim, output_dim
        self.E, self.H = E, H
        self.backbone = MLP(in_dim, list(backbone_hidden_dims) + [E * H],
                            activation, last_activation=True, device=device)
        self.head_kernel = nn.Parameter(torch.empty((E, H, O), device=device))
        self.head_bias = nn.Parameter(torch.empty((E, O), device=device))

    def forward(self, x):
        feats = self.backbone(x)
        feats = feats.reshape(feats.shape[:-1] + (self.E, self.H))
        return torch.einsum("...eh,eho->...eo", feats,
                            self.head_kernel) + self.head_bias


class MoE(nn.Module):
    """Experts + softmax gating (reference utils.py:96-126).

    Returns (output (B, out), weights (B, E))."""

    def __init__(self, in_dim, expert_num, hidden_dims, output_dim,
                 activation="elu", device=None):
        super().__init__()
        self.experts = Experts(in_dim, expert_num, list(hidden_dims[:-1]),
                               hidden_dims[-1], output_dim, activation, device)
        self.gating = MLP(in_dim, list(hidden_dims[:-1]) + [expert_num],
                          activation, device=device)

    def forward(self, x):
        experts = self.experts(x)
        weights = torch.softmax(self.gating(x), dim=-1)
        return torch.sum(weights[..., None] * experts, dim=-2), weights


class StudentMoEEncoder(nn.Module):
    """MoE + latent norm (reference utils.py:128-151)."""

    def __init__(self, in_dim, expert_num, hidden_dims, output_dim,
                 activation="elu", norm_type="l2norm", device=None):
        super().__init__()
        self.norm_type = norm_type
        self.moe = MoE(in_dim, expert_num, hidden_dims, output_dim, activation,
                       device)

    def forward(self, x):
        latent, weights = self.moe(x)
        return apply_norm(latent, self.norm_type), weights


class StudentMoENGEncoder(nn.Module):
    """Goal-stripped experts + full-history gating
    (reference actor_critic_moe_ng_cts.py:185-242)."""

    def __init__(self, full_dim, no_goal_dim, expert_num, hidden_dims,
                 expert_hidden_dim, latent_dim, activation="elu",
                 norm_type="l2norm", device=None):
        super().__init__()
        self.norm_type = norm_type
        self.experts = Experts(no_goal_dim, expert_num, list(hidden_dims),
                               expert_hidden_dim, latent_dim, activation,
                               device)
        self.gating = MLP(full_dim, list(hidden_dims) + [expert_num],
                          activation, device=device)

    def forward(self, full, no_goal):
        experts = self.experts(no_goal)
        weights = torch.softmax(self.gating(full), dim=-1)
        latent = torch.sum(weights[..., None] * experts, dim=-2)
        return apply_norm(latent, self.norm_type), weights


class ActorMCP(nn.Module):
    """Multiplicative compositional policy head
    (reference actor_critic_mcp_cts.py:174-246): sigmoid gates over experts
    that each give (mu, log_std), composed by precision weighting."""

    def __init__(self, in_dim, no_goal_dim, action_dim, hidden_dims,
                 expert_num=8, expert_hidden_dim=256, activation="elu",
                 device=None):
        super().__init__()
        self.action_dim = action_dim
        self.gating = MLP(in_dim, list(hidden_dims) + [expert_num],
                          activation, device=device)
        self.experts = Experts(no_goal_dim, expert_num, list(hidden_dims),
                               expert_hidden_dim, 2 * action_dim, activation,
                               device)

    def forward(self, x, x_no_goal):
        weights = torch.sigmoid(self.gating(x))                     # (B,E)
        expert_out = self.experts(x_no_goal)
        mu, log_std = torch.split(expert_out, self.action_dim, dim=-1)
        log_std = torch.clamp(log_std, -5.0, 2.0)
        var = torch.exp(2 * log_std) + 1e-9
        w = weights[..., None]
        inv_var_sum = torch.sum(w / var, dim=-2) + 1e-9
        var_total = 1.0 / inv_var_sum
        sigma = torch.sqrt(var_total)
        mu_total = var_total * torch.sum(w * mu / var, dim=-2)
        return mu_total, sigma, weights


class ActorCritic(nn.Module):
    """Plain PPO actor-critic (JAX networks.py:219-246): an actor MLP on the
    obs, a critic MLP on the privileged obs, and a state-independent std."""

    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 actor_hidden_dims=(512, 256, 128),
                 critic_hidden_dims=(512, 256, 128), activation="elu",
                 init_noise_std=1.0, device=None):
        super().__init__()
        self.init_noise_std = init_noise_std
        self.actor = MLP(num_obs, list(actor_hidden_dims) + [num_actions],
                         activation, device=device)
        self.critic = MLP(num_critic_obs, list(critic_hidden_dims) + [1],
                          activation, device=device)
        self.std = nn.Parameter(torch.empty((num_actions,), device=device))

    def actor_dist(self, obs):
        """Returns (mu, std broadcast to mu's shape)."""
        mu = self.actor(obs)
        return mu, self.std.expand(mu.shape)

    def value(self, critic_obs):
        return self.critic(critic_obs)[..., 0]


CTS_FAMILIES = ("cts", "moe_cts", "moe_ng_cts", "mcp_cts", "ac_moe_cts",
                "dual_moe_cts")
# families whose student encoder is a MoE on the whole history
_STUDENT_MOE = ("moe_cts", "dual_moe_cts")
# families whose actor is a MoE and whose critic is experts gated by it
_AC_MOE = ("ac_moe_cts", "dual_moe_cts")


class CTSFamily(nn.Module):
    """One module for the six concurrent teacher-student families.

    Encoders produce a latent, the actor consumes (latent, obs), the critic
    consumes (latent, priv) (reference actor_critic_cts.py); for ac_moe_cts
    and dual_moe_cts the critic's experts are gated by the actor's gating
    on (latent, obs). Gradient stops are the algorithm's business: this
    module is pure."""

    def __init__(self, family: str, num_obs: int, num_critic_obs: int,
                 num_actions: int, history_length: int = 5,
                 actor_hidden_dims=(512, 256, 128),
                 critic_hidden_dims=(512, 256, 128),
                 teacher_encoder_hidden_dims=(512, 256),
                 student_encoder_hidden_dims=(512, 256),
                 activation="elu", init_noise_std=1.0, latent_dim=32,
                 norm_type="l2norm", expert_num=8, obs_no_goal_mask=None,
                 device=None):
        super().__init__()
        if family not in CTS_FAMILIES:
            raise ValueError(f"unknown family {family!r}; "
                             f"families: {CTS_FAMILIES}")
        self.family = family
        self.num_obs = num_obs
        self.history_length = history_length
        self.norm_type = norm_type
        self.expert_num = expert_num
        self.init_noise_std = init_noise_std
        hist_dim = num_obs * history_length
        if obs_no_goal_mask is not None:
            # a boolean mask with a static count: a fixed index gather
            idx = [i for i, keep in enumerate(obs_no_goal_mask) if keep]
            self.register_buffer(
                "no_goal_idx", torch.tensor(idx, dtype=torch.long,
                                            device=device), persistent=False)
            n_ng = len(idx)
        self.teacher_encoder = MLP(
            num_critic_obs, list(teacher_encoder_hidden_dims) + [latent_dim],
            activation, device=device)
        if family in _STUDENT_MOE:
            self.student_encoder = StudentMoEEncoder(
                hist_dim, expert_num, list(student_encoder_hidden_dims),
                latent_dim, activation, norm_type, device)
        elif family == "moe_ng_cts":
            self.student_encoder = StudentMoENGEncoder(
                hist_dim, n_ng * history_length, expert_num,
                list(student_encoder_hidden_dims), 256, latent_dim,
                activation, norm_type, device)
        else:
            self.student_encoder = MLP(
                hist_dim, list(student_encoder_hidden_dims) + [latent_dim],
                activation, device=device)

        actor_in = latent_dim + num_obs
        if family == "mcp_cts":
            # the reference passes the full actor_hidden_dims to ActorMCP
            # (actor_critic_mcp_cts.py:91-98)
            self.actor = ActorMCP(actor_in, latent_dim + n_ng, num_actions,
                                  list(actor_hidden_dims), expert_num, 256,
                                  activation, device)
        elif family in _AC_MOE:
            self.actor = MoE(actor_in, expert_num, list(actor_hidden_dims),
                             num_actions, activation, device)
        else:
            self.actor = MLP(actor_in, list(actor_hidden_dims) + [num_actions],
                             activation, device=device)

        critic_in = latent_dim + num_critic_obs
        if family in _AC_MOE:
            self.critic = Experts(critic_in, expert_num,
                                  list(critic_hidden_dims)[:-1],
                                  critic_hidden_dims[-1], 1, activation,
                                  device)
        else:
            self.critic = MLP(critic_in, list(critic_hidden_dims) + [1],
                              activation, device=device)
        if family != "mcp_cts":
            self.std = nn.Parameter(torch.empty((num_actions,), device=device))

    def t_latent(self, priv):
        """Teacher latent from privileged obs."""
        return apply_norm(self.teacher_encoder(priv), self.norm_type)

    def s_latent(self, history):
        """Student latent from the flattened obs history. Returns (latent,
        gate_w); gate_w is None for the non-MoE students."""
        if self.family in _STUDENT_MOE:
            return self.student_encoder(history)
        if self.family == "moe_ng_cts":
            B = history.shape[:-1]
            hist = history.reshape(B + (self.history_length, self.num_obs))
            no_goal = hist.index_select(-1, self.no_goal_idx).reshape(B + (-1,))
            return self.student_encoder(history, no_goal)
        return apply_norm(self.student_encoder(history), self.norm_type), None

    def dist(self, latent, obs):
        """Action distribution. Returns (mu, std, actor_gate_w or None)."""
        x = torch.cat([latent, obs], dim=-1)
        if self.family == "mcp_cts":
            x_ng = torch.cat([latent, obs.index_select(-1, self.no_goal_idx)],
                             dim=-1)
            return self.actor(x, x_ng)
        if self.family in _AC_MOE:
            mu, w = self.actor(x)
            return mu, self.std.expand(mu.shape), w
        mu = self.actor(x)
        return mu, self.std.expand(mu.shape), None

    def val(self, latent, priv, obs=None):
        """Value. For ac_moe_cts / dual_moe_cts the expert values are
        weighted by the actor's gating on (latent, obs). Returns (value,
        gate_w or None)."""
        x = torch.cat([latent, priv], dim=-1)
        if self.family in _AC_MOE:
            _, w = self.actor(torch.cat([latent, obs], dim=-1))
            expert_v = self.critic(x)[..., 0]           # (B, E)
            return torch.sum(w * expert_v, dim=-1), w
        return self.critic(x)[..., 0], None


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator):
    """torch-Linear-style init from `gen`: every Linear weight and bias
    U(+-1/sqrt(fan_in)), expert heads U(+-1/sqrt(H)), std = init_noise_std
    for every model that has one. A module with an `init_from(gen)` method
    (the recurrent cells) initialises its own subtree. Modules are visited
    in registration order, so a seed fixes the weights."""
    def uniform_(t, bound):
        t.copy_((torch.rand(t.shape, generator=gen, device=gen.device)
                 * 2.0 - 1.0).to(t.device) * bound)

    done = set()
    for m in model.modules():
        if id(m) in done:
            continue
        if hasattr(m, "init_from"):
            m.init_from(gen)
            done.update(id(s) for s in m.modules())
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, Experts):
            bound = 1.0 / math.sqrt(m.H)
            uniform_(m.head_kernel, bound)
            uniform_(m.head_bias, bound)
    if hasattr(model, "init_noise_std") and hasattr(model, "std"):
        model.std.fill_(model.init_noise_std)
    return model


def make_cts_model(family: str, num_obs: int, num_critic_obs: int,
                   num_actions: int, policy_cfg, history_length: int = 5,
                   device=None):
    """Factory from a PolicyCfg (env/config.py). The parameters are left
    uninitialised: fill them with init_params or export/importer."""
    if (family in ("moe_ng_cts", "mcp_cts")
            and policy_cfg.obs_no_goal_mask is None):
        # without the mask the goal-stripped expert input is zero-width and
        # the latent silently NaNs (fan_in 0): fail loudly instead
        raise ValueError(f"{family} requires policy_cfg.obs_no_goal_mask")
    return CTSFamily(
        family, num_obs, num_critic_obs, num_actions, history_length,
        actor_hidden_dims=tuple(policy_cfg.actor_hidden_dims),
        critic_hidden_dims=tuple(policy_cfg.critic_hidden_dims),
        teacher_encoder_hidden_dims=tuple(policy_cfg.teacher_encoder_hidden_dims),
        student_encoder_hidden_dims=tuple(policy_cfg.student_encoder_hidden_dims),
        activation=policy_cfg.activation,
        init_noise_std=policy_cfg.init_noise_std,
        latent_dim=policy_cfg.latent_dim, norm_type=policy_cfg.norm_type,
        expert_num=(policy_cfg.student_expert_num
                    if family in ("moe_ng_cts", "mcp_cts")
                    else policy_cfg.expert_num),
        obs_no_goal_mask=policy_cfg.obs_no_goal_mask, device=device)
