"""Recurrent actor-critic (LSTM/GRU memory) + trajectory padding utilities
(PyTorch port of go2_rl_gym_tpu/agents/recurrent.py).

Counterparts of reference rsl_rl/modules/actor_critic_recurrent.py:40-116 and
rsl_rl/utils/utils.py:33-71 (split_and_pad_trajectories / unpad_trajectories).
The memory is carried explicitly in the rollout, not hidden module state.

The cells are flax's, gate for gate, so that the JAX package's parameter tree
(``memory_a/cell/<gate>/{kernel,bias}``) maps one to one onto the port's
parameter names (``memory_a.cell.<gate>.{weight,bias}``):

* ``LSTMCell`` = ``flax.linen.OptimizedLSTMCell``: input kernels ``ii, if,
  ig, io`` without bias, hidden kernels ``hi, hf, hg, ho`` with bias;
  ``i, f, o = sigmoid``, ``g = tanh``, ``c' = f c + i g``, ``h' = o tanh(c')``.
* ``GRUCell`` = ``flax.linen.GRUCell``: ``ir, iz, in`` with bias, ``hr, hz``
  without, ``hn`` with; ``n = tanh(in(x) + r hn(h))``, ``h' = (1-z) n + z h``.

Each side runs as one matmul over its gates concatenated in flax's order
(``fused``); the update's sequence replay concatenates once per window.
Initialisation is flax's, from an explicit generator: input kernels
lecun_normal (truncated normal, variance 1/fan_in), hidden kernels
orthogonal, biases zero.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from go2_rl_gym_tpu_torch.agents.networks import MLP


class LSTMState(NamedTuple):
    h: torch.Tensor   # (N, hidden)
    c: torch.Tensor


def _gate(fan_in, fan_out, bias, device):
    # skip_init: the parameters are filled by init_from
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=bias,
                              device=device)


# the truncation of jax.random.truncated_normal in lecun_normal, and the
# factor that gives the truncated draw unit variance (flax variance_scaling)
_TRUNC = 2.0
_TRUNC_STD = .87962566103423978


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, gen: torch.Generator):
    """Truncated normal on [-2, 2] by the inverse CDF, scaled to variance
    1/fan_in (torch weight (out, in): fan_in = in)."""
    lo = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(w.shape, generator=gen,
                                           device=gen.device)
    z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-_TRUNC, _TRUNC)
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    w.copy_((z * std).to(w.device))


@torch.no_grad()
def _orthogonal_(w: torch.Tensor, gen: torch.Generator):
    """A uniformly distributed orthogonal matrix (QR of a normal draw with
    the signs of R's diagonal, as jax.random.orthogonal)."""
    a = torch.randn(w.shape, generator=gen, device=gen.device)
    q, r = torch.linalg.qr(a)
    w.copy_((q * torch.sign(torch.diagonal(r))[None, :]).to(w.device))


class _Cell(nn.Module):
    """Shared init: kernels whose name starts with "i" take the input,
    "h" the hidden state."""

    @torch.no_grad()
    def init_from(self, gen: torch.Generator):
        for name, lin in self.named_children():
            (_lecun_normal_ if name[0] == "i" else _orthogonal_)(lin.weight,
                                                                 gen)
            if lin.bias is not None:
                lin.bias.zero_()


class LSTMCell(_Cell):
    """flax.linen.OptimizedLSTMCell (see the module docstring)."""
    GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        for g in self.GATES:
            self.add_module("i" + g, _gate(in_dim, hidden, False, device))
            self.add_module("h" + g, _gate(hidden, hidden, True, device))

    def fused(self):
        """(input kernel (4H, in), hidden kernel (4H, H), hidden bias (4H,)),
        the gates in flax's order i, f, g, o."""
        gi = [getattr(self, "i" + g) for g in self.GATES]
        gh = [getattr(self, "h" + g) for g in self.GATES]
        return (torch.cat([m.weight for m in gi]),
                torch.cat([m.weight for m in gh]),
                torch.cat([m.bias for m in gh]))

    def forward(self, x, state: LSTMState, fused=None) -> LSTMState:
        w_x, w_h, b_h = self.fused() if fused is None else fused
        # flax adds the hidden side (with its bias) to the input side
        z = F.linear(state.h, w_h, b_h) + F.linear(x, w_x)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * state.c + torch.sigmoid(i) * torch.tanh(g)
        return LSTMState(h=torch.sigmoid(o) * torch.tanh(c), c=c)


class GRUCell(_Cell):
    """flax.linen.GRUCell (see the module docstring); the carried `c` passes
    through unchanged."""
    GATES = ("r", "z", "n")

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        for g in self.GATES:
            self.add_module("i" + g, _gate(in_dim, hidden, True, device))
            self.add_module("h" + g, _gate(hidden, hidden, g == "n", device))

    def fused(self):
        """(input kernel (3H, in), input bias (3H,), hidden kernel (3H, H),
        hidden bias (3H,) = [0, 0, b_hn]), the gates in flax's order r, z,
        n. Adding the zeros is exact."""
        gi = [getattr(self, "i" + g) for g in self.GATES]
        hr, hz, hn = (getattr(self, "h" + g) for g in self.GATES)
        zero = torch.zeros_like(hn.bias)
        return (torch.cat([m.weight for m in gi]),
                torch.cat([m.bias for m in gi]),
                torch.cat([hr.weight, hz.weight, hn.weight]),
                torch.cat([zero, zero, hn.bias]))

    def forward(self, x, state: LSTMState, fused=None) -> LSTMState:
        w_x, b_x, w_h, b_h = self.fused() if fused is None else fused
        xr, xz, xn = F.linear(x, w_x, b_x).chunk(3, dim=-1)
        hr, hz, hn = F.linear(state.h, w_h, b_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return LSTMState(h=(1.0 - z) * n + z * state.h, c=state.c)


class Memory(nn.Module):
    """Single-layer LSTM/GRU front-end (reference Memory, :92-116)."""

    def __init__(self, in_dim: int, hidden_size: int = 256,
                 rnn_type: str = "lstm", device=None):
        super().__init__()
        cells = {"lstm": LSTMCell, "gru": GRUCell}
        if rnn_type not in cells:
            raise ValueError(f"unknown rnn_type {rnn_type!r}; "
                             f"known: {sorted(cells)}")
        self.cell = cells[rnn_type](in_dim, hidden_size, device)

    def forward(self, x, state: LSTMState, fused=None):
        """Returns (output features = new h, new state)."""
        state = self.cell(x, state, fused)
        return state.h, state

    @staticmethod
    def zero_state(batch: int, hidden_size: int, device=None) -> LSTMState:
        return LSTMState(h=torch.zeros((batch, hidden_size), device=device),
                         c=torch.zeros((batch, hidden_size), device=device))


class ActorCriticRecurrent(nn.Module):
    """LSTM/GRU memory before the actor and critic MLPs
    (reference actor_critic_recurrent.py:40-91). `fused`, where a method
    takes it, is its memory cell's `fused()`, made once by a caller that
    steps the cell many times."""

    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 actor_hidden_dims=(256, 256, 128),
                 critic_hidden_dims=(256, 256, 128), rnn_hidden_size=256,
                 rnn_type="lstm", activation="elu", init_noise_std=1.0,
                 device=None):
        super().__init__()
        self.init_noise_std = init_noise_std
        self.memory_a = Memory(num_obs, rnn_hidden_size, rnn_type, device)
        self.memory_c = Memory(num_critic_obs, rnn_hidden_size, rnn_type,
                               device)
        self.actor = MLP(rnn_hidden_size,
                         list(actor_hidden_dims) + [num_actions], activation,
                         device=device)
        self.critic = MLP(rnn_hidden_size, list(critic_hidden_dims) + [1],
                          activation, device=device)
        self.std = nn.Parameter(torch.empty((num_actions,), device=device))

    def actor_dist(self, obs, state: LSTMState, fused=None):
        """Returns (mu, std broadcast to mu's shape, new actor memory)."""
        feat, state = self.memory_a(obs, state, fused)
        mu = self.actor(feat)
        return mu, self.std.expand(mu.shape), state

    def value(self, critic_obs, state: LSTMState, fused=None):
        """Returns (value, new critic memory)."""
        feat, state = self.memory_c(critic_obs, state, fused)
        return self.critic(feat)[..., 0], state

    @staticmethod
    def reset_state(state: LSTMState, dones) -> LSTMState:
        mask = (~dones)[:, None].to(torch.float32)
        return LSTMState(h=state.h * mask, c=state.c * mask)


def _traj_indices(dones: torch.Tensor):
    T, N = dones.shape[:2]
    dev = dones.device
    dones = dones.to(torch.bool)
    starts = torch.cat([torch.ones((1, N), dtype=torch.bool, device=dev),
                        dones[:-1]], dim=0)
    traj_id_within = torch.cumsum(starts.to(torch.int64), dim=0) - 1
    env_ids = torch.arange(N, device=dev)[None, :].expand(T, N)
    global_id = env_ids * T + traj_id_within
    t = torch.arange(T, device=dev)[:, None]
    step_in_traj = t - torch.cummax(torch.where(starts, t, 0), dim=0).values
    return step_in_traj, global_id


def split_and_pad_trajectories(tensor: torch.Tensor, dones: torch.Tensor):
    """Split (T, N, ...) rollouts at episode boundaries and pad to length T.

    Returns (padded (T, N * T, ...), mask (T, N * T)): the fixed upper bound
    of N * T trajectories, unused slots masked out, as the JAX package does
    (reference rsl_rl/utils/utils.py:33-62)."""
    T, N = dones.shape[:2]
    step_in_traj, global_id = _traj_indices(dones)
    rows, cols = step_in_traj.reshape(-1), global_id.reshape(-1)
    padded = tensor.new_zeros((T, N * T) + tuple(tensor.shape[2:]))
    mask = torch.zeros((T, N * T), dtype=torch.bool, device=dones.device)
    padded[rows, cols] = tensor.reshape((T * N,) + tuple(tensor.shape[2:]))
    mask[rows, cols] = True
    return padded, mask


def unpad_trajectories(padded: torch.Tensor, dones: torch.Tensor):
    """Inverse of split_and_pad_trajectories: gather back to (T, N, ...)
    (reference utils.py:64-71)."""
    step_in_traj, global_id = _traj_indices(dones)
    return padded[step_in_traj, global_id]
