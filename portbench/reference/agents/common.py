"""Shared RL machinery (PyTorch port of go2_rl_gym_tpu/agents/common.py).

GAE as a reverse loop over time (reference rollout_storage.py:123-137), the
Gaussian log-prob and entropy, the clipped PPO losses, the adaptive-KL
learning rate (reference ppo.py:139-151), and the optimizer of the JAX
package: optax's clip-by-global-norm followed by Adam(0.9, 0.999, 1e-8), with
a learning rate that is a 0-d tensor on the device, so that the adaptive-KL
schedule never reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def gaussian_log_prob(mu, std, actions):
    """Diagonal normal log prob summed over the action dim (torch Normal
    semantics, actor_critic.py:159-160)."""
    var = std * std
    logp = (-0.5 * torch.square(actions - mu) / var
            - torch.log(std) - 0.5 * math.log(2.0 * math.pi))
    return torch.sum(logp, dim=-1)


def draw_noise(mu, gen: Optional[torch.Generator], noise):
    """The act noise: `noise` if given, else a standard normal draw of mu's
    shape from `gen`; nothing uses the global generator."""
    if noise is not None:
        return noise
    if gen is None:
        raise ValueError("act draws its noise from an explicit generator: "
                         "pass gen or noise")
    return torch.randn(mu.shape, generator=gen, device=mu.device)


def gaussian_entropy(std):
    """Sum over the action dim (actor_critic.py:143-144)."""
    return torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(std),
                     dim=-1)


def compute_gae(rewards, values, dones, last_values, gamma, lam):
    """Generalized advantage estimation, reverse loop over T.

    Args: rewards/values/dones (T, N); last_values (N,).
    Returns (returns (T, N), advantages normalized over the whole batch
    (T, N)). The normalization uses the mean and then the mean squared
    deviation over the T * N samples: the population std, as JAX's
    `jnp.std` computes it."""
    T = rewards.shape[0]
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    not_terminal = 1.0 - dones.to(torch.float32)
    deltas = rewards + not_terminal * gamma * next_values - values
    adv = torch.zeros_like(last_values)
    advs = [None] * T
    for t in range(T - 1, -1, -1):
        adv = deltas[t] + not_terminal[t] * gamma * lam * adv
        advs[t] = adv
    advs = torch.stack(advs)
    returns = advs + values
    count = advs.numel()
    mean = advs.sum() / count
    sq_dev = torch.square(advs - mean).sum()
    norm_advs = (advs - mean) / (torch.sqrt(sq_dev / count) + 1e-8)
    return returns, norm_advs


def kl_divergence(mu, sigma, old_mu, old_sigma):
    """Per-sample KL of the old diagonal Gaussian from the new one, summed
    over the action dim (reference ppo.py:141-144)."""
    return torch.sum(
        torch.log(sigma / old_sigma + 1e-5)
        + (torch.square(old_sigma) + torch.square(old_mu - mu))
        / (2.0 * torch.square(sigma)) - 0.5, dim=-1)


def kl_lr(lr, kl_mean, desired_kl):
    """The adaptive schedule's step (reference ppo.py:145-151): divide `lr`
    by 1.5 above twice the desired KL, multiply it below half; `lr` is a 0-d
    tensor and stays on its device."""
    lr = torch.where(kl_mean > desired_kl * 2.0,
                     torch.clamp(lr / 1.5, min=1e-5), lr)
    return torch.where((kl_mean < desired_kl / 2.0) & (kl_mean > 0.0),
                       torch.clamp(lr * 1.5, max=1e-2), lr)


def adaptive_kl_lr(lr, mu, sigma, old_mu, old_sigma, desired_kl):
    """KL-driven LR update (reference ppo.py:139-151) over the samples
    given. Returns (lr, kl_mean)."""
    kl_mean = torch.mean(kl_divergence(mu, sigma, old_mu, old_sigma))
    return kl_lr(lr, kl_mean, desired_kl), kl_mean


def minibatch_step(loss, params, opt: "AdamState", lr, max_grad_norm,
                   kl_sum=None, count=None, desired_kl=None):
    """One optimizer step on a minibatch: `loss` is the minibatch loss
    (sums over its counts), `kl_sum`, for the adaptive LR, the sum of its
    KLs (`kl_divergence`). The LR follows the minibatch's mean KL (over
    `count` samples), then the clip and Adam run. Returns (Adam state,
    lr)."""
    grads = list(torch.autograd.grad(loss, params))
    if kl_sum is not None:
        lr = kl_lr(lr, kl_sum / count, desired_kl)
    return adam_step(params, grads, opt, lr, max_grad_norm), lr


def weighted_sum(x, weight=None, dim=None):
    """`x` summed (over `dim`, else over everything), each sample scaled by
    its `weight` where one is given (a minibatch share's 1 / 0 padding
    mask, whose dims are x's leading dims)."""
    if weight is not None:
        x = x * weight.reshape(weight.shape + (1,) * (x.dim()
                                                     - weight.dim()))
    return x.sum() if dim is None else x.sum(dim=dim)


def stack_fields(fields: Dict[str, torch.Tensor], lead: int):
    """Tensors of one leading shape (`lead` dims) as one fp32 tensor
    (*lead, F), their trailing dims flattened side by side. Returns it and
    the layout that `split_fields` reads: (name, trailing shape) each."""
    shape = next(iter(fields.values())).shape[:lead]
    layout = [(k, tuple(v.shape[lead:])) for k, v in fields.items()]
    return torch.cat([v.reshape(shape + (-1,)).to(torch.float32)
                      for v in fields.values()], dim=-1), layout


def gather_fields(fields, lead: int):
    """The update's fields (name -> tensor whose `lead` leading dims are
    the samples) stacked (`stack_fields`) into one buffer, its sample dims
    flattened. Returns (samples (rows, F), layout)."""
    samples, layout = stack_fields(fields, lead)
    return samples.reshape(-1, samples.shape[-1]).contiguous(), layout


def split_fields(x, layout):
    """`stack_fields`' inverse on any leading dims: name -> a view of `x`'s
    columns with its trailing shape."""
    out, i = {}, 0
    for k, tail in layout:
        n = math.prod(tail)
        out[k] = x[..., i:i + n].reshape(x.shape[:-1] + tail)
        i += n
    return out


def surrogate_loss(logp, old_logp, advantages, clip_param):
    """Per-sample clipped surrogate (reference ppo.py:154-159), not reduced."""
    ratio = torch.exp(logp - old_logp)
    surr = -advantages * ratio
    surr_clipped = -advantages * torch.clamp(ratio, 1.0 - clip_param,
                                             1.0 + clip_param)
    return torch.maximum(surr, surr_clipped)


def clipped_value_loss(values, old_values, returns, clip_param,
                       use_clipped=True):
    """Per-sample clipped value loss (reference ppo.py:162-169), not
    reduced."""
    if use_clipped:
        clipped = old_values + torch.clamp(values - old_values, -clip_param,
                                           clip_param)
        return torch.maximum(torch.square(values - returns),
                             torch.square(clipped - returns))
    return torch.square(returns - values)


# ---------------------------------------------------------------------------
# optimizer: optax.chain(clip_by_global_norm, adam) (common.py:17-24)
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    count: torch.Tensor          # () int32, steps taken
    mu: List[torch.Tensor]       # first moments, one per parameter
    nu: List[torch.Tensor]       # second moments


def adam_init(params) -> AdamState:
    params = list(params)
    dev = params[0].device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params],
        nu=[torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params])


def adam_reset(state: AdamState):
    """`adam_init`'s values written into `state`'s tensors, in place."""
    state.count.zero_()
    torch._foreach_zero_(state.mu + state.nu)


def adam_load(state: AdamState, saved: Dict):
    """A saved Adam state (`AdamState._asdict()`, on any device) copied
    into `state`'s tensors, in place."""
    state.count.copy_(saved["count"])
    for dst, src in zip(state.mu + state.nu,
                        list(saved["mu"]) + list(saved["nu"])):
        dst.copy_(src)


def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm: every gradient becomes g / norm * max_norm
    when the global norm reaches max_norm, else stays g. `grads` are
    modified in place and returned; the choice is made on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    # g / 1 * 1 is g exactly, so one division and one product serve both
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return grads


@torch.no_grad()
def adam_step(params, grads, state: AdamState, lr, max_grad_norm):
    """One optimizer step, in place on `params` and the moments of `state`:
    clip by global norm, then optax's Adam with its order of operations
    (moments, bias correction by 1 - b**count, m / (sqrt(v) + eps)), then
    params + (-lr) * update. `lr` is a 0-d tensor on the parameters' device.
    Returns `state`, its count advanced in place."""
    params = list(params)
    grads = clip_by_global_norm(list(grads), max_grad_norm)
    mu, nu = state.mu, state.nu
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - ADAM_B1))
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - ADAM_B2))
    state.count.add_(1)
    step = state.count.to(torch.float32)
    mu_hat = torch._foreach_div(mu, 1 - torch.pow(ADAM_B1, step))
    denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - torch.pow(ADAM_B2,
                                                                   step)))
    torch._foreach_add_(denom, ADAM_EPS)
    updates = torch._foreach_div(mu_hat, denom)
    torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(params, updates)
    return state
