"""Operations and bytes from shapes, and the card's peaks: the yardstick of
the roofline and utilisation metrics, kept apart from the program.

`network_flops(config, num_envs)` counts the matmul FLOPs (2 per
multiply-add) of the policy and value networks in one train iteration,
from the configuration file's widths: the rollout's forwards (every
network the act step runs, on every env, each of the T steps, plus the last
value), and the update's forwards and backwards over its epochs and
minibatches. A backward costs the forward's FLOPs for the weight gradients
plus as much again for the input gradients, except at a first layer whose
input carries no gradient. Biases, activations, norms and the physics are
not counted. Supported: PPO (`ActorCritic`) and the CTS families "cts" and
"moe_cts"; other algorithms give None.

`patch_bytes(channels_shape, origins)` is the least traffic of one launch
of the patch kernel: the N x 3 x 32 x 32 fp32 windows it writes, plus the
union of the grid cells those windows read, each byte once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

# Published peaks of the card (NVIDIA's data sheet, SXM part, dense): fp32
# outside the tensor cores, and the HBM rate; at the 700 W power limit.
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12,
                                   "hbm_bytes_per_s": 3.35e12}}

PATCH = 32


def mlp(dims: Sequence[int]) -> int:
    """Forward FLOPs per sample of a stack of Linear layers."""
    return sum(2 * a * b for a, b in zip(dims, dims[1:]))


def train(dims: Sequence[int], input_grad: bool) -> int:
    """Forward plus backward FLOPs per sample of a Linear stack."""
    fwd = mlp(dims)
    return 3 * fwd - (0 if input_grad else 2 * dims[0] * dims[1])


def _moe(in_dim, hidden, out, experts):
    """(forward FLOPs, first-layer FLOPs of its two input stacks, head
    FLOPs) per sample of a MoE (agents/networks.py `MoE`): a backbone to
    experts x H features, per-expert heads H -> out, and a gating MLP."""
    h = hidden[-1]
    backbone = [in_dim, *hidden[:-1], experts * h]
    gating = [in_dim, *hidden[:-1], experts]
    head = 2 * experts * h * out
    first = 2 * in_dim * backbone[1] + 2 * in_dim * gating[1]
    return mlp(backbone) + mlp(gating) + head, first, head


def network_flops(config: Dict, num_envs: int) -> Optional[int]:
    """Matmul FLOPs of the networks in one train iteration (see the module
    docstring), or None for an algorithm this counter does not know."""
    env, tc = config["env_cfg"]["env"], config["train_cfg"]
    pol, alg = tc["policy"], tc["algorithm"]
    name = tc["runner"]["algorithm_class_name"]
    O, P, A = (env["num_observations"], env["num_privileged_obs"],
               env["num_actions"])
    N, T = num_envs, tc["runner"]["num_steps_per_env"]
    steps = alg["num_learning_epochs"] * alg["num_mini_batches"]
    actor = [*pol["actor_hidden_dims"], A]
    critic = [*pol["critic_hidden_dims"], 1]
    if name == "PPO":
        m = N * T // alg["num_mini_batches"]
        rollout = T * N * (mlp([O, *actor]) + mlp([P, *critic])) \
            + N * mlp([P, *critic])
        update = steps * m * (train([O, *actor], False)
                              + train([P, *critic], False))
        return rollout + update
    if name not in ("CTS", "MoECTS"):
        return None
    L = pol["latent_dim"]
    H = tc["history_length"] * O
    teacher = [P, *pol["teacher_encoder_hidden_dims"], L]
    student_hidden = pol["student_encoder_hidden_dims"]
    if name == "MoECTS":
        s_fwd, s_first, s_head = _moe(H, student_hidden, L, pol["expert_num"])
        s_train = 3 * s_fwd - s_first
    else:
        s_fwd = mlp([H, *student_hidden, L])
        s_train = train([H, *student_hidden, L], False)
    a_dims, c_dims = [L + O, *actor], [L + P, *critic]
    # the env split of agents/cts.py: every stride-th env is a student
    stride = int(round(1.0 / (1.0 - alg["teacher_env_ratio"])))
    students = math.ceil(N / stride)
    tmb = (N - students) * T // alg["num_mini_batches"]
    smb = students * T // alg["num_mini_batches"]
    # act: both encoders on every env, the actor, the critic
    rollout = T * N * (mlp(teacher) + s_fwd + mlp(a_dims) + mlp(c_dims)) \
        + N * (mlp(teacher) + s_fwd + mlp(c_dims))
    # pass 1 (PPO): the student latent without gradient, the teacher's with
    # it, the actor (its input carries the teacher's gradient), the critic
    # on a detached latent; pass 2 (distillation): the student with
    # gradient, the teacher without
    ppo = smb * s_fwd + tmb * train(teacher, False) \
        + (tmb + smb) * (train(a_dims, True) + train(c_dims, False))
    distill = smb * (s_train + mlp(teacher))
    return rollout + steps * (ppo + distill)


def patch_bytes(channels_shape, origins: torch.Tensor) -> int:
    """Least bytes one patch launch moves (see the module docstring).
    `channels_shape` is (3, C, R); `origins` (N, 2) holds the (x, y)
    corners, placed as the kernel places them."""
    _, C, R = channels_shape
    ox = origins[:, 0].long()
    oy = origins[:, 1].long()
    ox = torch.clamp(torch.where(ox < 0, ox + R, ox), 0, R - PATCH)
    oy = torch.clamp(torch.where(oy < 0, oy + C, oy), 0, C - PATCH)
    covered = torch.zeros((C + 1, R + 1), dtype=torch.int32,
                          device=origins.device)
    one = torch.ones_like(ox, dtype=torch.int32)
    # 2-D difference array: +1 at each window's corner, -1 past its edges
    covered.index_put_((oy, ox), one, accumulate=True)
    covered.index_put_((oy + PATCH, ox), -one, accumulate=True)
    covered.index_put_((oy, ox + PATCH), -one, accumulate=True)
    covered.index_put_((oy + PATCH, ox + PATCH), one, accumulate=True)
    cells = int((covered.cumsum(0).cumsum(1) > 0).sum())
    n = origins.shape[0]
    return 4 * 3 * (n * PATCH * PATCH + cells)


def origins_of(base_pos: torch.Tensor, border_offset: float,
               horizontal_scale: float, channels_shape) -> torch.Tensor:
    """The patch corners of bases at `base_pos` (N, 3), as the physics step
    computes them before it launches the kernel (sim/tengine.py)."""
    _, C, R = channels_shape
    bix = ((base_pos[:, 0] + border_offset) / horizontal_scale).to(torch.int32)
    biy = ((base_pos[:, 1] + border_offset) / horizontal_scale).to(torch.int32)
    ox = torch.clamp(bix - PATCH // 2, 0, R - PATCH)
    oy = torch.clamp(biy - PATCH // 2, 0, C - PATCH)
    return torch.stack([ox, oy], dim=1).to(torch.int32)
