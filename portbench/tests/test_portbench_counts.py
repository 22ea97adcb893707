"""The FLOP and byte counters against hand counts."""
import json
import os

import pytest
import torch

from conftest import ROOT
from portbench import counts


def tiny_config(algorithm):
    """go2_moe_cts's file with small widths, for counting by hand."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "go2_moe_cts.json")) as f:
        cfg = json.load(f)
    env = cfg["env_cfg"]["env"]
    env.update(num_observations=3, num_privileged_obs=5, num_actions=2)
    tc = cfg["train_cfg"]
    tc["history_length"] = 2
    tc["runner"].update(num_steps_per_env=2, algorithm_class_name=algorithm)
    tc["algorithm"].update(num_learning_epochs=1, num_mini_batches=2,
                           teacher_env_ratio=0.75)
    tc["policy"].update(actor_hidden_dims=[4], critic_hidden_dims=[4],
                        teacher_encoder_hidden_dims=[4],
                        student_encoder_hidden_dims=[4, 6], latent_dim=2,
                        expert_num=2)
    return cfg


def test_mlp_and_train_by_hand():
    assert counts.mlp([3, 4, 2]) == 2 * 3 * 4 + 2 * 4 * 2
    # forward 40, weight grads 40, input grads 16 (second layer only)
    assert counts.train([3, 4, 2], False) == 40 + 40 + 16
    assert counts.train([3, 4, 2], True) == 40 + 40 + 40


def test_ppo_by_hand():
    # N=8, T=2, nmb=2, 1 epoch; actor 3-4-2 (40), critic 5-4-1 (48)
    # rollout: 2*8*(40+48) + 8*48 = 1792; minibatch of 8 samples:
    # actor 40+40+16=96, critic 48+48+8=104; 2 minibatches
    expect = 2 * 8 * (40 + 48) + 8 * 48 + 2 * 8 * (96 + 104)
    assert counts.network_flops(tiny_config("PPO"), 8) == expect


def test_moe_cts_by_hand():
    # N=8: students 0 and 4 (stride 4), 6 teachers; T=2, nmb=2: tmb=6,
    # smb=2. latent 2, history 2*3=6.
    teacher = 2 * 5 * 4 + 2 * 4 * 2                       # 56
    # MoE of 2 experts over (4, 6): backbone 6-4-12 (144), gating 6-4-2
    # (64), heads 2*2*6*2 (48); first layers 2*6*4 twice (96)
    s_fwd = 144 + 64 + 48
    s_train = 3 * s_fwd - 96
    actor = 2 * 5 * 4 + 2 * 4 * 2                         # in 2+3: 56
    critic = 2 * 7 * 4 + 2 * 4 * 1                        # in 2+5: 64
    rollout = 2 * 8 * (teacher + s_fwd + actor + critic) \
        + 8 * (teacher + s_fwd + critic)
    ppo = 2 * s_fwd + 6 * (3 * teacher - 2 * 5 * 4) \
        + 8 * (3 * actor + 3 * critic - 2 * 7 * 4)
    distill = 2 * (s_train + teacher)
    assert counts.network_flops(tiny_config("MoECTS"), 8) == \
        rollout + 2 * (ppo + distill)


def test_unknown_algorithm_gives_none():
    assert counts.network_flops(tiny_config("RecurrentPPO"), 8) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_bytes_against_a_painted_grid(seed):
    g = torch.Generator().manual_seed(seed)
    C, R, n = 70, 90, 12
    origins = torch.stack([torch.randint(-5, R, (n,), generator=g),
                           torch.randint(-5, C, (n,), generator=g)], 1)
    painted = torch.zeros((C, R), dtype=torch.bool)
    for ox, oy in origins.tolist():
        ox = min(max(ox + R if ox < 0 else ox, 0), R - 32)
        oy = min(max(oy + C if oy < 0 else oy, 0), C - 32)
        painted[oy:oy + 32, ox:ox + 32] = True
    expect = 12 * (n * 32 * 32 + int(painted.sum()))
    assert counts.patch_bytes((3, C, R), origins.to(torch.int32)) == expect


def test_origins_as_the_physics_step_computes_them():
    pos = torch.tensor([[0.0, 0.0, 0.3], [5.05, 2.0, 0.3]])
    got = counts.origins_of(pos, 3.0, 0.1, (3, 100, 200))
    assert got.tolist() == [[14, 14], [64, 34]]
