"""Ablation config variants (copy of go2_rl_gym_tpu/env/config_variants.py,
numpy only, built on the port's env/config.py).

Counterparts of the reference's drop-in config files that shadow the GO2Cfg
class names (go2_config_vanilla.py, go2_config_vanilla_with_dynamic_cmd.py,
go2_config_fast_flat_move.py — reference legged_gym/envs/go2/). Here they are
explicit factory functions registered as tasks (`go2_vanilla`,
`go2_vanilla_dynamic_cmd`, `go2_fast_flat_move`) instead of import-swapped
class shadowing.
"""
from __future__ import annotations

from go2_rl_gym_tpu_torch.env.config import (CommandRanges, Go2Cfg,
                                             TrainCfg, go2_ppo_train_cfg)


def go2_vanilla_cfg() -> Go2Cfg:
    """unitree_rl_gym-like baseline (go2_config_vanilla.py:1-299): 20 s
    episodes, heading command on, all new command machinery off."""
    cfg = Go2Cfg()
    cfg.env.episode_length_s = 20.0
    c = cfg.commands
    c.heading_command = True
    c.resampling_time = 10.0
    c.zero_command_curriculum = None
    c.limit_vel_prob = 0.0
    c.limit_ang_vel_at_zero_command_prob = 0.0
    c.dynamic_resample_commands = False
    c.command_range_curriculum = []
    c.ranges = CommandRanges(lin_vel_x=(-1.0, 1.0), lin_vel_y=(-1.0, 1.0),
                             ang_vel_yaw=(-1.0, 1.0), heading=(-3.14, 3.14))
    r = cfg.rewards
    r.curriculum_rewards = []
    r.dynamic_sigma = None
    r.scales = dict(
        tracking_lin_vel=1.0, tracking_ang_vel=0.5, lin_vel_z=-2.0,
        ang_vel_xy=-0.05, orientation=-0.0, dof_acc=-2.5e-7, torques=-1e-5,
        base_height=-0.0, feet_air_time=1.0, collision=-1.0,
        action_rate=-0.01, dof_pos_limits=-2.0)
    cfg.domain_rand.randomize_action_delay = False
    cfg.domain_rand.randomize_motor_strength = False
    return cfg


def go2_vanilla_dynamic_cmd_cfg() -> Go2Cfg:
    """vanilla + dynamic command resampling
    (go2_config_vanilla_with_dynamic_cmd.py)."""
    cfg = go2_vanilla_cfg()
    cfg.commands.dynamic_resample_commands = True
    cfg.commands.resampling_time = 5.0
    return cfg


def go2_fast_flat_move_cfg() -> Go2Cfg:
    """High-speed flat running (go2_config_fast_flat_move.py:98-228): plane
    terrain, lin_vel_x up to 4.2 m/s via a 5-stage range curriculum,
    tracking_lin_vel=2.0, strong hip regularization, base height 0.33."""
    cfg = Go2Cfg()
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    c = cfg.commands
    c.ranges = CommandRanges(lin_vel_x=(-1.0, 1.0), lin_vel_y=(-0.5, 0.5),
                             ang_vel_yaw=(-1.0, 1.0), heading=(-1.57, 1.57))
    c.command_range_curriculum = [
        dict(iter=5000, lin_vel_x=[-1.5, 2.0], lin_vel_y=[-0.6, 0.6],
             ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),
        dict(iter=15000, lin_vel_x=[-2.0, 2.8], lin_vel_y=[-0.6, 0.6],
             ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),
        dict(iter=30000, lin_vel_x=[-2.0, 3.4], lin_vel_y=[-0.6, 0.6],
             ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),
        dict(iter=50000, lin_vel_x=[-2.0, 3.8], lin_vel_y=[-0.6, 0.6],
             ang_vel_yaw=[-2.0, 2.0], heading=[-1.57, 1.57]),
        dict(iter=80000, lin_vel_x=[-2.0, 4.2], lin_vel_y=[-0.6, 0.6],
             ang_vel_yaw=[-2.0, 2.0], heading=[-1.57, 1.57]),
    ]
    r = cfg.rewards
    r.base_height_target = 0.33
    r.scales = dict(r.scales)
    r.scales["tracking_lin_vel"] = 2.0
    r.scales["x_command_hip_regular"] = -0.5
    return cfg


def go2_vanilla_train_cfg() -> TrainCfg:
    tc = go2_ppo_train_cfg()
    tc.runner.experiment_name = "go2_vanilla"
    return tc


def go2_fast_flat_move_train_cfg() -> TrainCfg:
    tc = go2_ppo_train_cfg()
    tc.runner.experiment_name = "go2_fast_flat_move"
    return tc
