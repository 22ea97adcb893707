"""Reward term library — all 26 base terms + 2 Go2-specific terms.

PyTorch port of go2_rl_gym_tpu/env/rewards.py: pure functions over a
RewardContext, mirroring the reference's ``_reward_*`` methods (reference
legged_gym/envs/base/legged_robot.py:1228-1441 and
legged_gym/envs/go2/go2_env.py:55-68). Each returns (N,).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from go2_rl_gym_tpu_torch.core import maths


class RewardContext(NamedTuple):
    """Everything reward terms may read (all batched (N, ...))."""
    base_pos: torch.Tensor            # (N,3)
    base_quat: torch.Tensor           # (N,4)
    base_lin_vel: torch.Tensor        # (N,3) body frame
    base_ang_vel: torch.Tensor        # (N,3) body frame
    projected_gravity: torch.Tensor   # (N,3)
    commands: torch.Tensor            # (N,4)
    dof_pos: torch.Tensor             # (N,12)
    dof_vel: torch.Tensor             # (N,12)
    last_dof_vel: torch.Tensor        # (N,12)
    actions: torch.Tensor             # (N,12)
    last_actions: torch.Tensor        # (N,12)
    last_last_actions: torch.Tensor   # (N,12)
    torques: torch.Tensor             # (N,12)
    contact_forces: torch.Tensor      # (N,nb,3)
    foot_forces: torch.Tensor         # (N,4,3)
    foot_pos: torch.Tensor            # (N,4,3) world
    foot_vel: torch.Tensor            # (N,4,3) world
    feet_air_time: torch.Tensor       # (N,4) (already incremented this step)
    first_contact: torch.Tensor       # (N,4) bool
    contact_filt: torch.Tensor        # (N,4) bool
    measured_heights: torch.Tensor    # (N,P) or (N,0)
    base_height: torch.Tensor         # (N,) estimated height above ground
    reset_buf: torch.Tensor           # (N,) bool
    time_out_buf: torch.Tensor        # (N,) bool
    # static-ish per-env data
    default_dof_pos: torch.Tensor     # (12,)
    dof_pos_limits: torch.Tensor      # (12,2) soft limits
    dof_vel_limits: torch.Tensor      # (12,)
    torque_limits: torch.Tensor       # (12,)
    tracking_sigma_lin: torch.Tensor  # (N,2) per-axis sigma
    tracking_sigma_ang: torch.Tensor  # (N,)
    dt: float
    cfg: object                       # RewardsCfg (static)
    # body / joint indices: long tensors on the device, so that a step
    # copies nothing from the host
    penalized_bodies: torch.Tensor    # body indices with contact penalty
    termination_bodies: torch.Tensor
    hip_idx: torch.Tensor             # hip joint indices (0, 3, 6, 9)


def _norm(x, dim):
    return torch.linalg.vector_norm(x, dim=dim)


# --- individual terms (names match reference `_reward_<name>`) --------------


def lin_vel_z(c):
    return torch.square(c.base_lin_vel[:, 2])


def ang_vel_xy(c):
    return torch.sum(torch.square(c.base_ang_vel[:, :2]), dim=1)


def orientation(c):
    return torch.sum(torch.square(c.projected_gravity[:, :2]), dim=1)


def base_height(c):
    """Feet-contact-referenced base height error (legged_robot.py:1245-1259)."""
    cf = c.contact_filt.to(torch.float32)
    num_contact = torch.clamp(torch.sum(cf, dim=1), min=1.0)
    feet_contact_pos = (torch.sum(c.foot_pos * cf[..., None], dim=1)
                        / num_contact[:, None])
    delta = feet_contact_pos - c.base_pos
    h = torch.sum(delta * c.projected_gravity, dim=1)
    rew = torch.square(h - c.cfg.base_height_target)
    return rew * (torch.sum(cf, dim=1) > 0)


def torques(c):
    return torch.sum(torch.square(c.torques), dim=1)


def dof_vel(c):
    return torch.sum(torch.square(c.dof_vel), dim=1)


def dof_acc(c):
    return torch.sum(torch.square((c.last_dof_vel - c.dof_vel) / c.dt), dim=1)


def action_rate(c):
    return torch.sum(torch.square(c.last_actions - c.actions), dim=1)


def collision(c):
    f = c.contact_forces[:, c.penalized_bodies, :]
    return torch.sum((_norm(f, -1) > 0.1).to(torch.float32), dim=1)


def termination(c):
    return (c.reset_buf & ~c.time_out_buf).to(torch.float32)


def dof_pos_limits(c):
    lo = -torch.clamp(c.dof_pos - c.dof_pos_limits[:, 0], max=0.0)
    hi = torch.clamp(c.dof_pos - c.dof_pos_limits[:, 1], min=0.0)
    return torch.sum(lo + hi, dim=1)


def dof_vel_limits(c):
    return torch.sum(torch.clamp(
        torch.abs(c.dof_vel) - c.dof_vel_limits * c.cfg.soft_dof_vel_limit,
        0.0, 1.0), dim=1)


def torque_limits(c):
    return torch.sum(torch.clamp(
        torch.abs(c.torques) - c.torque_limits * c.cfg.soft_torque_limit,
        min=0.0), dim=1)


def tracking_lin_vel(c):
    err_sq = torch.square(c.commands[:, :2] - c.base_lin_vel[:, :2])
    scaled = (err_sq[:, 0] / c.tracking_sigma_lin[:, 0]
              + err_sq[:, 1] / c.tracking_sigma_lin[:, 1])
    return torch.exp(-scaled)


def tracking_ang_vel(c):
    err_sq = torch.square(c.commands[:, 2] - c.base_ang_vel[:, 2])
    return torch.exp(-err_sq / c.tracking_sigma_ang)


def feet_air_time(c):
    rew = torch.sum((c.feet_air_time - 0.5) * c.first_contact, dim=1)
    return rew * (_norm(c.commands[:, :2], 1) > 0.1)


def stumble(c):
    fxy = _norm(c.foot_forces[:, :, :2], 2)
    fz = torch.abs(c.foot_forces[:, :, 2])
    return torch.any(fxy > 5.0 * fz, dim=1).to(torch.float32)


def stand_still(c):
    return (torch.sum(torch.abs(c.dof_pos - c.default_dof_pos), dim=1)
            * (_norm(c.commands[:, :2], 1) < 0.1))


def feet_contact_forces(c):
    return torch.sum(torch.clamp(
        _norm(c.foot_forces, -1) - c.cfg.max_contact_force, min=0.0), dim=1)


def action_smoothness(c):
    return torch.sum(torch.square(c.actions - 2 * c.last_actions
                                  + c.last_last_actions), dim=1)


def dof_power(c):
    return torch.sum(torch.abs(c.torques * c.dof_vel), dim=1)


def correct_base_height(c):
    """Height-scan-referenced base height (legged_robot.py:1387-1402)."""
    return torch.square(c.base_height - c.cfg.base_height_target)


def feet_regulation(c):
    """CTS foot-lift regularization (legged_robot.py:1404-1414)."""
    delta_feet = c.foot_pos - c.base_pos[:, None, :]
    feet2base_h = torch.sum(delta_feet * c.projected_gravity[:, None, :], dim=-1)
    feet_h = torch.clamp(c.base_height[:, None] - feet2base_h, min=0.0)
    vxy_sq = torch.sum(torch.square(c.foot_vel[:, :, :2]), dim=-1)
    return torch.sum(
        vxy_sq * torch.exp(-feet_h / (0.025 * c.cfg.base_height_target)), dim=-1)


def similar_to_default(c):
    return torch.sum(torch.abs(c.dof_pos - c.default_dof_pos), dim=1)


def upright(c):
    return (-1.0 - c.projected_gravity[:, 2]) / 2.0


def legs_distance(c):
    """Penalize front/rear feet y-distance below min (legged_robot.py:1423-1441)."""
    rel = c.foot_pos - c.base_pos[:, None, :]
    local = maths.quat_rotate_inverse(c.base_quat[:, None, :], rel)
    dy_front = local[:, 0, 1] - local[:, 1, 1]
    dy_rear = local[:, 2, 1] - local[:, 3, 1]
    m = c.cfg.min_legs_distance
    return (torch.square(torch.clamp(m - dy_front, min=0.0))
            + torch.square(torch.clamp(m - dy_rear, min=0.0)))


def hip_to_default(c):
    """Go2 extra (go2_env.py:55-60)."""
    idx = c.hip_idx
    return torch.sum(torch.abs(c.dof_pos[:, idx] - c.default_dof_pos[idx]),
                     dim=1)


def x_command_hip_regular(c):
    """Go2 extra (go2_env.py:62-68)."""
    hip = c.dof_pos[:, c.hip_idx]
    ratio = (torch.abs(c.commands[:, 0])
             / (_norm(c.commands[:, :3], 1) + 1e-9))
    rew = torch.abs(hip[:, 0] + hip[:, 1]) + torch.abs(hip[:, 2] + hip[:, 3])
    return rew * ratio


REWARD_TERMS = {
    "lin_vel_z": lin_vel_z,
    "ang_vel_xy": ang_vel_xy,
    "orientation": orientation,
    "base_height": base_height,
    "torques": torques,
    "dof_vel": dof_vel,
    "dof_acc": dof_acc,
    "action_rate": action_rate,
    "collision": collision,
    "termination": termination,
    "dof_pos_limits": dof_pos_limits,
    "dof_vel_limits": dof_vel_limits,
    "torque_limits": torque_limits,
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "feet_air_time": feet_air_time,
    "feet_stumble": stumble,
    "stumble": stumble,
    "stand_still": stand_still,
    "feet_contact_forces": feet_contact_forces,
    "action_smoothness": action_smoothness,
    "dof_power": dof_power,
    "correct_base_height": correct_base_height,
    "feet_regulation": feet_regulation,
    "similar_to_default": similar_to_default,
    "upright": upright,
    "legs_distance": legs_distance,
    "hip_to_default": hip_to_default,
    "x_command_hip_regular": x_command_hip_regular,
}
