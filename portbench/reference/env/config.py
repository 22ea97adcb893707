"""Config schema + Go2 defaults.

Counterpart of the reference's nested-class config tree
(reference legged_gym/envs/base/legged_robot_config.py +
legged_gym/envs/go2/go2_config.py), as plain dataclasses. Copy of
go2_rl_gym_tpu/env/config.py, so that the port builds the same configs without
importing the JAX package. There is no runtime config mutation (the
reference's imperative curriculum-pop at legged_robot.py:433-446 becomes a pure
function of the iteration counter).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from dataclasses import dataclass, field


def _d(**kw):
    return field(default_factory=lambda: dict(kw))


@dataclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 45
    num_privileged_obs: Optional[int] = 263
    num_actions: int = 12
    episode_length_s: float = 25.0
    send_timeouts: bool = True
    env_spacing: float = 3.0
    test: bool = False


@dataclass
class TerrainCfg:
    mesh_type: str = "heightfield"          # plane | heightfield
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 25.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    measure_heights: bool = True
    measured_points_x: Tuple[float, ...] = tuple(
        [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
         0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    measured_points_y: Tuple[float, ...] = tuple(
        [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5])
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_spacing: float = 0.5
    # [wave, slope, rough_slope, stairs_up, stairs_down, obstacles,
    #  stepping_stones, gap, flat] (go2_config.py:91)
    terrain_proportions: Tuple[float, ...] = (
        0.05, 0.20, 0.05, 0.25, 0.10, 0.20, 0.0, 0.0, 0.15)
    move_down_by_accumulated_xy_command: bool = True


@dataclass
class CommandRanges:
    lin_vel_x: Tuple[float, float] = (-0.5, 0.5)
    lin_vel_y: Tuple[float, float] = (-0.5, 0.5)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    heading: Tuple[float, float] = (-1.57, 1.57)


@dataclass
class CommandsCfg:
    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4
    resampling_time: float = 5.0
    heading_command: bool = False
    ranges: CommandRanges = field(default_factory=CommandRanges)
    # zero-command curriculum (go2_config.py:105)
    zero_command_curriculum: Optional[Dict[str, float]] = _d(
        start_iter=0, end_iter=1500, start_value=0.0, end_value=0.1)
    limit_ang_vel_at_zero_command_prob: float = 0.2
    limit_vel_prob: float = 0.2
    limit_vel_invert_when_continuous: bool = True
    limit_vel: Dict[str, List[int]] = _d(
        lin_vel_x=[-1, 1], lin_vel_y=[-1, 1], ang_vel_yaw=[-1, 0, 1])
    stop_heading_at_limit: bool = True
    dynamic_resample_commands: bool = True
    # command-range curriculum (go2_config.py:112-124)
    command_range_curriculum: List[Dict[str, Any]] = field(default_factory=lambda: [
        dict(iter=20000, lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0],
             ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),
        dict(iter=50000, lin_vel_x=[-2.0, 2.0], lin_vel_y=[-1.0, 1.0],
             ang_vel_yaw=[-2.0, 2.0], heading=[-1.57, 1.57]),
    ])
    turn_over_zero_time: Dict[str, float] = _d(backflip=5.0, sideflip=3.0)
    # per-terrain-type command caps (go2_config.py:130-140)
    terrain_max_command_ranges: List[Dict[str, List[float]]] = field(
        default_factory=lambda: [
            dict(lin_vel_x=[-1.5, 1.5], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # wave
            dict(lin_vel_x=[-1.5, 1.5], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # slope
            dict(lin_vel_x=[-1.5, 1.5], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # rough slope
            dict(lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # stairs up
            dict(lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # stairs down
            dict(lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # obstacles
            dict(lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # stepping stones
            dict(lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-1.5, 1.5], heading=[-1.57, 1.57]),  # gap
            dict(lin_vel_x=[-2.0, 2.0], lin_vel_y=[-1.0, 1.0], ang_vel_yaw=[-2.0, 2.0], heading=[-1.57, 1.57]),  # flat
        ])


@dataclass
class InitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.42)
    rot: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    lin_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ang_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # go2_config.py:7-22
    default_joint_angles: Dict[str, float] = _d(
        FL_hip_joint=0.1, RL_hip_joint=0.1, FR_hip_joint=-0.1, RR_hip_joint=-0.1,
        FL_thigh_joint=0.8, RL_thigh_joint=1.0, FR_thigh_joint=0.8, RR_thigh_joint=1.0,
        FL_calf_joint=-1.5, RL_calf_joint=-1.5, FR_calf_joint=-1.5, RR_calf_joint=-1.5)
    turn_over: bool = False
    turn_over_proportions: Tuple[float, float, float] = (0.0, 0.2, 0.8)
    turn_over_init_heights: Dict[str, Tuple[float, float]] = _d(
        backflip=(0.10, 0.15), sideflip=(0.16, 0.21))


@dataclass
class ControlCfg:
    control_type: str = "P"
    stiffness: Dict[str, float] = _d(joint=20.0)
    damping: Dict[str, float] = _d(joint=0.5)
    action_scale: float = 0.25
    decimation: int = 4


@dataclass
class AssetCfg:
    name: str = "go2"
    foot_name: str = "foot"
    penalize_contacts_on: Tuple[str, ...] = ("thigh", "calf")
    terminate_after_contacts_on: Tuple[str, ...] = ("base",)
    self_collisions: int = 1  # 1 = disabled (go2_config.py:154)


@dataclass
class DomainRandCfg:
    # robot properties (creation-time in reference; reset-time here)
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.0, 2.0)
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-1.0, 1.0)
    randomize_link_mass: bool = True
    multiplied_link_mass_range: Tuple[float, float] = (0.9, 1.1)
    randomize_base_com: bool = True
    added_base_com_range: Tuple[float, float] = (-0.03, 0.03)
    randomize_restitution: bool = True
    restitution_range: Tuple[float, float] = (0.0, 0.5)
    # env-reset randomizations
    randomize_pd_gains: bool = True
    stiffness_multiplier_range: Tuple[float, float] = (0.9, 1.1)
    damping_multiplier_range: Tuple[float, float] = (0.9, 1.1)
    randomize_motor_zero_offset: bool = True
    motor_zero_offset_range: Tuple[float, float] = (-0.035, 0.035)
    randomize_motor_strength: bool = True
    motor_strength_range: Tuple[float, float] = (0.8, 1.2)
    # per-step
    push_robots: bool = True
    push_interval_s: float = 4.0
    max_push_vel_xy: float = 0.4
    max_push_ang_vel: float = 0.6
    randomize_action_delay: bool = True


@dataclass
class RewardsCfg:
    # go2_config.py:178-197 scales
    scales: Dict[str, float] = _d(
        tracking_lin_vel=1.0,
        tracking_ang_vel=0.5,
        lin_vel_z=-2.0,
        ang_vel_xy=-0.05,
        dof_acc=-2.5e-7,
        dof_power=-2e-5,
        torques=-1e-4,
        correct_base_height=-1.0,
        action_rate=-0.01,
        action_smoothness=-0.01,
        collision=-1.0,
        dof_pos_limits=-2.0,
        feet_regulation=-0.05,
        hip_to_default=-0.05,
    )
    turn_over_scales: Dict[str, float] = _d(upright=1.0)
    only_positive_rewards: bool = False
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 0.9
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 0.38
    max_contact_force: float = 147.0
    min_legs_distance: float = 0.1
    turn_over_roll_threshold: float = math.pi / 4
    # go2_config.py:161-166
    curriculum_rewards: List[Dict[str, Any]] = field(default_factory=lambda: [
        dict(reward_name="lin_vel_z", start_iter=0, end_iter=1500,
             start_value=1.0, end_value=0.0),
        dict(reward_name="correct_base_height", start_iter=0, end_iter=5000,
             start_value=1.0, end_value=10.0),
    ])
    # go2_config.py:168-176
    dynamic_sigma: Optional[Dict[str, Any]] = field(default_factory=lambda: dict(
        min_lin_vel=0.5, max_lin_vel=1.5, min_ang_vel=1.0, max_ang_vel=2.0,
        max_sigma=[5 / 12, 1 / 4, 1 / 4, 1 / 2, 1 / 2, 3 / 4, 1.0, 1.0, 1 / 4]))


@dataclass
class ObsScales:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 2.5


@dataclass
class NormalizationCfg:
    obs_scales: ObsScales = field(default_factory=ObsScales)
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclass
class NoiseScales:
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: NoiseScales = field(default_factory=NoiseScales)


@dataclass
class SimCfg:
    dt: float = 0.005
    gravity: float = -9.81
    substeps: int = 1


@dataclass
class Go2Cfg:
    env: EnvCfg = field(default_factory=lambda: EnvCfg(num_envs=8192))
    terrain: TerrainCfg = field(default_factory=TerrainCfg)
    commands: CommandsCfg = field(default_factory=CommandsCfg)
    init_state: InitStateCfg = field(default_factory=InitStateCfg)
    control: ControlCfg = field(default_factory=ControlCfg)
    asset: AssetCfg = field(default_factory=AssetCfg)
    domain_rand: DomainRandCfg = field(default_factory=DomainRandCfg)
    rewards: RewardsCfg = field(default_factory=RewardsCfg)
    normalization: NormalizationCfg = field(default_factory=NormalizationCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    sim: SimCfg = field(default_factory=SimCfg)
    seed: int = 1

    @property
    def dt(self) -> float:
        """Policy dt = decimation * sim dt (reference legged_robot.py:1094)."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        return int(math.ceil(self.env.episode_length_s / self.dt))


# ---------------------------------------------------------------------------
# Train configs (PPO + 6 CTS variants; reference legged_robot_config.py:261-409)
# ---------------------------------------------------------------------------


@dataclass
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    teacher_encoder_hidden_dims: Tuple[int, ...] = (512, 256)
    student_encoder_hidden_dims: Tuple[int, ...] = (512, 256)
    activation: str = "elu"
    latent_dim: int = 32
    norm_type: str = "l2norm"            # l2norm | simnorm
    expert_num: int = 8
    student_expert_num: int = 8
    obs_no_goal_mask: Optional[Tuple[bool, ...]] = None
    # recurrent policy (reference actor_critic_recurrent.py:40-116)
    rnn_type: str = "lstm"               # lstm | gru
    rnn_hidden_size: int = 256


@dataclass
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    student_encoder_learning_rate: float = 1e-3
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    teacher_env_ratio: float = 0.75
    load_balance_coef: float = 0.01


@dataclass
class RunnerCfg:
    policy_class_name: str = "ActorCritic"
    algorithm_class_name: str = "PPO"
    num_steps_per_env: int = 24
    max_iterations: int = 150000
    save_interval: int = 500
    experiment_name: str = "go2_ppo"
    run_name: str = ""
    resume: bool = False
    load_run: int = -1
    checkpoint: int = -1


@dataclass
class TrainCfg:
    seed: int = 1
    runner_class_name: str = "OnPolicyRunner"
    history_length: int = 5
    policy: PolicyCfg = field(default_factory=PolicyCfg)
    algorithm: AlgorithmCfg = field(default_factory=AlgorithmCfg)
    runner: RunnerCfg = field(default_factory=RunnerCfg)


_NO_GOAL_MASK_45 = tuple([True] * 6 + [False] * 3 + [True] * 36)


def go2_ppo_train_cfg() -> TrainCfg:
    return TrainCfg(runner=RunnerCfg(experiment_name="go2_ppo"))


def go2_lstm_train_cfg() -> TrainCfg:
    """Recurrent-PPO task (the reference ships ActorCriticRecurrent but
    registers no task with it, actor_critic_recurrent.py:40-116; this makes
    the recurrent path first-class)."""
    return TrainCfg(
        runner_class_name="OnPolicyRunner",
        policy=PolicyCfg(actor_hidden_dims=(256, 256, 128),
                         critic_hidden_dims=(256, 256, 128)),
        runner=RunnerCfg(policy_class_name="ActorCriticRecurrent",
                         algorithm_class_name="RecurrentPPO",
                         experiment_name="go2_lstm"))


def go2_cts_train_cfg() -> TrainCfg:
    return TrainCfg(
        seed=0, runner_class_name="OnPolicyRunnerCTS",
        policy=PolicyCfg(),
        runner=RunnerCfg(policy_class_name="ActorCriticCTS",
                         algorithm_class_name="CTS",
                         experiment_name="go2_cts"))


def go2_moe_cts_train_cfg() -> TrainCfg:
    return TrainCfg(
        seed=0, runner_class_name="OnPolicyRunnerCTS",
        policy=PolicyCfg(student_encoder_hidden_dims=(512, 256, 256)),
        runner=RunnerCfg(policy_class_name="ActorCriticMoECTS",
                         algorithm_class_name="MoECTS",
                         experiment_name="go2_moe_cts"))


def go2_moe_ng_cts_train_cfg() -> TrainCfg:
    return TrainCfg(
        seed=0, runner_class_name="OnPolicyRunnerCTS",
        policy=PolicyCfg(obs_no_goal_mask=_NO_GOAL_MASK_45),
        runner=RunnerCfg(policy_class_name="ActorCriticMoENGCTS",
                         algorithm_class_name="MoENGCTS",
                         experiment_name="go2_moe_no_goal_cts"))


def go2_mcp_cts_train_cfg() -> TrainCfg:
    return TrainCfg(
        seed=0, runner_class_name="OnPolicyRunnerCTS",
        policy=PolicyCfg(obs_no_goal_mask=_NO_GOAL_MASK_45),
        runner=RunnerCfg(policy_class_name="ActorCriticMCPCTS",
                         algorithm_class_name="MCPCTS",
                         experiment_name="go2_mcp_cts"))


def go2_ac_moe_cts_train_cfg() -> TrainCfg:
    return TrainCfg(
        seed=0, runner_class_name="OnPolicyRunnerCTS",
        policy=PolicyCfg(),
        runner=RunnerCfg(policy_class_name="ActorCriticACMoECTS",
                         algorithm_class_name="ACMoECTS",
                         experiment_name="go2_ac_moe_cts"))


def go2_dual_moe_cts_train_cfg() -> TrainCfg:
    return TrainCfg(
        seed=0, runner_class_name="OnPolicyRunnerCTS",
        policy=PolicyCfg(student_encoder_hidden_dims=(512, 256, 256)),
        runner=RunnerCfg(policy_class_name="ActorCriticDualMoECTS",
                         algorithm_class_name="DualMoECTS",
                         experiment_name="go2_dual_moe_cts"))
