"""Go2 locomotion environment (PyTorch port of go2_rl_gym_tpu/env/go2_env.py).

One `step(state, actions)` reproduces the reference's pipeline (reference
legged_gym/envs/base/legged_robot.py + legged_gym/envs/go2/go2_env.py):
4x-decimation PD control against the T-layout engine, post-physics
bookkeeping, the command machinery (dynamic resampling, limit-vel combos,
zero-command curriculum, per-terrain command caps), terrain / reward /
command curricula, termination, every reward term, turn-over mode, pushes,
domain randomization, and the 45-wide obs and 263-wide privileged obs.

As in the JAX package, resets are dense masked updates (`torch.where` over
the whole batch, no data-dependent shapes), and creation-time DR is re-rolled
at every reset. Every random draw comes from the `torch.Generator` the state
carries (`EnvState.gen`), on the env's device, in a fixed order per step.

Under a data-parallel mesh (distributed/mesh.py) the env is one rank's shard
of the global batch: it inits its envs as their rows of the global init,
all-reduces the command curriculum's two sums, and its step reports metric
sums that the runner all-reduces once per iteration (`_metric_sums`).
"""
from __future__ import annotations

from itertools import product
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from go2_rl_gym_tpu_torch.core import maths
from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
from go2_rl_gym_tpu_torch.env import rewards as reward_lib
from go2_rl_gym_tpu_torch.env.config import Go2Cfg
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.sim import engine, tengine
from go2_rl_gym_tpu_torch.sim.model import RobotModel, go2_model
from go2_rl_gym_tpu_torch.terrain import generator


class EnvState(NamedTuple):
    """Complete batched environment state (legged_robot.py:765-859)."""
    sim: engine.SimState                   # batched (N, ...)
    dyn: engine.DynParams                  # batched
    # reset-time DR (legged_robot.py:195-206)
    motor_strength: torch.Tensor           # (N,12)
    motor_offset: torch.Tensor             # (N,12)
    kp_mult: torch.Tensor                  # (N,12)
    kd_mult: torch.Tensor                  # (N,12)
    # action / dof bookkeeping
    actions: torch.Tensor                  # (N,12)
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor
    last_dof_vel: torch.Tensor
    episode_length: torch.Tensor           # (N,) int32
    # feet
    feet_air_time: torch.Tensor            # (N,4)
    last_contacts: torch.Tensor            # (N,4) bool
    last_contacts2: torch.Tensor           # (N,4) bool
    # commands
    commands: torch.Tensor                 # (N,4)
    commands_resampling_step: torch.Tensor  # (N,)
    commands_xy_accum: torch.Tensor        # (N,2)
    stop_heading: torch.Tensor             # (N,) bool
    last_is_limit_vel: torch.Tensor        # (N,) bool
    turn_over_timer: torch.Tensor          # (N,)
    # performance-based command curriculum (vanilla variant)
    cmd_range_x: torch.Tensor              # (2,)
    # terrain
    terrain_levels: torch.Tensor           # (N,) int32
    terrain_types: torch.Tensor            # (N,) int32
    terrain_ids: torch.Tensor              # (N,) int32 terrain-type id
    env_origins: torch.Tensor              # (N,3)
    max_move_distance: torch.Tensor        # (N,)
    # cached sim outputs (post-physics refresh)
    torques: torch.Tensor                  # (N,12)
    contact_forces: torch.Tensor           # (N,13,3)
    foot_forces: torch.Tensor              # (N,4,3)
    foot_pos: torch.Tensor                 # (N,4,3)
    foot_vel: torch.Tensor                 # (N,4,3)
    # episodic reward accumulators
    episode_sums: Dict[str, torch.Tensor]  # name -> (N,)
    common_step_counter: torch.Tensor      # () int32
    gen: torch.Generator                   # every random draw of the env


class StepOutput(NamedTuple):
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    rew: torch.Tensor
    done: torch.Tensor
    time_outs: torch.Tensor
    metrics: Dict[str, torch.Tensor]


def _where(mask, new, old):
    """Masked update; `mask` is (N,) and broadcasts over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)),
                       new, old)


class Go2Env:
    """Builds static tables from cfg and exposes init/step functions.

    `device` defaults to the card; without one it raises (pass
    device="cpu" to run on the CPU). With a `mesh` the env is that rank's
    shard of the cfg.env.num_envs envs (`attach_mesh`). `riser_threshold`
    is the heightfield's riser snap (ops/terrain_patches.build_channels);
    inf turns it off."""

    def __init__(self, cfg: Go2Cfg, model: Optional[RobotModel] = None,
                 num_steps_per_env: int = 24, terrain_seed: int = 0,
                 device="cuda", mesh: Optional[mesh_lib.Mesh] = None,
                 riser_threshold: float = tp.RISER_SLOPE_THRESHOLD):
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = cfg
        self.model = model or go2_model()
        # the batch this env steps; under a mesh, its shard of the global one
        self.num_envs_global = self.num_envs = cfg.env.num_envs
        self.env_ids = np.arange(self.num_envs)     # global env indices
        self.mesh = None
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.dt
        self.max_episode_length = cfg.max_episode_length
        self.max_episode_length_s = cfg.env.episode_length_s
        self.num_steps_per_env = num_steps_per_env

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        self.sim_params = engine.SimParams(dt=cfg.sim.dt, gravity=cfg.sim.gravity)

        # ---- terrain ----
        if cfg.terrain.mesh_type in ("heightfield", "trimesh"):
            self.grid = generator.build_terrain(cfg.terrain, seed=terrain_seed)
            self.terrain = engine.make_terrain_data(
                self.grid.heights_m, self.grid.horizontal_scale,
                self.grid.border_size, device=dev,
                riser_threshold=riser_threshold)
            self.terrain_origins = f32(self.grid.env_origins)
            # empty in randomized mode -> per-terrain caps/ids disabled
            # (reference legged_robot.py:863-870, 1074-1075)
            self.cols2id = (torch.as_tensor(np.asarray(self.grid.cols2id),
                                            dtype=torch.int32, device=dev)
                            if len(self.grid.cols2id) else None)
            self.custom_origins = True
            self.terrain_type_names = {
                name: torch.as_tensor(np.asarray(cols), dtype=torch.int32,
                                      device=dev)
                for name, cols in self.grid.name2cols.items()}
        else:
            self.grid = None
            self.terrain = engine.flat_terrain(device=dev)
            self.cols2id = None
            self.custom_origins = False
            self.terrain_type_names = {}
            # grid of robots (legged_robot.py:1081-1091)
            num_cols = int(np.floor(np.sqrt(self.num_envs)))
            num_rows = int(np.ceil(self.num_envs / num_cols))
            xx, yy = np.meshgrid(np.arange(num_rows), np.arange(num_cols),
                                 indexing="ij")
            spacing = cfg.env.env_spacing
            origins = np.zeros((self.num_envs, 3), np.float32)
            origins[:, 0] = spacing * xx.flatten()[: self.num_envs]
            origins[:, 1] = spacing * yy.flatten()[: self.num_envs]
            self.flat_origins = self._flat_origins_global = f32(origins)

        # ---- joint defaults / gains (legged_robot.py:843-859) ----
        angles = np.zeros(12, np.float32)
        kp = np.zeros(12, np.float32)
        kd = np.zeros(12, np.float32)
        for i, name in enumerate(self.model.dof_names):
            angles[i] = cfg.init_state.default_joint_angles[name]
            for dof_name, val in cfg.control.stiffness.items():
                if dof_name in name:
                    kp[i] = val
                    kd[i] = cfg.control.damping[dof_name]
        self.default_dof_pos = f32(angles)
        self.p_gains = f32(kp)
        self.d_gains = f32(kd)
        self.torque_limits = f32(self.model.dof_effort_limit)
        self.dof_vel_limits = f32(self.model.dof_vel_limit)

        # soft dof limits (legged_robot.py:366-375)
        lo = self.model.dof_lower
        hi = self.model.dof_upper
        mid = (lo + hi) / 2
        rng = hi - lo
        soft = cfg.rewards.soft_dof_pos_limit
        self.soft_dof_limits = f32(
            np.stack([mid - 0.5 * rng * soft, mid + 0.5 * rng * soft], 1))

        # ---- height-scan points (legged_robot.py:1172-1186) ----
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y),
                             indexing="ij")
        pts = np.zeros((gx.size, 3), np.float32)
        pts[:, 0] = gx.flatten()
        pts[:, 1] = gy.flatten()
        self.height_points = f32(pts)
        self.num_height_points = gx.size
        scan_mask = ((np.abs(pts[:, 0]) <= 0.2) & (np.abs(pts[:, 1]) <= 0.15))
        self.base_scan_mask = f32(scan_mask.astype(np.float32))
        self.num_base_scan = float(scan_mask.sum())

        # ---- contact body groups: 0 base, 1+3l hips, 2+3l thighs, 3+3l calfs
        self.termination_bodies = (0,)
        self.penalized_bodies = tuple(
            b for b in range(self.model.nb)
            if any(n in self.model.body_names[b].lower()
                   for n in cfg.asset.penalize_contacts_on))
        # the step's constant tensors, made once on the device: a tensor
        # built from host data in the step would copy from the host
        long = dict(dtype=torch.long, device=dev)
        self._termination_idx = torch.as_tensor(self.termination_bodies,
                                                **long)
        self._penalized_idx = torch.as_tensor(self.penalized_bodies, **long)
        self._hip_idx = torch.as_tensor((0, 3, 6, 9), **long)  # the hips
        self._gravity_dir = f32([0.0, 0.0, -1.0])
        self._forward_axis = f32([1.0, 0.0, 0.0])
        self._default_dyn = engine.default_dyn_params(self.model, dev)

        # ---- command machinery tables ----
        c = cfg.commands
        self.limit_vel_comb = torch.as_tensor(list(product(
            c.limit_vel["lin_vel_x"], c.limit_vel["lin_vel_y"],
            c.limit_vel["ang_vel_yaw"])), dtype=torch.int32, device=dev)
        caps = np.zeros((len(c.terrain_max_command_ranges), 4, 2), np.float32)
        for i, entry in enumerate(c.terrain_max_command_ranges):
            caps[i, 0] = entry["lin_vel_x"]
            caps[i, 1] = entry["lin_vel_y"]
            caps[i, 2] = entry["ang_vel_yaw"]
            caps[i, 3] = entry["heading"]
        self.terrain_cmd_caps = f32(caps)
        self.cmd_curriculum = sorted(c.command_range_curriculum,
                                     key=lambda e: e["iter"])
        r = c.ranges
        self.base_cmd_ranges = f32([list(r.lin_vel_x), list(r.lin_vel_y),
                                    list(r.ang_vel_yaw), list(r.heading)])
        self.cmd_stages = [
            (e["iter"], f32([e["lin_vel_x"], e["lin_vel_y"],
                             e["ang_vel_yaw"], e["heading"]]))
            for e in self.cmd_curriculum]

        # ---- rewards ----
        scales = {k: v for k, v in cfg.rewards.scales.items() if v != 0.0}
        to_scales = ({k: v for k, v in cfg.rewards.turn_over_scales.items()
                      if v != 0.0}
                     if cfg.init_state.turn_over else {})
        self.reward_scales = {k: v * self.dt for k, v in scales.items()}
        self.turn_over_scales = {k: v * self.dt for k, v in to_scales.items()}
        names = set(self.reward_scales) | set(self.turn_over_scales)
        self.termination_scale = self.reward_scales.pop("termination", None)
        names.discard("termination")
        self.reward_names = sorted(names)
        self.curriculum_rewards = {e["reward_name"]: e
                                   for e in (cfg.rewards.curriculum_rewards or [])}
        ds = cfg.rewards.dynamic_sigma
        self.terrain_max_sigmas = f32(ds["max_sigma"]) if ds else None

        # ---- noise vector (go2_env.py:9-21) ----
        ns = cfg.noise.noise_scales
        lvl = cfg.noise.noise_level
        os_ = cfg.normalization.obs_scales
        nv = np.zeros(self.num_obs, np.float32)
        nv[0:3] = ns.ang_vel * lvl * os_.ang_vel
        nv[3:6] = ns.gravity * lvl
        nv[6:9] = 0.0
        nv[9:21] = ns.dof_pos * lvl * os_.dof_pos
        nv[21:33] = ns.dof_vel * lvl * os_.dof_vel
        nv[33:45] = 0.0
        self.noise_vec = f32(nv)
        self.commands_scale = f32([os_.lin_vel, os_.lin_vel, os_.ang_vel])

        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.physics_step = tengine.make_physics_step(
            self.model, self.sim_params, self.terrain, cfg.control.decimation)
        if mesh is not None:
            self.attach_mesh(mesh)

    def attach_mesh(self, mesh: mesh_lib.Mesh):
        """Make this env rank `mesh.rank`'s shard of the global batch of
        cfg.env.num_envs envs: it steps the envs of global index
        `mesh.env_ids()`, whose init is their rows of the global init (the
        terrain levels and types and the plane's grid origins are functions
        of the global index), and its curriculum and metrics are global.
        Every rank builds the same terrain from the same terrain seed."""
        if mesh.num_envs != self.num_envs_global:
            raise ValueError(f"the mesh covers {mesh.num_envs} envs, the "
                             f"config {self.num_envs_global}")
        if mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the "
                             f"env on {self.device}")
        self.mesh = mesh
        self.num_envs = mesh.local_envs
        self.env_ids = mesh.env_ids()
        if self.grid is None:
            self.flat_origins = self._flat_origins_global[mesh.env_slice]

    # ------------------------------------------------------------------
    # Curriculum helpers (pure functions of the iteration counter)
    # ------------------------------------------------------------------

    def _current_iter(self, counter):
        return counter // self.num_steps_per_env

    @staticmethod
    def _interp_curriculum(entry, it):
        """Linear interpolation (legged_robot.py:154-168)."""
        pct = ((it - entry["start_iter"]) /
               max(entry["end_iter"] - entry["start_iter"], 1))
        pct = torch.clamp(pct, 0.0, 1.0)
        return (1.0 - pct) * entry["start_value"] + pct * entry["end_value"]

    def _reward_curriculum_scale(self, name, it):
        if name not in self.curriculum_rewards:
            return None
        return self._interp_curriculum(self.curriculum_rewards[name], it)

    def _command_ranges(self, it, cmd_range_x):
        """Piecewise command ranges (replaces the list-pop mutation at
        legged_robot.py:433-446). Returns (4,2) rows
        [lin_vel_x, lin_vel_y, ang_vel_yaw, heading]."""
        base = self.base_cmd_ranges
        if self.cfg.commands.curriculum:
            base = torch.cat([cmd_range_x[None], base[1:]], dim=0)
        for start, stage in self.cmd_stages:
            base = torch.where(it >= start, stage, base)
        return base

    def _env_command_ranges(self, ranges, terrain_ids):
        """Per-env ranges = global ranges clipped by per-terrain-type caps
        (legged_robot.py:861-907). Returns (N,4,2)."""
        if self.grid is None or self.cols2id is None:
            return ranges.expand(self.num_envs, 4, 2)
        caps = self.terrain_cmd_caps[terrain_ids.long()]  # (N,4,2)
        lo = torch.maximum(caps[..., 0], ranges[None, :, 0])
        hi = torch.minimum(caps[..., 1], ranges[None, :, 1])
        return torch.stack([lo, hi], dim=-1)

    # ------------------------------------------------------------------
    # Reset pieces (masked dense updates)
    # ------------------------------------------------------------------

    def _sample_dyn(self, gen) -> engine.DynParams:
        """Physical-property DR (reference creation-time callbacks,
        legged_robot.py:320-402), dense over all envs."""
        dr = self.cfg.domain_rand
        N = self.num_envs
        nb = self.model.nb
        base = self._default_dyn
        mass = base.mass.expand(N, nb).clone()
        com = base.com.expand(N, nb, 3).clone()
        inertia = base.inertia.expand(N, nb, 3, 3).clone()
        if dr.randomize_base_mass:
            mass[:, 0] += maths.uniform(gen, (N,), *dr.added_mass_range)
        if dr.randomize_link_mass:
            mult = maths.uniform(gen, (N, nb - 1), *dr.multiplied_link_mass_range)
            mass[:, 1:] *= mult
            inertia[:, 1:] *= mult[..., None, None]
        if dr.randomize_base_com:
            com[:, 0] += maths.uniform(gen, (N, 3), *dr.added_base_com_range)
        if dr.randomize_friction:
            fr = maths.uniform(gen, (N,), *dr.friction_range)
        else:
            fr = torch.full((N,), self.cfg.terrain.static_friction,
                            device=self.device)
        # combine = (terrain + robot)/2
        friction = (self.cfg.terrain.static_friction + fr) / 2.0
        if dr.randomize_restitution:
            re = maths.uniform(gen, (N,), *dr.restitution_range)
        else:
            re = torch.zeros(N, device=self.device)
        restitution = (self.cfg.terrain.restitution + re) / 2.0
        return engine.DynParams(mass=mass, com=com, inertia=inertia,
                                friction=friction, restitution=restitution)

    def _sample_control_dr(self, gen):
        dr = self.cfg.domain_rand
        shape = (self.num_envs, 12)
        ones = torch.ones(shape, device=self.device)
        strength = (maths.uniform(gen, shape, *dr.motor_strength_range)
                    if dr.randomize_motor_strength else ones)
        offset = (maths.uniform(gen, shape, *dr.motor_zero_offset_range)
                  if dr.randomize_motor_zero_offset else torch.zeros_like(ones))
        kp_m = (maths.uniform(gen, shape, *dr.stiffness_multiplier_range)
                if dr.randomize_pd_gains else ones)
        kd_m = (maths.uniform(gen, shape, *dr.damping_multiplier_range)
                if dr.randomize_pd_gains else ones)
        return strength, offset, kp_m, kd_m

    def _sample_root_state(self, gen, env_origins):
        """Spawn pose/velocity (legged_robot.py:635-707), dense (N, ...)."""
        cfg = self.cfg.init_state
        N = self.num_envs
        dev = self.device
        yaw = maths.uniform(gen, (N,), -np.pi, np.pi)
        roll = torch.zeros(N, device=dev)
        z_off = torch.full((N,), cfg.pos[2], device=dev)
        turn_timer = torch.zeros(N, device=dev)
        if cfg.turn_over:
            prob = maths.rand(gen, (N,))
            p_back, p_side, _ = cfg.turn_over_proportions
            back = prob < p_back
            side = (prob >= p_back) & (prob < p_back + p_side)
            hb = maths.uniform(gen, (N,), *cfg.turn_over_init_heights["backflip"])
            hs = maths.uniform(gen, (N,), *cfg.turn_over_init_heights["sideflip"])
            side_sign = torch.where(maths.rand(gen, (N,)) < 0.5, 1.0, -1.0)
            roll = torch.where(back, np.pi,
                               torch.where(side, side_sign * np.pi / 2, 0.0))
            z_off = torch.where(back, hb, torch.where(side, hs, z_off))
            tz = self.cfg.commands.turn_over_zero_time
            turn_timer = torch.where(back, tz["backflip"],
                                     torch.where(side, tz["sideflip"], 0.0))
        quat = maths.quat_from_euler_xyz(roll, torch.zeros_like(roll), yaw)
        pos = env_origins + torch.stack(
            [torch.zeros_like(z_off), torch.zeros_like(z_off), z_off], dim=-1)
        if self.custom_origins:
            jitter = maths.uniform(gen, (N, 2), -1.0, 1.0)
            pos = torch.cat([pos[:, :2] + jitter, pos[:, 2:]], dim=1)
        vel = maths.uniform(gen, (N, 6), -0.5, 0.5)
        return pos, quat, vel, turn_timer

    def _sample_dofs(self, gen):
        mult = maths.uniform(gen, (self.num_envs, 12), 0.5, 1.5)
        return self.default_dof_pos * mult

    def _update_terrain_curriculum(self, state: EnvState, done, gen):
        """Game-inspired terrain curriculum (legged_robot.py:1143-1169)."""
        cfg = self.cfg
        if self.grid is None or not cfg.terrain.curriculum:
            return state.terrain_levels, state.terrain_types, state.env_origins
        dist = state.max_move_distance
        move_up = dist > self.grid.env_length / 2
        if cfg.terrain.move_down_by_accumulated_xy_command:
            zero_p = self._zero_command_proba(
                self._current_iter(state.common_step_counter))
            need = (torch.linalg.vector_norm(state.commands_xy_accum, dim=1)
                    * (cfg.commands.resampling_time * (1 - zero_p)) * 0.5)
            move_down = (dist < need) & ~move_up
        else:
            move_down = (dist < torch.linalg.vector_norm(
                state.commands[:, :2], dim=1)
                * self.max_episode_length_s * 0.5) & ~move_up
        levels = (state.terrain_levels + move_up.to(torch.int32)
                  - move_down.to(torch.int32))
        max_level = cfg.terrain.num_rows
        rand_lvl = torch.randint(0, max_level, (self.num_envs,), generator=gen,
                                 device=self.device, dtype=torch.int32)
        levels = torch.where(levels >= max_level, rand_lvl,
                             torch.clamp(levels, min=0))
        levels = torch.where(done, levels, state.terrain_levels)
        origins = _where(done, self._origins_at(levels, state.terrain_types),
                         state.env_origins)
        return levels, state.terrain_types, origins

    def _origins_at(self, levels, types):
        """terrain_origins[levels, types] with indices clamped into the grid,
        as a JAX gather clamps them (init levels reach
        max_init_terrain_level, which may exceed num_rows - 1)."""
        rows, cols = self.terrain_origins.shape[:2]
        return self.terrain_origins[levels.long().clamp(0, rows - 1),
                                    types.long().clamp(0, cols - 1)]

    def _zero_command_proba(self, it):
        zc = self.cfg.commands.zero_command_curriculum
        if zc is None:
            return torch.zeros((), device=self.device)
        return self._interp_curriculum(zc, it)

    # ------------------------------------------------------------------
    # Command resampling (legged_robot.py:423-592), dense masked
    # ------------------------------------------------------------------

    def _resample_commands(self, state: EnvState, mask, gen):
        cfg = self.cfg.commands
        N = self.num_envs
        it = self._current_iter(state.common_step_counter)
        ranges = self._command_ranges(it, state.cmd_range_x)
        env_ranges = self._env_command_ranges(ranges, state.terrain_ids)  # (N,4,2)
        max_lin_vel = torch.max(torch.abs(ranges[:2]))

        commands = state.commands
        stop_heading = torch.where(mask, False, state.stop_heading)
        resample_step = torch.where(
            mask, cfg.resampling_time / self.dt, state.commands_resampling_step)

        remaining_dist = torch.clamp(
            0.625 * self.cfg.terrain.terrain_length
            - torch.linalg.vector_norm(state.commands_xy_accum, dim=1)
            * cfg.resampling_time, min=0.0)

        if cfg.dynamic_resample_commands:
            vel_low = torch.clamp(
                remaining_dist
                / ((self.max_episode_length - state.episode_length + 1e-9)
                   * self.dt), min=0.0)
            cx = maths.sample_disjoint_intervals(
                gen, vel_low, env_ranges[:, 0, 0], env_ranges[:, 0, 1])
            cy = maths.sample_disjoint_intervals(
                gen, vel_low, env_ranges[:, 1, 0], env_ranges[:, 1, 1])
            cz = maths.sample_single_interval(
                gen, env_ranges[:, 2, 0], env_ranges[:, 2, 1])
            ch = maths.sample_single_interval(
                gen, env_ranges[:, 3, 0], env_ranges[:, 3, 1])
        else:
            cx = maths.sample_single_interval(
                gen, env_ranges[:, 0, 0], env_ranges[:, 0, 1])
            cy = maths.sample_single_interval(
                gen, env_ranges[:, 1, 0], env_ranges[:, 1, 1])
            cz = maths.sample_single_interval(
                gen, env_ranges[:, 2, 0], env_ranges[:, 2, 1])
            ch = maths.sample_single_interval(
                gen, env_ranges[:, 3, 0], env_ranges[:, 3, 1])
            # zero small commands (legged_robot.py:507)
            small = torch.linalg.vector_norm(torch.stack([cx, cy], 1),
                                             dim=1) <= 0.2
            cx = torch.where(small, 0.0, cx)
            cy = torch.where(small, 0.0, cy)

        if cfg.heading_command:
            new_cmd = torch.stack([cx, cy, state.commands[:, 2], ch], dim=1)
        else:
            new_cmd = torch.stack([cx, cy, cz, state.commands[:, 3]], dim=1)
        commands = _where(mask, new_cmd, commands)

        # --- limit-vel sampling (legged_robot.py:509-553) ---
        rand_prob = maths.rand(gen, (N,))
        min_prob = 0.0
        last_is_limit = state.last_is_limit_vel
        if cfg.limit_vel_prob > 0.0:
            lim_mask = (mask & (rand_prob >= min_prob)
                        & (rand_prob < min_prob + cfg.limit_vel_prob))
            if cfg.limit_vel_invert_when_continuous:
                invert = lim_mask & state.last_is_limit_vel
                flipped = torch.cat([-commands[:, :3], commands[:, 3:]], dim=1)
                commands = _where(invert, flipped, commands)
                change = lim_mask & ~state.last_is_limit_vel
            else:
                change = lim_mask
            idx = torch.randint(0, self.limit_vel_comb.shape[0], (N,),
                                generator=gen, device=self.device)
            comb = self.limit_vel_comb[idx]                       # (N,3)

            def pick(axis):
                lim = torch.where(comb[:, axis] == -1,
                                  env_ranges[:, axis, 0], env_ranges[:, axis, 1])
                return torch.where(comb[:, axis] == 0, 0.0, lim)
            lim_cmd = torch.stack([pick(0), pick(1), pick(2)], dim=1)
            commands = _where(change, torch.cat([lim_cmd, commands[:, 3:]], 1),
                              commands)
            if cfg.heading_command and cfg.stop_heading_at_limit:
                stop_heading = torch.where(lim_mask, True, stop_heading)
            last_is_limit = torch.where(mask, lim_mask, state.last_is_limit_vel)
            min_prob += cfg.limit_vel_prob

        # --- zero-command curriculum (legged_robot.py:556-583) ---
        zero_p = self._zero_command_proba(it)
        next_resample = torch.clamp(
            self.max_episode_length - state.episode_length
            - remaining_dist / (0.8 * max_lin_vel * self.dt + 1e-9),
            0.0, cfg.resampling_time / self.dt)
        zero_mask = (mask & (rand_prob >= min_prob)
                     & (rand_prob < min_prob + zero_p) & (next_resample > 0.0))
        commands = _where(zero_mask, torch.cat(
            [torch.zeros_like(commands[:, :2]), commands[:, 2:]], 1), commands)
        resample_step = torch.where(zero_mask, next_resample, resample_step)
        if cfg.limit_ang_vel_at_zero_command_prob > 0.0:
            ang_rand = maths.rand(gen, (N,))
            add_ang = zero_mask & (ang_rand < cfg.limit_ang_vel_at_zero_command_prob)
            direction = maths.rand(gen, (N,))
            ang_cmd = torch.where(direction < 0.5,
                                  env_ranges[:, 2, 0], env_ranges[:, 2, 1])
            commands = _where(add_ang, torch.cat(
                [commands[:, :2], ang_cmd[:, None], commands[:, 3:]], 1),
                commands)
            if cfg.heading_command:
                stop_heading = torch.where(add_ang, True, stop_heading)

        # --- turn-over zero command (legged_robot.py:586-590) ---
        if self.cfg.init_state.turn_over:
            to_mask = mask & (state.turn_over_timer > 0)
            commands = _where(to_mask, torch.cat(
                [torch.zeros_like(commands[:, :3]), commands[:, 3:]], 1),
                commands)
            stop_heading = torch.where(to_mask, True, stop_heading)

        xy_accum = state.commands_xy_accum + torch.where(
            mask[:, None], commands[:, :2], 0.0)

        return state._replace(
            commands=commands,
            commands_resampling_step=resample_step,
            commands_xy_accum=xy_accum,
            stop_heading=stop_heading,
            last_is_limit_vel=last_is_limit,
        )

    # ------------------------------------------------------------------
    # Heights / observations
    # ------------------------------------------------------------------

    def _get_heights(self, sim: engine.SimState, patch_data=None):
        """187-point yaw-rotated height scan (legged_robot.py:1188-1224).

        When the physics step extracted terrain patches this reuses them
        (one in-patch lookup instead of a 187 x N global gather)."""
        if self.grid is None:
            return torch.zeros((self.num_envs, self.num_height_points),
                               device=self.device)
        # yaw-only rotation from the quat's z,w components (normalized)
        qz = sim.base_quat[:, 2:3]
        qw = sim.base_quat[:, 3:4]
        nrm = torch.sqrt(qz * qz + qw * qw) + 1e-9
        qz, qw = qz / nrm, qw / nrm
        cos_t = 1.0 - 2.0 * qz * qz
        sin_t = 2.0 * qz * qw
        hx = self.height_points[:, 0]          # (P,)
        hy = self.height_points[:, 1]
        px = sim.base_pos[:, 0:1] + cos_t * hx - sin_t * hy    # (N,P)
        py = sim.base_pos[:, 1:2] + sin_t * hx + cos_t * hy
        t = self.terrain
        if patch_data is not None:
            from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
            patches_flat, origins = patch_data
            ix = ((px + t.border_offset) / t.horizontal_scale).to(torch.int32)
            iy = ((py + t.border_offset) / t.horizontal_scale).to(torch.int32)
            hmin, _, _ = tp.lookup(patches_flat, origins, ix, iy)
            return hmin
        return engine.height_at(t, px, py)

    def _base_height_est(self, sim, measured_heights):
        """Estimated base height above ground (legged_robot.py:1387-1397)."""
        if not self.cfg.terrain.measure_heights or self.grid is None:
            return sim.base_pos[:, 2]
        ground = (torch.sum(measured_heights * self.base_scan_mask, dim=1)
                  / self.num_base_scan)
        return sim.base_pos[:, 2] - ground

    def _observations(self, sim, commands, actions, measured_heights,
                      base_ang_vel_b, projected_gravity, base_lin_vel_b,
                      torques, foot_forces, dof_acc, gen):
        os_ = self.cfg.normalization.obs_scales
        dq = (sim.q - self.default_dof_pos) * os_.dof_pos
        obs = torch.cat([
            base_ang_vel_b * os_.ang_vel,
            projected_gravity,
            commands[:, :3] * self.commands_scale,
            dq,
            sim.qd * os_.dof_vel,
            actions,
        ], dim=-1)
        heights = torch.clamp(
            sim.base_pos[:, 2:3] - 0.5 - measured_heights, -1.0, 1.0
        ) * os_.height_measurements
        priv = torch.cat([
            base_lin_vel_b * os_.lin_vel,
            obs,
            torch.linalg.vector_norm(foot_forces, dim=-1) * 1e-3,
            torques / self.torque_limits,
            dof_acc * 1e-4,
            heights,
        ], dim=-1)
        if self.cfg.noise.add_noise:
            noise = (2.0 * maths.rand(gen, obs.shape) - 1.0) * self.noise_vec
            obs = obs + noise
        clip = self.cfg.normalization.clip_observations
        # NaN passes through clamp: sanitize so a just-reset bad env's stale
        # quantities cannot leak non-finite values into the policy
        obs = torch.where(torch.isfinite(obs), obs, 0.0)
        priv = torch.where(torch.isfinite(priv), priv, 0.0)
        return torch.clamp(obs, -clip, clip), torch.clamp(priv, -clip, clip)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> EnvState:
        """Fresh batched state; every later draw of the env comes from a
        generator on the env's device seeded with `seed`."""
        N = self.num_envs
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        if self.grid is not None:
            max_init = (self.cfg.terrain.max_init_terrain_level
                        if self.cfg.terrain.curriculum
                        else self.cfg.terrain.num_rows - 1)
            # functions of the global env index
            ids, n_all = self.env_ids, self.num_envs_global
            levels = torch.as_tensor(ids % (max_init + 1),
                                     dtype=torch.int32, device=dev)
            types = torch.as_tensor(
                (ids / (n_all / self.cfg.terrain.num_cols)).astype(np.int64),
                dtype=torch.int32, device=dev)
            terrain_ids = (self.cols2id[types.long()]
                           if self.cols2id is not None
                           else torch.zeros(N, dtype=torch.int32, device=dev))
            origins = self._origins_at(levels, types)
        else:
            levels = torch.zeros(N, dtype=torch.int32, device=dev)
            types = torch.zeros(N, dtype=torch.int32, device=dev)
            terrain_ids = torch.full((N,), 8, dtype=torch.int32, device=dev)
            origins = self.flat_origins

        dyn = self._sample_dyn(gen)
        strength, offset, kp_m, kd_m = self._sample_control_dr(gen)
        pos, quat, vel, turn_timer = self._sample_root_state(gen, origins)
        q0 = self._sample_dofs(gen)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        sim = engine.SimState(
            base_pos=pos, base_quat=quat, q=q0,
            base_lin_vel=vel[:, :3].contiguous(),
            base_ang_vel=vel[:, 3:].contiguous(), qd=zeros(N, 12))

        state = EnvState(
            sim=sim, dyn=dyn,
            motor_strength=strength, motor_offset=offset,
            kp_mult=kp_m, kd_mult=kd_m,
            actions=zeros(N, 12), last_actions=zeros(N, 12),
            last_last_actions=zeros(N, 12),
            last_dof_vel=zeros(N, 12),
            episode_length=zeros(N, dtype=torch.int32),
            feet_air_time=zeros(N, 4),
            last_contacts=zeros(N, 4, dtype=torch.bool),
            last_contacts2=zeros(N, 4, dtype=torch.bool),
            commands=zeros(N, 4),
            commands_resampling_step=torch.full(
                (N,), self.cfg.commands.resampling_time / self.dt, device=dev),
            commands_xy_accum=zeros(N, 2),
            stop_heading=zeros(N, dtype=torch.bool),
            last_is_limit_vel=zeros(N, dtype=torch.bool),
            turn_over_timer=turn_timer,
            cmd_range_x=torch.tensor(list(self.cfg.commands.ranges.lin_vel_x),
                                     dtype=torch.float32, device=dev),
            terrain_levels=levels, terrain_types=types, terrain_ids=terrain_ids,
            env_origins=origins,
            max_move_distance=zeros(N),
            torques=zeros(N, 12),
            contact_forces=zeros(N, self.model.nb, 3),
            foot_forces=zeros(N, 4, 3),
            foot_pos=zeros(N, 4, 3),
            foot_vel=zeros(N, 4, 3),
            episode_sums={n: zeros(N) for n in
                          (self.reward_names +
                           (["termination"] if self.termination_scale else []))},
            common_step_counter=torch.zeros((), dtype=torch.int32, device=dev),
            gen=gen,
        )
        return self._resample_commands(
            state, torch.ones(N, dtype=torch.bool, device=dev), gen)

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------

    def step(self, state: EnvState, actions: torch.Tensor):
        """One policy step (reference legged_robot.py:60-100)."""
        if tuple(actions.shape) != (self.num_envs, self.num_actions):
            raise ValueError(f"actions must be ({self.num_envs}, "
                             f"{self.num_actions}), got {tuple(actions.shape)}")
        if not actions.is_floating_point():
            raise TypeError(f"actions must be floating point, got {actions.dtype}")
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        gen = state.gen

        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)

        # ---- decimation loop with action delay (legged_robot.py:71-92);
        # per-substep PD targets precomputed, physics in the T-layout engine
        if cfg.domain_rand.randomize_action_delay:
            start_dec = torch.randint(0, cfg.control.decimation + 1, (N, 1),
                                      generator=gen, device=dev)
        else:
            start_dec = torch.zeros((N, 1), dtype=torch.long, device=dev)
        kp = (self.p_gains * state.kp_mult).expand(N, 12)
        kd = (self.d_gains * state.kd_mult).expand(N, 12)
        dec_idx = torch.arange(cfg.control.decimation, device=dev)
        use = (dec_idx[:, None, None] >= start_dec[None]).to(torch.float32)
        inp = ((1.0 - use) * state.last_actions[None]
               + use * actions[None])                       # (dec, N, 12)
        targets = inp * cfg.control.action_scale + self.default_dof_pos
        strength = (state.motor_strength
                    if cfg.domain_rand.randomize_motor_strength
                    else torch.ones((N, 12), device=dev))
        sim, last_out, torques, patch_data = self.physics_step(
            state.dyn, state.sim, targets, kp, kd, strength,
            state.motor_offset)

        # ---- post-physics (legged_robot.py:102-142) ----
        episode_length = state.episode_length + 1
        counter = state.common_step_counter + 1
        resample_step = state.commands_resampling_step - 1.0
        turn_timer = torch.clamp(state.turn_over_timer - self.dt, min=0.0)

        base_quat = sim.base_quat
        base_lin_vel_b = maths.quat_rotate_inverse(base_quat, sim.base_lin_vel)
        base_ang_vel_b = maths.quat_rotate_inverse(base_quat, sim.base_ang_vel)
        gvec = self._gravity_dir.expand(N, 3)
        projected_gravity = maths.quat_rotate_inverse(base_quat, gvec)
        rpy = maths.quat_to_euler_xyz(base_quat)
        max_move = torch.maximum(
            state.max_move_distance,
            torch.linalg.vector_norm(
                sim.base_pos[:, :2] - state.env_origins[:, :2], dim=1))

        state = state._replace(
            sim=sim, episode_length=episode_length,
            common_step_counter=counter,
            commands_resampling_step=resample_step,
            turn_over_timer=turn_timer, max_move_distance=max_move,
            torques=torques, actions=actions,
            contact_forces=last_out.contact_forces,
            foot_forces=last_out.foot_forces,
            foot_pos=last_out.foot_pos, foot_vel=last_out.foot_vel)

        # ---- callback: resample + heading + heights (legged_robot.py:404-421)
        resample_mask = ((resample_step <= 0.0)
                         & (episode_length < self.max_episode_length - 1))
        state = self._resample_commands(state, resample_mask, gen)
        commands = state.commands
        if cfg.commands.heading_command:
            fwd = maths.quat_rotate(
                base_quat, self._forward_axis.expand(N, 3))
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            it = self._current_iter(counter)
            env_ranges = self._env_command_ranges(
                self._command_ranges(it, state.cmd_range_x), state.terrain_ids)
            yaw_cmd = torch.clamp(
                0.5 * maths.wrap_to_pi(commands[:, 3] - heading),
                env_ranges[:, 2, 0], env_ranges[:, 2, 1])
            with_yaw = torch.cat([commands[:, :2], yaw_cmd[:, None],
                                  commands[:, 3:]], 1)
            commands = _where(state.stop_heading, commands, with_yaw)
            state = state._replace(commands=commands)

        measured_heights = self._get_heights(sim, patch_data)

        # ---- termination (legged_robot.py:170-178) ----
        term_f = state.contact_forces[:, self._termination_idx, :]
        contact_term = torch.any(
            torch.linalg.vector_norm(term_f, dim=-1) > 1.0, dim=1)
        if cfg.init_state.turn_over:
            contact_term = torch.zeros(N, dtype=torch.bool, device=dev)
        time_out = episode_length > self.max_episode_length
        # failsafe: reset any env whose state went non-finite, escaped the
        # world, or reached unphysical speeds (thresholds below the engine's
        # velocity clamps, so a clamped runaway state still trips it)
        bad_state = ~(torch.isfinite(sim.base_pos).all(dim=1)
                      & torch.isfinite(sim.base_quat).all(dim=1)
                      & torch.isfinite(sim.qd).all(dim=1)
                      & (torch.abs(sim.base_pos) < 1e4).all(dim=1)
                      & (torch.abs(sim.base_lin_vel) < 12.0).all(dim=1)
                      & (torch.abs(sim.base_ang_vel) < 30.0).all(dim=1))
        # a base driven below the terrain surface is an invalid state the
        # top-K contact set may fail to report as base contact: terminate
        # (a global gather on the height grid)
        ground_z = engine.terrain_height(self.terrain, sim.base_pos[:, :2])
        bad_state = bad_state | ((sim.base_pos[:, 2] - ground_z) < 0.0)
        reset_buf = contact_term | time_out | bad_state

        # ---- rewards ----
        rew, episode_sums, feet_state = self._compute_rewards(
            state, measured_heights, base_lin_vel_b, base_ang_vel_b,
            projected_gravity, rpy, reset_buf, time_out)
        feet_air_time, last_contacts, last_contacts2 = feet_state
        state = state._replace(feet_air_time=feet_air_time,
                               last_contacts=last_contacts,
                               last_contacts2=last_contacts2,
                               episode_sums=episode_sums)

        # ---- metrics (before sums are cleared); under a mesh the shard's
        # sums, which the runner all-reduces ----
        metrics = (self._metrics(state, reset_buf) if self.mesh is None
                   else self._metric_sums(state, reset_buf))

        # action_smoothness history advances after rewards
        # (legged_robot.py:1373-1379)
        state = state._replace(last_last_actions=state.last_actions)

        # ---- reset (masked, legged_robot.py:180-245) ----
        state = self._reset_envs(state, reset_buf, gen)

        # ---- pushes (legged_robot.py:709-724) ----
        if cfg.domain_rand.push_robots:
            push_mask = (state.episode_length % self.push_interval) == 0
            pv = maths.uniform(gen, (N, 2), -cfg.domain_rand.max_push_vel_xy,
                               cfg.domain_rand.max_push_vel_xy)
            pw = maths.uniform(gen, (N, 3), -cfg.domain_rand.max_push_ang_vel,
                               cfg.domain_rand.max_push_ang_vel)
            sim2 = state.sim
            new_lin = torch.cat([pv, sim2.base_lin_vel[:, 2:]], dim=1)
            sim2 = sim2._replace(
                base_lin_vel=_where(push_mask, new_lin, sim2.base_lin_vel),
                base_ang_vel=_where(push_mask, pw, sim2.base_ang_vel))
            state = state._replace(sim=sim2)

        # ---- observations (stale base quantities for reset envs, matching
        # the reference's refresh ordering) ----
        dof_acc = (state.last_dof_vel - state.sim.qd) / self.dt
        obs, priv = self._observations(
            state.sim, state.commands, state.actions, measured_heights,
            base_ang_vel_b, projected_gravity, base_lin_vel_b,
            state.torques, state.foot_forces, dof_acc, gen)

        # ---- bookkeeping (legged_robot.py:140-142); actions for reset envs
        # were already zeroed inside _reset_envs ----
        state = state._replace(last_actions=state.actions,
                               last_dof_vel=state.sim.qd)

        out = StepOutput(obs=obs, privileged_obs=priv, rew=rew,
                         done=reset_buf, time_outs=time_out, metrics=metrics)
        return state, out

    # ------------------------------------------------------------------

    def _compute_rewards(self, state, measured_heights, base_lin_vel_b,
                         base_ang_vel_b, projected_gravity, rpy,
                         reset_buf, time_out):
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        it = self._current_iter(state.common_step_counter)
        sim = state.sim

        # feet contact filtering (legged_robot.py:1347-1358)
        contact = state.foot_forces[:, :, 2] > 1.0
        contact_filt = contact | state.last_contacts
        last_contacts = contact
        contact_filt2 = contact | state.last_contacts2
        last_contacts2 = contact
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        feet_air_time = state.feet_air_time + self.dt

        # dynamic tracking sigma (legged_robot.py:1300-1345)
        default_sigma = cfg.rewards.tracking_sigma
        ds = cfg.rewards.dynamic_sigma
        if ds is not None and self.grid is not None and cfg.terrain.curriculum:
            tmax = self.terrain_max_sigmas[state.terrain_ids.long()]
            lvl_scale = torch.clamp(
                torch.exp((state.terrain_levels.to(torch.float32) + 1.0) / 10.0)
                - 1.0, max=1.0)

            def dyn_sigma(target_abs, vmin, vmax):
                ratio = torch.clamp((target_abs - vmin) / (vmax - vmin), 0.0, 1.0)
                sig = default_sigma + ratio * (tmax - default_sigma)
                sig = torch.where(target_abs < vmin, default_sigma, sig)
                return default_sigma + lvl_scale * (sig - default_sigma)

            sx = dyn_sigma(torch.abs(state.commands[:, 0]),
                           ds["min_lin_vel"], ds["max_lin_vel"])
            sy = dyn_sigma(torch.abs(state.commands[:, 1]),
                           ds["min_lin_vel"], ds["max_lin_vel"])
            sa = dyn_sigma(torch.abs(state.commands[:, 2]),
                           ds["min_ang_vel"], ds["max_ang_vel"])
            sig_lin = torch.stack([sx, sy], 1)
            sig_ang = sa
        else:
            sig_lin = torch.full((N, 2), default_sigma, device=dev)
            sig_ang = torch.full((N,), default_sigma, device=dev)

        base_h = self._base_height_est(sim, measured_heights)

        ctx = reward_lib.RewardContext(
            base_pos=sim.base_pos, base_quat=sim.base_quat,
            base_lin_vel=base_lin_vel_b, base_ang_vel=base_ang_vel_b,
            projected_gravity=projected_gravity,
            commands=state.commands,
            dof_pos=sim.q, dof_vel=sim.qd, last_dof_vel=state.last_dof_vel,
            actions=state.actions, last_actions=state.last_actions,
            last_last_actions=state.last_last_actions,
            torques=state.torques, contact_forces=state.contact_forces,
            foot_forces=state.foot_forces, foot_pos=state.foot_pos,
            foot_vel=state.foot_vel,
            feet_air_time=feet_air_time, first_contact=first_contact,
            contact_filt=contact_filt2,
            measured_heights=measured_heights, base_height=base_h,
            reset_buf=reset_buf, time_out_buf=time_out,
            default_dof_pos=self.default_dof_pos,
            dof_pos_limits=self.soft_dof_limits,
            dof_vel_limits=self.dof_vel_limits,
            torque_limits=self.torque_limits,
            tracking_sigma_lin=sig_lin, tracking_sigma_ang=sig_ang,
            dt=self.dt, cfg=cfg.rewards,
            penalized_bodies=self._penalized_idx,
            termination_bodies=self._termination_idx,
            hip_idx=self._hip_idx,
        )

        total = torch.zeros(N, device=dev)
        episode_sums = dict(state.episode_sums)
        turn_over = cfg.init_state.turn_over
        need_turn_over = (torch.abs(rpy[:, 0]) > cfg.rewards.turn_over_roll_threshold
                          if turn_over else None)
        for name in self.reward_names:
            raw = reward_lib.REWARD_TERMS[name](ctx)
            rew = raw * self.reward_scales.get(name, 0.0)
            if turn_over:
                to_rew = raw * self.turn_over_scales.get(name, 0.0)
            cscale = self._reward_curriculum_scale(name, it)
            if cscale is not None:
                rew = rew * cscale
                if turn_over:
                    to_rew = to_rew * cscale
            if turn_over:
                rew = torch.where(need_turn_over, to_rew, rew)
            total = total + rew
            episode_sums[name] = episode_sums[name] + rew
        if cfg.rewards.only_positive_rewards:
            total = torch.clamp(total, min=0.0)
        if self.termination_scale is not None:
            term_rew = reward_lib.termination(ctx) * self.termination_scale
            total = total + term_rew
            episode_sums["termination"] = episode_sums["termination"] + term_rew

        # clear feet air time on contact (legged_robot.py:1357)
        feet_air_time = feet_air_time * (~contact_filt)
        # a non-finite reward from a pathological env would poison the global
        # advantage normalization: zero it (the env resets this step anyway)
        total = torch.where(torch.isfinite(total), total, 0.0)
        return total, episode_sums, (feet_air_time, last_contacts, last_contacts2)

    def _metrics(self, state, done):
        """Episode metrics: masked sums + counts (runner divides), matching
        reference extras['episode'] (legged_robot.py:229-245)."""
        return self.finish_metrics(self._metric_sums(state, done))

    def _metric_sums(self, state, done):
        """The metrics as sums over this env's batch, so that the sums of
        the ranks' values are the global batch's: `done_count`, `rew_*`,
        `terrain_level_all` (the level sum over the global env count), and
        per terrain type a (level sum, env count) pair that
        `finish_metrics` divides; `max_command_x` is the same on every
        rank."""
        m = {}
        donef = done.to(torch.float32)
        m["done_count"] = torch.sum(donef)
        for name, sums in state.episode_sums.items():
            m[f"rew_{name}"] = torch.sum(sums * donef) / self.max_episode_length_s
        if self.grid is not None:
            levels = state.terrain_levels
            m["terrain_level_all"] = (torch.sum(levels.to(torch.float32))
                                      / self.num_envs_global)
            for tname, cols in self.terrain_type_names.items():
                in_type = torch.isin(state.terrain_types, cols)
                m[f"terrain_level_{tname}"] = torch.stack([
                    torch.sum(torch.where(in_type, levels, 0)),
                    torch.sum(in_type)]).to(torch.float32)
        else:
            m["terrain_level_all"] = torch.zeros((), device=self.device)
        if self.cfg.commands.curriculum:
            m["max_command_x"] = state.cmd_range_x[1]
        return m

    @staticmethod
    def finish_metrics(sums):
        """`_metric_sums`' per-type (level sum, env count) pairs, the last
        dim of their values, become mean levels (over at least one env);
        the other metrics are kept."""
        return {k: (v[..., 0] / torch.clamp(v[..., 1], min=1.0)
                    if k.startswith("terrain_level_") and k != "terrain_level_all"
                    else v)
                for k, v in sums.items()}

    def _reset_envs(self, state: EnvState, done, gen):
        """Masked env reset (legged_robot.py:180-245)."""
        cfg = self.cfg

        # performance-based command curriculum (legged_robot.py:728-737)
        cmd_range_x = state.cmd_range_x
        if cfg.commands.curriculum:
            # over the done envs of the global batch, so that cmd_range_x
            # stays the same on every rank
            donef = done.to(torch.float32)
            track_sum, done_sum = mesh_lib.all_reduce(self.mesh, [torch.stack([
                torch.sum(state.episode_sums["tracking_lin_vel"] * donef),
                torch.sum(donef)])])[0]
            cnt = torch.clamp(done_sum, min=1.0)
            mean_track = track_sum / cnt / self.max_episode_length
            expand = (mean_track >
                      0.8 * self.reward_scales.get("tracking_lin_vel", 1.0))
            expand = expand & (done_sum > 0)
            new_lo = torch.clamp(cmd_range_x[0] - 0.5,
                                 -cfg.commands.max_curriculum, 0.0)
            new_hi = torch.clamp(cmd_range_x[1] + 0.5,
                                 0.0, cfg.commands.max_curriculum)
            cmd_range_x = torch.where(expand, torch.stack([new_lo, new_hi]),
                                      cmd_range_x)

        # reset-time control DR (legged_robot.py:195-206)
        strength, offset, kp_m, kd_m = self._sample_control_dr(gen)
        # physical-property DR (creation-time class in reference)
        dyn_new = self._sample_dyn(gen)
        dyn = engine.DynParams(*[_where(done, new, old)
                                 for new, old in zip(dyn_new, state.dyn)])

        # terrain curriculum BEFORE root reset (legged_robot.py:208-210)
        levels, types, origins = self._update_terrain_curriculum(
            state, done, gen)
        terrain_ids = (self.cols2id[types.long()]
                       if self.grid is not None and self.cols2id is not None
                       else state.terrain_ids)

        # dof + root reset
        q0 = self._sample_dofs(gen)
        pos, quat, vel, turn_timer = self._sample_root_state(gen, origins)
        sim = state.sim
        sim = engine.SimState(
            base_pos=_where(done, pos, sim.base_pos),
            base_quat=_where(done, quat, sim.base_quat),
            q=_where(done, q0, sim.q),
            base_lin_vel=_where(done, vel[:, :3], sim.base_lin_vel),
            base_ang_vel=_where(done, vel[:, 3:], sim.base_ang_vel),
            qd=_where(done, 0.0, sim.qd))

        episode_sums = {k: torch.where(done, 0.0, v)
                        for k, v in state.episode_sums.items()}

        state = state._replace(
            sim=sim, dyn=dyn,
            motor_strength=_where(done, strength, state.motor_strength),
            motor_offset=_where(done, offset, state.motor_offset),
            kp_mult=_where(done, kp_m, state.kp_mult),
            kd_mult=_where(done, kd_m, state.kd_mult),
            actions=_where(done, 0.0, state.actions),
            last_actions=_where(done, 0.0, state.last_actions),
            last_dof_vel=_where(done, 0.0, state.last_dof_vel),
            feet_air_time=_where(done, 0.0, state.feet_air_time),
            episode_length=torch.where(done, 0, state.episode_length),
            commands_resampling_step=torch.where(
                done, cfg.commands.resampling_time / self.dt,
                state.commands_resampling_step),
            commands_xy_accum=_where(done, 0.0, state.commands_xy_accum),
            turn_over_timer=torch.where(done, turn_timer, state.turn_over_timer),
            cmd_range_x=cmd_range_x,
            terrain_levels=levels, terrain_types=types,
            terrain_ids=terrain_ids, env_origins=origins,
            max_move_distance=torch.where(done, 0.0, state.max_move_distance),
            episode_sums=episode_sums)

        # command resample for reset envs
        return self._resample_commands(state, done, gen)
