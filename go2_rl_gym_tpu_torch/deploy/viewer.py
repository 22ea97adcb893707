"""Interactive MuJoCo deploy tooling: live viewer, gamepad/keyboard teleop,
velocity-arrow overlays, and a MoE gating-weight HUD (copy of
go2_rl_gym_tpu/deploy/viewer.py).

Counterparts of the reference's interactive sim2sim stack:
* velocity arrows — deploy/deploy_mujoco/utils.py:6-112 (command arrow in
  green, measured base velocity in blue, scaled/hidden below 0.1);
* pygame teleop — deploy_go2.py:49-61 (left stick vx/vy, right stick yaw);
* MoE-weight HUD — deploy_go2_moe.py (bar chart of gating weights).

Everything display-bound is import-/runtime-gated so the headless evaluator
(mujoco_eval.py) stays dependency-free; the geometry math (arrow poses) is
plain numpy and unit-testable without GL.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def arrow_pose(start_pos: np.ndarray, vec: np.ndarray, scale: float = 0.7):
    """Arrow placement for a velocity vector: returns (size, pos, mat 3x3)
    or None when the arrow should be hidden (|v|*scale < 0.1, the
    reference's display threshold)."""
    vel_norm = float(np.linalg.norm(vec))
    display_norm = min(vel_norm * scale, 1.0)
    if display_norm < 0.10:
        return None
    z = vec / vel_norm
    # rotation taking +z to `z` (mju_quatZ2Vec equivalent)
    a = np.array([0.0, 0.0, 1.0])
    v = np.cross(a, z)
    c = float(np.dot(a, z))
    if np.linalg.norm(v) < 1e-8:
        mat = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        mat = np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))
    mat = mat.copy()
    mat[:, 2] *= display_norm
    size = np.array([0.02, 0.02, display_norm])
    return size, np.asarray(start_pos, float), mat


def _quat_rotate_wxyz(q, v):
    w, x, y, z = q
    qv = np.array([x, y, z])
    return (v * (2 * w * w - 1) + np.cross(qv, v) * 2 * w
            + qv * np.dot(qv, v) * 2)


def velocity_arrows(qpos, qvel, cmd_xy) -> Sequence[tuple]:
    """Compute the two overlay arrows from mujoco state: [(size,pos,mat,rgba)]
    — command velocity (green) and measured base velocity (blue), both drawn
    in the world frame from 0.2 m above the base."""
    base_pos = np.asarray(qpos[:3], float)
    quat = np.asarray(qpos[3:7], float)           # wxyz
    start = base_pos + _quat_rotate_wxyz(quat, np.array([0.0, 0.0, 0.2]))

    tgt_body = np.array([cmd_xy[0], cmd_xy[1], 0.0])
    # body-frame planar velocity, re-expressed in world for drawing
    inv = np.array([quat[0], -quat[1], -quat[2], -quat[3]])
    cur_body = _quat_rotate_wxyz(inv, np.asarray(qvel[:3], float))
    cur_body[2] = 0.0

    out = []
    for vec_body, rgba in ((tgt_body, (0, 1, 0, 1)), (cur_body, (0, 0, 1, 1))):
        pose = arrow_pose(start, _quat_rotate_wxyz(quat, vec_body))
        if pose is not None:
            out.append((*pose, np.array(rgba, float)))
    return out


def draw_arrows_into_scene(scene, qpos, qvel, cmd_xy, reset: bool = True):
    """Write the overlay arrows into an MjvScene / viewer.user_scn."""
    import mujoco
    if reset:
        scene.ngeom = 0
    for size, pos, mat, rgba in velocity_arrows(qpos, qvel, cmd_xy):
        if scene.ngeom >= scene.maxgeom:
            break
        mujoco.mjv_initGeom(scene.geoms[scene.ngeom],
                            type=mujoco.mjtGeom.mjGEOM_ARROW,
                            size=size, pos=pos, mat=mat.flatten(), rgba=rgba)
        scene.ngeom += 1


class Teleop:
    """Gamepad/keyboard command source (reference deploy_go2.py:49-61).

    Gamepad: left stick -> vx/vy, right stick x -> yaw rate. Keyboard
    fallback: WASD + QE. Degrades to the fixed command when pygame or a
    display is unavailable."""

    def __init__(self, cmd_max=(1.0, 0.5, 1.0), fixed_cmd=(0.8, 0.0, 0.0)):
        self.cmd_max = np.asarray(cmd_max, np.float32)
        self.cmd = np.asarray(fixed_cmd, np.float32)
        self._joystick = None
        self._pygame = None
        try:
            import pygame
            pygame.init()
            pygame.joystick.init()
            if pygame.joystick.get_count() > 0:
                self._joystick = pygame.joystick.Joystick(0)
                self._joystick.init()
            self._pygame = pygame
        except Exception:
            pass

    def poll(self) -> np.ndarray:
        pg = self._pygame
        if pg is None:
            return self.cmd
        pg.event.pump()
        if self._joystick is not None:
            vx = -self._joystick.get_axis(1)
            vy = -self._joystick.get_axis(0)
            wz = -self._joystick.get_axis(3)
            self.cmd = np.array([vx, vy, wz], np.float32) * self.cmd_max
        else:
            keys = pg.key.get_pressed()
            vx = float(keys[pg.K_w]) - float(keys[pg.K_s])
            vy = float(keys[pg.K_a]) - float(keys[pg.K_d])
            wz = float(keys[pg.K_q]) - float(keys[pg.K_e])
            self.cmd = np.array([vx, vy, wz], np.float32) * self.cmd_max
        return self.cmd


class MoEHud:
    """Pygame bar-chart window of MoE gating weights (reference
    deploy_go2_moe.py). No-ops when pygame/display are unavailable."""

    def __init__(self, num_experts: int = 8, size=(320, 200)):
        self.num_experts = num_experts
        self._screen = None
        try:
            import pygame
            pygame.init()
            self._screen = pygame.display.set_mode(size)
            pygame.display.set_caption("MoE gating weights")
            self._pygame = pygame
            self._size = size
        except Exception:
            pass

    def update(self, weights: np.ndarray):
        if self._screen is None:
            return
        pg = self._pygame
        w, h = self._size
        self._screen.fill((20, 20, 24))
        bar_w = w // max(len(weights), 1)
        for i, wt in enumerate(np.asarray(weights).ravel()):
            bh = int(max(min(float(wt), 1.0), 0.0) * (h - 20))
            color = (60, 160, 255)
            pg.draw.rect(self._screen, color,
                         (i * bar_w + 4, h - bh, bar_w - 8, bh))
        pg.display.flip()


def run_interactive(policy, scene: str = "flat", duration_s: float = 60.0,
                    simulation_dt: float = 0.002, control_decimation: int = 10,
                    kp: float = 20.0, kd: float = 0.5,
                    action_scale: float = 0.25,
                    fixed_cmd=(0.8, 0.0, 0.0), moe_hud: bool = False):
    """Live viewer loop: mujoco.viewer + teleop + arrows (+ MoE HUD).

    The control loop mirrors mujoco_eval.run_episode exactly (500 Hz physics,
    50 Hz policy, host-side PD); this adds the interactive surface the
    reference exposes in deploy_go2.py:63-275."""
    import time

    import mujoco
    import mujoco.viewer

    from go2_rl_gym_tpu_torch.deploy.mujoco_eval import (DEFAULT_ANGLES,
                                                         gravity_orientation,
                                                         load_scene_model)

    m = load_scene_model(scene)
    m.opt.timestep = simulation_dt
    d = mujoco.MjData(m)
    teleop = Teleop(fixed_cmd=fixed_cmd)
    hud = MoEHud() if moe_hud else None
    cmd_scale = np.array([2.0, 2.0, 0.25], np.float32)
    action = np.zeros(12, np.float32)
    target = DEFAULT_ANGLES.copy()
    obs = np.zeros(45, np.float32)

    with mujoco.viewer.launch_passive(m, d) as viewer:
        t_end = time.time() + duration_s
        counter = 0
        while viewer.is_running() and time.time() < t_end:
            step_start = time.time()
            tau = (target - d.qpos[7:]) * kp - d.qvel[6:] * kd
            d.ctrl[:] = tau
            mujoco.mj_step(m, d)
            cmd = teleop.poll()
            if counter % control_decimation == 0:
                quat = d.qpos[3:7]
                obs[0:3] = d.qvel[3:6] * 0.25
                obs[3:6] = gravity_orientation(quat)
                obs[6:9] = cmd * cmd_scale
                obs[9:21] = d.qpos[7:] - DEFAULT_ANGLES
                obs[21:33] = d.qvel[6:] * 0.05
                obs[33:45] = action
                action = policy(obs.copy())
                target = action * action_scale + DEFAULT_ANGLES
                if hud is not None and getattr(policy, "moe_weights", None):
                    hud.update(policy.moe_weights[-1])
            draw_arrows_into_scene(viewer.user_scn, d.qpos, d.qvel, cmd[:2])
            viewer.sync()
            counter += 1
            leftover = simulation_dt - (time.time() - step_start)
            if leftover > 0:
                time.sleep(leftover)
