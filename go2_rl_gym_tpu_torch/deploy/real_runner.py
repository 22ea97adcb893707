"""Real-robot deployment runner (Unitree Go2 over DDS), host-side (copy of
go2_rl_gym_tpu/deploy/real_runner.py).

Counterpart of reference deploy/deploy_real/deploy_real_go2.py:40-225: a 50 Hz
LowState -> 45-dim obs -> policy -> LowCmd PD-target loop with the
zero-torque -> move-to-default -> wait -> run state machine and a damping
command on exit. Consumes the TorchScript artifact produced by
go2_rl_gym_tpu_torch.export or the JAX package's exporter (identical
interface to the reference's export, so every stack's policies run here).

This file is import-guarded: ``unitree_sdk2py`` (CycloneDDS native transport)
only exists on the robot's host computer; everything except `main()` is
testable without it.
"""
from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# policy joint order (FL,FR,RL,RR x hip,thigh,calf) -> unitree motor index
# (reference deploy/deploy_real/configs/go2.yaml joint2motor_idx)
JOINT2MOTOR = [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]


@dataclass
class RealDeployConfig:
    """Reference deploy/deploy_real/config_go2.py:7-36 defaults."""
    control_dt: float = 0.02
    kp: float = 20.0
    kd: float = 0.5
    move_to_default_kp: float = 40.0
    move_to_default_kd: float = 1.0
    action_scale: float = 0.25
    ang_vel_scale: float = 0.25
    dof_pos_scale: float = 1.0
    dof_vel_scale: float = 0.05
    cmd_scale: tuple = (2.0, 2.0, 0.25)
    max_cmd: tuple = (1.0, 0.5, 1.0)
    default_angles: tuple = (0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                             0.1, 1.0, -1.5, -0.1, 1.0, -1.5)
    num_obs: int = 45
    num_actions: int = 12


class RemoteController:
    """Decode the 40-byte wireless_remote blob: 16 buttons + 4 stick floats
    (reference deploy/deploy_real/common/remote_controller.py:23-39)."""

    BTN = {name: i for i, name in enumerate(
        ["R1", "L1", "start", "select", "R2", "L2", "F1", "F2",
         "A", "B", "X", "Y", "up", "right", "down", "left"])}

    def __init__(self):
        self.button = [0] * 16
        self.lx = self.ly = self.rx = self.ry = 0.0

    def set(self, data: bytes):
        keys = struct.unpack("H", bytes(data[2:4]))[0]
        for i in range(16):
            self.button[i] = (keys >> i) & 1
        self.lx = struct.unpack("f", bytes(data[4:8]))[0]
        self.rx = struct.unpack("f", bytes(data[8:12]))[0]
        self.ry = struct.unpack("f", bytes(data[12:16]))[0]
        self.ly = struct.unpack("f", bytes(data[20:24]))[0]


def build_observation(cfg: RealDeployConfig, gyro: np.ndarray,
                      gravity_orient: np.ndarray, cmd: np.ndarray,
                      q_motor: np.ndarray, dq_motor: np.ndarray,
                      last_action: np.ndarray) -> np.ndarray:
    """45-dim obs from sensor readings, identical layout to training
    (reference deploy_real_go2.py:150-170)."""
    q = q_motor[JOINT2MOTOR]
    dq = dq_motor[JOINT2MOTOR]
    obs = np.zeros(cfg.num_obs, np.float32)
    obs[0:3] = gyro * cfg.ang_vel_scale
    obs[3:6] = gravity_orient
    obs[6:9] = cmd * np.asarray(cfg.cmd_scale, np.float32)
    obs[9:21] = (q - np.asarray(cfg.default_angles)) * cfg.dof_pos_scale
    obs[21:33] = dq * cfg.dof_vel_scale
    obs[33:45] = last_action
    return obs


def action_to_motor_targets(cfg: RealDeployConfig,
                            action: np.ndarray) -> np.ndarray:
    """policy action -> per-motor position targets (deploy_real_go2.py:171-180)."""
    targets_joint = action * cfg.action_scale + np.asarray(cfg.default_angles)
    motor = np.zeros(12, np.float32)
    motor[JOINT2MOTOR] = targets_joint
    return motor


def gravity_from_quat_wxyz(q: np.ndarray) -> np.ndarray:
    """(w,x,y,z) IMU quaternion -> projected gravity
    (reference deploy/deploy_real/common/rotation_helper.py)."""
    w, x, y, z = q
    return np.array([
        -2 * (x * z - w * y),
        -2 * (y * z + w * x),
        -(1 - 2 * (x * x + y * y)),
    ], np.float32)


def main(net_interface: str = "eth0", policy_path: str = "policy_jit.pt",
         cfg: Optional[RealDeployConfig] = None):  # pragma: no cover
    """50 Hz DDS control loop; requires unitree_sdk2py on the robot host."""
    cfg = cfg or RealDeployConfig()
    import torch
    from unitree_sdk2py.core.channel import (ChannelFactoryInitialize,
                                             ChannelPublisher,
                                             ChannelSubscriber)
    from unitree_sdk2py.idl.default import (unitree_go_msg_dds__LowCmd_,
                                            unitree_go_msg_dds__LowState_)
    from unitree_sdk2py.idl.unitree_go.msg.dds_ import LowCmd_, LowState_
    from unitree_sdk2py.utils.crc import CRC

    policy = torch.jit.load(policy_path)
    policy(torch.zeros(1, cfg.num_obs))  # warmup
    crc = CRC()
    remote = RemoteController()

    ChannelFactoryInitialize(0, net_interface)
    pub = ChannelPublisher("rt/lowcmd", LowCmd_)
    pub.Init()
    state = {"low": None}

    def on_low_state(msg):
        state["low"] = msg
        remote.set(msg.wireless_remote)

    sub = ChannelSubscriber("rt/lowstate", LowState_)
    sub.Init(on_low_state, 10)

    cmd_msg = unitree_go_msg_dds__LowCmd_()
    cmd_msg.head[0], cmd_msg.head[1] = 0xFE, 0xEF
    cmd_msg.level_flag = 0xFF
    cmd_msg.gpio = 0

    def send(targets, kp, kd):
        for i in range(12):
            mc = cmd_msg.motor_cmd[i]
            mc.mode = 0x01
            mc.q = float(targets[i])
            mc.qd = 0.0
            mc.kp = kp
            mc.kd = kd
            mc.tau = 0.0
        cmd_msg.crc = crc.Crc(cmd_msg)
        pub.Write(cmd_msg)

    while state["low"] is None:
        time.sleep(0.01)
    print("LowState received; waiting for START (zero torque)...")
    while not remote.button[RemoteController.BTN["start"]]:
        send(np.zeros(12), 0.0, 0.0)
        time.sleep(cfg.control_dt)

    # move to default over 2 s (deploy_real_go2.py:103-121)
    q0 = np.array([state["low"].motor_state[i].q for i in range(12)])
    targets_default = action_to_motor_targets(cfg, np.zeros(12))
    for step in range(100):
        alpha = (step + 1) / 100.0
        send(q0 * (1 - alpha) + targets_default * alpha,
             cfg.move_to_default_kp, cfg.move_to_default_kd)
        time.sleep(cfg.control_dt)
    print("holding default pose; press A to run...")
    while not remote.button[RemoteController.BTN["A"]]:
        send(targets_default, cfg.move_to_default_kp, cfg.move_to_default_kd)
        time.sleep(cfg.control_dt)

    last_action = np.zeros(12, np.float32)
    try:
        while not remote.button[RemoteController.BTN["select"]]:
            t0 = time.time()
            low = state["low"]
            gyro = np.array(low.imu_state.gyroscope, np.float32)
            grav = gravity_from_quat_wxyz(
                np.array(low.imu_state.quaternion, np.float32))
            q = np.array([low.motor_state[i].q for i in range(12)], np.float32)
            dq = np.array([low.motor_state[i].dq for i in range(12)], np.float32)
            cmd = np.array([remote.ly, -remote.lx, -remote.rx], np.float32)
            cmd = cmd * np.asarray(cfg.max_cmd, np.float32)
            obs = build_observation(cfg, gyro, grav, cmd, q, dq, last_action)
            with torch.no_grad():
                out = policy(torch.from_numpy(obs).unsqueeze(0))
            if isinstance(out, tuple):
                out = out[0]
            last_action = out.numpy().squeeze().astype(np.float32)
            send(action_to_motor_targets(cfg, last_action), cfg.kp, cfg.kd)
            time.sleep(max(0.0, cfg.control_dt - (time.time() - t0)))
    finally:
        # damping on exit (deploy_real_go2.py:219-225)
        for _ in range(10):
            send(np.zeros(12), 0.0, 5.0)
            time.sleep(cfg.control_dt)


if __name__ == "__main__":  # pragma: no cover
    import sys
    main(*(sys.argv[1:]))
