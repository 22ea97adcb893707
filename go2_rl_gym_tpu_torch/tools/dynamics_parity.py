"""Dynamics parity harness: the port's N-major engine vs CPU MuJoCo.

Twin of tools/dynamics_parity.py. The reference's engine (PhysX) is
closed; the acceptance bar of the from-scratch engine is matching
MuJoCo-validated Go2 dynamics. This tool steps both simulators from
identical states under identical PD targets and reports the trajectory
divergence: MuJoCo through the port's deploy/mujoco_eval.load_scene_model,
the engine as sim/engine.py's `substep` at N = 1 on `device`.

Usage:
    python -m go2_rl_gym_tpu_torch.tools.dynamics_parity [--steps 100] \\
        [--scenario stand|drop|walk|spawn] [--device cuda]
    python -m go2_rl_gym_tpu_torch.tools.dynamics_parity --report \\
        [build/dynamics_parity.json]
Prints a JSON summary; `run_parity` is importable. ``spawn`` reproduces the
training reset distribution (0.42 m drop, dof_pos = default x U[0.5, 1.5],
legged_robot.py:620-707). --report runs every scenario at a 5 s horizon and
writes the report under build/ (the committed doc/evidence/parity.json is
the JAX package's and is never overwritten).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build")
DEFAULT_REPORT = os.path.join(BUILD, "dynamics_parity.json")
SCENARIOS = ("stand", "drop", "walk", "spawn")

DEFAULT_Q = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                      0.1, 1.0, -1.5, -0.1, 1.0, -1.5], np.float32)


def _scenario(scenario, steps, dt, rng):
    """(z0, PD targets (steps, 12), initial joint angles)."""
    if scenario in ("stand", "drop", "spawn"):
        z0 = {"stand": 0.33, "drop": 0.5, "spawn": 0.42}[scenario]
        targets = np.tile(DEFAULT_Q, (steps, 1))
    elif scenario == "walk":
        z0 = 0.33
        t = np.arange(steps)[:, None] * dt
        phase = 2 * np.pi * 2.0 * t  # 2 Hz trot-ish excitation
        offs = 0.2 * np.sin(phase + np.array([0] * 3 + [np.pi] * 3
                                             + [np.pi] * 3 + [0] * 3))
        targets = DEFAULT_Q + offs * np.array([0, 1, 1] * 4)
    else:
        raise ValueError(scenario)
    q_init = DEFAULT_Q.copy()
    if scenario == "spawn":
        q_init = (DEFAULT_Q * rng.uniform(0.5, 1.5, 12)).astype(np.float32)
    return z0, targets, q_init


def _mujoco_rollout(z0, q_init, targets, dt, kp, kd):
    """MuJoCo trajectory rows [pos(3), quat wxyz(4), q(12)] and the total
    normal ground force per step."""
    import mujoco

    from go2_rl_gym_tpu_torch.deploy.mujoco_eval import load_scene_model

    m = load_scene_model("flat")
    m.opt.timestep = dt
    d = mujoco.MjData(m)
    d.qpos[:3] = [0, 0, z0]
    d.qpos[3:7] = [1, 0, 0, 0]  # wxyz
    d.qpos[7:] = q_init
    mujoco.mj_forward(m, d)
    traj, fzs = [], []
    cf = np.zeros(6)
    for tgt in targets:
        d.ctrl[:] = (tgt - d.qpos[7:]) * kp - d.qvel[6:] * kd
        mujoco.mj_step(m, d)
        traj.append(np.concatenate([d.qpos[:3], d.qpos[3:7], d.qpos[7:]]))
        fz = 0.0
        for ci in range(d.ncon):
            mujoco.mj_contactForce(m, d, ci, cf)
            # contact frame: x = normal (into geom1); world normal z-comp
            fz += abs(cf[0] * d.contact[ci].frame[2])
        fzs.append(fz)
    return np.stack(traj), np.asarray(fzs)


def _engine_rollout(z0, q_init, targets, dt, kp, kd, device):
    """The port's engine at N = 1: the same rows (quaternion converted from
    xyzw to wxyz) and the total ground force (feet + other bodies)."""
    import torch

    from go2_rl_gym_tpu_torch.sim import engine
    from go2_rl_gym_tpu_torch.sim.model import go2_model

    model = go2_model()
    step = engine.make_batched_substep(model, engine.SimParams(dt=dt),
                                       engine.flat_terrain(), device=device)
    dev = torch.device(device)
    dyn = engine.DynParams(*[x[None].to(dev) for x in
                             engine.default_dyn_params(model)])
    effort = torch.as_tensor(model.dof_effort_limit, dtype=torch.float32,
                             device=dev)
    kd_t = torch.full((1, 12), kd, device=dev)

    def row(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)[None]
    s = engine.SimState(row([0.0, 0.0, z0]), row([0.0, 0.0, 0.0, 1.0]),
                        row(q_init), row(np.zeros(3)), row(np.zeros(3)),
                        row(np.zeros(12)))
    rows, fzs = [], []
    for tgt in row(targets)[0]:
        tau = torch.clamp(kp * (tgt - s.q) - kd * s.qd, -effort, effort)
        s, out = step(dyn, s, tau, kd_t)
        quat = s.base_quat[0]
        rows.append(torch.cat([s.base_pos[0], quat[3:], quat[:3], s.q[0]]))
        fzs.append(out.foot_forces[0, :, 2].sum()
                   + out.contact_forces[0, :, 2].sum())
    return (torch.stack(rows).cpu().numpy().astype(np.float64),
            torch.stack(fzs).cpu().numpy().astype(np.float64))


def run_parity(steps=200, scenario="stand", dt=0.005, kp=20.0, kd=0.5,
               seed=0, device="cuda"):
    """Both rollouts of `scenario` and their divergence (the JAX tool's
    keys: final heights, max errors, errors at 0.25-5 s, the ground-force
    profile)."""
    from go2_rl_gym_tpu_torch.device import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    z0, targets, q_init = _scenario(scenario, steps, dt, rng)
    mj_traj, mj_fz = _mujoco_rollout(z0, q_init, targets, dt, kp, kd)
    our_traj, our_fz = _engine_rollout(z0, q_init, targets, dt, kp, kd,
                                       device)

    pos_err = np.linalg.norm(mj_traj[:, :3] - our_traj[:, :3], axis=1)
    # quat distance (handle double cover)
    qdot = np.abs(np.sum(mj_traj[:, 3:7] * our_traj[:, 3:7], axis=1))
    ang_err = 2 * np.arccos(np.clip(qdot, -1, 1))
    joint_err = np.abs(mj_traj[:, 7:] - our_traj[:, 7:]).max(axis=1)

    def at(t_s):
        i = min(int(t_s / dt) - 1, steps - 1)
        return dict(pos=float(pos_err[i]), ang=float(ang_err[i]),
                    joint=float(joint_err[i]))

    res = {
        "scenario": scenario,
        "steps": steps,
        "final_z_mujoco": float(mj_traj[-1, 2]),
        "final_z_ours": float(our_traj[-1, 2]),
        "max_pos_err": float(pos_err.max()),
        "max_joint_err": float(joint_err.max()),
    }
    for t_s in (0.25, 0.5, 1.0, 2.0, 5.0):
        if t_s <= steps * dt + 1e-9:
            res[f"err_at_{t_s}s"] = at(t_s)
    # ground-reaction-force profile comparison (weight 147.3 N reference)
    settle = min(int(0.5 / dt), steps // 2)
    res["grf"] = {
        "peak_fz_mujoco": float(mj_fz.max()),
        "peak_fz_ours": float(our_fz.max()),
        "settled_mean_fz_mujoco": float(mj_fz[settle:].mean()),
        "settled_mean_fz_ours": float(our_fz[settle:].mean()),
        "settled_mean_abs_diff": float(
            np.abs(mj_fz[settle:] - our_fz[settle:]).mean()),
    }
    return res


def write_report(path=DEFAULT_REPORT, steps=1000, device="cuda"):
    """Run every scenario at a 5 s horizon and write the report to `path`,
    which must lie under build/."""
    path = os.path.abspath(path)
    if os.path.commonpath([path, BUILD]) != BUILD:
        raise ValueError(f"the report goes under {BUILD}, not {path}")
    report = {"horizon_s": steps * 0.005, "engine": "go2_rl_gym_tpu_torch",
              "device": str(device),
              "scenarios": {sc: run_parity(steps, sc, device=device)
                            for sc in SCENARIOS}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {path}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--scenario", default="stand", choices=SCENARIOS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--report", nargs="?", const=DEFAULT_REPORT, default=None,
                   help="write the full multi-scenario 5 s report here "
                        "(under build/)")
    args = p.parse_args(argv)
    if args.report:
        write_report(args.report, device=args.device)
    else:
        print(json.dumps(run_parity(args.steps, args.scenario,
                                    device=args.device), indent=2))


if __name__ == "__main__":
    main()
