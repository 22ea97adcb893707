"""MuJoCo sim2sim deployment runner (PyTorch port of scripts/sim2sim.py).

Counterpart of reference deploy/deploy_mujoco/deploy_go2.py's CLI (headless
by default: use --video to record offscreen, --record-moe to capture gating
weights/latents like --visualize-moe-weights / --save-moe-latent,
--interactive for the live viewer with teleop where a display exists).

Usage:
    python -m go2_rl_gym_tpu_torch.scripts.sim2sim \
        [--config go2_rl_gym_tpu_torch/deploy/configs/go2.yaml] \
        [--policy path.pt] [--scene flat] [--cmd 1.0 0.0 0.0] \
        [--video out.mp4] [--record-moe moe.npz]
"""
from __future__ import annotations

import argparse
import json
import os

import yaml

from go2_rl_gym_tpu_torch.deploy import mujoco_eval

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "deploy", "configs", "go2.yaml")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--policy", default=None)
    p.add_argument("--scene", default=None)
    p.add_argument("--cmd", nargs=3, type=float, default=None)
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--record-moe", default=None)
    p.add_argument("--interactive", action="store_true",
                   help="live mujoco viewer + teleop + velocity arrows "
                        "(+ MoE HUD with --record-moe); needs a display")
    args = p.parse_args(argv)

    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    policy_path = args.policy or cfg["policy_path"]
    scene = args.scene or cfg.get("scene", "flat")
    cmd = tuple(args.cmd) if args.cmd else tuple(cfg.get("cmd_init", (1, 0, 0)))
    duration = args.duration or float(cfg.get("simulation_duration", 10.0))

    policy = mujoco_eval.TorchPolicy(policy_path,
                                     record_moe=bool(args.record_moe))
    if args.interactive:
        from go2_rl_gym_tpu_torch.deploy.viewer import run_interactive
        run_interactive(policy, scene, duration_s=min(duration, 600.0),
                        simulation_dt=float(cfg.get("simulation_dt", 0.002)),
                        control_decimation=int(cfg.get("control_decimation", 10)),
                        kp=float(cfg.get("kp", 20.0)),
                        kd=float(cfg.get("kd", 0.5)),
                        action_scale=float(cfg.get("action_scale", 0.25)),
                        fixed_cmd=cmd, moe_hud=bool(args.record_moe))
        return None
    res = mujoco_eval.run_episode(
        policy, scene, cmd, duration_s=min(duration, 120.0),
        simulation_dt=float(cfg.get("simulation_dt", 0.002)),
        control_decimation=int(cfg.get("control_decimation", 10)),
        kp=float(cfg.get("kp", 20.0)), kd=float(cfg.get("kd", 0.5)),
        action_scale=float(cfg.get("action_scale", 0.25)),
        video_path=args.video)
    if args.record_moe and policy.moe_weights:
        policy.save_moe_traces(args.record_moe)
        print(f"saved MoE traces to {args.record_moe}")
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
