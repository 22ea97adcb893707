"""MuJoCo sim2sim evaluation CLI (the RoboGauge-style regression check;
PyTorch port of scripts/evaluate.py).

Counterpart of running reference deploy/deploy_mujoco/deploy_go2.py headless +
the RoboGauge scoring loop (on_policy_runner.py:252-295), in-repo. The
TorchScript policy runs on the CPU. The eval hook (train/eval_hook.py)
launches this module once per export.

Usage:
    python -m go2_rl_gym_tpu_torch.scripts.evaluate --policy <policy_jit.pt> \
        [--scenes flat stairs] [--duration 8] [--extended] [--out res.yaml]
"""
from __future__ import annotations

import argparse
import json
import os

import yaml

from go2_rl_gym_tpu_torch.deploy import mujoco_eval


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--policy", required=True, help="TorchScript policy path")
    p.add_argument("--scenes", nargs="+", default=["flat"])
    p.add_argument("--duration", type=float, default=8.0)
    p.add_argument("--extended", action="store_true",
                   help="12-command sweep per scene (3x the base 4-command "
                        "sweep)")
    p.add_argument("--out", default=None, help="write YAML results here")
    args = p.parse_args(argv)

    scores = mujoco_eval.evaluate_policy(
        lambda: mujoco_eval.TorchPolicy(args.policy),
        scenes=args.scenes, duration_s=args.duration,
        commands=(mujoco_eval.EXTENDED_COMMANDS if args.extended
                  else mujoco_eval.BASE_COMMANDS))
    print(json.dumps(scores, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            yaml.safe_dump(scores, f)
    return scores


if __name__ == "__main__":
    main()
