"""CLI/config helpers (copy of go2_rl_gym_tpu/utils/helpers.py, with the
port's checkpoint files).

Counterparts of reference legged_gym/utils/helpers.py: config<->dict
conversion (class_to_dict:12-27), run/checkpoint resolution
(get_load_path:74-97), CLI overrides (update_cfg_from_args:99-126).
"""
from __future__ import annotations

import dataclasses
import os
import re

# a checkpoint of the port: one torch.save file per saved iteration
CHECKPOINT_RE = re.compile(r"model_(\d+)\.pt$")


def class_to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: class_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: class_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [class_to_dict(v) for v in obj]
    return obj


def get_load_path(root: str, load_run=-1, checkpoint: int = -1) -> str:
    """Latest-run / latest-checkpoint resolution (helpers.py:74-97).

    Checkpoints are files named model_<iter>.pt."""
    runs = sorted(os.listdir(root)) if os.path.isdir(root) else []
    runs = [r for r in runs if os.path.isdir(os.path.join(root, r))]
    # CLI flags arrive as strings: "--load_run -1" must mean "latest" just
    # like the int default (reference helpers.py accepts both)
    if load_run in (-1, "-1"):
        candidates = [r for r in runs
                      if any(CHECKPOINT_RE.match(d)
                             for d in os.listdir(os.path.join(root, r)))]
        if not candidates:
            raise FileNotFoundError(f"no runs with checkpoints under {root}")
        run_dir = os.path.join(root, candidates[-1])
    else:
        run_dir = os.path.join(root, str(load_run))
    models = [d for d in os.listdir(run_dir) if CHECKPOINT_RE.match(d)]
    if not models:
        raise FileNotFoundError(f"no checkpoints in {run_dir}")
    if int(checkpoint) == -1:
        model = max(models, key=lambda m: int(CHECKPOINT_RE.match(m).group(1)))
    else:
        model = f"model_{checkpoint}.pt"
    return os.path.join(run_dir, model)


def update_cfg_from_args(env_cfg, train_cfg, args):
    """CLI overrides (helpers.py:99-126)."""
    if getattr(args, "num_envs", None) is not None:
        env_cfg.env.num_envs = args.num_envs
    if getattr(args, "seed", None) is not None:
        train_cfg.seed = args.seed
        env_cfg.seed = args.seed
    if getattr(args, "max_iterations", None) is not None:
        train_cfg.runner.max_iterations = args.max_iterations
    if getattr(args, "experiment_name", None):
        train_cfg.runner.experiment_name = args.experiment_name
    if getattr(args, "run_name", None):
        train_cfg.runner.run_name = args.run_name
    if getattr(args, "resume", False):
        train_cfg.runner.resume = True
    if getattr(args, "terrain", None):
        env_cfg.terrain.mesh_type = args.terrain
        if args.terrain == "plane":
            env_cfg.terrain.measure_heights = False
            env_cfg.terrain.curriculum = False
    return env_cfg, train_cfg
