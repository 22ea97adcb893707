"""Task registry (PyTorch port of go2_rl_gym_tpu/utils/registry.py):
name -> (env cfg, train cfg) factories.

Counterpart of reference legged_gym/utils/task_registry.py:15-129 +
legged_gym/envs/__init__.py:9-15: the same eleven tasks as the JAX package
(the seven reference tasks, recurrent PPO and the three ablation variants).
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Callable, Dict, Optional, Tuple

from go2_rl_gym_tpu_torch.distributed.mesh import Mesh
from go2_rl_gym_tpu_torch.env import config as cfgs
from go2_rl_gym_tpu_torch.env import config_variants as _variants
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {}


def register(name: str, env_cfg_fn: Callable, train_cfg_fn: Callable):
    _REGISTRY[name] = (env_cfg_fn, train_cfg_fn)


def task_names():
    return sorted(_REGISTRY)


def get_cfgs(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; available: {task_names()}")
    env_cfg_fn, train_cfg_fn = _REGISTRY[name]
    return env_cfg_fn(), train_cfg_fn()


def make_env(name: str, env_cfg=None, num_envs: Optional[int] = None,
             num_steps_per_env: int = 24, terrain_seed: int = 0,
             device="cuda", mesh: Optional[Mesh] = None) -> Go2Env:
    """The task's env of `num_envs` envs (the config's by default); with a
    `mesh`, this rank's shard of them (a runner made on it trains
    data-parallel)."""
    if env_cfg is None:
        env_cfg, _ = get_cfgs(name)
    if num_envs is not None:
        env_cfg.env.num_envs = num_envs
    return Go2Env(env_cfg, num_steps_per_env=num_steps_per_env,
                  terrain_seed=terrain_seed, device=device, mesh=mesh)


def make_runner(name: str, env: Go2Env, train_cfg=None,
                log_root: Optional[str] = None, run_name: str = "",
                device="cuda", eval_interval: int = 0) -> OnPolicyRunner:
    """The task's runner on `env`; with a `log_root`, logging to
    <log_root>/<experiment>/<date>[_<run_name>] (and scoring its exports in
    MuJoCo every `eval_interval` iterations, when that is set)."""
    if train_cfg is None:
        _, train_cfg = get_cfgs(name)
    log_dir = None
    if log_root is not None:
        stamp = datetime.now().strftime("%b%d_%H-%M-%S")
        log_dir = os.path.join(
            log_root, train_cfg.runner.experiment_name,
            stamp + ("_" + run_name if run_name else ""))
    return OnPolicyRunner(env, train_cfg, log_dir=log_dir, device=device,
                          eval_interval=eval_interval)


# ---- the seven reference tasks (legged_gym/envs/__init__.py:9-15) ----
register("go2", cfgs.Go2Cfg, cfgs.go2_ppo_train_cfg)
register("go2_cts", cfgs.Go2Cfg, cfgs.go2_cts_train_cfg)
register("go2_moe_cts", cfgs.Go2Cfg, cfgs.go2_moe_cts_train_cfg)
register("go2_moe_ng_cts", cfgs.Go2Cfg, cfgs.go2_moe_ng_cts_train_cfg)
register("go2_mcp_cts", cfgs.Go2Cfg, cfgs.go2_mcp_cts_train_cfg)
register("go2_ac_moe_cts", cfgs.Go2Cfg, cfgs.go2_ac_moe_cts_train_cfg)
register("go2_dual_moe_cts", cfgs.Go2Cfg, cfgs.go2_dual_moe_cts_train_cfg)
# recurrent PPO (the reference ships the module but registers no task)
register("go2_lstm", cfgs.Go2Cfg, cfgs.go2_lstm_train_cfg)

# ---- ablation variant tasks (reference go2_config_{vanilla,...}.py) ----
register("go2_vanilla", _variants.go2_vanilla_cfg,
         _variants.go2_vanilla_train_cfg)
register("go2_vanilla_dynamic_cmd", _variants.go2_vanilla_dynamic_cmd_cfg,
         _variants.go2_vanilla_train_cfg)
register("go2_fast_flat_move", _variants.go2_fast_flat_move_cfg,
         _variants.go2_fast_flat_move_train_cfg)
