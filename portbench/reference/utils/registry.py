"""Task registry (PyTorch port of go2_rl_gym_tpu/utils/registry.py), cut
to the tasks the benchmark's configurations run: name -> (env cfg, train
cfg) factories.

Counterpart of reference legged_gym/utils/task_registry.py:15-129 +
legged_gym/envs/__init__.py:9-15.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from portbench.reference.env import config as cfgs

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


# ---- the reference tasks of the benchmark's configurations
# (legged_gym/envs/__init__.py:9-15) ----
register("go2", cfgs.Go2Cfg, cfgs.go2_ppo_train_cfg)
register("go2_moe_cts", cfgs.Go2Cfg, cfgs.go2_moe_cts_train_cfg)
