"""PyTorch port: the train script's flags against the JAX package's.

* Every flag that `scripts/train.py`'s `get_args` and the port's
  `scripts.train.get_args` share has the same default; the JAX parser is
  built under a patched `sys.argv = ["train.py"]`, the port's from `[]`.
  The flags of one side only are named here: the port's `--device` (the
  torch device) and the JAX script's `--platform` (a JAX platform).
* With no `--task`, the port's script trains the JAX script's default
  task, `go2` (PPO).
"""
import importlib.util
import os
import sys

import pytest
import torch

from go2_rl_gym_tpu_torch.scripts import train as train_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"device"}
JAX_ONLY = {"platform"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def defaults():
    """(JAX defaults, port defaults) as dicts of flag -> default."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_script", os.path.join(ROOT, "scripts", "train.py"))
    jax_script = importlib.util.module_from_spec(spec)
    argv, path = sys.argv, list(sys.path)
    try:
        spec.loader.exec_module(jax_script)
        sys.argv = ["train.py"]
        jax_args = vars(jax_script.get_args())
    finally:
        sys.argv = argv
        sys.path[:] = path
    return jax_args, vars(train_script.get_args([]))


def test_flags_of_one_side_are_the_named_ones(defaults):
    jax_args, port_args = defaults
    assert set(port_args) - set(jax_args) == PORT_ONLY
    assert set(jax_args) - set(port_args) == JAX_ONLY


def test_shared_flags_have_the_jax_defaults(defaults):
    jax_args, port_args = defaults
    shared = sorted(set(jax_args) & set(port_args))
    assert "task" in shared and len(shared) >= 15
    diff = {k: (jax_args[k], port_args[k]) for k in shared
            if jax_args[k] != port_args[k]}
    assert not diff, f"defaults differ (JAX, port): {diff}"
    assert port_args["task"] == "go2"


def test_no_task_trains_go2(tmp_path):
    runner, _ = train_script.main(
        ["--num_envs", "8", "--terrain", "plane", "--device", "cpu",
         "--log_root", str(tmp_path), "--max_iterations", "0"])
    assert runner.cfg.runner.algorithm_class_name == "PPO"
    assert runner.cfg.runner.experiment_name == "go2_ppo"
    assert type(runner.alg).__name__ == "PPO"
