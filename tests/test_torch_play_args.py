"""PyTorch port: the play script's flags against the JAX package's.

* Every flag that `scripts/play.py`'s parser and the port's
  `scripts.play.get_parser` share has the same default. The JAX parser is
  read from its `main` under a patched `sys.argv = ["play.py"]` and a
  patched `ArgumentParser.parse_args` that raises once it has parsed, so
  that nothing of JAX runs. The flags of one side only are named here: the
  port's `--policy`, `--num_envs`, `--seed` and `--device`, and the JAX
  script's `--platform` (a JAX platform).
* With no arguments the port's script does what the JAX script does: it
  plays the latest checkpoint of go2_moe_cts for 250 steps
  (`play_checkpoint`), on the CPU too, and ends with a JSON line.
  `--policy` rolls a .pt policy (`play`; a bare `--policy` the
  committed one).
"""
import argparse
import importlib.util
import json
import os
import sys

import pytest
import torch

from go2_rl_gym_tpu_torch import ops
from go2_rl_gym_tpu_torch.scripts import play as play_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"policy", "num_envs", "seed", "device"}
JAX_ONLY = {"platform"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Parsed(Exception):
    """Raised by the patched parse_args once the JAX parser has parsed."""


@pytest.fixture(scope="module")
def defaults():
    """(JAX defaults, port defaults) as dicts of flag -> default."""
    spec = importlib.util.spec_from_file_location(
        "jax_play_script", os.path.join(ROOT, "scripts", "play.py"))
    jax_script = importlib.util.module_from_spec(spec)
    argv, path = sys.argv, list(sys.path)
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def parse_then_stop(self, args=None, namespace=None):
        seen.update(vars(parse(self, args, namespace)))
        raise _Parsed
    try:
        spec.loader.exec_module(jax_script)
        sys.argv = ["play.py"]
        argparse.ArgumentParser.parse_args = parse_then_stop
        with pytest.raises(_Parsed):
            jax_script.main()
    finally:
        argparse.ArgumentParser.parse_args = parse
        sys.argv = argv
        sys.path[:] = path
    return seen, vars(play_script.get_parser().parse_args([]))


def test_flags_of_one_side_are_the_named_ones(defaults):
    jax_args, port_args = defaults
    assert set(port_args) - set(jax_args) == PORT_ONLY
    assert set(jax_args) - set(port_args) == JAX_ONLY


def test_shared_flags_have_the_jax_defaults(defaults):
    jax_args, port_args = defaults
    shared = sorted(set(jax_args) & set(port_args))
    assert {"task", "steps", "log_root"} <= set(shared) and len(shared) == 6
    diff = {k: (jax_args[k], port_args[k]) for k in shared
            if jax_args[k] != port_args[k]}
    assert not diff, f"defaults differ (JAX, port): {diff}"
    assert (port_args["task"], port_args["steps"]) == ("go2_moe_cts", 250)


@pytest.fixture
def calls(monkeypatch):
    """The mode each call of the script's main took, with its arguments."""
    seen = []

    monkeypatch.setattr(play_script, "play_checkpoint",
                        lambda *args: seen.append(("checkpoint", args)))

    def play(*args):
        seen.append(("policy", args))
        return dict(mean_reward=[0.0], done_share=[0.0],
                    env_steps_per_s=1.0, finite=True)
    monkeypatch.setattr(play_script, "play", play)
    return seen


def test_no_arguments_play_the_latest_checkpoint(calls):
    play_script.main([])
    assert calls == [("checkpoint", (
        "go2_moe_cts", None, -1, -1, os.path.join(ROOT, "logs"), 16, 250, 0,
        "cuda"))]


def test_policy_without_task_rolls_the_policy(calls, capsys):
    play_script.main(["--policy"])
    play_script.main(["--policy", "p.pt", "--num_envs", "8", "--steps", "3",
                      "--device", "cpu"])
    capsys.readouterr()
    assert calls == [
        ("policy", (play_script.DEFAULT_POLICY, 4096, 250, 0, "cuda")),
        ("policy", ("p.pt", 8, 3, 0, "cpu"))]


def test_no_task_plays_the_latest_checkpoint_on_the_cpu(tmp_path, capsys):
    """No --task and no --policy on the CPU: the latest run's latest
    checkpoint of go2_moe_cts is exported and rolled; the last line says
    so as JSON."""
    from go2_rl_gym_tpu_torch.utils import registry
    env_cfg, tc = play_script.play_checkpoint_cfgs("go2_moe_cts")
    env = registry.make_env("go2_moe_cts", env_cfg, device="cpu")
    runner = registry.make_runner("go2_moe_cts", env, tc, device="cpu")
    rs = runner.init_runner_state(0)
    for run, it in (("a_run", 5), ("b_run", 2), ("b_run", 7)):
        d = tmp_path / tc.runner.experiment_name / run
        d.mkdir(parents=True, exist_ok=True)
        runner.save(rs, str(d / f"model_{it}.pt"))
    capsys.readouterr()
    res = play_script.main(["--log_root", str(tmp_path), "--steps", "3",
                            "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = str(tmp_path / tc.runner.experiment_name / "b_run" / "model_7.pt")
    assert res["checkpoint"] == last["checkpoint"] == want
    assert last["exported"] == res["exported"]
    assert sorted(res["exported"]) == ["jit", "onnx", "pkl"]
    assert last["finite"] is res["finite"] is True
    assert last["launches"] == ops.launch_counts()
    assert set(last["launches"]) == {"extract_patches", "rigid_body"}
    assert len(res["mean_reward"]) == 3
