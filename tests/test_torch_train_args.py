"""PyTorch port: the train script's flags against the JAX package's.

* Every flag that `scripts/train.py`'s `get_args` and the port's
  `scripts.train.get_args` share has the same default; the JAX parser is
  built under a patched `sys.argv = ["train.py"]`, the port's from `[]`.
  The flags of one side only are named here: the port's `--device` (the
  torch device) and `--spans` (the device's phase spans, which the JAX
  package lacks), and the JAX script's `--platform` (a JAX platform).
* With no `--task`, the port's script trains the JAX script's default
  task, `go2` (PPO).
* Who trains, as the JAX script's mesh of devices: with no launcher one
  rank per visible card (`own_ranks`), `--num_devices 1` on a mesh of one
  rank in this process; under a launcher or on the CPU the script starts
  no rank itself. W > 1 ranks start as torch.distributed.run of the script
  with the same arguments, in place of this process.
* `--profile_dir` traces iterations 10-12 through a lead-in window into
  `trace.json`; every run ends with its kernel launches as a JSON line.
"""
import importlib.util
import json
import os
import sys

import pytest
import torch

from go2_rl_gym_tpu_torch.scripts import train as train_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"device", "spans"}
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


def test_rank_plan(monkeypatch):
    """Ranks the script starts itself: one per card when more than one is
    visible and --device is cuda; none under a launcher, with --multihost,
    on the CPU, on a named card or with one card; --num_devices wins."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def plan(*argv):
        return train_script.own_ranks(train_script.get_args(list(argv)))
    assert plan() == 4 and plan("--device", "cuda") == 4
    assert plan("--device", "cpu") == 0
    assert plan("--device", "cuda:1") == 0
    assert plan("--multihost") == 0
    assert plan("--num_devices", "2") == 2
    assert plan("--device", "cpu", "--num_devices", "2") == 2
    assert plan("--num_devices", "1") == 1
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert plan() == 0 and plan("--num_devices", "4") == 0
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert plan() == 0


def test_ranks_start_as_torchrun_of_the_script(monkeypatch, capsys):
    """W > 1 ranks with no launcher: this process becomes torch.distributed.run
    --standalone --nproc_per_node W of the script with the same arguments,
    after the checks that each rank would make."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    calls = []

    def execv(path, argv):
        calls.append((path, argv))
        raise SystemExit(0)
    monkeypatch.setattr(os, "execv", execv)
    argv = ["--task", "go2_moe_cts", "--num_envs", "8", "--terrain",
            "plane", "--device", "cpu", "--num_devices", "2"]
    with pytest.raises(SystemExit):
        train_script.main(argv)
    assert calls == [(sys.executable, [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "2", "-m", "go2_rl_gym_tpu_torch.scripts.train",
        *argv])]
    assert "scripts.train: starting 2 ranks on cpu" in capsys.readouterr().out
    with pytest.raises(ValueError, match="3 ranks do not divide"):
        train_script.main(argv[:-1] + ["3"])
    assert len(calls) == 1


def test_num_devices_one_trains_on_a_mesh_of_one(tmp_path, monkeypatch,
                                                  capsys):
    """--num_devices 1 with no launcher: one rank in this process, as the
    JAX script's attach_mesh(n_devices=1); it does not raise."""
    from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    try:
        runner, _ = train_script.main(
            ["--task", "go2_moe_cts", "--num_envs", "4", "--terrain",
             "plane", "--device", "cpu", "--num_devices", "1",
             "--log_root", str(tmp_path), "--max_iterations", "1"])
        assert torch.distributed.get_world_size() == 1
    finally:
        mesh_lib.shutdown()
    out = capsys.readouterr().out
    assert "data-parallel over 1 ranks: rank 0 on cpu, envs [0, 4)" in out
    assert out.splitlines()[-1] == (
        'launches: {"rank": 0, "extract_patches": 0, "rigid_body": 0}')
    assert runner.mesh.world == 1 and runner.current_iteration == 1
    ck = torch.load(os.path.join(runner.log_dir, "model_1.pt"),
                    weights_only=True)
    assert ck["world"] == 1 and ck["iteration"] == 1


def test_profile_dir_traces_iterations_10_to_12(tmp_path, monkeypatch,
                                                 capsys):
    """--profile_dir at 4 envs on the plane for 14 iterations (each cut to
    2 policy steps and one minibatch, to keep the CPU trace small): the
    trace of iterations 10-12, its window opened after a lead-in, holds
    one range over the three iterations and their ops; the run goes on
    to 14."""
    from go2_rl_gym_tpu_torch.tools import profile_rollout as pr
    from go2_rl_gym_tpu_torch.utils import registry
    get_cfgs = registry.get_cfgs

    def short(task):
        env_cfg, tc = get_cfgs(task)
        tc.runner.num_steps_per_env = 2
        tc.algorithm.num_learning_epochs = tc.algorithm.num_mini_batches = 1
        return env_cfg, tc
    monkeypatch.setattr(registry, "get_cfgs", short)
    opened = []
    open_window = pr.open_window
    monkeypatch.setattr(pr, "open_window",
                        lambda *args: opened.append(open_window(*args)))
    prof_dir = tmp_path / "profile"
    runner, _ = train_script.main(
        ["--task", "go2_moe_cts", "--num_envs", "4", "--terrain", "plane",
         "--device", "cpu", "--log_root", str(tmp_path / "logs"),
         "--max_iterations", "14", "--profile_dir", str(prof_dir)])
    assert len(opened) == 1 and runner.current_iteration == 14
    assert {"model_10.pt", "model_13.pt", "model_14.pt"} <= set(
        os.listdir(runner.log_dir))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("profile: ")]
    res = json.loads(line[0][len("profile: "):])
    assert res == {"rank": 0, "trace": str(prof_dir / "trace.json"),
                   "iterations": [10, 12], "kernel_launches": 0,
                   "lost_launches": 0}
    assert os.listdir(prof_dir) == ["trace.json"]
    with open(prof_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    [r] = [e for e in events
           if e.get("name", "").startswith("learn iterations")]
    assert r["name"] == "learn iterations 10-12"
    # the ops of the three iterations lie inside the range
    ops = [e for e in events if e.get("name", "").startswith("aten::")]
    inside = [e for e in ops if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
    assert len(inside) > 3000 and len(inside) > 0.9 * len(ops)
