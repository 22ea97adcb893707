"""Guard for the PyTorch port: no module of go2_rl_gym_tpu_torch (nor
chip_smoke.py) imports JAX, its libraries or the JAX package, and every
public entry point runs on the card unless told otherwise."""
import ast
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "go2_rl_gym_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax",
             "go2_rl_gym_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_guard_sees_the_port():
    files = _port_files()
    assert len(files) > 15
    assert any(f.endswith(os.path.join("sim", "tengine.py")) for f in files)
    # the twins of files outside the JAX package (__graft_entry__.py,
    # tools/) are held to the rule too
    for rel in ("graft_entry.py", "tools/dynamics_parity.py",
                "tools/stairs_probe.py", "tools/diagnose_learning.py",
                "sim/engine.py"):
        assert os.path.join(PORT, *rel.split("/")) in files, rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_guard_flags_the_old_package():
    tree = ast.parse("import jax.numpy as jnp\n"
                     "from go2_rl_gym_tpu.sim import model\n"
                     "from go2_rl_gym_tpu_torch.sim import model\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "jax.numpy", "go2_rl_gym_tpu.sim"]


def test_entry_points_default_to_the_card():
    from go2_rl_gym_tpu_torch.deploy.mujoco_eval import ModelPolicy
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.env.vec_env import VecEnvAdapter
    from go2_rl_gym_tpu_torch.scripts import train
    from go2_rl_gym_tpu_torch.scripts.play import play, play_checkpoint
    from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
    from go2_rl_gym_tpu_torch.utils import registry
    for fn in (Go2Env.__init__, OnPolicyRunner.__init__, play,
               play_checkpoint, ModelPolicy.__init__,
               registry.make_env, registry.make_runner,
               VecEnvAdapter.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert train.get_args([]).device == "cuda"
    from go2_rl_gym_tpu_torch import graft_entry
    from go2_rl_gym_tpu_torch.sim.engine import make_batched_substep
    from go2_rl_gym_tpu_torch.tools import (diagnose_learning,
                                            dynamics_parity, stairs_probe)
    for fn in (graft_entry.entry, graft_entry.dryrun_multichip,
               make_batched_substep, dynamics_parity.run_parity,
               dynamics_parity.write_report, stairs_probe.build_env,
               diagnose_learning.make_env):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # train_step and learn run on the runner's device, the card by default
    assert "device" not in inspect.signature(OnPolicyRunner.train_step).parameters
    assert "device" not in inspect.signature(OnPolicyRunner.learn).parameters


def test_train_entry_points_raise_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    from go2_rl_gym_tpu_torch.scripts import train
    from go2_rl_gym_tpu_torch.utils import registry
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--task", "go2_moe_cts", "--num_envs", "8",
                    "--terrain", "plane"])
    cfg, _ = registry.get_cfgs("go2_cts")
    cfg.terrain.mesh_type = "plane"
    with pytest.raises(RuntimeError, match="cuda"):
        registry.make_env("go2_cts", cfg, num_envs=8)
    env = registry.make_env("go2_cts", cfg, num_envs=8, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        registry.make_runner("go2_cts", env)


def test_export_and_deploy_entry_points_raise_without_a_card(monkeypatch):
    """ModelPolicy and play's checkpoint mode (its --device flag defaults
    to the card too) refuse to fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    from go2_rl_gym_tpu_torch.deploy.mujoco_eval import ModelPolicy
    from go2_rl_gym_tpu_torch.scripts import play
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelPolicy(model)
    with pytest.raises(RuntimeError, match="cuda"):
        play.play_checkpoint("go2_moe_cts", log_root="no_such_dir")
    seen = {}
    monkeypatch.setattr(play, "play_checkpoint",
                        lambda *args: seen.setdefault("args", args))
    play.main(["--task", "go2_moe_cts"])
    assert seen["args"][-1] == "cuda"


def test_slice_six_entry_points_raise_without_a_card():
    """The N-major engine, the graft entry and the tools refuse to fall
    back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    from go2_rl_gym_tpu_torch import graft_entry
    from go2_rl_gym_tpu_torch.sim import engine
    from go2_rl_gym_tpu_torch.sim.model import go2_model
    from go2_rl_gym_tpu_torch.tools import (diagnose_learning,
                                            dynamics_parity, stairs_probe)
    for call in (lambda: graft_entry.entry(),
                 lambda: graft_entry.dryrun_multichip(1),
                 lambda: engine.make_batched_substep(
                     go2_model(), engine.SimParams(), engine.flat_terrain()),
                 lambda: dynamics_parity.main(["--steps", "2"]),
                 lambda: stairs_probe.main(["--steps", "1", "--levels", "2"]),
                 lambda: diagnose_learning.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
