"""PyTorch port: the learning diagnostics (go2_rl_gym_tpu_torch/tools/
diagnose_learning.py) against the JAX tool (tools/diagnose_learning.py).

At 16 envs, 40 env steps, with domain randomization, pushes and
observation noise off in both, from the JAX env's init (PRNGKey 0) bridged
across: the per-cause termination counts of the zero-action probe on the
heightfield and of the random-action probe on the plane (the port's policy
replays the JAX tool's draws) equal the JAX tool's, and so do the
printed figures of the summary. The tool's own random policy draws from a
seeded generator.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu_torch.tools import card_check
from go2_rl_gym_tpu_torch.tools import diagnose_learning as tdl
from test_torch_env import bridge_env_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
N, STEPS = 16, 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(cfg):
    for name in card_check.DR_FLAGS:
        setattr(cfg.domain_rand, name, False)
    cfg.noise.add_noise = False
    return cfg


def _jax_env(terrain):
    from go2_rl_gym_tpu.env.go2_env import Go2Env
    from go2_rl_gym_tpu.utils import registry
    env_cfg, train_cfg = registry.get_cfgs("go2")
    env_cfg.env.num_envs = N
    env_cfg.terrain.mesh_type = terrain
    if terrain != "plane":
        env_cfg.terrain.num_rows = 4
        env_cfg.terrain.num_cols = 4
    return Go2Env(_quiet(env_cfg),
                  num_steps_per_env=train_cfg.runner.num_steps_per_env)


@pytest.mark.parametrize("terrain,kind", [("heightfield", "zero"),
                                          ("plane", "random")])
def test_termination_causes_match_the_jax_tool(terrain, kind, capsys):
    import jax.numpy as jnp
    import tools.diagnose_learning as jdl
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env

    jenv = _jax_env(terrain)
    if kind == "zero":
        def jpolicy(state, k):
            return jnp.zeros((N, 12))
        draws = np.zeros((STEPS, N, 12), np.float32)
    else:
        def jpolicy(state, k):
            return jax.random.normal(k, (N, 12))
        draws = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(123), t), (N, 12)))
            for t in range(STEPS)])
    want = jdl.probe(jenv, jpolicy, STEPS, "jax")

    env_cfg, train_cfg = tdl.probe_cfgs(terrain, N)
    env = Go2Env(_quiet(env_cfg),
                 num_steps_per_env=train_cfg.runner.num_steps_per_env,
                 device="cpu")
    state = bridge_env_state(jenv.init_state(jax.random.PRNGKey(0)))
    got = tdl.probe(env, lambda s, t: torch.as_tensor(draws[t]), STEPS,
                    "port", state=state)
    assert got == want
    assert sum(got.values()) > 0, got        # the probe sees terminations
    out = capsys.readouterr().out
    jax_out, port_out = out.split("=== port (40 steps x 16 envs) ===")
    assert f"causes: {want}" in port_out
    # the summary's figures (episode lengths, base heights, base contact
    # forces, foot heights) agree to the printed digits, within a rounding
    assert _figures(port_out) == pytest.approx(_figures(jax_out), abs=0.015,
                                               rel=1e-3)


def _figures(text):
    """The numbers of the summary lines after the causes."""
    import re
    lines = text.split("causes:")[1].splitlines()[1:]
    return [float(x) for line in lines
            for x in re.findall(r"-?\d+\.?\d*", line.split(":", 1)[-1])]


def test_tool_policies():
    env = tdl.make_env("plane", 4, device="cpu")
    assert env.grid is None            # the plane
    z = tdl.zero_policy(env)(None, 0)
    assert z.shape == (4, 12) and not bool(z.any())
    a, b = tdl.random_policy(env), tdl.random_policy(env)
    x0, y0 = a(None, 0), b(None, 0)
    torch.testing.assert_close(x0, y0, rtol=0, atol=0)   # seeded
    assert not torch.equal(a(None, 1), x0)               # a stream
    counts = tdl.probe(env, tdl.random_policy(env), 3, "smoke")
    assert sorted(counts) == sorted(tdl.CAUSES)
