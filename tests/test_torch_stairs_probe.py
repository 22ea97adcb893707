"""PyTorch port: the stairs probe (go2_rl_gym_tpu_torch/tools/
stairs_probe.py) against the JAX tool (tools/stairs_probe.py), and the
riser threshold as a parameter of the terrain build.

* probe_level at 8 envs, level 8, 60 policy steps, in both modes (the
  riser snap, and none): the JAX tool's probe from its env's init
  (PRNGKey 0), the port's from that state bridged across; survival equal,
  progress within 1e-5 m. The JAX side sets its module global as its tool
  does; the port passes the threshold to the env. Noise, friction DR,
  pushes and the action delay are off in both tools. Past 60 steps robots
  start to end their episodes, and the tools record an ending env's
  progress at its reset position, which the envs draw from different
  random streams.
* build_channels: the default threshold gives the channels of before the
  parameter existed (the JAX package's, bit for bit), inf gives the JAX
  package's channels with its global at inf, and the two modes differ on
  the probe's stairs.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.ops import terrain_patches as jtp
from go2_rl_gym_tpu_torch.ops import terrain_patches as ttp
from go2_rl_gym_tpu_torch.sim import engine as te
from go2_rl_gym_tpu_torch.tools import stairs_probe as tsp
from test_torch_env import bridge_env_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TASK = "go2_moe_cts"
N, LEVEL, STEPS, VX = 8, 8, 60, 0.6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", [m for m, _ in tsp.MODES])
def test_probe_matches_the_jax_tool(mode, monkeypatch):
    import tools.stairs_probe as jsp
    thresh = dict(tsp.MODES)[mode]
    monkeypatch.setattr(jtp, "RISER_SLOPE_THRESHOLD", thresh)
    jenv, jtc = jsp.build_env(TASK, N)
    jmodel, jparams, jhist = jsp.load_policy(jenv, jtc, tsp.DEFAULT_POLICY)
    want = jsp.probe_level(jenv, jmodel, jparams, jhist, LEVEL, STEPS, VX)
    js = jenv.init_state(jax.random.PRNGKey(0))

    env, tc = tsp.build_env(TASK, N, thresh, device="cpu")
    np.testing.assert_array_equal(env.terrain.channels.numpy(),
                                  np.asarray(jenv.terrain.channels))
    model, hist = tsp.load_policy(env, tc, tsp.DEFAULT_POLICY)
    got = tsp.probe_level(env, model, hist, LEVEL, STEPS, VX,
                          state=bridge_env_state(js))
    assert got["level"] == want["level"] == LEVEL
    assert got["survival"] == want["survival"]
    for k in ("mean_progress_m", "p90_progress_m"):
        assert abs(got[k] - want[k]) < 1e-5, (k, got, want)
    assert want["mean_progress_m"] > 0.1     # the robots walk


def test_riser_threshold_is_a_parameter(monkeypatch):
    env_cfg, _ = tsp.probe_cfgs(TASK, N)
    from go2_rl_gym_tpu_torch.terrain import generator
    grid = generator.build_terrain(env_cfg.terrain, seed=0)
    h, s = grid.heights_m, grid.horizontal_scale
    default = ttp.build_channels(h, s)
    np.testing.assert_array_equal(
        default, ttp.build_channels(h, s, ttp.RISER_SLOPE_THRESHOLD))
    np.testing.assert_array_equal(default, jtp.build_channels(h, s))
    off = ttp.build_channels(h, s, float("inf"))
    monkeypatch.setattr(jtp, "RISER_SLOPE_THRESHOLD", float("inf"))
    np.testing.assert_array_equal(off, jtp.build_channels(h, s))
    monkeypatch.undo()
    # the modes differ only in the slope channels, at the risers
    np.testing.assert_array_equal(default[0], off[0])
    assert np.count_nonzero(default[1:] != off[1:]) > 1000
    assert ttp.RISER_SLOPE_THRESHOLD == 0.75   # no global was changed
    # the direct path's normals take the same parameter
    terrain = te.make_terrain_data(h, s, grid.border_size, with_channels=False)
    xy = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 30.0, (4096, 2)).astype(np.float32))
    n_snap = te.terrain_normal(terrain, xy)
    np.testing.assert_array_equal(
        n_snap.numpy(), te.terrain_normal(terrain, xy, 0.75).numpy())
    n_off = te.terrain_normal(terrain, xy, float("inf"))
    assert bool((n_snap != n_off).any(dim=-1).any())
    assert bool((n_snap[:, :2] == 0).all(dim=-1).sum()
                > (n_off[:, :2] == 0).all(dim=-1).sum())
