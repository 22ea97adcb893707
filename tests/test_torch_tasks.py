"""PyTorch port: the task registry, the ablation variant configs and their
env paths, VecEnvAdapter, the logger and the train script for the PPO task,
against the JAX package on the CPU.

* `registry.task_names()` equals the JAX package's; every task's env and
  train configs equal JAX's field by field (`dataclasses.asdict`), and each
  builds through get_cfgs / make_env / make_runner with its algorithm.
* Env steps of each variant (randomness off, the parity cut of
  tests/test_torch_env.py): 4 steps from a bridged JAX state, tolerances of
  that file. These reach paths the CTS tasks never take: the heading
  command (go2_vanilla), the plane (go2_fast_flat_move).
* The command-range curriculum of go2_fast_flat_move at iterations around
  each of its 5 stages: equal to JAX's.
* go2_vanilla_dynamic_cmd's dynamic resampling: half the envs resample in
  a step late in their episode; both packages draw x and y commands
  outside (-v, v), v the speed that still covers the remaining distance,
  and leave the other envs' commands alike.
* VecEnvAdapter's contract (as tests/test_vec_env.py) and the logger.
* `scripts.train --task go2` on the CPU for 2 iterations, then resumed.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu.utils import logger as jlogger
from go2_rl_gym_tpu.utils import registry as jreg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as TEnv
from go2_rl_gym_tpu_torch.env.vec_env import VecEnvAdapter
from go2_rl_gym_tpu_torch.scripts import train as train_script
from go2_rl_gym_tpu_torch.tools import card_check
from go2_rl_gym_tpu_torch.utils import logger as tlogger
from go2_rl_gym_tpu_torch.utils import registry as treg
from test_torch_env import N, bridge_env_state

VARIANTS = ["go2_vanilla", "go2_vanilla_dynamic_cmd", "go2_fast_flat_move"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_task_names_match_jax():
    assert treg.task_names() == jreg.task_names()
    assert len(treg.task_names()) == 11


@pytest.mark.parametrize("task", jreg.task_names())
def test_task_configs_match_jax_and_build(task):
    jenv_cfg, jtrain_cfg = jreg.get_cfgs(task)
    env_cfg, train_cfg = treg.get_cfgs(task)
    assert dataclasses.asdict(env_cfg) == dataclasses.asdict(jenv_cfg)
    assert dataclasses.asdict(train_cfg) == dataclasses.asdict(jtrain_cfg)
    plane = env_cfg.terrain.mesh_type == "plane"
    card_check.parity_cfg(env_cfg, N, plane)
    env = treg.make_env(task, env_cfg, num_steps_per_env=4, device="cpu")
    runner = treg.make_runner(task, env, train_cfg, device="cpu")
    alg = train_cfg.runner.algorithm_class_name
    want = {"PPO": "PPO", "RecurrentPPO": "RecurrentPPO"}.get(alg, "CTS")
    assert type(runner.alg).__name__ == want
    rs = runner.init_runner_state(0)
    assert rs.obs.shape == (N, 45) and bool(torch.isfinite(rs.obs).all())
    assert rs.history.shape == (N, runner.history_length, 45)
    assert (rs.memory != ()) == (alg == "RecurrentPPO")


# ---------------------------------------------------------------------------
# the variants' env paths
# ---------------------------------------------------------------------------


def _cfgs(task):
    """Both packages' env configs of `task` with the parity cut."""
    out = []
    for reg in (jreg, treg):
        cfg, _ = reg.get_cfgs(task)
        out.append(card_check.parity_cfg(cfg, N,
                                         cfg.terrain.mesh_type == "plane"))
    return out


@functools.cache
def _variant(task):
    """Both packages' envs of `task` (parity cut), JAX's jitted step, and
    the JAX state after init and one zero-action step; made once per task
    for this module's tests."""
    jc, tc = _cfgs(task)
    je, te = JEnv(jc), TEnv(tc, device="cpu")
    js = je.init_state(jax.random.PRNGKey(0))
    step = jax.jit(je.step)
    js, _ = step(js, jnp.zeros((N, 12)))
    return je, te, step, js


def _assert_step_close(jo, to, rows=slice(None)):
    for k in ("obs", "privileged_obs"):
        np.testing.assert_allclose(getattr(to, k).numpy()[rows],
                                   np.asarray(getattr(jo, k))[rows],
                                   atol=5e-3, err_msg=k)
    np.testing.assert_allclose(to.rew.numpy()[rows], np.asarray(jo.rew)[rows],
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))


@pytest.mark.parametrize("task", VARIANTS)
def test_variant_env_steps_match_jax(task):
    je, te, step, js = _variant(task)
    assert te.cfg.commands.heading_command == (task != "go2_fast_flat_move")
    assert (te.grid is None) == (task == "go2_fast_flat_move")
    ts = bridge_env_state(js)
    rng = np.random.default_rng(0)
    for _ in range(4):
        a = (0.3 * rng.normal(size=(N, 12))).astype(np.float32)
        js, jo = step(js, jnp.asarray(a))
        ts, to = te.step(ts, torch.as_tensor(a))
        assert not bool(np.asarray(jo.done).any()), "an env reset"
        _assert_step_close(jo, to)
        for k, v in jo.metrics.items():
            np.testing.assert_allclose(float(to.metrics[k]), float(v),
                                       rtol=1e-2, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ts.commands.numpy(),
                                   np.asarray(js.commands), atol=1e-4)
    np.testing.assert_allclose(ts.sim.base_pos.numpy(),
                               np.asarray(js.sim.base_pos), atol=1e-3)


def test_command_range_curriculum_matches_jax():
    jc, tc = _cfgs("go2_fast_flat_move")
    je, te = JEnv(jc), TEnv(tc, device="cpu")
    stages = [e["iter"] for e in tc.commands.command_range_curriculum]
    assert len(stages) == 5
    x = np.asarray([-1.0, 1.0], np.float32)
    seen = set()
    for it in [0] + [s + d for s in stages for d in (-1, 0, 1)]:
        want = np.asarray(je._command_ranges(jnp.int32(it), jnp.asarray(x)))
        got = te._command_ranges(torch.tensor(it, dtype=torch.int32),
                                 torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"iteration {it}")
        seen.add(float(got[0, 1]))
    assert seen == {float(np.float32(v))
                    for v in (1.0, 2.0, 2.8, 3.4, 3.8, 4.2)}


def test_dynamic_resample_matches_jax():
    """Envs 0-3 resample in one step at episode step 585 of 1000 with no
    distance covered: the remaining 5 m (0.625 x 8 m) need 0.602 m/s over
    the 415 steps left, so the dynamic draw keeps |x|, |y| >= 0.602; the
    plain one would spread them over [-1, 1]."""
    je, te, step, js = _variant("go2_vanilla_dynamic_cmd")
    tc = te.cfg
    assert tc.commands.dynamic_resample_commands
    resample = np.arange(N) < 4
    js = js._replace(
        episode_length=jnp.full((N,), 584, jnp.int32),
        commands_xy_accum=jnp.zeros((N, 2)),
        commands_resampling_step=jnp.where(jnp.asarray(resample), 1.0,
                                           100.0))
    ts = bridge_env_state(js)
    a = (0.3 * np.random.default_rng(1).normal(size=(N, 12))).astype(
        np.float32)
    js2, jo = step(js, jnp.asarray(a))
    ts2, to = te.step(ts, torch.as_tensor(a))
    remaining = 0.625 * tc.terrain.terrain_length
    v = remaining / ((te.max_episode_length - 585) * te.dt)
    assert 0.6 < v < 0.61
    full = tc.commands.resampling_time / te.dt
    for cmd, step_left in ((np.asarray(js2.commands),
                            np.asarray(js2.commands_resampling_step)),
                           (ts2.commands.numpy(),
                            ts2.commands_resampling_step.numpy())):
        xy = cmd[resample, :2]
        assert (np.abs(xy) >= v - 1e-5).all() and (np.abs(xy) <= 1.0).all()
        assert (np.abs(cmd[resample, 3]) <= 3.14).all()      # heading
        np.testing.assert_allclose(step_left[resample], full, rtol=1e-6)
    keep = ~resample
    np.testing.assert_allclose(ts2.commands.numpy()[keep],
                               np.asarray(js2.commands)[keep], atol=1e-4)
    np.testing.assert_array_equal(ts2.commands_resampling_step.numpy()[keep],
                                  np.asarray(js2.commands_resampling_step)
                                  [keep])
    _assert_step_close(jo, to, keep)


# ---------------------------------------------------------------------------
# VecEnvAdapter, logger
# ---------------------------------------------------------------------------


def _plane_env(num_envs=4):
    cfg, _ = treg.get_cfgs("go2")
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    return TEnv(cfg, device="cpu")


def test_vec_env_contract():
    env = VecEnvAdapter(_plane_env(), seed=0, device="cpu")
    assert (env.num_obs, env.num_privileged_obs, env.num_actions) == \
        (45, 263, 12)
    obs, priv = env.get_observations(), env.get_privileged_observations()
    assert obs.shape == (4, 45) and priv.shape == (4, 263)
    obs2, priv2, rew, done, extras = env.step(np.zeros((4, 12), np.float32))
    assert obs2.shape == (4, 45) and priv2.shape == (4, 263)
    assert rew.shape == (4,) and done.shape == (4,)
    assert "time_outs" in extras and "episode" in extras
    assert bool(torch.isfinite(obs2).all())
    # episode length advances and is settable (init_at_random_ep_len)
    assert int(env.episode_length_buf.max()) >= 1
    env.episode_length_buf = torch.zeros(4, dtype=torch.int32)
    assert int(env.episode_length_buf.max()) == 0
    # the seed fixes the draws; reset draws a new init state
    again = VecEnvAdapter(_plane_env(), seed=0, device="cpu")
    assert torch.equal(again.get_observations(), obs)
    first = again.reset()[0]
    assert not torch.equal(first, obs)


def test_vec_env_runs_on_its_env_device():
    with pytest.raises(ValueError, match="env lives on"):
        VecEnvAdapter(_plane_env(), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            VecEnvAdapter(_plane_env())


def test_logger_matches_jax(capsys):
    out = []
    for mod in (jlogger, tlogger):
        lg = mod.Logger(dt=0.02)
        lg.log_states({"dof_pos": 0.5, "base_vel_x": [1.0, 2.0]})
        lg.log_rewards({"rew_tracking": np.array([0.25, 0.5]),
                        "other": 3.0}, num_episodes=3)
        lg.log_rewards({"rew_tracking": np.array([1.0])}, num_episodes=1)
        lg.print_rewards()
        out.append((capsys.readouterr().out, lg.num_episodes,
                    {k: [np.asarray(x).tolist() for x in v]
                     for k, v in lg.state_log.items()}))
        lg.reset()
        assert lg.num_episodes == 0 and not lg.rew_log
    assert out[0] == out[1]
    assert "rew_tracking" in out[0][0] and out[0][1] == 4


# ---------------------------------------------------------------------------
# the train script for the PPO task
# ---------------------------------------------------------------------------


def test_train_script_go2_runs_and_resumes(tmp_path):
    """The go2 task (PPO) on the plane at 8 envs on the CPU: 2 iterations,
    then --resume continues from model_2.pt for one more."""
    argv = ["--task", "go2", "--num_envs", "8", "--device", "cpu",
            "--terrain", "plane",
            "--log_root", str(tmp_path), "--max_iterations", "2"]
    runner, rs = train_script.main(argv)
    assert type(runner.alg).__name__ == "PPO"
    assert {"model_0.pt", "model_2.pt"} <= set(os.listdir(runner.log_dir))
    with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"Loss/value", "Loss/surrogate", "Loss/learning_rate",
            "Policy/mean_noise_std"} <= tags
    runner2, _ = train_script.main(argv[:-1] + ["1", "--resume",
                                                 "--run_name", "again"])
    assert runner2.current_iteration == 3
    assert "model_3.pt" in os.listdir(runner2.log_dir)
