"""PyTorch port, the train iteration as a whole on the CPU.

* One full `train_step` (rollout, GAE, PPO + distillation update, metric
  aggregation) against the JAX runner's jitted train step
  (runner.py:182-295), on the rough parity config of tests/test_torch_env.py
  (8 envs x 4 steps) from the same env state and the same init weights, with
  the act noise and the update's permutations replayed from the JAX
  runner's key sequence (runner.py:194, 266; cts.py:197-199). Both updates
  start from a fresh Adam state. Returns and advantages atol 5e-3 (they sum
  the rollout's rewards and values, held at that tolerance by
  test_torch_rollout.py), metrics rtol 1e-2, params after the 5 x 4 update
  atol 1e-3.
* `learn` for 3 iterations with save_interval 2: checkpoints model_0.pt,
  model_2.pt and the final model_3.pt (the JAX runner's numbering), the
  metrics log and its tags.
* Exact resume: save after one iteration, load into a fresh runner, one
  more iteration: bit-identical to the uninterrupted run.
* `load_params` across env counts (as tests/test_runner.py:121).
* The train script at 8 envs on the CPU, then resumed.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.agents import cts as jcts
from go2_rl_gym_tpu.env.config import Go2Cfg as JCfg
from go2_rl_gym_tpu.env.config import go2_moe_cts_train_cfg as j_train_cfg
from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu.train.runner import OnPolicyRunner as JRunner
from go2_rl_gym_tpu_torch.env.config import Go2Cfg as TCfg
from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg as t_train_cfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as TEnv
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.scripts import train as train_script
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner as TRunner
from go2_rl_gym_tpu_torch.train.runner import RunnerState
from test_torch_env import N, bridge_env_state, parity_cfg
from test_torch_update import jax_perms

T_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy_update(alg, captured):
    """Wrap `alg.update` so that each call records its inputs."""
    update = alg.update

    def spy(*args, **kwargs):
        captured["args"] = args
        return update(*args, **kwargs)
    alg.update = spy


@pytest.fixture(scope="module")
def jax_iteration():
    """The JAX runner, its initial state, and one jitted train step that
    also returns the returns, advantages and key its update received."""
    jc = j_train_cfg()
    jc.runner.num_steps_per_env = T_STEPS
    jr = JRunner(JEnv(parity_cfg(JCfg), num_steps_per_env=T_STEPS), jc)
    rs = jr.init_runner_state(jax.random.PRNGKey(0))
    captured = {}
    _spy_update(jr.alg, captured)
    step = jr._build_train_step()

    def run(rs):
        out = step(rs)
        _, _, returns, advantages, key = captured["args"]
        return out, (returns, advantages, key)
    (rs2, metrics), extra = jax.jit(run)(rs)
    return jr, rs, rs2, metrics, extra


def _replayed_noise(key):
    """The act noise of each rollout step and the update's key, from the
    JAX runner's key sequence (runner.py:194, 266)."""
    noise = []
    for _ in range(T_STEPS):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, (N, 12))))
    _, k_up = jax.random.split(key)
    return np.stack(noise), k_up


def test_train_step_matches_jax(jax_iteration):
    jr, rs, rs2, jm, (j_ret, j_adv, j_key) = jax_iteration
    tc = t_train_cfg()
    tc.runner.num_steps_per_env = T_STEPS
    tr = TRunner(TEnv(parity_cfg(TCfg), num_steps_per_env=T_STEPS,
                      device="cpu"), tc, device="cpu")
    params = jcts.merge_params(rs.train_state.params1, rs.train_state.params2)
    timp.params_from_jax(jax.tree.map(np.asarray, params), tr.alg.model)
    tr.alg.reset_train_state()
    gen = torch.Generator()
    gen.manual_seed(0)
    trs = RunnerState(
        env_state=bridge_env_state(rs.env_state),
        obs=torch.as_tensor(np.asarray(rs.obs)),
        priv_obs=torch.as_tensor(np.asarray(rs.priv_obs)),
        history=torch.as_tensor(np.asarray(rs.history)), gen=gen,
        cur_reward_sum=torch.zeros(N), cur_episode_length=torch.zeros(N))
    noise, k_up = _replayed_noise(rs.key)
    np.testing.assert_array_equal(np.asarray(k_up), np.asarray(j_key))
    captured = {}
    _spy_update(tr.alg, captured)
    trs2, tm = tr.train_step(trs, noise=torch.as_tensor(noise),
                             perms=jax_perms(k_up, jr.alg, T_STEPS))
    _, t_ret, t_adv = captured["args"][:3]

    assert not bool(np.asarray(rs2.env_state.episode_length == 0).any()), \
        "an env reset"
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), atol=5e-3)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), atol=5e-3)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-2, atol=1e-6, err_msg=k)
    got = timp.tree_from_named(tr.alg.model.named_parameters())
    want = jcts.merge_params(rs2.train_state.params1, rs2.train_state.params2)
    wl = dict(jax.tree_util.tree_leaves_with_path(want))
    moved = 0.0
    for path, v in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(v, np.asarray(wl[path]), atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(
            np.asarray(wl[path]) - np.asarray(dict(
                jax.tree_util.tree_leaves_with_path(params))[path])).max()))
    assert moved > 1e-3          # the update moved the weights past atol
    np.testing.assert_allclose(trs2.obs.numpy(), np.asarray(rs2.obs),
                               atol=5e-3)


# ---------------------------------------------------------------------------
# learn, checkpoints, resume, the script
# ---------------------------------------------------------------------------


def _plane_runner(num_envs=8, log_dir=None, steps=T_STEPS):
    """A go2_moe_cts runner on the plane (DR, noise, pushes on)."""
    cfg = TCfg()
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    tc = t_train_cfg()
    tc.runner.num_steps_per_env = steps
    tc.runner.save_interval = 2
    env = TEnv(cfg, num_steps_per_env=steps, device="cpu")
    return TRunner(env, tc, log_dir=log_dir, device="cpu")


def test_learn_saves_and_logs_like_jax(tmp_path):
    runner = _plane_runner(log_dir=str(tmp_path))
    rs = runner.init_runner_state(0, init_at_random_ep_len=True)
    runner.learn(rs, 3, log_every=2, print_every=10)
    assert runner.current_iteration == 3
    # checkpoints at save_interval multiples plus the final model
    saves = sorted(int(d[6:-3]) for d in os.listdir(tmp_path)
                   if d.startswith("model_") and d.endswith(".pt"))
    assert saves == [0, 2, 3], saves
    assert os.path.exists(tmp_path / "config.yaml")
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert sorted({r["step"] for r in rows}) == [0, 2]
    tags = {r["tag"] for r in rows}
    for tag in ("Loss/value", "Loss/surrogate", "Loss/entropy",
                "Loss/latent", "Loss/load_balance", "Loss/learning_rate",
                "Policy/mean_noise_std", "Perf/total_fps",
                "Perf/iteration_time", "Terrain/terrain_level_all"):
        assert tag in tags, tag
    assert all(np.isfinite(r["value"]) for r in rows)


def _snapshot(runner, rs):
    """Every tensor of the train state and the runner state, and both
    generators' states, as one flat dict."""
    out = {f"model.{k}": v.clone()
           for k, v in runner.alg.model.state_dict().items()}
    for tag, opt in (("opt1", runner.alg.opt1), ("opt2", runner.alg.opt2)):
        out[f"{tag}.count"] = opt.count.clone()
        for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
            out[f"{tag}.mu{i}"], out[f"{tag}.nu{i}"] = m.clone(), v.clone()
    out["lr"] = runner.alg.lr.clone()

    def walk(prefix, x):
        if isinstance(x, torch.Generator):
            out[prefix] = x.get_state()
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, tuple):      # RunnerState.memory, () for CTS
            for i, v in enumerate(x):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = x.clone()
    walk("rs", rs)
    return out


def test_train_step_aggregates_like_jax():
    """With episodes ending in the window, train_step sums `rew_*` and
    `done_count` over the rollout's steps and averages the other env
    metrics (JAX runner.py:276-280); ep_stats are summed by the rollout."""
    runner = _plane_runner()
    rs = runner.init_runner_state(0)
    ends = torch.zeros(8, dtype=torch.bool)
    ends[[1, 6]] = True
    rs = rs._replace(env_state=rs.env_state._replace(
        episode_length=torch.where(
            ends, runner.env.max_episode_length - 2,
            rs.env_state.episode_length)))
    captured = {}
    rollout = runner.rollout

    def spy(*args, **kwargs):
        captured["ro"] = out = rollout(*args, **kwargs)
        return out
    runner.rollout = spy
    _, m = runner.train_step(rs)
    ro = captured["ro"][1]
    assert float(m["done_count"]) == 2.0
    assert any(float(v) != 0.0 for k, v in m.items() if k.startswith("rew_"))
    for k, v in ro.metrics.items():
        want = v.sum() if k.startswith("rew_") or k == "done_count" \
            else v.mean()
        assert torch.equal(m[k], want), k
    assert torch.equal(m["ep_stats"], ro.ep_stats)
    assert float(m["ep_stats"][2] + m["ep_stats"][5]) == 2.0


def test_resume_is_exact(tmp_path):
    a = _plane_runner()
    rs = a.init_runner_state(0, init_at_random_ep_len=True)
    rs, _ = a.train_step(rs)
    a.current_iteration = 1
    path = str(tmp_path / "model_1.pt")
    a.save(rs, path)
    rs_a, m_a = a.train_step(rs)

    b = _plane_runner()
    rs_b = b.load(b.init_runner_state(5), path)
    assert b.current_iteration == 1
    rs_b, m_b = b.train_step(rs_b)
    sa, sb = _snapshot(a, rs_a), _snapshot(b, rs_b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k


def test_checkpoint_without_memory_loads(tmp_path):
    """A CTS checkpoint written before RunnerState had its `memory` field
    (empty for CTS) loads and resumes as one that has it."""
    a = _plane_runner()
    rs = a.init_runner_state(0)
    path = str(tmp_path / "model_0.pt")
    a.save(rs, path)
    ck = torch.load(path, weights_only=True)
    assert ck["runner_state"].pop("memory") == ()
    old = str(tmp_path / "old.pt")
    torch.save(ck, old)
    b = _plane_runner()
    rs_b = b.load(b.init_runner_state(5), old)
    assert rs_b.memory == ()
    sa, sb = _snapshot(a, rs), _snapshot(b, rs_b)
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ck["runner_state"].pop("obs")
    torch.save(ck, old)
    with pytest.raises(KeyError):
        b.load(b.init_runner_state(5), old)


def test_load_params_across_env_counts(tmp_path):
    r16 = _plane_runner(16)
    rs = r16.init_runner_state(0)
    path = str(tmp_path / "model_0.pt")
    r16.save(rs, path)
    want = r16.get_inference_params()

    r8 = _plane_runner(8)
    rs8 = r8.init_runner_state(3)
    got = r8.load_params(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="load_params"):
        r8.load(rs8, path)


def test_train_script_runs_and_resumes(tmp_path):
    """The flagship task on the full terrain at 8 envs on the CPU: 2
    iterations, then --resume continues from model_2.pt for one more."""
    argv = ["--task", "go2_moe_cts", "--num_envs", "8", "--device", "cpu",
            "--log_root", str(tmp_path), "--max_iterations", "2"]
    runner, _ = train_script.main(argv)
    run_dir = runner.log_dir
    assert {"model_0.pt", "model_2.pt"} <= set(os.listdir(run_dir))
    runner2, _ = train_script.main(argv[:-1] + ["1", "--resume",
                                                 "--run_name", "again"])
    assert runner2.current_iteration == 3
    assert "model_3.pt" in os.listdir(runner2.log_dir)


def test_script_rejects_what_is_not_ported(tmp_path, monkeypatch):
    """Everything the script offers is ported: --eval_interval reaches the
    runner's evaluator, which exports and submits the final model (the
    evaluator process is replaced by a no-op here; the scoring runs in
    tests/test_torch_eval_hook.py). What it still rejects is a
    --num_devices that the launcher did not start."""
    from go2_rl_gym_tpu_torch.train import eval_hook
    monkeypatch.setattr(eval_hook.AsyncEvaluator, "command",
                        lambda self, policy, out: [sys.executable, "-c", ""])
    runner, _ = train_script.main(
        ["--task", "go2_cts", "--num_envs", "8", "--terrain", "plane",
         "--device", "cpu", "--log_root", str(tmp_path),
         "--max_iterations", "0", "--eval_interval", "5"])
    assert runner.eval_interval == 5
    assert runner.evaluator.scenes == ["flat", "stairs", "cross_slope"]
    assert os.listdir(os.path.join(runner.log_dir, "jit_models")) == [
        "policy_jit_0.pt"]
    # under a launcher of one rank
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="--num_devices 2"):
        train_script.main(["--num_devices", "2", "--device", "cpu"])
