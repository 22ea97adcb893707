"""PyTorch port, the sim2sim eval hook (go2_rl_gym_tpu_torch/train/
eval_hook.py and its use in OnPolicyRunner.learn).

* AsyncEvaluator round trip on the CPU: a port export is scored in MuJoCo
  by `python -m go2_rl_gym_tpu_torch.scripts.evaluate` in a subprocess that
  sees no card, on the flat scene for 1 s, as tests/test_eval_hook.py does
  for the JAX package: tracking, safety, quality and overall in [0, 1] and
  eval_results/results_<it>.yaml written.
* The cap of 3 running evaluations drops the newest submission.
* learn(eval_interval=k) exports at the JAX runner's cadence
  (runner.py:401-463): after iteration it when it % k == 0 and after the
  last, for CTS algorithms only; 2 iterations at interval 1 export 0, 1, 2
  (scored by real evaluators, logged as Eval/*), 3 iterations at interval 2
  export 0, 2, 3.
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from go2_rl_gym_tpu_torch.env.config import Go2Cfg
from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg
from go2_rl_gym_tpu_torch.env.config import go2_ppo_train_cfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch.train import eval_hook
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
from test_torch_export import cts_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = ("tracking", "safety", "quality", "overall")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recording(eval_hook.AsyncEvaluator):
    """The hook's evaluator, recording each process's command and
    environment."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spawned = []

    def _spawn(self, cmd, env):
        self.spawned.append((cmd, env))
        return super()._spawn(cmd, env)


def test_async_evaluator_roundtrip(tmp_path):
    pytest.importorskip("mujoco")
    from go2_rl_gym_tpu_torch.export import exporter
    _, model = cts_pair("cts")
    path = exporter.export_model(model, "jit", "cts", str(tmp_path))
    ev = Recording(str(tmp_path), scenes=("flat",), duration_s=1.0)
    ev.submit(path, iteration=7)
    results = ev.wait_all(timeout=300)
    assert 7 in results, "evaluation subprocess produced no result"
    for k in SCORES:
        assert 0.0 <= float(results[7][k]) <= 1.0, k
    assert os.path.exists(tmp_path / "eval_results" / "results_7.yaml")
    (cmd, env), = ev.spawned
    assert cmd[1:3] == ["-m", "go2_rl_gym_tpu_torch.scripts.evaluate"]
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT


def test_cap_drops_the_newest(tmp_path, monkeypatch):
    monkeypatch.setattr(
        eval_hook.AsyncEvaluator, "command",
        lambda self, policy, out: [sys.executable, "-c",
                                   "import time; time.sleep(60)"])
    ev = Recording(str(tmp_path))
    for it in range(5):
        ev.submit("policy.pt", it)
    assert len(ev.spawned) == ev.max_pending == 3
    assert [it for it, _, _ in ev._jobs] == [0, 1, 2]
    # a timed-out evaluation is killed and leaves no result
    assert ev.wait_all(timeout=0.1) == {}
    assert ev._jobs == []


def _plane_runner(train_cfg, log_dir, eval_interval, steps=4):
    cfg = Go2Cfg()
    cfg.env.num_envs = 16
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    train_cfg.runner.num_steps_per_env = steps
    env = Go2Env(cfg, num_steps_per_env=steps, device="cpu")
    return OnPolicyRunner(env, train_cfg, log_dir=log_dir, device="cpu",
                          eval_interval=eval_interval)


def _exports(log_dir):
    d = os.path.join(log_dir, "jit_models")
    if not os.path.isdir(d):
        return []
    return sorted(int(f[len("policy_jit_"):-3]) for f in os.listdir(d))


def test_learn_scores_exports_and_logs_eval(tmp_path):
    pytest.importorskip("mujoco")
    log_dir = str(tmp_path)
    runner = _plane_runner(go2_moe_cts_train_cfg(), log_dir, 1)
    assert runner.evaluator.scenes == ["flat", "stairs", "cross_slope"]
    runner.evaluator = Recording(log_dir, scenes=("flat",), duration_s=0.2)
    runner.learn(runner.init_runner_state(0), 2, log_every=1)
    assert _exports(log_dir) == [0, 1, 2]
    assert [c[c.index("--policy") + 1] for c, _ in
            runner.evaluator.spawned] == [
        os.path.join(log_dir, "jit_models", f"policy_jit_{i}.pt")
        for i in range(3)]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    evals = {(r["tag"], r["step"]): r["value"] for r in rows
             if r["tag"].startswith("Eval/")}
    for it in range(3):
        assert os.path.exists(tmp_path / "eval_results" /
                              f"results_{it}.yaml")
        for k in SCORES:
            assert 0.0 <= evals[(f"Eval/{k}", it)] <= 1.0
        assert evals[("Eval/episodes", it)] == 4


class Fake:
    """An evaluator that scores every submission at once with its
    iteration, without a process; a submission advances `clock` (if given)
    by `delay` seconds instead of sleeping."""

    def __init__(self, delay=0.0, clock=None):
        self.submitted, self.pending = [], {}
        self.delay, self.clock = delay, clock

    def submit(self, path, it):
        assert os.path.exists(path)
        if self.clock is not None:
            self.clock.offset += self.delay
        self.submitted.append(it)
        self.pending[it] = {"overall": it / 10.0, "scene": "flat"}

    def poll(self):
        done, self.pending = self.pending, {}
        return done

    def wait_all(self, timeout=None):
        assert timeout == 600
        return self.poll()


class Clock:
    """Stands in for the `time` module that train/runner.py reads: the
    host's clock plus `offset` seconds, which a submission advances."""

    def __init__(self):
        self.offset = 0.0

    def time(self):
        return time.time() + self.offset


# a submission "takes" this long on the runner's clock; an iteration on the
# CPU takes seconds, so an iteration time under it cannot hold a submission
SUBMIT_S = 1000.0


def test_learn_eval_cadence_and_timing(tmp_path, monkeypatch):
    from go2_rl_gym_tpu_torch.train import runner as runner_mod
    log_dir = str(tmp_path)
    runner = _plane_runner(go2_moe_cts_train_cfg(), log_dir, 2)
    clock = Clock()
    monkeypatch.setattr(runner_mod, "time", clock)
    runner.evaluator = Fake(delay=SUBMIT_S, clock=clock)
    runner.learn(runner.init_runner_state(0), 3, log_every=1)
    assert runner.evaluator.submitted == [0, 2, 3]
    assert clock.offset == 3 * SUBMIT_S
    assert _exports(log_dir) == [0, 2, 3]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    evals = sorted((r["step"], r["value"]) for r in rows
                   if r["tag"] == "Eval/overall")
    assert evals == [(0, 0.0), (2, 0.2), (3, 0.3)]
    assert not any(r["tag"] == "Eval/scene" for r in rows)
    # iteration 1 starts its clock after the export and submission at 0,
    # and no iteration's time holds a submission
    times = {r["step"]: r["value"] for r in rows
             if r["tag"] == "Perf/iteration_time"}
    assert sorted(times) == [0, 1, 2]
    assert all(t < SUBMIT_S for t in times.values()), times
    assert all(np.isfinite(r["value"]) for r in rows)


def test_hook_scores_cts_only(tmp_path):
    """PPO gets the evaluator (the JAX runner builds it for any algorithm)
    but exports nothing; without a log_dir there is no evaluator."""
    runner = _plane_runner(go2_ppo_train_cfg(), str(tmp_path), 1)
    runner.evaluator = Fake()
    runner.learn(runner.init_runner_state(0), 1)
    assert runner.evaluator.submitted == []
    assert _exports(str(tmp_path)) == []
    assert _plane_runner(go2_moe_cts_train_cfg(), None, 1).evaluator is None
