"""PyTorch port, `OnPolicyRunner.learn` in chunks (JAX runner.py:337-463).

* The schedule against the JAX package's `learn`: both loops are driven
  with their step replaced by a recorder (JAX: `_jit_train_chunk`, so
  nothing compiles; the port: `compiled_step`) and `save`, the eval
  submission, `_log` and the clock replaced, over a grid of
  (num_iterations, log_every, save_interval, eval_interval, start
  iteration, GO2_SYNC_TRAIN). Chunk sizes, checkpoint names, eval
  iterations, logged iterations, `tot_timesteps` and the final iteration
  must be equal.
* One real run against JAX: a 3-iteration `learn` of go2_moe_cts on the
  rough parity config (8 envs x 4 steps, randomness off, the JAX state
  bridged, the act noise and the update's permutations replayed from the
  JAX runner's key sequence, as tests/test_torch_train.py does for one
  iteration). Final parameters atol 1e-3 and the logged scalars rtol 1e-2
  (that file's tolerances).
* GO2_SYNC_TRAIN=1 (one iteration per chunk, blocking) gives the chunked
  loop's result bit for bit.
* --debug_nans: the train script with a NaN fed into the first obs raises
  FloatingPointError at iteration 0.
"""
import itertools
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.agents import cts as jcts
from go2_rl_gym_tpu.env.config import Go2Cfg as JCfg
from go2_rl_gym_tpu.env.config import go2_moe_cts_train_cfg as j_train_cfg
from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu.train import runner as jrunner_mod
from go2_rl_gym_tpu.train.runner import OnPolicyRunner as JRunner
from go2_rl_gym_tpu_torch.env.config import Go2Cfg as TCfg
from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg as t_train_cfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as TEnv
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.scripts import train as train_script
from go2_rl_gym_tpu_torch.train import runner as trunner_mod
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner as TRunner
from go2_rl_gym_tpu_torch.train.runner import RunnerState
from go2_rl_gym_tpu_torch.utils import graphs
from test_torch_env import N, bridge_env_state, parity_cfg
from test_torch_update import jax_perms

T_STEPS = 4
KEYS = ["ep_stats", "learning_rate", "value_loss"]
SIZES = [6, 1, 1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the schedule against JAX's
# ---------------------------------------------------------------------------


class Clock:
    """Stands in for the `time` module of both runners: one second per
    reading, so that no iteration time is zero."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 1.0
        return self.t


class NoEvaluator:
    def poll(self):
        return {}

    def wait_all(self, timeout=None):
        return {}


def _fake(cls, start, save_interval, eval_interval, record):
    """A runner of `cls` with no env or model: what `learn` reads, and
    recorders for what it does."""
    r = object.__new__(cls)
    r.current_iteration = start
    r.tot_timesteps = 0
    r.tot_time = 0.0
    r.num_steps = 24
    r.is_cts = True
    r.writer = object()
    r.log_dir = "logs"
    r.save_interval = save_interval
    r.eval_interval = eval_interval
    r.evaluator = NoEvaluator() if eval_interval else None
    r._log = lambda it, *a: record["logged"].append(it)
    return r


def jax_schedule(n, log_every, save_interval, eval_interval, start, record):
    r = _fake(JRunner, start, save_interval, eval_interval, record)
    r.env = type("E", (), {"num_envs": 4096})()

    def chunk_fn(c):
        def fn(rs):
            record["chunks"].append(c)
            return rs, np.zeros((c, sum(SIZES)), np.float32)
        return fn, {"keys": KEYS, "sizes": SIZES}
    r._jit_train_chunk = chunk_fn
    r.save = lambda rs, path: record["saves"].append(os.path.basename(path))
    r._submit_eval = lambda rs, it: record["evals"].append(it)
    r.learn(SimpleNamespace(train_state=None), n, log_every=log_every,
            print_every=10 ** 9)
    return r


class FakeStep:
    """The port's compiled step, counting its calls: each returns one
    iteration's metrics."""

    def __init__(self, record):
        self.record = record
        self.state = None

    def __call__(self):
        self.record["calls"] += 1
        return torch.zeros(sum(SIZES))


GRID = list(itertools.product((1, 7, 12), (1, 4, 10), (0, 2, 5), (0, 3)))


@pytest.mark.parametrize("start", [0, 5])
@pytest.mark.parametrize("sync", ["0", "1"], ids=["chunked", "sync"])
def test_chunk_schedule_matches_jax(start, sync, monkeypatch):
    """Over (num_iterations, log_every, save_interval, eval_interval)."""
    monkeypatch.setenv("GO2_SYNC_TRAIN", sync)
    for n, log_every, save_interval, eval_interval in GRID:
        args = (n, log_every, save_interval, eval_interval, start)
        out = {}
        for side, run in (("jax", jax_schedule), ("port", _port_learn)):
            rec = {"chunks": [], "saves": [], "evals": [], "logged": [],
                   "calls": 0}
            clock = Clock()
            monkeypatch.setattr(jrunner_mod, "time", clock)
            monkeypatch.setattr(trunner_mod, "time", clock)
            r = run(*args, rec)
            out[side] = dict(rec, calls=None, tot_timesteps=r.tot_timesteps,
                             end=r.current_iteration)
        assert out["port"] == out["jax"], args
        assert sum(out["port"]["chunks"]) == n, args


def _port_learn(n, log_every, save_interval, eval_interval, start, rec):
    """The port's learn on a fake runner; a chunk is the step calls between
    two additions to tot_timesteps."""
    r = _fake(TRunner, start, save_interval, eval_interval, rec)
    r.env = type("E", (), {"num_envs_global": 4096})()
    r.is_main = True
    r.debug_nans = False
    r.mesh = None
    r.device = torch.device("cpu")
    r._mode_printed = True
    r.metric_keys, r.metric_sizes = KEYS, SIZES
    step = FakeStep(rec)
    r.compiled_step = lambda rs: step
    r.save = lambda rs, path: rec["saves"].append(
        os.path.basename(path)[:-len(".pt")])
    r._submit_eval = lambda it: rec["evals"].append(it)
    r._log_eval = lambda results: None

    class Counted(TRunner):
        """tot_timesteps grows once per chunk: read the calls there."""
        seen = 0

        def __setattr__(self, name, value):
            if name == "tot_timesteps" and value:
                rec["chunks"].append(rec["calls"] - Counted.seen)
                Counted.seen = rec["calls"]
            object.__setattr__(self, name, value)
    r.__class__ = Counted
    r.learn(None, n, log_every=log_every, print_every=10 ** 9)
    return r


# ---------------------------------------------------------------------------
# one real run against JAX
# ---------------------------------------------------------------------------


class Recorder:
    """A metrics writer that keeps its scalars."""

    def __init__(self):
        self.rows = {}

    def add_scalar(self, tag, value, step):
        self.rows[(tag, step)] = float(value)

    def flush(self):
        pass


def _replayed(key, iterations, jalg):
    """Per iteration, the act noise (T, N, 12) and the update's
    permutations that the JAX runner draws from its key sequence
    (runner.py:194, 266; cts.py:197-199)."""
    noise, perms = [], []
    for _ in range(iterations):
        it_noise = []
        for _ in range(T_STEPS):
            key, k_act = jax.random.split(key)
            it_noise.append(np.asarray(jax.random.normal(k_act, (N, 12))))
        key, k_up = jax.random.split(key)
        noise.append(torch.as_tensor(np.stack(it_noise)))
        perms.append(jax_perms(k_up, jalg, T_STEPS))
    return noise, perms


def test_learn_matches_jax():
    iters = 3
    jc = j_train_cfg()
    jc.runner.num_steps_per_env = T_STEPS
    jr = JRunner(JEnv(parity_cfg(JCfg), num_steps_per_env=T_STEPS), jc)
    rs = jr.init_runner_state(jax.random.PRNGKey(0))
    jr.writer = Recorder()
    rs_end = jr.learn(rs, iters, log_every=1, print_every=10 ** 9)
    assert not bool(np.asarray(rs_end.env_state.episode_length == 0).any()) \
        and int(np.asarray(rs_end.env_state.episode_length).min()) \
        > iters * T_STEPS - 1, "an env reset"

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
        cur_reward_sum=torch.zeros(N), cur_episode_length=torch.zeros(N),
        perm_gen=torch.Generator().manual_seed(1))
    noise, perms = _replayed(rs.key, iters, jr.alg)
    train_step, calls = tr.train_step, []

    def replayed(r):
        i = len(calls)
        calls.append(i)
        return train_step(r, noise=noise[i], perms=perms[i])
    tr.train_step = replayed
    tr.writer = Recorder()
    tr.learn(trs, iters, log_every=1, print_every=10 ** 9)
    assert calls == [0, 1, 2] and tr.current_iteration == iters
    assert tr.tot_timesteps == jr.tot_timesteps

    got = timp.tree_from_named(tr.alg.model.named_parameters())
    want = jcts.merge_params(rs_end.train_state.params1,
                             rs_end.train_state.params2)
    wl = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, v in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(v, np.asarray(wl[path]), atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
    jrows, trows = jr.writer.rows, tr.writer.rows
    assert sorted(trows) == sorted(jrows)
    assert {s for _, s in jrows} == {0, 1, 2}
    for (tag, step), v in jrows.items():
        if tag.startswith("Perf/"):
            continue
        np.testing.assert_allclose(trows[(tag, step)], v, rtol=1e-2,
                                   atol=1e-6, err_msg=f"{tag} at {step}")


# ---------------------------------------------------------------------------
# GO2_SYNC_TRAIN and --debug_nans
# ---------------------------------------------------------------------------


def _plane_runner(log_dir):
    cfg = TCfg()
    cfg.env.num_envs = 8
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    tc = t_train_cfg()
    tc.runner.num_steps_per_env = 2
    tc.runner.save_interval = 2
    env = TEnv(cfg, num_steps_per_env=2, device="cpu")
    return TRunner(env, tc, log_dir=log_dir, device="cpu")


def test_sync_mode_equals_chunks(tmp_path, monkeypatch):
    """3 iterations at log_every 3 (one chunk of 2 after model_0) and the
    same under GO2_SYNC_TRAIN=1 (three chunks of 1): equal parameters,
    state, checkpoints and logged metrics."""
    out = {}
    for sync in ("0", "1"):
        monkeypatch.setenv("GO2_SYNC_TRAIN", sync)
        log_dir = tmp_path / f"sync{sync}"
        runner = _plane_runner(str(log_dir))
        rs = runner.learn(runner.init_runner_state(0), 3, log_every=3)
        rows = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
        out[sync] = (runner, rs, {(r["tag"], r["step"]): r["value"]
                                  for r in rows
                                  if not r["tag"].startswith("Perf/")},
                     sorted(p.name for p in log_dir.glob("model_*.pt")))
    (a, rs_a, rows_a, saves_a), (b, rs_b, rows_b, saves_b) = out["0"], out["1"]
    assert saves_a == saves_b == ["model_0.pt", "model_2.pt", "model_3.pt"]
    assert rows_a == rows_b and {s for _, s in rows_a} == {0, 2}
    for (k, p), (_, q) in zip(a.alg.model.named_parameters(),
                              b.alg.model.named_parameters()):
        assert torch.equal(p, q), k
    for (p, x), (_, y) in zip(graphs.leaves(rs_a), graphs.leaves(rs_b)):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), p
        else:
            assert torch.equal(x, y), p


def test_debug_nans_names_the_iteration(tmp_path, monkeypatch):
    """`--debug_nans` runs learn eagerly under anomaly detection; a NaN fed
    into the first obs raises at iteration 0, naming it."""
    init = TRunner.init_runner_state

    def with_nan(self, *args, **kwargs):
        rs = init(self, *args, **kwargs)
        obs = rs.obs.clone()
        obs[0, 0] = float("nan")
        return rs._replace(obs=obs)
    monkeypatch.setattr(TRunner, "init_runner_state", with_nan)
    argv = ["--task", "go2_moe_cts", "--num_envs", "8", "--terrain", "plane",
            "--device", "cpu", "--log_root", str(tmp_path),
            "--max_iterations", "2", "--debug_nans"]
    with pytest.raises(FloatingPointError, match="iteration 0"):
        train_script.main(argv)
    runner = _plane_runner(None)
    runner.debug_nans = True
    assert runner.train_mode()[0] == "eager"
    monkeypatch.setattr(TRunner, "init_runner_state", init)
    runner.learn(runner.init_runner_state(0), 1)      # finite: no raise
