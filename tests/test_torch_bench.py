"""PyTorch port: the benchmark (`go2_rl_gym_tpu_torch/bench.py`, the twin of
bench.py) and its env-count sweep (`tools/bench_scaling.py`, the twin of
tools/bench_scaling.sh), on the CPU.

* `run` at 8 envs on a 3 x 9 terrain with bench.py's train config
  (iters 2, reps 1): every key of bench.py's line but `vs_baseline`, plus
  the port's, and value = iters * 24 * N / median_dispatch_s. It refuses
  with deterministic algorithms on, and the entry point raises without a
  card.
* The guard: a capture, or a patch launch from the host, made during a
  dispatch (both counters moved by hand, as the CPU's eager step moves
  neither) makes `main` print bench.py's error line and exit with 1.
* Parity with the JAX package: from the same bridged state, with
  randomness off (the parity config of tests/test_torch_env.py) and the
  act noise and the update's permutations replayed from the JAX runner's
  key sequence, the port's `run_k` over K = 2 iterations gives the
  value_loss sequence of bench.py:63-67's `run_k` (a jitted lax.scan of
  `_build_train_step()` over K = 2), at tests/test_torch_train.py's
  tolerance for a train step's metrics (rtol 1e-2, atol 1e-6). Both start
  from a fresh Adam state.
* The sweep at 8 and 16 envs, one process each, writes two wrapped lines;
  a size whose process fails or times out gets a line with its `error`,
  the other sizes still run, and the sweep exits with 1 (its subprocess
  call replaced, so this part starts no process).
"""
import json
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.agents import cts as jcts
from go2_rl_gym_tpu.env.config import Go2Cfg as JCfg
from go2_rl_gym_tpu.env.config import go2_moe_cts_train_cfg as j_train_cfg
from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu.train.runner import OnPolicyRunner as JRunner
from go2_rl_gym_tpu_torch import bench
from go2_rl_gym_tpu_torch.env.config import Go2Cfg as TCfg
from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg as t_train_cfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as TEnv
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.ops import rigid_body as rb
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.tools import bench_scaling
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner as TRunner
from go2_rl_gym_tpu_torch.train.runner import RunnerState
from go2_rl_gym_tpu_torch.utils import graphs
from test_torch_env import N, bridge_env_state, parity_cfg
from test_torch_update import jax_perms

K = 2               # iterations of the parity dispatch
T_STEPS = 4         # policy steps per iteration in the parity and guard runs
KEYS = {"metric", "value", "unit", "median_dispatch_s", "all_dispatch_s",
        "first_dispatch_s", "iters_per_dispatch", "num_envs", "task",
        "capture_s", "name", "power_limit", "guard"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg():
    """Go2Cfg() on 3 x 9 sub-terrains with a 3 m border."""
    cfg = TCfg()
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 9
    cfg.terrain.border_size = 3.0
    return cfg


def short_tc():
    tc = t_train_cfg()
    tc.runner.num_steps_per_env = T_STEPS
    return tc


def test_run_reports_bench_keys_and_rate():
    res = bench.run(8, iters=2, reps=1, device="cpu", cfg=small_cfg())
    assert set(res) == KEYS
    assert "vs_baseline" not in res
    assert (res["metric"], res["unit"], res["task"]) == (
        "env_steps_per_s_per_chip", "env-steps/s", "go2_moe_cts")
    assert (res["num_envs"], res["iters_per_dispatch"]) == (8, 2)
    assert len(res["all_dispatch_s"]) == 1
    assert res["median_dispatch_s"] == res["all_dispatch_s"][0] > 0
    assert res["first_dispatch_s"] > 0 and res["capture_s"] > 0
    assert res["value"] == pytest.approx(
        2 * 24 * 8 / res["median_dispatch_s"], rel=1e-12)
    assert (res["name"], res["power_limit"]) == ("cpu", None)
    assert res["guard"].startswith("eager on the cpu: 0 captures")
    json.dumps(res)


def test_run_refuses_deterministic_algorithms():
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="deterministic"):
            bench.run(8, iters=1, reps=1, device="cpu", cfg=small_cfg())
    finally:
        torch.use_deterministic_algorithms(False)


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run(8, iters=1, reps=1, cfg=small_cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])


@pytest.mark.parametrize("counter", ["captures", "patch_launches",
                                     "rigid_body_launches"])
def test_guard_breach_prints_error_and_exits_non_zero(
        monkeypatch, capsys, counter):
    """The third call of the step is the first dispatch's: it moves one
    counter, as a second capture or a rollout run from the host would."""
    table, key = {"captures": (graphs.CAPTURES, "train_step"),
                  "patch_launches": (tp.LAUNCHES, "extract_patches"),
                  "rigid_body_launches": (rb.LAUNCHES, "rigid_body")}[counter]
    monkeypatch.setitem(table, key, table[key])     # restored afterwards
    train_step = TRunner.train_step
    calls = []

    def moving(self, rs, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            table[key] += 1
        return train_step(self, rs, *args, **kwargs)

    monkeypatch.setattr(TRunner, "train_step", moving)
    run = bench.run
    monkeypatch.setattr(bench, "run", lambda n, iters, reps, device: run(
        n, iters, reps, device=device, cfg=small_cfg(), tc=short_tc()))
    monkeypatch.setenv("BENCH_NUM_ENVS", "8")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_REPS", "1")
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu"])
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "error"}
    assert (line["metric"], line["value"], line["unit"]) == (
        "env_steps_per_s_per_chip", 0.0, "env-steps/s")
    assert "after the first dispatch" in line["error"]
    want = {"captures": "1 captures of the train step (want 0)",
            "patch_launches": "1 patch launches from the host",
            "rigid_body_launches": "1 rigid-body launches from the host"
            }[counter]
    assert want in line["error"]
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# parity with the JAX package's run_k
# ---------------------------------------------------------------------------


def _replayed(key, jalg):
    """Each iteration's act noise (T, N, 12) and update permutations, from
    the JAX runner's key sequence (runner.py:194, 266; cts.py:197-199)."""
    out = []
    for _ in range(K):
        noise = []
        for _ in range(T_STEPS):
            key, k_act = jax.random.split(key)
            noise.append(np.asarray(jax.random.normal(k_act, (N, 12))))
        key, k_up = jax.random.split(key)
        out.append((torch.as_tensor(np.stack(noise)),
                    jax_perms(k_up, jalg, T_STEPS)))
    return out


def test_run_k_matches_jax_scan():
    jc = j_train_cfg()
    jc.runner.num_steps_per_env = T_STEPS
    jr = JRunner(JEnv(parity_cfg(JCfg), num_steps_per_env=T_STEPS), jc)
    rs = jr.init_runner_state(jax.random.PRNGKey(0))
    step = jr._build_train_step()

    @jax.jit
    def run_k(rs):                      # bench.py:63-67
        def body(r, _):
            r, m = step(r)
            return r, m["value_loss"]
        return jax.lax.scan(body, rs, None, length=K)

    rs2, j_vl = run_k(rs)
    assert not bool(np.asarray(rs2.env_state.episode_length == 0).any()), \
        "an env reset"

    tr = TRunner(TEnv(parity_cfg(TCfg), num_steps_per_env=T_STEPS,
                      device="cpu"), short_tc(), device="cpu")
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
    draws = iter(_replayed(rs.key, jr.alg))
    train_step = tr.train_step

    def replayed(r):
        noise, perms = next(draws)
        return train_step(r, noise=noise, perms=perms)

    tr.train_step = replayed
    t_vl = bench.run_k(tr, tr.compiled_step(trs), torch.empty(K))
    assert next(draws, None) is None            # K iterations ran
    np.testing.assert_allclose(t_vl, np.asarray(j_vl), rtol=1e-2, atol=1e-6)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def test_sweep_writes_one_wrapped_line_per_size(monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_REPS", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "bench_scaling.jsonl"
    bench_scaling.main(["--sizes", "8", "16", "--device", "cpu",
                        "--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["num_envs"] for x in lines] == [8, 16]
    for x in lines:
        assert set(x) == {"num_envs", "bench"}
        b = x["bench"]
        assert set(b) == KEYS
        assert (b["num_envs"], b["iters_per_dispatch"]) == (x["num_envs"], 1)
        assert b["value"] > 0 and b["name"] == "cpu"


def test_sweep_records_failed_sizes_and_exits_non_zero(
        monkeypatch, tmp_path, capsys):
    """Size 8 times out, 16 exits with an error line of the guard, 32 dies
    with a traceback, 64 succeeds: four lines, and exit 1 at the end."""
    ok = {"metric": bench.METRIC, "value": 1.0, "unit": bench.UNIT}
    guard = {"metric": bench.METRIC, "value": 0.0, "unit": bench.UNIT,
             "error": "after the first dispatch: 2 captures"}
    seen = []

    def fake_run(cmd, cwd, env, capture_output, text, timeout):
        n = int(env["BENCH_NUM_ENVS"])
        seen.append((n, cmd[-3:], timeout))
        if n == 8:
            raise subprocess.TimeoutExpired(cmd, timeout)
        if n == 16:
            return subprocess.CompletedProcess(cmd, 1, json.dumps(guard), "")
        if n == 32:
            return subprocess.CompletedProcess(
                cmd, 1, "", "Traceback\nRuntimeError: boom\n")
        return subprocess.CompletedProcess(cmd, 0, "x\n" + json.dumps(ok), "")

    monkeypatch.setattr(bench_scaling.subprocess, "run", fake_run)
    monkeypatch.setattr(bench_scaling, "TIMEOUT_S", 5.0)
    out = tmp_path / "s.jsonl"
    with pytest.raises(SystemExit) as exc:
        bench_scaling.main(["--sizes", "8", "16", "32", "64", "--out",
                            str(out)])
    assert exc.value.code == 1
    assert seen == [(n, ["go2_rl_gym_tpu_torch.bench", "--device", "cuda"],
                     5.0) for n in (8, 16, 32, 64)]
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["num_envs"] for x in lines] == [8, 16, 32, 64]
    b = [x["bench"] for x in lines]
    assert b[0]["error"] == "timed out after 5.0 s" and b[0]["value"] == 0.0
    assert b[1] == guard
    assert b[2]["error"] == "exit code 1: RuntimeError: boom"
    assert b[3] == ok
    assert "failed at [8, 16, 32]" in capsys.readouterr().err


def test_sweep_default_sizes_and_output():
    assert bench_scaling.SIZES == (2048, 4096, 8192, 16384)
    assert bench_scaling.TIMEOUT_S == 900.0
    assert bench_scaling.OUT == os.path.join(
        bench_scaling.ROOT, "build", "bench_scaling.jsonl")
    assert "doc" not in os.path.relpath(bench_scaling.OUT, bench_scaling.ROOT)
    assert os.path.isdir(os.path.join(bench_scaling.ROOT,
                                      "go2_rl_gym_tpu_torch"))
