"""PyTorch port: tools/profile_rollout's `--ops` and `--decompose`, the twins
of the JAX package's tools/profile_physics.py and tools/bench_decompose.py.

* `build("physics")` and `build("env")` run the JAX tools' work: the JAX
  tools' lambdas (tools/profile_physics.py:88-97, the same in
  tools/bench_decompose.py:44-62) and the port's setup step one state of
  the JAX env, carried into the port, on the parity config of
  tests/test_torch_env.py (3 x 9 sub-terrains, 8 envs, randomness off).
  The physics step is held to the decimated-step tolerances of
  tests/test_torch_physics.py (base_pos 2e-4, q 2e-3, qd 0.1, base_quat
  2e-4, contact and foot forces atol 2 / rtol 0.05, foot_pos 1e-3); the env
  step to those of tests/test_torch_env.py (obs and privileged obs atol
  5e-3, rewards rtol 1e-2 + atol 1e-6, done exactly).
* `build("train")` has the JAX tools' configs and starts the envs at
  random episode lengths.
* The CLI on the CPU: `--ops physics` tabulates self host time with
  source lines under sim/, the same ops per call in every table,
  `--decompose physics env` prints the JAX tool's lines; without
  `--device`, a machine with no card raises.
* The device-time reduction and the ranking on made-up events: each kernel
  counts once, at the op that launched it, a backward op takes its forward
  op's line, rows rank by their time.
* Every trace window opens after a lead-in (`window`, `open_window`).
"""
import copy
import dataclasses
import inspect
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.env.config import Go2Cfg as JCfg
from go2_rl_gym_tpu.env.config import go2_moe_cts_train_cfg as j_train_cfg
from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu_torch.env.config import Go2Cfg as TCfg
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.tools import card_check
from go2_rl_gym_tpu_torch.tools import profile_rollout as pr
from go2_rl_gym_tpu_torch.tools import trace_window
from test_torch_env import N, bridge_env_state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_env():
    """The JAX env on the parity config and its state of init_state(0)."""
    je = JEnv(card_check.parity_cfg(JCfg(), N),
              num_steps_per_env=j_train_cfg().runner.num_steps_per_env)
    return je, jax.jit(je.init_state)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def physics_setup():
    return pr.build("physics", device="cpu",
                    cfg=card_check.parity_cfg(TCfg(), N))


def _close(j, t, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_build_physics_runs_the_jax_tools_step(jax_env, physics_setup):
    je, js = jax_env
    # tools/profile_physics.py:88-93
    targets = jnp.zeros((4, N, 12), jnp.float32)
    kp = jnp.full((N, 12), 20.0)
    kd = jnp.full((N, 12), 0.5)
    f = jax.jit(lambda d, s: je.physics_step(
        d, s, targets, kp, kd, jnp.ones((N, 12)), jnp.zeros((N, 12))))
    sj, oj, tauj, _ = f(js.dyn, js.sim)

    s = physics_setup
    assert s.mode == "physics"
    assert s.args[0] is s.state.dyn and s.args[1] is s.state.sim
    ts = bridge_env_state(js)
    st, ot, taut, _ = s.fn(ts.dyn, ts.sim)
    _close(sj.base_pos, st.base_pos, 2e-4)
    _close(sj.q, st.q, 2e-3)
    _close(sj.qd, st.qd, 0.1)
    _close(sj.base_quat, st.base_quat, 2e-4)
    _close(oj.contact_forces, ot.contact_forces, 2.0, 0.05)
    _close(oj.foot_forces, ot.foot_forces, 2.0, 0.05)
    _close(oj.foot_pos, ot.foot_pos, 1e-3)
    _close(tauj, taut, 0.1)


def test_build_env_runs_the_jax_tools_step(jax_env, physics_setup):
    je, js = jax_env
    # tools/profile_physics.py:95-97
    js2, jo = jax.jit(je.step)(js, jnp.zeros((N, 12)))

    s = pr.build("env", like=physics_setup)
    assert s.env is physics_setup.env and s.args[0] is s.state
    assert torch.equal(s.args[1], torch.zeros((N, 12)))
    ts, to = s.fn(bridge_env_state(js), s.args[1])
    np.testing.assert_array_equal(np.asarray(jo.done), to.done.numpy())
    _close(jo.obs, to.obs, 5e-3)
    _close(jo.privileged_obs, to.privileged_obs, 5e-3)
    _close(jo.rew, to.rew, 1e-6, 1e-2)
    _close(js2.sim.base_pos, ts.sim.base_pos, 2e-4)


def test_build_train_has_the_jax_tools_configs(monkeypatch):
    # tools/profile_physics.py:73-86, 99-103
    s = pr.build("train", num_envs=N, device="cpu")
    jcfg = JCfg()
    jcfg.env.num_envs = N
    assert dataclasses.asdict(s.env.cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(s.tc) == dataclasses.asdict(j_train_cfg())
    assert s.env.num_steps_per_env == j_train_cfg().runner.num_steps_per_env
    assert s.runner.log_dir is None and s.runner.cfg is s.tc
    assert s.args == (s.rs,)
    # init_at_random_ep_len: lengths drawn in [0, max), then one step
    lengths = s.rs.env_state.episode_length
    assert len(torch.unique(lengths)) > 1 and int(lengths.max()) > 1
    # rollout shares the runner and its start
    r = pr.build("rollout", like=s)
    assert r.runner is s.runner and r.args == (s.rs,)
    monkeypatch.setenv("BENCH_NUM_ENVS", "96")
    assert pr.default_num_envs() == 96
    monkeypatch.delenv("BENCH_NUM_ENVS")
    assert pr.default_num_envs() == 4096


def test_the_patch_range_is_named_after_its_caller(physics_setup):
    """The plain patch extraction runs inside the range of its caller's
    line in sim/tengine.py, not of a line of ops/terrain_patches.py."""
    tengine = physics_setup.env.physics_step.__code__.co_filename
    with open(tengine) as f:
        line = next(i for i, text in enumerate(f, 1)
                    if "tp.extract_patches(" in text)
    res = pr.op_table(physics_setup, iters=1)
    ops = {r["name"] for r in res["rows"]
           if r["source"] == f"sim/tengine.py:{line}"}
    assert "aten::index" in ops
    inside = set()
    for fn in (tp.extract_patches, tp.extract_patches_plain):
        body, first = inspect.getsourcelines(fn)
        inside |= {f"ops/terrain_patches.py:{first + i}"
                   for i in range(len(body))}
    assert not inside & {r["source"] for r in res["rows"]}


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_ops_physics_on_the_cpu(capsys, physics_setup):
    """The CLI's table of host time, and what a loaded host cannot move:
    the ops each call runs, by op and source line, and the launches per
    call are the same in 3 full tables. Host milliseconds under load are
    not held here (a preemption of a few ms inside one op outweighs the
    gap between rows): the ranking by ms is held on made-up events with
    fixed durations (`test_op_table_ranks_rows_by_their_time`), the card's
    by chip_smoke.py's phase profile."""
    argv = ["--ops", "physics", "--device", "cpu", "--num_envs", "16",
            "--iters", "1", "--top", "10"]
    res = pr.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("total host self time:")
    assert json.loads(lines[-1]) == res
    assert len(lines) == 12 and len(res["rows"]) == 10
    assert {"mode", "time", "num_envs", "iters", "total_ms", "kernel_ms",
            "attributed_share", "launches_per_call", "patch_kernel_launches",
            "trace_s", "reduce_s", "device", "rows"} <= set(res)
    assert (res["mode"], res["time"], res["device"]) == ("physics", "host",
                                                         "cpu")
    assert res["num_envs"] == 16 and res["kernel_ms"] is None
    assert res["patch_kernel_launches"] == 0        # the plain version
    assert res["attributed_share"] > 0.9
    rows = res["rows"]
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)

    # 3 full tables of the same call: every row's calls per call, the
    # launches per call and the patch launches are equal
    tables = [pr.op_table(physics_setup, iters=1, top=0) for _ in range(3)]
    capsys.readouterr()
    calls = [{(r["name"], r["source"]): r["calls"] for r in t["rows"]}
             for t in tables]
    assert calls[0] == calls[1] == calls[2] and len(calls[0]) > 100
    assert {t["launches_per_call"] for t in tables} == {0.0}
    assert {t["patch_kernel_launches"] for t in tables} == {0}
    for t in tables:
        ms = [r["ms"] for r in t["rows"]]
        assert ms == sorted(ms, reverse=True)
    # the CLI's rows are rows of the full table, with its call counts
    assert all(calls[0][r["name"], r["source"]] == r["calls"] for r in rows)
    # the ops run most often sit at source lines of sim/
    top = sorted(calls[0], key=lambda k: -calls[0][k])[:5]
    for name, source in top:
        assert source.startswith("sim/"), (name, source)
        path, line = source.rsplit(":", 1)
        assert path.endswith(".py") and int(line) > 0
        assert name.startswith("aten::")


def test_op_table_ranks_rows_by_their_time():
    """The table's ranking on made-up events with fixed host times: rows
    by (op, source) heaviest first, each with its ms and percent per call
    and its calls per call."""
    src = _event("sim/tmath.py:25", annotation=True)
    src2 = _event("sim/tengine.py:412", annotation=True)
    ops = [_event("aten::mul", src, us=3.0), _event("aten::mul", src, us=5.0),
           _event("aten::cat", src, us=2.0), _event("aten::sum", src2, us=12.0),
           _event("aten::add", us=0.5), _event("aten::mul", src2, us=1.0)]
    rows, _, _ = pr.op_rows([src, src2] + ops,
                            {"sim/tmath.py:25", "sim/tengine.py:412"}, False)
    table = pr.ranked(rows, iters=2)
    assert [(r["name"], r["source"]) for r in table] == [
        ("aten::sum", "sim/tengine.py:412"), ("aten::mul", "sim/tmath.py:25"),
        ("aten::cat", "sim/tmath.py:25"), ("aten::mul", "sim/tengine.py:412"),
        ("aten::add", "")]
    assert [r["ms"] for r in table] == [0.006, 0.004, 0.001, 0.0005, 0.00025]
    assert [r["calls"] for r in table] == [0.5, 1.0, 0.5, 0.5, 0.5]
    np.testing.assert_allclose([r["pct"] for r in table],
                               [100 * us / 23.5 for us in
                                (12.0, 8.0, 2.0, 1.0, 0.5)])
    assert pr.ranked({}, iters=1) == []


def test_decompose_on_the_cpu(capsys):
    res = pr.main(["--decompose", "physics", "env", "--device", "cpu",
                   "--num_envs", "16", "--iters", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("physics 4-substep:") and "env-steps/s" in out[0]
    assert out[1].startswith("full env.step:")
    assert _last_json("\n".join(out)) == res
    assert sorted(res["decompose"]) == ["env", "physics"]
    for stage in res["decompose"].values():
        assert np.isfinite(stage["ms"]) and stage["ms"] > 0
        assert stage["iters"] == 2
        np.testing.assert_allclose(stage["env_steps_per_s"],
                                   16 / stage["ms"] * 1e3)


def test_without_a_card_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--ops", "physics"], ["--decompose"], []):
        with pytest.raises(RuntimeError, match="is_available"):
            pr.main(argv + ["--num_envs", "16"])


def _event(name, parent=None, scope=0, seq=-1, thread=1, fwd_thread=1,
           device=torch.autograd.DeviceType.CPU, us=0.0, cid=0,
           annotation=False, start=0.0):
    return types.SimpleNamespace(
        name=name, cpu_parent=parent, scope=scope, sequence_nr=seq,
        thread=thread, fwd_thread=fwd_thread, device_type=device, id=cid,
        is_user_annotation=annotation, self_cpu_time_total=us,
        time_range=types.SimpleNamespace(elapsed_us=lambda: us, start=start))


def test_device_rows_count_each_kernel_once_at_its_source():
    """A kernel counts at the op around its launch call (same correlation
    id): aten::einsum -> aten::bmm -> kernel counts at aten::bmm, einsum's
    own kernel at einsum; the patch kernel's launch lies in its range
    `extract_patches`, whose device-side copy is no kernel; backward ops
    take the forward op's line; a launch outside any op is "(no op)"; a
    kernel without a launch stays out of the rows, so the rows' total falls
    short of the kernel sum."""
    cuda = torch.autograd.DeviceType.CUDA
    launch = "cudaLaunchKernel"
    src = _event("sim/tengine.py:412", annotation=True)
    einsum = _event("aten::einsum", src, seq=7)
    bmm = _event("aten::bmm", einsum)
    src2 = _event("sim/tengine.py:300", annotation=True)
    patch = _event("extract_patches", src2, annotation=True)
    bw_fn = _event("autograd::engine::evaluate_function: BmmBackward0",
                   scope=1, seq=7, thread=2, fwd_thread=1)
    bw_op = _event("aten::bmm", bw_fn, thread=2)
    orphan = _event("aten::add")
    ops = [src, einsum, bmm, src2, patch, bw_fn, bw_op, orphan]
    launches = [_event(launch, parent, cid=100 + i) for i, parent in
                enumerate([einsum, bmm, bmm, patch, bw_op, orphan, None])]
    kernels = [_event(f"k{i}", device=cuda, us=us, cid=100 + i)
               for i, us in enumerate([0.125, 3.0, 1.0, 0.5, 2.0, 0.25,
                                       0.0625, 9.0])]
    copy = _event("extract_patches", device=cuda, us=0.5, cid=103,
                  annotation=True)
    rows, kernel_us, kernel_n = pr.op_rows(
        ops + launches + kernels + [copy],
        {"sim/tengine.py:412", "sim/tengine.py:300"}, True)
    assert rows == {
        ("aten::einsum", "sim/tengine.py:412"): [0.125, 1, 1],
        ("aten::bmm", "sim/tengine.py:412"): [4.0, 1, 2],
        ("extract_patches", "sim/tengine.py:300"): [0.5, 1, 1],
        ("aten::bmm", "sim/tengine.py:412 (backward)"): [2.0, 1, 1],
        ("aten::add", ""): [0.25, 1, 1],
        ("(no op)", ""): [0.0625, 1, 1]}
    assert (kernel_us, kernel_n) == (15.9375, 8)
    # host time: every op's self CPU time, the source ranges left out
    rows, _, _ = pr.op_rows(
        [src, _event("aten::mul", src, us=5.0)], {"sim/tengine.py:412"},
        False)
    assert rows == {("aten::mul", "sim/tengine.py:412"): [5.0, 1, 0]}


def test_launches_without_kernel_are_the_lost_ones():
    """A kernel launch inside the window whose correlation id no kernel
    carries is lost; a launch before the window (the lead-in's), a copy
    call and a launch whose id only a profiler range's device-side copy
    carries are told apart."""
    cuda = torch.autograd.DeviceType.CUDA
    op = _event("aten::add")
    events = [
        _event("cudaLaunchKernel", op, cid=1, start=10.0),
        _event("k1", device=cuda, cid=1),
        _event("cudaLaunchKernel", op, cid=2, start=12.0),      # lost
        _event("cuLaunchKernel", op, cid=3, start=14.0),        # lost
        _event("cudaLaunchKernel", op, cid=4, start=-3.0),      # lead-in
        _event("cudaMemcpyAsync", op, cid=5, start=16.0),       # no kernel
        _event("cudaLaunchKernel", op, cid=6, start=18.0),      # lost
        _event("extract_patches", device=cuda, cid=6, annotation=True),
        _event("sim/tengine.py:412", cid=2, annotation=True),   # a CPU range
    ]
    lost = pr.launches_without_kernel(events)
    assert [(e.name, e.id) for e in lost] == [
        ("cudaLaunchKernel", 2), ("cuLaunchKernel", 3), ("cudaLaunchKernel", 6)]


def test_op_table_raises_rather_than_lose_a_kernel(physics_setup,
                                                   monkeypatch):
    lost = _event("cudaLaunchKernel", cid=9, start=1428.8)
    monkeypatch.setattr(pr, "launches_without_kernel", lambda events: [lost])
    with pytest.raises(RuntimeError, match="lacks the kernels of 1 launch"):
        pr.op_table(physics_setup, iters=1)


def test_window_opens_after_the_lead_in():
    """What the lead-in runs lies before the window and is not traced; the
    body of the `with` is."""
    def lead_in():
        with torch.profiler.record_function("lead_in"):
            torch.ones(4).add(1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with pr.window(acts, lead_in) as prof:
        with torch.profiler.record_function("body"):
            torch.ones(4).mul(2)
    names = {e.name for e in prof.events()}
    assert "body" in names and "aten::mul" in names
    assert "lead_in" not in names and "aten::add" not in names


@pytest.mark.parametrize("kind", ["at once", "lead-in"])
def test_trace_window_rows_on_the_cpu(physics_setup, kind):
    """tools/trace_window.py's two windows over the physics step: on the
    CPU there is no kernel to lose and none of the patch kernel."""
    row = trace_window.trace(physics_setup, kind)
    assert row == {"window": kind, "lost": 0, "first_lost_us": None,
                   "patch_kernels": 0}


def test_trace_window_capture_and_profiled_replay_on_the_cpu(physics_setup):
    """`capture` (the graph that chip_smoke.py's phase profile replays under
    the profiler before its op tables) leaves deterministic algorithms off
    and captures nothing on the CPU, where the step is eager; one profiled
    call then runs an iteration and reports no kernel and no lost launch.
    The distributed check worker's profiled iteration (one process, no
    mesh) reports its lost launches beside its launches."""
    from go2_rl_gym_tpu_torch.distributed import check
    from go2_rl_gym_tpu_torch.utils import graphs

    # a short iteration: 2 policy steps, one epoch of one minibatch
    tc = copy.deepcopy(physics_setup.tc)
    tc.runner.num_steps_per_env = 2
    tc.algorithm.num_learning_epochs = tc.algorithm.num_mini_batches = 1
    captures = dict(graphs.CAPTURES)
    step, runner = trace_window.capture(physics_setup._replace(tc=tc))
    assert not torch.are_deterministic_algorithms_enabled()
    assert dict(graphs.CAPTURES) == captures
    assert runner.env is physics_setup.env and runner.num_steps == 2
    obs = step.state.obs.clone()
    assert trace_window.profile_replay(step, torch.device("cpu")) == {
        "kernels": 0, "lost": 0}
    assert not torch.equal(step.state.obs, obs)
    prof = check._profile_iteration(runner, graphs.copy_tree(step.state),
                                    lambda: None)
    assert (prof["launches"], prof["lost_launches"]) == (0, 0)
    assert prof["wall_ms"] > 0


class _HostEvent:
    """torch.cuda.Event's interface on the host clock, for the card-only
    tool on the CPU."""

    def __init__(self, **kwargs):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_windows_open_after_a_lead_in(physics_setup, monkeypatch, capsys):
    """Every trace window of `profile_rollout --train` (the iteration and
    the update) and of the distributed check worker (its profiled compiled
    call and its profiled iteration) opens through `open_window`: the
    tracing on, a lead-in, the window, the pad. Counted by a patched
    `open_window`; on the CPU no trace holds a kernel or loses one."""
    from go2_rl_gym_tpu_torch.distributed import check
    from go2_rl_gym_tpu_torch.utils import graphs

    opened = []
    open_window = pr.open_window

    def counted(prof, lead_in):
        opened.append(prof)
        open_window(prof, lead_in)
    monkeypatch.setattr(pr, "open_window", counted)
    # the --train mode is the card's: its clock and names on the host
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *args: "cpu")

    tc = copy.deepcopy(physics_setup.tc)
    tc.runner.num_steps_per_env = 2
    tc.algorithm.num_learning_epochs = tc.algorithm.num_mini_batches = 1
    train = pr.build("train", like=physics_setup._replace(tc=tc))
    pr.profile_train(train.runner, train.rs, 3, "go2_moe_cts")
    res = _last_json(capsys.readouterr().out)
    assert len(opened) == 2
    assert res["lost_launches"] == {"iteration": 0, "update": 0}
    assert res["kernel_launches"] == {"iteration": 0, "update": 0}
    assert res["profiled_wall_ms"]["update"] > 0

    step = train.runner.compiled_step(graphs.copy_tree(train.rs))
    timed = check._time_compiled(train.runner, step, 1, None)
    assert len(opened) == 3
    assert (timed["profiled"]["launches"],
            timed["profiled"]["lost_launches"]) == (0, 0)
    prof = check._profile_iteration(
        train.runner, graphs.copy_tree(step.state), lambda: None)
    assert len(opened) == 4
    assert (prof["launches"], prof["lost_launches"]) == (0, 0)
