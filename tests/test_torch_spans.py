"""PyTorch port: the spans of the train iteration (utils/spans.py).

On the CPU (stamps on the host clock), with 16-env runners of go2_moe_cts
and go2 on a small rough terrain:

* one `train_step` with a recorder on stamps exactly the schedule of its
  spans: `train_step` round `rollout` (T x `act`, T x `env` each round one
  `physics`), `gae` and `update`, nested as the code nests them; a
  listener sees the same edges, the ends of `rollout`, `gae` and `update`
  in that order;
* the decoded milliseconds are non-negative, and the phases and the
  uncovered rest add up to `train_step`;
* decoding a hand-made ring reads across its wrap-around and drops an
  iteration that the ring has partly overwritten;
* with no recorder on, nothing is stamped and no listener fires;
* `compiled_step` makes a new graph when the recorder on differs from the
  one its graph was captured under, and only then;
* `learn` with a recorder on logs `Perf/phase/<span>_ms`, and
  `scripts.train --spans` does so, its `--profile_dir` trace holds the
  `go2.*` host ranges, and it leaves no recorder on;
* `tools/span_cost.py`'s turns run on the CPU.

On a card (marked `gpu`, skipped without one; this file imports no JAX):
each replay advances the ring's cursor by exactly len(schedule), and a
graph captured with spans off has the kernels and copies of one captured
before any recorder was on, a graph with spans on those and one stamp per
edge.

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_spans.py
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
from go2_rl_gym_tpu_torch.utils import graphs, registry, spans

T = 4


def _runner(task, device="cpu", num_envs=16, steps=T):
    env_cfg, tc = registry.get_cfgs(task)
    env_cfg.env.num_envs = num_envs
    env_cfg.terrain.num_rows, env_cfg.terrain.num_cols = 2, 4
    env_cfg.terrain.border_size = 3.0
    tc.runner.num_steps_per_env = steps
    env = Go2Env(env_cfg, num_steps_per_env=steps, device=device)
    runner = OnPolicyRunner(env, tc, device=device)
    return runner, runner.init_runner_state(0, init_at_random_ep_len=True)


@pytest.fixture(scope="module", params=["go2_moe_cts", "go2"])
def setup(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _runner(request.param)
    torch.set_num_threads(n)


def _schedule(steps):
    B, E = spans.BEGIN, spans.END
    one = [("act", B), ("act", E), ("env", B), ("physics", B),
           ("physics", E), ("env", E)]
    return tuple([("train_step", B), ("rollout", B)] + one * steps
                 + [("rollout", E), ("gae", B), ("gae", E), ("update", B),
                    ("update", E), ("train_step", E)])


def test_one_iteration_stamps_the_schedule(setup):
    runner, rs = setup
    seen = []
    with spans.recording("cpu") as rec, \
            spans.listen(lambda name, kind: seen.append((name, kind))):
        runner.train_step(graphs.copy_tree(rs))
    assert rec.schedule == _schedule(T)
    assert len(rec.schedule) == 2 * (3 * T + 4)
    assert int(rec.buf[0]) == len(rec.schedule)
    assert tuple(seen) == rec.schedule
    ends = [name for name, kind in seen if kind == spans.END
            and name in ("rollout", "gae", "update")]
    assert ends == ["rollout", "gae", "update"]
    # nesting: every physics inside an env, every act and env inside the
    # rollout, the three phases inside train_step
    by = {k: name for k, (name, *_) in enumerate(spans.pairs(rec.schedule))}
    parent = {by[k]: set() for k in by}
    for k, (name, _, _, up) in enumerate(spans.pairs(rec.schedule)):
        parent[name].add(by.get(up))
    assert parent == {"train_step": {None}, "rollout": {"train_step"},
                      "act": {"rollout"}, "env": {"rollout"},
                      "physics": {"env"}, "gae": {"train_step"},
                      "update": {"train_step"}}


def test_decoded_phases_add_up(setup):
    runner, rs = setup
    with spans.recording("cpu") as rec:
        state = graphs.copy_tree(rs)
        for _ in range(2):
            state, _ = runner.train_step(state)
    [a, b] = rec.iterations(rec.copy(), 2)
    for it in (a, b):
        assert list(it) == list(spans.NAMES) + [spans.UNCOVERED]
        assert all(v >= 0 for v in it.values()), it
        total = sum(it[p] for p in spans.PHASES) + it[spans.UNCOVERED]
        assert total == pytest.approx(it["train_step"], rel=1e-9)
        assert it["rollout"] <= it["train_step"]
    # three iterations asked of a ring that holds two: the two
    assert rec.iterations(rec.copy(), 3) == [a, b]


def test_decode_reads_across_the_wrap_and_drops_a_partial_iteration():
    B, E = spans.BEGIN, spans.END
    schedule = (("train_step", B), ("env", B), ("physics", B),
                ("physics", E), ("env", E), ("train_step", E))
    L = len(schedule)
    # iteration i starts at 1000 i: env 10-60, physics 20-50, end at 100
    offsets = [0, 10, 20, 50, 60, 100]
    cap = 16
    ring = np.zeros(cap, np.int64)
    iters = 5
    for i in range(iters):
        for k in range(L):
            ring[(i * L + k) % cap] = 1000 * i + offsets[k] * (i + 1)
    cursor = iters * L         # 30 stamps into 16 slots: the last 2 whole
    got = spans.decode(ring, cursor, iters * L, schedule)
    assert len(got) == cap // L == 2
    for i, it in zip((3, 4), got):
        s = (i + 1) / 1e6
        assert it["train_step"] == pytest.approx(100 * s)
        assert it["physics"] == pytest.approx(30 * s)
        assert it["env"] == pytest.approx(20 * s)     # 50 less physics
        assert it[spans.UNCOVERED] == pytest.approx(50 * s)
    # a count that is not whole iterations reads the whole ones at the end
    assert spans.decode(ring, cursor, L + 3, schedule) == got[1:]
    # no schedule, or fewer stamps than one iteration: nothing
    assert spans.decode(ring, cursor, cursor, ()) == []
    assert spans.decode(ring, L - 1, L - 1, schedule) == []


def test_spans_that_do_not_nest_are_refused():
    B, E = spans.BEGIN, spans.END
    with pytest.raises(ValueError):
        spans.pairs((("a", B), ("b", B), ("a", E), ("b", E)))
    with pytest.raises(ValueError):
        spans.pairs((("a", B),))


def test_with_no_recorder_nothing_is_stamped(setup):
    runner, rs = setup
    seen = []
    assert spans.current() is None
    with spans.recording("cpu") as rec:
        pass
    with spans.listen(lambda *edge: seen.append(edge)):
        runner.train_step(graphs.copy_tree(rs))
    assert seen == [] and int(rec.buf[0]) == 0 and rec.schedule == ()
    assert spans.current() is None
    # outside train_step a span records nothing, recorder on or not
    with spans.recording("cpu") as rec, \
            spans.listen(lambda *edge: seen.append(edge)):
        with spans.span("physics"):
            pass
        runner.env.step(rs.env_state, torch.zeros(16, 12))
        with spans.host("learn.launch"):
            pass
    assert seen == [] and int(rec.buf[0]) == 0
    assert rec.host_ms("learn.launch", 1)[0] >= 0


class _HostGraph(graphs.StepGraph):
    """StepGraph's bookkeeping without a card: the warm-up runs the step,
    the capture notes the recorder and counts, a replay runs the step."""

    def _warm_up(self):
        return self.step()

    def _capture(self):
        self.recorder = spans.current()
        self.graph = SimpleNamespace(
            replay=lambda: setattr(self, "out", self.step()))
        self.captures += 1
        graphs.CAPTURES[self.kind] += 1


def test_compiled_step_follows_the_recorder(monkeypatch):
    runner, rs = _runner("go2", num_envs=8, steps=1)
    monkeypatch.setattr(graphs, "StepGraph", _HostGraph)
    monkeypatch.setattr(runner, "train_mode", lambda: ("graph", "test"))
    before = graphs.CAPTURES["train_step"]

    def captures():
        return graphs.CAPTURES["train_step"] - before
    off = runner.compiled_step(rs)
    off()
    off()
    assert captures() == 1 and off.recorder is None
    assert runner.compiled_step(rs) is off
    with spans.recording("cpu") as rec:
        on = runner.compiled_step(rs)
        assert on is not off
        on()
        on()
        assert captures() == 2 and on.recorder is rec
        assert runner.compiled_step(rs) is on
        with spans.recording("cpu"):
            other = runner.compiled_step(rs)
            other()
            assert other is not on and captures() == 3
    again = runner.compiled_step(rs)
    assert again is not other
    again()
    assert captures() == 4 and again.recorder is None
    assert runner.compiled_step(rs) is again


class _Writer:
    def __init__(self):
        self.rows = {}

    def add_scalar(self, tag, value, step):
        self.rows[(tag, step)] = float(value)

    def flush(self):
        pass


def test_learn_logs_the_phases():
    runner, rs = _runner("go2", num_envs=8, steps=2)
    runner.writer = _Writer()
    with spans.recording("cpu"):
        runner.learn(rs, 3, log_every=2, print_every=10 ** 9)
    rows = runner.writer.rows
    names = list(spans.NAMES) + [spans.UNCOVERED, "learn.launch"]
    logged = {step for tag, step in rows if tag == "Perf/iteration_time"}
    assert logged == {0, 2}
    for step in logged:
        got = {n: rows[(f"Perf/phase/{n}_ms", step)] for n in names}
        assert all(v >= 0 for v in got.values())
        assert got["learn.launch"] >= got["train_step"]
    # without a recorder no phase is logged
    runner.writer = _Writer()
    runner.learn(rs, 1)
    assert not [t for t, _ in runner.writer.rows if "phase" in t]


def test_train_script_spans_log_the_phases(tmp_path, monkeypatch):
    """`scripts.train --spans --profile_dir` at 4 envs on the plane for 14
    iterations (each cut to 2 policy steps and one minibatch, as the
    script's --profile_dir test cuts them): the phases are logged, the
    trace holds the go2.* host ranges, and no recorder is left on."""
    from go2_rl_gym_tpu_torch.scripts import train as train_script
    get_cfgs = registry.get_cfgs

    def short(task):
        env_cfg, tc = get_cfgs(task)
        tc.runner.num_steps_per_env = 2
        tc.algorithm.num_learning_epochs = tc.algorithm.num_mini_batches = 1
        return env_cfg, tc
    monkeypatch.setattr(registry, "get_cfgs", short)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runner, _ = train_script.main(
            ["--task", "go2", "--num_envs", "4", "--terrain", "plane",
             "--device", "cpu", "--log_root", str(tmp_path / "logs"),
             "--max_iterations", "14", "--spans",
             "--profile_dir", str(tmp_path / "profile")])
    finally:
        torch.set_num_threads(n)
    assert spans.current() is None and runner.current_iteration == 14
    with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {f"Perf/phase/{n}_ms" for n in spans.NAMES} <= tags
    assert "Perf/phase/learn.launch_ms" in tags
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {spans.PREFIX + n for n in spans.NAMES} <= names
    assert spans.PREFIX + "learn.launch" in names


def test_span_cost_turns_on_the_cpu():
    """tools/span_cost.py: off, on, on, off turns of one runner, the on
    turns stamping the schedule."""
    from go2_rl_gym_tpu_torch.tools import span_cost
    runner, rs = _runner("go2", num_envs=8, steps=1)
    got = span_cost.measure(runner, rs, rounds=1, replays=1)
    assert got["stamps_per_replay"] == 2 * (3 + 4)
    assert [len(v) for v in got["turn_ms"].values()] == [2, 2]
    assert all(v > 0 for v in got["median_ms"].values())
    assert got["cost_pct"] == pytest.approx(
        100 * (got["median_ms"]["on"] / got["median_ms"]["off"] - 1))
    assert set(got["span_ms"]) == set(spans.NAMES) | {spans.UNCOVERED}
    assert all(lo <= mid <= hi for mid, lo, hi in got["span_ms"].values())
    assert spans.current() is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernels_of_one_replay(step):
    """(kernels and copies, stamp kernels) that one call of a captured step
    runs, read from a profiler trace of it whose window opens after another
    call as its lead-in (`profile_rollout.window`); fills left out. Copies
    count with the kernels: the first graph captured in a process runs its
    device-to-device copies as kernels (`memcpy32_post`), later ones as copy
    nodes."""
    from go2_rl_gym_tpu_torch.tools import profile_rollout as pr
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    step()
    torch.cuda.synchronize()
    with pr.window(acts, lambda: (step(), torch.cuda.synchronize())) as prof:
        step()
        torch.cuda.synchronize()
    assert not pr.launches_without_kernel(prof.events())
    rows = [e for e in pr._kernels(prof) if not e.key.startswith("Memset")]
    return (sum(e.count for e in rows),
            sum(e.count for e in rows if spans.STAMP_KERNEL in e.key))


@pytest.mark.gpu
def test_replays_stamp_the_schedule_on_the_card():
    dev = _card()
    runner, rs = _runner("go2", device=dev, num_envs=256, steps=2)
    before, stamps_off = _kernels_of_one_replay(runner.compiled_step(rs))
    assert stamps_off == 0
    with spans.recording(dev) as rec:
        step = runner.compiled_step(rs)
        step()                                  # warm-up and capture
        torch.cuda.synchronize()
        L = len(rec.schedule)
        assert L == 2 * (3 * 2 + 4) and int(rec.buf[0]) == L
        assert step.recorder is rec
        for k in range(1, 4):
            step()
            torch.cuda.synchronize()
            assert int(rec.buf[0]) == L * (k + 1)
        copied = rec.copy()
        torch.cuda.synchronize()
        its = rec.iterations(copied, 4)
        assert len(its) == 4
        for it in its:
            assert all(v >= 0 for v in it.values()), it
            assert it["physics"] > 0 and it["update"] > 0
        on, stamps_on = _kernels_of_one_replay(step)
        assert stamps_on == L
    off, stamps = _kernels_of_one_replay(runner.compiled_step(rs))
    assert stamps == 0
    assert (before, off) == (on - L, on - L)
