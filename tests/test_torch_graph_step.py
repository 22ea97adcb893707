"""PyTorch port, the compiled step on the CPU (utils/graphs.py).

On the card the train iteration is one CUDA graph, captured once and
replayed; a graph replays fixed addresses and cannot read the device from
the host. These tests hold what makes that possible, on the CPU:

* The host-read sentinel (`graphs.HostReads`): a TorchDispatchMode over
  the second `train_step` of five tasks (go2_moe_cts, go2_dual_moe_cts,
  go2, go2_lstm, go2_fast_flat_move) and over `env.step` (heading command
  on) fails on
  `aten._local_scalar_dense` (a value read back), `aten.lift_fresh` (a
  tensor built from host data, which copies from the host), `aten.nonzero`
  and a boolean-mask index (data-dependent shapes).
* The in-place step: 3 calls of `OnPolicyRunner.compiled_step` (which runs
  `train_step` on fixed storage and writes every result back into it)
  equal 3 plain `train_step`s bit for bit: parameters, Adam states,
  learning rates, the RunnerState with its generators, and the metrics in
  the JAX order. The algorithm's train state (Adam states, learning rates)
  advances in the storage it started in, through steps and `load`.
* `graphs.write_back` is order-free when a result is another field's
  storage; `graphs.EnvStep` (play's and VecEnv's step) equals `env.step`.

Small: 8 envs on a 2 x 2 terrain, 2 policy steps per iteration.
"""
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
from go2_rl_gym_tpu_torch.utils import graphs, registry

N, T = 8, 2
TASKS = ("go2_moe_cts", "go2_dual_moe_cts", "go2", "go2_lstm",
         "go2_fast_flat_move")
# the algorithms' train state besides the parameters: PPO's or CTS's
TRAIN_STATE = ("opt", "opt1", "opt2", "lr", "lr2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_runner(task, log_dir=None, steps=T):
    env_cfg, tc = registry.get_cfgs(task)
    env_cfg.terrain.num_rows = 2
    env_cfg.terrain.num_cols = 2
    tc.runner.num_steps_per_env = steps
    env = registry.make_env(task, env_cfg, num_envs=N,
                            num_steps_per_env=steps, device="cpu")
    return OnPolicyRunner(env, tc, log_dir=log_dir, device="cpu")


@pytest.fixture(scope="module", params=TASKS)
def task_runner(request):
    """A task's runner and a state at random episode lengths, and the
    snapshot that restores both."""
    runner = small_runner(request.param)
    rs0 = graphs.copy_tree(runner.init_runner_state(
        0, init_at_random_ep_len=True))
    return request.param, runner, rs0, _train_state(runner)


def _train_state(runner):
    alg = runner.alg
    return ({k: p.detach().clone() for k, p in alg.model.named_parameters()},
            {n: graphs.copy_tree(getattr(alg, n)) for n in TRAIN_STATE
             if hasattr(alg, n)})


def _storage(alg):
    """Where the algorithm's train state lives: every tensor's address."""
    return [(n, p, x.data_ptr()) for n in TRAIN_STATE if hasattr(alg, n)
            for p, x in graphs.leaves(getattr(alg, n))]


def _restore(runner, rs0, train_state):
    params, owned = train_state
    with torch.no_grad():
        for k, p in runner.alg.model.named_parameters():
            p.copy_(params[k])
    for n, v in owned.items():
        graphs.assign(getattr(runner.alg, n), v)
    return graphs.copy_tree(rs0)


def _flat(m):
    return graphs.flat_metrics(sorted(m))(m)


def _assert_trees_equal(a, b):
    la, lb = list(graphs.leaves(a)), list(graphs.leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), p
        else:
            assert torch.equal(x, y), p


def test_train_step_reads_nothing_from_the_host(task_runner):
    task, runner, rs0, ts = task_runner
    rs = _restore(runner, rs0, ts)
    rs, _ = runner.train_step(rs)       # first calls fill lazy caches
    mode = graphs.HostReads()
    with mode:
        runner.train_step(rs)
    assert mode.hits == [], f"{task}: {sorted(set(mode.hits))}"


def test_env_step_reads_nothing_from_the_host():
    """The env step alone, with the heading command (off in the tasks)."""
    env_cfg, _ = registry.get_cfgs("go2_moe_cts")
    env_cfg.terrain.num_rows = env_cfg.terrain.num_cols = 2
    env_cfg.commands.heading_command = True
    env = registry.make_env("go2_moe_cts", env_cfg, num_envs=N, device="cpu")
    state = env.init_state(0)
    acts = torch.zeros((N, env.num_actions))
    with torch.no_grad():
        state, _ = env.step(state, acts)
        mode = graphs.HostReads()
        with mode:
            env.step(state, acts + 0.1)
    assert mode.hits == [], sorted(set(mode.hits))


def test_sentinel_sees_a_tensor_from_host_data():
    """The sentinel itself: a step that builds a tensor from a list, reads
    a value back or masks by a boolean is caught."""
    x = torch.ones(3)
    for fn in (lambda: x * torch.tensor([1.0, 2.0, 3.0]),
               lambda: float(x.sum()),
               lambda: x[x > 0]):
        mode = graphs.HostReads()
        with mode:
            fn()
        assert mode.hits, fn


def test_in_place_step_equals_train_step(task_runner):
    """3 calls of the in-place step equal 3 plain train_steps bit for bit;
    the adaptive learning rate and the Adam counts moved (so that one left
    unwritten would show), in the storage they started in (a graph reads
    that storage)."""
    task, runner, rs0, ts = task_runner
    alg = runner.alg
    where = _storage(alg)
    rs, rows = _restore(runner, rs0, ts), []
    for _ in range(3):
        rs, m = runner.train_step(rs)
        rows.append(_flat(m))
    want_state, want_train = rs, _train_state(runner)

    step = runner.compiled_step(_restore(runner, rs0, ts))
    assert isinstance(step, graphs.InPlaceStep)     # eager on the CPU
    got = [step().clone() for _ in range(3)]
    assert runner.metric_keys == sorted(m)
    assert sum(runner.metric_sizes) == got[0].numel()
    for a, b in zip(rows, got):
        assert torch.equal(a, b)
    _assert_trees_equal(step.state, want_state)
    params, owned = want_train
    for k, p in alg.model.named_parameters():
        assert torch.equal(p, params[k]), k
    for n, v in owned.items():
        _assert_trees_equal(getattr(alg, n), v)
    assert _storage(alg) == where
    lr0 = ts[1]["lr"]
    assert not torch.equal(alg.lr, lr0), "the learning rate never moved"
    counts = [getattr(alg, n).count for n in ("opt", "opt1", "opt2")
              if hasattr(alg, n)]
    assert all(int(c) == 3 * alg.cfg.num_learning_epochs
               * alg.cfg.num_mini_batches for c in counts)


def test_in_place_step_adopts_a_loaded_state(tmp_path):
    """`load` copies the file's Adam states and learning rate into the
    storage the kept step reads, and the step copies the file's
    RunnerState into its own: the next call equals a plain train_step from
    the file."""
    runner = small_runner("go2_moe_cts")
    rs = runner.init_runner_state(0)
    step = runner.compiled_step(rs)
    step()
    where = _storage(runner.alg)
    path = str(tmp_path / "model.pt")
    runner.save(step.state, path)
    step()
    rs_file = runner.load(runner.init_runner_state(3), path)
    assert runner.compiled_step(rs_file) is step
    assert _storage(runner.alg) == where
    got = step().clone()

    other = small_runner("go2_moe_cts")
    rs_o = other.load(other.init_runner_state(5), path)
    rs_o, m = other.train_step(rs_o)
    assert torch.equal(got, _flat(m))
    _assert_trees_equal(step.state, rs_o)
    for (k, p), (_, q) in zip(runner.alg.model.named_parameters(),
                              other.alg.model.named_parameters()):
        assert torch.equal(p, q), k


def test_write_back_is_order_free():
    """A result that is another field's storage (the env's
    `last_last_actions = last_actions`) is copied aside before any field is
    overwritten."""
    a, b = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    state = {"a": a, "b": b}
    new = {"a": b, "b": a}            # swapped: each result is the other
    graphs.write_back(graphs._pairs(state, new))
    assert state["a"].tolist() == [3.0, 4.0]
    assert state["b"].tolist() == [1.0, 2.0]
    with pytest.raises(ValueError, match="changed the structure"):
        graphs.write_back(graphs._pairs(state, {"a": a}))
    with pytest.raises(ValueError, match="returned"):
        graphs.write_back(graphs._pairs(state, {"a": a, "b": b[:1]}))


def test_copy_tree_unshares_storage():
    """The step's storage never aliases: RNN memory starts as one zero
    tensor in four places (RecurrentPPO.zero_memory)."""
    runner = small_runner("go2_lstm")
    rs = runner.init_runner_state(0)
    mem = rs.memory
    assert mem.a.h is mem.c.c
    ptrs = [x.untyped_storage().data_ptr()
            for _, x in graphs.leaves(graphs.copy_tree(rs))
            if isinstance(x, torch.Tensor) and x.numel()]
    assert len(ptrs) == len(set(ptrs))


def test_env_step_helper_equals_env_step():
    """graphs.EnvStep (play's and VecEnvAdapter's step) on the CPU: the
    in-place env step equals env.step over 3 steps, with the state handed
    back changed between calls as play's loop changes the command."""
    env_cfg, _ = registry.get_cfgs("go2_moe_cts")
    env_cfg.terrain.num_rows = env_cfg.terrain.num_cols = 2
    env = registry.make_env("go2_moe_cts", env_cfg, num_envs=N, device="cpu")
    s0 = env.init_state(0)
    g = torch.Generator().manual_seed(0)
    acts = [0.3 * torch.randn((N, 12), generator=g) for _ in range(3)]
    step = graphs.EnvStep(env)
    with torch.no_grad():
        want, s = [], graphs.copy_tree(s0, generators=True)
        for a in acts:
            s = s._replace(commands=s.commands * 0.5)
            s, out = env.step(s, a)
            want.append(graphs.copy_tree(out))
        got, t = [], graphs.copy_tree(s0, generators=True)
        for a in acts:
            t = t._replace(commands=t.commands * 0.5)
            t, out = step(t, a)
            got.append(graphs.copy_tree(out))
    assert t is step.step.state
    for w, o in zip(want, got):
        _assert_trees_equal(w, o)
    _assert_trees_equal(s, t)
    assert graphs.CAPTURES["env_step"] == 0        # nothing captured on CPU
    np.testing.assert_array_equal(t.episode_length.numpy(),
                                  s0.episode_length.numpy() + 3)
