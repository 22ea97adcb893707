"""PyTorch port: the train step under a mesh with fixed shapes
(distributed/mesh.py `share`, `share_index`, `gather_samples`,
`make_sharded_train_step`), on the CPU with gloo.

Under a mesh the update all_gathers the samples it reads once, and each
rank takes a static share of every global minibatch: c = ceil(m / W)
members from r * c on, padding clamped and weighted 0. Nothing is read
back, so the iteration is one CUDA graph per rank under NCCL.

* The shares (pure functions, no processes): for W in 1-4 and minibatch
  sizes W does not divide, the ranks' shares cover each minibatch once, in
  order, with zero-weight padding only (a hypothesis test and explicit
  cases); `sample_rows` addresses the rank-major gathered buffer.
* Two gloo ranks of `go2_rl_gym_tpu_torch.distributed.check`, spawned once
  for the module (one torch thread each, a 60 s process-group timeout),
  while this process computes the references:
  - the host-read sentinel (`graphs.HostReads`) over the second
    `train_step` of go2_moe_cts, go2 and go2_lstm records nothing;
  - padded shares: go2_moe_cts with 8 minibatches (3 teacher and 1
    student sample each: rank 1 holds one teacher and one student padding
    row), go2 with 32 (1 sample each) and go2_lstm with 8 (1 env each):
    parameters within 1e-5 of one port process and bitwise equal across
    the ranks, metrics within 1e-5 relative, and go2_moe_cts from the JAX
    runner's fresh train state against the JAX runner's jitted train step
    with 8 minibatches, at the tolerances of tests/test_torch_distributed.py;
  - `learn(rs, 3)` on the plane (randomness off, the act noise of each
    iteration injected) gives one process's logged metrics (rtol 1e-5,
    atol 1e-6) and final parameters (atol 1e-5); its mode is eager, "gloo
    cannot be captured";
  - the "graph" job: the compiled step (under gloo the eager in-place step)
    equals 3 eager `train_step`s bit for bit on each rank.
* `make_sharded_train_step` refuses a runner that is not the mesh's.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from go2_rl_gym_tpu.agents import cts as jcts
from go2_rl_gym_tpu.env.config import Go2Cfg as JCfg
from go2_rl_gym_tpu.env.config import go2_moe_cts_train_cfg as j_train_cfg
from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu.train.runner import OnPolicyRunner as JRunner
from go2_rl_gym_tpu_torch.agents import recurrent_ppo as trppo
from go2_rl_gym_tpu_torch.agents.recurrent import LSTMState
from go2_rl_gym_tpu_torch.distributed import check
from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
from go2_rl_gym_tpu_torch.distributed.mesh import Mesh
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.tools import card_check
from go2_rl_gym_tpu_torch.train.runner import _pack
from test_torch_distributed import (N, T_STEPS, WORLD, _runner_state, _t,
                                    _wait, spawn_ranks)
from test_torch_env import parity_cfg
from test_torch_train import _replayed_noise, _spy_update
from test_torch_update import jax_perms

CPU = torch.device("cpu")
SENTINEL_TASKS = ("go2_moe_cts", "go2", "go2_lstm")
# minibatch counts whose minibatches W = 2 does not divide (N = 8 envs, 4
# steps, go2_moe_cts's 6 teacher and 2 student envs)
PADDED = {"go2_moe_cts": 8, "go2": 32, "go2_lstm": 8}
PADDED_JOB = {t: len(SENTINEL_TASKS) + i for i, t in enumerate(PADDED)}
JAX_JOB = PADDED_JOB["go2_lstm"] + 1
LEARN_JOB, GRAPH_JOB = JAX_JOB + 1, JAX_JOB + 2
LEARN_ITERATIONS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the shares, without processes
# ---------------------------------------------------------------------------


def _covers_once(m, world):
    """Every rank's share of a minibatch of m, checked against the rule;
    returns the members in rank order."""
    shares = [mesh_lib.share(m, world, r) for r in range(world)]
    members = []
    for r, sh in enumerate(shares):
        assert sh.size == -(-m // world)            # the same on every rank
        assert 0 <= sh.valid <= sh.size
        cols, weight = mesh_lib.share_index(Mesh(r, world, CPU, world), m,
                                            CPU)
        assert cols.dtype == torch.int64 and tuple(cols.shape) == (sh.size,)
        want = np.minimum(np.arange(sh.start, sh.start + sh.size), m - 1)
        np.testing.assert_array_equal(cols.numpy(), want)
        if sh.valid == sh.size:
            assert weight is None
        else:                    # padding only after the members
            np.testing.assert_array_equal(
                weight.numpy(), [1.0] * sh.valid
                + [0.0] * (sh.size - sh.valid))
        members += cols[:sh.valid].tolist()
    assert members == list(range(m))               # once each, in order
    return members


@settings(max_examples=60, deadline=None)
@given(world=st.integers(1, 4), m=st.integers(1, 97))
def test_shares_cover_each_minibatch_once(world, m):
    _covers_once(m, world)


@pytest.mark.parametrize("world,m", [(2, 3), (2, 1), (3, 7), (4, 5),
                                     (4, 1), (4, 18433)])
def test_shares_pad_only_the_last_ranks(world, m):
    """W not dividing m: the last ranks' shares end in padding (a rank may
    hold nothing but padding), the first ones none."""
    _covers_once(m, world)
    pads = [mesh_lib.share(m, world, r) for r in range(world)]
    pads = [sh.size - sh.valid for sh in pads]
    assert sum(pads) == -(-m // world) * world - m > 0
    assert pads == sorted(pads)


def test_one_rank_takes_the_whole_minibatch():
    cols, weight = mesh_lib.share_index(None, 6, CPU)
    assert cols.tolist() == list(range(6)) and weight is None
    cols, weight = mesh_lib.share_index(Mesh(0, 1, CPU, 4), 6, CPU)
    assert cols.tolist() == list(range(6)) and weight is None


def test_sample_rows_address_the_gathered_buffer():
    """W ranks' (T, n, F) blocks concatenated in rank order (what
    all_gather returns) hold global env e's step t at sample_rows(e, t)."""
    T, world, n, F = 3, 4, 5, 2
    g = torch.Generator().manual_seed(0)
    glob = torch.randn((T, world * n, F), generator=g)     # (T, N, F)
    buf = torch.cat([glob[:, r * n:(r + 1) * n].reshape(T * n, F)
                     for r in range(world)])
    env = torch.arange(world * n)[None, :]
    t = torch.arange(T)[:, None]
    rows = mesh_lib.sample_rows(env, t, T, n)
    assert torch.equal(buf[rows], glob)
    # without a mesh the buffer is the (T * N, F) reshape, row t * N + e
    flat = mesh_lib.gather_samples(None, glob)
    assert torch.equal(flat[mesh_lib.sample_rows(env, t, T, world * n)],
                       glob)


def test_make_sharded_train_step_refuses_another_mesh():
    runner = check.build(dict(task="go2_moe_cts", num_envs=N, steps=2,
                              terrain="plane"), "cpu")
    with pytest.raises(ValueError, match="not attached"):
        mesh_lib.make_sharded_train_step(runner, Mesh(0, 2, CPU, N),
                                         runner.init_runner_state(0))


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------


def _job(task, **kw):
    return dict(dict(task=task, num_envs=N, steps=T_STEPS, terrain="parity",
                     randomness=False), **kw)


def _padded_jobs(jr, jrs, rng):
    """The padded-share step jobs: each task with warm Adam moments, then
    go2_moe_cts from the JAX runner's fresh train state with its noise and
    permutations."""
    jobs, params0 = [], {}
    for task, nmb in PADDED.items():
        runner = check.build(_job(task, mini_batches=nmb), "cpu")
        runner.init_runner_state(5)
        memory = ()
        if task == "go2_lstm":
            h = runner.alg.hidden
            memory = trppo.Memory(*[LSTMState(*[
                torch.as_tensor(0.5 * rng.normal(size=(N, h)),
                                dtype=torch.float32) for _ in "hc"])
                for _ in "ac"])
        if task == "go2_moe_cts":
            noise, k_up = _replayed_noise(jrs.key)
            perms = tuple(torch.as_tensor(np.array(p))
                          for p in jax_perms(k_up, jr.alg, T_STEPS))
            timp.params_from_jax(jax.tree.map(np.asarray, jcts.merge_params(
                jrs.train_state.params1, jrs.train_state.params2)),
                runner.alg.model)
            state = _runner_state(jrs, _t(jrs.history))
            noise = _t(noise)
            jax_job = _job(task, kind="step", mini_batches=nmb,
                           train_state=runner.alg.train_state_dict(),
                           state=_pack(state), noise=noise, perms=perms)
        else:
            state = _runner_state(jrs, _t(jrs.obs)[:, None], memory)
            noise = torch.as_tensor(rng.normal(size=(T_STEPS, N, 12)),
                                    dtype=torch.float32)
            n_perm = N if task == "go2_lstm" else T_STEPS * N
            perms = torch.as_tensor(rng.permutation(n_perm))
        check.warm_adam(runner.alg, seed=len(jobs))
        jobs.append(_job(task, kind="step", mini_batches=nmb,
                         train_state=runner.alg.train_state_dict(),
                         state=_pack(state), noise=noise, perms=perms))
        params0[task] = {k: p.detach().clone()
                         for k, p in runner.alg.model.named_parameters()}
    return jobs + [jax_job], params0


def _learn_job():
    """`learn` of go2_moe_cts on the plane from a seeded state with warm
    Adam moments and injected noise."""
    job = dict(kind="learn", task="go2_moe_cts", num_envs=N,
               steps=T_STEPS, terrain="plane", randomness=False,
               iterations=LEARN_ITERATIONS)
    runner = check.build(job, "cpu")
    rs = runner.init_runner_state(0)
    check.warm_adam(runner.alg, seed=7)
    g = torch.Generator().manual_seed(7)
    return dict(job, state=card_check.tree_to(_pack(rs), "cpu"),
                train_state=card_check.tree_to(
                    runner.alg.train_state_dict(), "cpu"),
                noise=torch.randn((LEARN_ITERATIONS, T_STEPS, N, 12),
                                  generator=g))


def _jax_reference(jr, jrs):
    """The JAX runner's jitted train step with the returns and advantages
    its update received."""
    captured = {}
    _spy_update(jr.alg, captured)
    step = jr._build_train_step()

    def run(rs):
        out = step(rs)
        _, _, returns, advantages, _ = captured["args"]
        return out, (returns, advantages)
    (jrs2, jm), (j_ret, j_adv) = jax.jit(run)(jrs)
    return dict(rs=jrs, rs2=jrs2, metrics=jm, returns=j_ret,
                advantages=j_adv)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks on every job, compute the references here while
    they run, then collect. Returns (results by rank, references)."""
    tmp = tmp_path_factory.mktemp("mesh_graph")
    jc = j_train_cfg()
    jc.runner.num_steps_per_env = T_STEPS
    jc.algorithm.num_mini_batches = PADDED["go2_moe_cts"]
    jr = JRunner(JEnv(parity_cfg(JCfg), num_steps_per_env=T_STEPS), jc)
    jrs = jr.init_runner_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jobs = [_job(task, kind="host_reads", steps=2)
            for task in SENTINEL_TASKS]
    padded, params0 = _padded_jobs(jr, jrs, rng)
    learn = _learn_job()
    jobs += padded + [learn, _job("go2_moe_cts", kind="graph", steps=2,
                                  iterations=3)]
    job_path = str(tmp / "job.pt")
    torch.save({"jobs": jobs}, job_path)
    procs = spawn_ranks(job_path, str(tmp / "out"))
    try:
        refs = {"params0": params0, "jax": _jax_reference(jr, jrs)}
        for task in PADDED:
            refs[task] = check.run_step(jobs[PADDED_JOB[task]], "cpu")
        refs["learn"] = check.run_learn(learn, "cpu")
    finally:
        outs = _wait(procs)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    results = [torch.load(str(tmp / f"out.rank{r}"), weights_only=True)
               for r in range(WORLD)]
    return results, refs, outs


@pytest.mark.parametrize("task", SENTINEL_TASKS)
def test_train_step_under_a_mesh_reads_nothing_from_the_host(ranks, task):
    results, _, _ = ranks
    for r in range(WORLD):
        hits = results[r][SENTINEL_TASKS.index(task)]["hits"]
        assert hits == [], f"{task} rank {r}: {sorted(set(map(tuple, hits)))}"


@pytest.mark.parametrize("task", tuple(PADDED))
def test_padded_shares_match_one_process(ranks, task):
    results, refs, _ = ranks
    i = PADDED_JOB[task]
    r0, r1, ref = results[0][i], results[1][i], refs[task]
    assert not bool(ref["dones"].any()), "an env reset"
    for k, want in ref["params"].items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        np.testing.assert_allclose(r0["params"][k].numpy(), want.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    moved = max(float((ref["params"][k] - v).abs().max())
                for k, v in refs["params0"][task].items())
    assert moved > 1e-4          # the update moved the weights past atol
    assert float(r0["lr"]) == float(r1["lr"]) == float(ref["lr"])
    assert sorted(r0["metrics"]) == sorted(ref["metrics"])
    for k, want in ref["metrics"].items():
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
        np.testing.assert_allclose(r0["metrics"][k].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_padded_moe_cts_ranks_match_jax(ranks):
    results, refs, _ = ranks
    r0, r1 = (res[JAX_JOB] for res in results)
    j = refs["jax"]
    assert not bool(np.asarray(j["rs2"].env_state.episode_length == 0).any())
    for k in ("returns", "advantages"):
        np.testing.assert_allclose(torch.cat([r0[k], r1[k]], dim=1).numpy(),
                                   np.asarray(j[k]), atol=5e-3, err_msg=k)
    assert sorted(r0["metrics"]) == sorted(j["metrics"])
    for k, v in j["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k].numpy(), np.asarray(v),
                                   rtol=1e-2, atol=1e-6, err_msg=k)
    got = timp.tree_from_named(r0["params"].items())
    want = dict(jax.tree_util.tree_leaves_with_path(jcts.merge_params(
        j["rs2"].train_state.params1, j["rs2"].train_state.params2)))
    before = dict(jax.tree_util.tree_leaves_with_path(jcts.merge_params(
        j["rs"].train_state.params1, j["rs"].train_state.params2)))
    moved = 0.0
    for path, v in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(v, np.asarray(want[path]), atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(np.asarray(want[path])
                                        - np.asarray(before[path])).max()))
    assert moved > 1e-3          # the update moved the weights past atol


def test_learn_under_two_ranks_matches_one_process(ranks):
    results, refs, outs = ranks
    r0, r1 = (res[LEARN_JOB] for res in results)
    ref = refs["learn"]
    assert tuple(r0["mode"]) == ("eager", "gloo cannot be captured")
    assert tuple(ref["mode"]) == ("eager", "on cpu")
    assert any("learn: eager (gloo cannot be captured)" in out
               for _, out in outs)
    assert r1["logged"] == {}                      # rank 0 alone logs
    logged, want = r0["logged"], ref["logged"]
    assert sorted(logged) == sorted(want)
    assert "Loss/latent" in want
    # the episode terms are logged only after a reset
    assert not [t for t in want if t.startswith("Episode/")], "a reset"
    # atol 1e-6: the surrogate is a mean of O(1) terms of both signs (-2e-3
    # at iteration 0), where the ranks' summation order shows at ~3e-7
    for tag, by_step in want.items():
        assert sorted(logged[tag]) == sorted(by_step), tag
        for it, v in by_step.items():
            np.testing.assert_allclose(logged[tag][it], v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{tag} {it}")
    for k, v in ref["params"].items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_compiled_step_equals_eager_on_two_ranks(ranks):
    """The "graph" job chip_smoke.py runs under NCCL, here under gloo: the
    in-place step equals eager train_steps bit for bit on each rank, and
    the ranks' parameters are equal."""
    results, _, _ = ranks
    for r in range(WORLD):
        g = results[r][GRAPH_JOB]
        assert tuple(g["mode"]) == ("eager", "gloo cannot be captured")
        assert not g["graphed"] and g["captures"] == 0
        assert g["local_envs"] == N // WORLD
        for cat, want in g["eager"].items():
            for k, v in want.items():
                assert torch.equal(g["compiled"][cat][k], v), (r, cat, k)
    for k, v in results[0][GRAPH_JOB]["compiled"]["params"].items():
        assert torch.equal(results[1][GRAPH_JOB]["compiled"]["params"][k],
                           v), k
