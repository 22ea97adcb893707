"""PyTorch port: data-parallel training over several ranks
(distributed/mesh.py) on the CPU with gloo.

* Env shards without processes: for go2_moe_cts on the rough parity terrain
  and on the plane, the W = 2 and W = 4 shards' inits concatenated are the
  W = 1 init exactly (terrain levels, types, ids, origins), and so are the
  CTS student masks.
* Two gloo ranks of `go2_rl_gym_tpu_torch.distributed.check`, spawned once
  for the module (one torch thread each, a 60 s process-group timeout, a
  timeout on every wait), while this process computes the references:
  - `train_step` of go2, go2_lstm (from a seeded non-zero memory) and
    go2_moe_cts on the parity config of tests/test_torch_ppo.py (8 envs x
    4 steps), from the same state (the JAX runner's init of go2_moe_cts,
    bridged), warm Adam moments (check.warm_adam says why), act noise and
    permutations: parameters within 1e-5 of one port process and bitwise
    equal across the ranks, metrics within 1e-5 relative (atol 1e-7), the
    returns, advantages and next state within 1e-5 (absolute and
    relative: the physics' contact forces reach 150 N);
  - a go2_moe_cts step of the ranks from the JAX runner's fresh train
    state, gathered, against the JAX runner's jitted train step (its noise
    and permutations replayed): returns and advantages atol 5e-3,
    parameters atol 1e-3, metrics rtol 1e-2 (the tolerances of
    tests/test_torch_train.py);
  - the command curriculum, driven by done envs on both ranks whose global
    mean tracking reward expands the range while rank 1's alone would not:
    `cmd_range_x` equal on both ranks and to one process's, expanded;
  - exact resume at W = 2 (plane, DR, noise and pushes on): save after one
    iteration, a fresh runner loads, one more iteration is bit-identical;
    `load_params` of that checkpoint in one process gives rank 0's
    parameters, and one process refuses to `load` it.
* `scripts.train` under torch.distributed.run, two gloo ranks, one
  iteration; its refusals (W not dividing num_envs, no launcher for
  --num_devices, no card).
"""
import os
import socket
import subprocess
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
from go2_rl_gym_tpu_torch.agents import recurrent_ppo as trppo
from go2_rl_gym_tpu_torch.agents.recurrent import LSTMState
from go2_rl_gym_tpu_torch.distributed import check
from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
from go2_rl_gym_tpu_torch.distributed.mesh import Mesh
from go2_rl_gym_tpu_torch.env.config import Go2Cfg as TCfg
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as TEnv
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.scripts import train as train_script
from go2_rl_gym_tpu_torch.train.runner import RunnerState, _pack
from test_torch_env import N, bridge_env_state, parity_cfg
from test_torch_train import _replayed_noise, _spy_update
from test_torch_update import jax_perms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_STEPS = 4
WORLD = 2
TASKS = ("go2", "go2_lstm", "go2_moe_cts")
CPU = torch.device("cpu")
WAIT_S = 240          # for any spawned process
# the jobs after the three step jobs
CURRICULUM_JOB, JAX_JOB, RESUME_JOB = 3, 4, 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _subprocess_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _wait(procs):
    """Each process's (return code, output), killing all on a timeout."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def spawn_ranks(job_path, out, world=WORLD):
    """`world` gloo ranks of the check worker on the CPU."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "go2_rl_gym_tpu_torch.distributed.check",
         "--job", job_path, "--out", out, "--backend", "gloo",
         "--device", "cpu", "--coordinator", f"localhost:{port}",
         "--world", str(world), "--rank", str(r), "--threads", "1",
         "--timeout", "60"],
        cwd=ROOT, env=_subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


# ---------------------------------------------------------------------------
# env shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plane", [False, True], ids=["rough", "plane"])
def test_env_shards_concatenate_to_the_global_init(plane):
    n = 24           # W = 4 slices of 6 envs: not a multiple of CTS's stride
    cfg = parity_cfg(TCfg, plane)
    cfg.env.num_envs = n
    fields = ("terrain_levels", "terrain_types", "terrain_ids", "env_origins")
    full = TEnv(cfg, device="cpu").init_state(0)
    alg = check.build(dict(task="go2_moe_cts", num_envs=n, steps=T_STEPS,
                           terrain="plane"), "cpu").alg
    student = alg.is_student.clone()
    for world in (2, 4):
        envs = [TEnv(cfg, device="cpu", mesh=Mesh(r, world, CPU, n))
                for r in range(world)]
        parts = [e.init_state(0) for e in envs]
        assert [e.num_envs for e in envs] == [n // world] * world
        for f in fields:
            got = torch.cat([getattr(p, f) for p in parts])
            assert torch.equal(got, getattr(full, f)), (world, f)
        masks = []
        for r in range(world):
            a = check.build(dict(task="go2_moe_cts", num_envs=n,
                                 steps=T_STEPS, terrain="plane"), "cpu").alg
            a.attach_mesh(Mesh(r, world, CPU, n))
            masks.append(a.is_student)
        assert torch.equal(torch.cat(masks), student)
    assert len(set(full.terrain_levels.tolist())) > 1 or plane


def test_attach_mesh_and_shard_a_global_state():
    """OnPolicyRunner.attach_mesh makes the runner a rank's (attaching twice
    slices once), and shard_runner_state cuts a global RunnerState to that
    rank's envs; neither needs a collective."""
    job = dict(task="go2_moe_cts", num_envs=16, steps=T_STEPS,
               terrain="plane")
    one = check.build(job, "cpu")
    rs = one.init_runner_state(0)
    runner = check.build(job, "cpu")
    mesh = Mesh(1, 2, CPU, 16)
    runner.attach_mesh(mesh)
    runner.attach_mesh(mesh)
    part = mesh_lib.shard_runner_state(mesh, rs)
    assert runner.env.num_envs == 8 and runner.mesh is mesh
    assert torch.equal(runner.alg.is_student, one.alg.is_student[8:])
    assert torch.equal(part.obs, rs.obs[8:])
    assert torch.equal(part.env_state.sim.q, rs.env_state.sim.q[8:])
    assert torch.equal(part.env_state.cmd_range_x, rs.env_state.cmd_range_x)
    assert part.gen is rs.gen
    with pytest.raises(ValueError, match="runs on"):
        runner.attach_mesh(Mesh(0, 2, torch.device("meta"), 16))


def test_mesh_refuses_a_world_that_does_not_divide_the_envs():
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(0, 3, CPU, 16)
    env = TEnv(parity_cfg(TCfg, True), device="cpu")
    with pytest.raises(ValueError, match="covers"):
        env.attach_mesh(Mesh(0, 2, CPU, 2 * N))


# ---------------------------------------------------------------------------
# two ranks against one process and against JAX
# ---------------------------------------------------------------------------


def _step_job(task, train_state, state, noise, perms):
    return dict(kind="step", task=task, num_envs=N, steps=T_STEPS,
                terrain="parity", randomness=False, train_state=train_state,
                state=_pack(state), noise=noise, perms=perms)


def _runner_state(jrs, history, memory=()):
    """The JAX runner's initial state as the port's (generators unused: the
    noise and permutations are given)."""
    return RunnerState(
        env_state=bridge_env_state(jrs.env_state), obs=_t(jrs.obs),
        priv_obs=_t(jrs.priv_obs), history=history,
        gen=torch.Generator().manual_seed(0),
        cur_reward_sum=torch.zeros(N), cur_episode_length=torch.zeros(N),
        memory=memory, perm_gen=torch.Generator().manual_seed(1))


def _curriculum_job():
    """A global env state in which envs 0-3 (rank 0) and 4-5 (rank 1) time
    out this step with mean tracking rewards of 1.0 and 0.7 times the
    curriculum's scale: the global mean (0.9) passes its 0.8 threshold,
    rank 1's alone does not."""
    cfg = parity_cfg(TCfg)
    cfg.commands.curriculum = True
    env = TEnv(cfg, device="cpu")
    s = env.init_state(0)
    scale = env.reward_scales["tracking_lin_vel"] * env.max_episode_length
    frac = torch.tensor([1.0] * 4 + [0.7] * 2 + [0.0] * 2)
    ends = frac > 0
    sums = dict(s.episode_sums, tracking_lin_vel=frac * scale)
    s = s._replace(episode_sums=sums, episode_length=torch.where(
        ends, env.max_episode_length, s.episode_length))
    return dict(kind="curriculum", task="go2_moe_cts", num_envs=N,
                terrain="parity", randomness=False, env_state=_pack(s)), s


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Spawn the two ranks on every job, compute the references here while
    they run, then collect. Returns (results by rank, references)."""
    tmp = tmp_path_factory.mktemp("ranks")
    jc = j_train_cfg()
    jc.runner.num_steps_per_env = T_STEPS
    jr = JRunner(JEnv(parity_cfg(JCfg), num_steps_per_env=T_STEPS), jc)
    jrs = jr.init_runner_state(jax.random.PRNGKey(0))
    obs = _t(jrs.obs)
    rng = np.random.default_rng(0)
    jobs, params0 = [], {}
    for task in TASKS:
        if task == "go2_moe_cts":
            noise, k_up = _replayed_noise(jrs.key)
            perms = tuple(torch.as_tensor(p)
                          for p in jax_perms(k_up, jr.alg, T_STEPS))
            runner = check.build(dict(task=task, num_envs=N, steps=T_STEPS,
                                      terrain="parity"), "cpu")
            timp.params_from_jax(jax.tree.map(np.asarray, jcts.merge_params(
                jrs.train_state.params1, jrs.train_state.params2)),
                runner.alg.model)
            state = _runner_state(jrs, _t(jrs.history))
            noise = _t(noise)
        else:
            runner = check.build(dict(task=task, num_envs=N, steps=T_STEPS,
                                      terrain="parity"), "cpu")
            runner.init_runner_state(3)
            memory = ()
            if task == "go2_lstm":
                h = runner.alg.hidden
                memory = trppo.Memory(*[LSTMState(*[
                    torch.as_tensor(0.5 * rng.normal(size=(N, h)),
                                    dtype=torch.float32) for _ in "hc"])
                    for _ in "ac"])
            state = _runner_state(jrs, obs[:, None], memory)
            noise = torch.as_tensor(rng.normal(size=(T_STEPS, N, 12)),
                                    dtype=torch.float32)
            n_perm = N if task == "go2_lstm" else T_STEPS * N
            perms = torch.as_tensor(rng.permutation(n_perm))
        if task == "go2_moe_cts":       # from JAX's fresh train state
            jax_job = _step_job(task, runner.alg.train_state_dict(), state,
                                noise, perms)
        check.warm_adam(runner.alg, seed=TASKS.index(task))
        jobs.append(_step_job(task, runner.alg.train_state_dict(), state,
                              noise, perms))
        params0[task] = {k: p.detach().clone()
                         for k, p in runner.alg.model.named_parameters()}
    cur_job, cur_state = _curriculum_job()
    jobs += [cur_job, jax_job]
    resume_path = str(tmp / "model_1.pt")
    jobs.append(dict(kind="resume", task="go2_moe_cts", num_envs=N,
                     steps=T_STEPS, terrain="plane", seed=0,
                     path=resume_path))
    job_path = str(tmp / "job.pt")
    torch.save({"jobs": jobs}, job_path)
    procs = spawn_ranks(job_path, str(tmp / "out"))

    try:
        # the references, while the ranks run
        captured = {}
        _spy_update(jr.alg, captured)
        step = jr._build_train_step()

        def run(rs):
            out = step(rs)
            _, _, returns, advantages, _ = captured["args"]
            return out, (returns, advantages)
        (jrs2, jm), (j_ret, j_adv) = jax.jit(run)(jrs)
        refs = {"jax": dict(rs=jrs, rs2=jrs2, metrics=jm, returns=j_ret,
                            advantages=j_adv),
                "params0": params0, "resume_path": resume_path}
        for task, job in zip(TASKS, jobs):
            refs[task] = check.run_step(job, "cpu")
        refs["curriculum"] = check.run_curriculum(cur_job, "cpu")
        refs["curriculum_start"] = cur_state.cmd_range_x
    finally:
        outs = _wait(procs)
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    results = [torch.load(str(tmp / f"out.rank{r}"), weights_only=True)
               for r in range(WORLD)]
    return results, refs


@pytest.mark.parametrize("task", TASKS)
def test_two_ranks_match_one_process(two_ranks, task):
    results, refs = two_ranks
    i = TASKS.index(task)
    r0, r1, ref = results[0][i], results[1][i], refs[task]
    assert not bool(ref["dones"].any()), "an env reset"
    assert sorted(r0["params"]) == sorted(ref["params"])
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
    # the next state, gathered in global env order
    for k, want in ref["state"].items():
        if k.endswith("generator_state"):
            continue
        a, b = r0["state"][k], r1["state"][k]
        got = a if a.dim() == 0 or k.endswith(
            ("cmd_range_x", "common_step_counter")) else torch.cat([a, b])
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("returns", "advantages"):
        np.testing.assert_allclose(
            torch.cat([r0[k], r1[k]], dim=1).numpy(), ref[k].numpy(),
            atol=1e-5, err_msg=k)


def test_two_moe_cts_ranks_match_jax(two_ranks):
    results, refs = two_ranks
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
    want = jcts.merge_params(j["rs2"].train_state.params1,
                             j["rs2"].train_state.params2)
    before = dict(jax.tree_util.tree_leaves_with_path(jcts.merge_params(
        j["rs"].train_state.params1, j["rs"].train_state.params2)))
    wl = dict(jax.tree_util.tree_leaves_with_path(want))
    moved = 0.0
    for path, v in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(v, np.asarray(wl[path]), atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(np.asarray(wl[path])
                                        - np.asarray(before[path])).max()))
    assert moved > 1e-3          # the update moved the weights past atol


def test_command_curriculum_is_global(two_ranks):
    results, refs = two_ranks
    r0, r1 = (res[CURRICULUM_JOB] for res in results)
    ref = refs["curriculum"]
    assert int(ref["done"].sum()) == 6
    assert torch.equal(r0["cmd_range_x"], r1["cmd_range_x"])
    assert torch.equal(r0["cmd_range_x"], ref["cmd_range_x"])
    assert not torch.equal(ref["cmd_range_x"], refs["curriculum_start"])


def test_resume_at_two_ranks_is_exact(two_ranks):
    results, _ = two_ranks
    for res in results:
        out = res[RESUME_JOB]
        a, b = out["a"], out["b"]
        assert out["iteration"] == 1
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # the ranks' envs differ, their parameters do not
    a0, a1 = (res[RESUME_JOB]["a"] for res in results)
    assert not torch.equal(a0[".rs.obs"], a1[".rs.obs"])
    for k in a0:
        if k.startswith(".alg.model"):
            assert torch.equal(a0[k], a1[k]), k
    # the updates drew their permutations from perm_gen: it advanced alike
    # on both ranks and as in one process over the same two iterations
    one = check.build(dict(task="go2_moe_cts", num_envs=N, steps=T_STEPS,
                           terrain="plane"), "cpu")
    rs = one.init_runner_state(0, init_at_random_ep_len=True)
    fresh = rs.perm_gen.get_state()
    for _ in range(2):
        rs, _ = one.train_step(rs)
    assert torch.equal(a0[".rs.perm_gen"], a1[".rs.perm_gen"])
    assert torch.equal(a0[".rs.perm_gen"], rs.perm_gen.get_state())
    assert not torch.equal(a0[".rs.perm_gen"], fresh)


def test_two_rank_checkpoint_loads_in_one_process(two_ranks):
    """load_params of the W = 2 checkpoint in one process, at another env
    count, gives rank 0's parameters at the save; the file holds the global
    batch; one process refuses to resume it."""
    results, refs = two_ranks
    saved = results[0][RESUME_JOB]["saved_params"]
    path = refs["resume_path"]
    ck = torch.load(path, weights_only=True)
    assert ck["world"] == WORLD
    assert ck["runner_state"]["obs"].shape[0] == N
    assert ck["rank_generators"]["gen"].shape[0] == WORLD
    job = dict(task="go2_moe_cts", num_envs=16, steps=T_STEPS,
               terrain="plane")
    got = check.build(job, "cpu").load_params(path)
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    one = check.build(dict(job, num_envs=N), "cpu")
    with pytest.raises(ValueError, match="ranks"):
        one.load(one.init_runner_state(0), path)


# ---------------------------------------------------------------------------
# the train script
# ---------------------------------------------------------------------------


def test_train_script_under_torchrun(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    go2_rl_gym_tpu_torch.scripts.train ... --device cpu: two gloo ranks of
    4 envs each train one iteration; rank 0 alone writes the run."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), "-m",
           "go2_rl_gym_tpu_torch.scripts.train", "--task", "go2_moe_cts",
           "--num_envs", str(N), "--device", "cpu", "--terrain", "plane",
           "--max_iterations", "1", "--num_devices", str(WORLD),
           "--log_root", str(tmp_path)]
    [(rc, out)] = _wait([subprocess.Popen(
        cmd, cwd=ROOT, env=_subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)])
    assert rc == 0, out[-4000:]
    assert f"data-parallel over {WORLD} ranks: rank 1 on cpu, envs [4, 8)" \
        in out
    runs = os.listdir(tmp_path / "go2_moe_cts")
    assert len(runs) == 1, runs
    run_dir = tmp_path / "go2_moe_cts" / runs[0]
    assert {"model_0.pt", "model_1.pt"} <= set(os.listdir(run_dir))
    ck = torch.load(run_dir / "model_1.pt", weights_only=True)
    assert ck["world"] == WORLD and ck["iteration"] == 1
    assert ck["runner_state"]["obs"].shape[0] == N


def test_train_script_without_a_launcher_starts_its_ranks(tmp_path):
    """python -m go2_rl_gym_tpu_torch.scripts.train --num_devices 2
    --device cpu with no launcher starts two gloo ranks of itself, which
    give what they give under torch.distributed.run."""
    cmd = [sys.executable, "-m", "go2_rl_gym_tpu_torch.scripts.train",
           "--task", "go2_moe_cts", "--num_envs", str(N), "--device", "cpu",
           "--terrain", "plane", "--max_iterations", "1", "--num_devices",
           str(WORLD), "--log_root", str(tmp_path)]
    env = {k: v for k, v in _subprocess_env().items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    [(rc, out)] = _wait([subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)])
    assert rc == 0, out[-4000:]
    assert f"scripts.train: starting {WORLD} ranks on cpu" in out
    assert f"data-parallel over {WORLD} ranks: rank 1 on cpu, envs [4, 8)" \
        in out
    runs = os.listdir(tmp_path / "go2_moe_cts")
    assert len(runs) == 1, runs
    run_dir = tmp_path / "go2_moe_cts" / runs[0]
    assert {"model_0.pt", "model_1.pt"} <= set(os.listdir(run_dir))
    ck = torch.load(run_dir / "model_1.pt", weights_only=True)
    assert ck["world"] == WORLD and ck["iteration"] == 1
    assert ck["runner_state"]["obs"].shape[0] == N


def test_train_script_refuses_rather_than_degrades(monkeypatch):
    """With no launcher, ranks that do not divide the envs; a
    --num_devices that the launcher did not start, a world that does not
    divide the envs, and a rank without a card each raise before any
    training."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    base = ["--task", "go2_moe_cts", "--num_envs", str(N), "--terrain",
            "plane", "--device", "cpu"]
    with pytest.raises(ValueError, match="3 ranks do not divide"):
        train_script.main(base + ["--num_devices", "3"])
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        train_script.main(base + ["--multihost"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError, match="--num_devices 2"):
        train_script.main(base + ["--num_devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_script.main(base[:-2])
    with pytest.raises(ValueError, match="do not divide"):
        Mesh(rank=0, world=3, device=CPU, num_envs=N)
