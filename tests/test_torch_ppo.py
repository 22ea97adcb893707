"""PyTorch port: PPO (agents/ppo.py, networks.ActorCritic) and the go2 task's
train iteration against the JAX package, on the CPU.

* `ActorCritic` at full width (45 -> (512, 256, 128) -> 12 actor, 263 ->
  (512, 256, 128) -> 1 critic) from the JAX init carried across by
  importer.params_from_jax: mu, std and value atol 1e-5; `PPO.act` with
  JAX's normal draw injected, the same.
* `PPO.update` against JAX's jitted update at full width, from warm Adam
  moments (as tests/test_torch_update.py, whose docstring says why) on a
  batch whose old policy is the current one shifted by half a std (every
  minibatch then divides the LR by 1.5, far from a threshold), with JAX's
  permutation of the T * N t-major samples injected: params, Adam moments
  and metrics atol 1e-5 after one minibatch and 1e-4 after 5 x 4, the
  learning rates equal.
* One full go2 `train_step` against the JAX runner's jitted step on the
  parity config of tests/test_torch_env.py (8 envs x 4 steps), fresh Adam
  state, act noise and permutation replayed from the JAX runner's key
  sequence: returns / advantages atol 5e-3, metrics rtol 1e-2, params atol
  1e-3 (as tests/test_torch_train.py).
* Exact resume and `load_params` across env counts for go2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.agents import common as jcommon
from go2_rl_gym_tpu.agents import ppo as jppo
from go2_rl_gym_tpu.env import config as jconfig
from go2_rl_gym_tpu.env.go2_env import Go2Env as JEnv
from go2_rl_gym_tpu.train.runner import OnPolicyRunner as JRunner
from go2_rl_gym_tpu_torch.agents import common as tcommon
from go2_rl_gym_tpu_torch.agents import ppo as tppo
from go2_rl_gym_tpu_torch.env import config as tconfig
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as TEnv
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.tools import card_check
from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner as TRunner
from go2_rl_gym_tpu_torch.train.runner import RunnerState
from test_torch_env import N, bridge_env_state, parity_cfg

NUM_OBS, NUM_PRIV, NUM_ACT = 45, 263, 12
T_STEPS = 4


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


def _close(got, want, atol, err_msg=""):
    if isinstance(got, torch.Tensor):   # an expanded parameter keeps its grad
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=err_msg)


def assert_trees_close(got, want, atol, tag):
    """Two {"params": ...} trees (or optax moment trees) leaf by leaf."""
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(gl) == len(wl), tag
    for path, v in gl:
        _close(v, wl[path], atol,
               err_msg=f"{tag} {jax.tree_util.keystr(path)}")


def adam_of(opt_state):
    """The ScaleByAdamState inside optax's inject_hyperparams(chain(clip,
    adam)) state."""
    return opt_state.inner_state[1][0]


def warm_adam(ts, talg, seed):
    """`ts` (a JAX PPOTrainState) with its Adam state as after 10 steps
    (seeded first moments, second moments with sqrt(v_hat) in [1e-4,
    1e-3]); the same state set on `talg` (PPO or RecurrentPPO)."""
    rng = np.random.default_rng(seed)
    bc = np.float32(1 - 0.999 ** 10)
    adam = adam_of(ts.opt_state)
    mu = jax.tree.map(lambda x: jnp.asarray(
        1e-4 * rng.normal(size=x.shape), jnp.float32), adam.mu)
    nu = jax.tree.map(lambda x: jnp.asarray(
        bc * rng.uniform(1e-4, 1e-3, size=x.shape) ** 2, jnp.float32), adam.nu)
    adam = adam._replace(count=jnp.asarray(10, jnp.int32), mu=mu, nu=nu)
    inner = ts.opt_state.inner_state
    ts = ts._replace(opt_state=ts.opt_state._replace(
        inner_state=(inner[0], (adam,) + tuple(inner[1][1:]))))
    names = [n for n, _ in talg.model.named_parameters()]
    talg.opt = tcommon.AdamState(torch.tensor(10, dtype=torch.int32),
                                 timp.tensors_from_tree(names, adam.mu),
                                 timp.tensors_from_tree(names, adam.nu))
    return ts


def assert_update_matches(talg, ts2, jm, tm, epochs, nmb, atol):
    """The port's algorithm after its update against JAX's train state
    `ts2` and metrics `jm`: metrics, the LR sequence (every minibatch
    divides it by 1.5, down to its floor), params and Adam moments."""
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k].detach(), jm[k], atol, err_msg=k)
    lr = np.float32(1e-3)
    for _ in range(epochs * nmb):
        lr = max(np.float32(1e-5), np.float32(lr / np.float32(1.5)))
    assert float(talg.lr) == float(ts2.lr) == float(jm["learning_rate"]) \
        == float(lr)
    names = [n for n, _ in talg.model.named_parameters()]
    adam = adam_of(ts2.opt_state)
    assert int(talg.opt.count) == int(adam.count) == 10 + epochs * nmb
    assert_trees_close(timp.tree_from_named(talg.model.named_parameters()),
                       ts2.params, atol, "params")
    assert_trees_close(timp.tree_from_named(zip(names, talg.opt.mu)),
                       adam.mu, atol, "mu")
    assert_trees_close(timp.tree_from_named(zip(names, talg.opt.nu)),
                       adam.nu, atol, "nu")


# ---------------------------------------------------------------------------
# ActorCritic and PPO.act
# ---------------------------------------------------------------------------


def _algs(epochs=5, nmb=4):
    kw = dict(num_learning_epochs=epochs, num_mini_batches=nmb)
    jc, tc = jconfig.go2_ppo_train_cfg(), tconfig.go2_ppo_train_cfg()
    jalg = jppo.PPO(NUM_OBS, NUM_PRIV, NUM_ACT, jc.policy,
                    jconfig.AlgorithmCfg(**kw))
    talg = tppo.PPO(NUM_OBS, NUM_PRIV, NUM_ACT, tc.policy,
                    tconfig.AlgorithmCfg(**kw), "cpu")
    return jalg, talg


@pytest.fixture(scope="module")
def jax_init():
    jalg, _ = _algs()
    return jax.jit(jalg.init)(jax.random.PRNGKey(0))


def _loaded(jax_init, epochs=5, nmb=4):
    jalg, talg = _algs(epochs, nmb)
    timp.params_from_jax(jax.tree.map(np.asarray, jax_init.params),
                         talg.model)
    return jalg, talg


def test_actor_critic_matches_jax(jax_init):
    jalg, talg = _loaded(jax_init)
    params = jax_init.params
    assert sum(np.asarray(x).size for x in jax.tree.leaves(params)) == \
        sum(p.numel() for p in talg.model.parameters())
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, NUM_OBS)).astype(np.float32)
    priv = rng.normal(size=(64, NUM_PRIV)).astype(np.float32)
    jmu, jstd = jalg.model.apply(params, obs, method="actor_dist")
    jv = jalg.model.apply(params, priv, method="value")
    with torch.no_grad():
        mu, std = talg.model.actor_dist(_t(obs))
        v = talg.model.value(_t(priv))
    _close(mu, jmu, 1e-5, "mu")
    _close(std, jstd, 1e-5, "std")
    _close(v, jv, 1e-5, "value")

    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (64, NUM_ACT)))
    j_out = jalg.act(params, key, obs, priv)
    t_out = talg.act(_t(obs), _t(priv), noise=_t(noise))
    for name, j, t in zip(("actions", "values", "logp", "mu", "std"), j_out,
                          t_out):
        assert not t.requires_grad, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-6, err_msg=name)
    _close(talg.value(_t(priv)), jalg.value(params, priv), 1e-5)


def test_actor_critic_init():
    """init_params fills std with init_noise_std (the parameter is made
    uninitialised) and the Linears torch's way."""
    from go2_rl_gym_tpu_torch.agents.networks import ActorCritic, init_params
    m = ActorCritic(NUM_OBS, NUM_PRIV, NUM_ACT, init_noise_std=0.7,
                    device="cpu")
    init_params(m, torch.Generator().manual_seed(0))
    assert torch.equal(m.std.detach(), torch.full((NUM_ACT,), 0.7))
    w = m.actor.fc0.weight.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(NUM_OBS)
    m2 = ActorCritic(NUM_OBS, NUM_PRIV, NUM_ACT, init_noise_std=0.7,
                     device="cpu")
    init_params(m2, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))


# ---------------------------------------------------------------------------
# PPO.update
# ---------------------------------------------------------------------------


def update_batch(talg, N_, T, seed):
    """A seeded batch whose old policy is `talg`'s current one shifted by
    half a std, with its GAE from JAX. Returns (fields, returns,
    advantages) as numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    obs = rng.normal(size=(T, N_, NUM_OBS)).astype(f)
    priv = rng.normal(size=(T, N_, NUM_PRIV)).astype(f)
    with torch.no_grad():
        mu, std = (x.numpy() for x in talg.model.actor_dist(_t(obs)))
    old_mu = (mu + 0.5 * std).astype(f)
    actions = (old_mu + std * rng.normal(size=mu.shape)).astype(f)
    logp = np.asarray(jcommon.gaussian_log_prob(old_mu, std, actions))
    rewards = rng.normal(size=(T, N_)).astype(f)
    values = rng.normal(size=(T, N_)).astype(f)
    dones = rng.random((T, N_)) < 0.1
    fields = dict(obs=obs, critic_obs=priv, actions=actions, rewards=rewards,
                  dones=dones, values=values, log_probs=logp, mu=old_mu,
                  sigma=np.ascontiguousarray(std))
    ret, adv = jcommon.compute_gae(
        *map(jnp.asarray, (rewards, values, dones,
                           rng.normal(size=N_).astype(f))), 0.99, 0.95)
    return fields, np.asarray(ret), np.asarray(adv)


@pytest.mark.parametrize("epochs,nmb,atol", [(1, 1, 1e-5), (5, 4, 1e-4)],
                         ids=["one_minibatch", "full_5x4"])
def test_ppo_update_matches_jax(jax_init, epochs, nmb, atol):
    N_, T = 8, 4
    jalg, talg = _loaded(jax_init, epochs, nmb)
    fields, ret, adv = update_batch(talg, N_, T, seed=7)
    ts = warm_adam(jax_init, talg, seed=8)
    key = jax.random.PRNGKey(5)
    ts2, jm = jax.jit(jalg.update)(ts, jppo.Transition(**fields), ret, adv,
                                   key)
    perm = np.asarray(jax.random.permutation(key, T * N_))
    tm = talg.update(tppo.Transition(**{k: _t(v) for k, v in fields.items()}),
                     _t(ret), _t(adv), perms=perm)
    assert_update_matches(talg, ts2, jm, tm, epochs, nmb, atol)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(ts2.params),
                                jax.tree.leaves(jax_init.params)))
    assert moved > 10 * atol


def test_ppo_update_needs_an_explicit_shuffle(jax_init):
    _, talg = _loaded(jax_init)
    fields, ret, adv = update_batch(talg, 8, 4, seed=1)
    batch = tppo.Transition(**{k: _t(v) for k, v in fields.items()})
    with pytest.raises(ValueError, match="gen or perms"):
        talg.update(batch, _t(ret), _t(adv))
    with pytest.raises(ValueError, match="gen or noise"):
        talg.act(batch.obs[0], batch.critic_obs[0])
    m = talg.update(batch, _t(ret), _t(adv),
                    gen=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_ppo_update_check_agrees_with_itself_on_the_cpu():
    """tools/card_check.ppo_update_card_vs_cpu with the CPU on both sides:
    bit-identical."""
    worst = card_check.ppo_update_card_vs_cpu(device="cpu", num_envs=16)
    assert worst == dict.fromkeys(("params", "opt.mu", "opt.nu", "metrics"),
                                  0.0)


# ---------------------------------------------------------------------------
# the go2 train iteration, resume, load_params
# ---------------------------------------------------------------------------


def spy_update(alg, captured):
    """Wrap `alg.update` so that each call records its inputs."""
    update = alg.update

    def spy(*args, **kwargs):
        captured["args"] = args
        return update(*args, **kwargs)
    alg.update = spy


def replayed_noise(key, steps=T_STEPS):
    """The act noise of each rollout step and the update's key, from the
    JAX runner's key sequence (runner.py:194, 266)."""
    noise = []
    for _ in range(steps):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, (N, NUM_ACT))))
    _, k_up = jax.random.split(key)
    return np.stack(noise), k_up


def jax_iteration(train_cfg):
    """The JAX runner on the parity config, its initial state, and one
    jitted train step that also returns the returns, advantages and key
    its update received."""
    train_cfg.runner.num_steps_per_env = T_STEPS
    jr = JRunner(JEnv(parity_cfg(jconfig.Go2Cfg), num_steps_per_env=T_STEPS),
                 train_cfg)
    rs = jr.init_runner_state(jax.random.PRNGKey(0))
    captured = {}
    spy_update(jr.alg, captured)
    step = jr._build_train_step()

    def run(rs):
        out = step(rs)
        _, _, returns, advantages, key = captured["args"][:5]
        return out, (returns, advantages, key)
    (rs2, metrics), extra = jax.jit(run)(rs)
    return jr, rs, rs2, metrics, extra


def port_runner_from(train_cfg, rs, memory=()):
    """The port's runner on the parity config with the JAX runner's initial
    weights (fresh Adam state) and RunnerState `rs` bridged across."""
    train_cfg.runner.num_steps_per_env = T_STEPS
    tr = TRunner(TEnv(parity_cfg(tconfig.Go2Cfg), num_steps_per_env=T_STEPS,
                      device="cpu"), train_cfg, device="cpu")
    timp.params_from_jax(jax.tree.map(np.asarray, rs.train_state.params),
                         tr.alg.model)
    tr.alg.reset_train_state()
    trs = RunnerState(
        env_state=bridge_env_state(rs.env_state),
        obs=_t(rs.obs), priv_obs=_t(rs.priv_obs), history=_t(rs.history),
        gen=torch.Generator().manual_seed(0), cur_reward_sum=torch.zeros(N),
        cur_episode_length=torch.zeros(N), memory=memory)
    return tr, trs


def assert_train_step_matches(jit_out, tr, trs, perm):
    """Run the port's train_step with the JAX run's noise and permutation;
    hold its GAE, metrics, params and next obs against the JAX step's."""
    jr, rs, rs2, jm, (j_ret, j_adv, j_key) = jit_out
    noise, k_up = replayed_noise(rs.key)
    np.testing.assert_array_equal(np.asarray(k_up), np.asarray(j_key))
    captured = {}
    spy_update(tr.alg, captured)
    trs2, tm = tr.train_step(trs, noise=_t(noise), perms=perm(k_up))
    _, t_ret, t_adv = captured["args"][:3]
    assert not bool(np.asarray(rs2.env_state.episode_length == 0).any()), \
        "an env reset"
    _close(t_ret, j_ret, 5e-3, "returns")
    _close(t_adv, j_adv, 5e-3, "advantages")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-2, atol=1e-6, err_msg=k)
    assert_trees_close(timp.tree_from_named(tr.alg.model.named_parameters()),
                       rs2.train_state.params, 1e-3, "params")
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(rs2.train_state.params),
                                jax.tree.leaves(rs.train_state.params)))
    assert moved > 1e-3          # the update moved the weights past atol
    _close(trs2.obs, rs2.obs, 5e-3, "obs")
    return trs2


def test_go2_train_step_matches_jax():
    out = jax_iteration(jconfig.go2_ppo_train_cfg())
    jr, rs = out[:2]
    assert not jr.is_cts and not jr.is_recurrent
    assert rs.history.shape == (N, 1, NUM_OBS)
    tr, trs = port_runner_from(tconfig.go2_ppo_train_cfg(), rs)
    assert tr.history_length == 1 and not tr.is_cts
    assert_train_step_matches(
        out, tr, trs,
        lambda k: np.asarray(jax.random.permutation(k, T_STEPS * N)))


def plane_runner(task, num_envs=8):
    """A runner of `task` on the plane (DR, noise, pushes on), 4 steps per
    iteration."""
    from go2_rl_gym_tpu_torch.utils import registry
    cfg, tc = registry.get_cfgs(task)
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    tc.runner.num_steps_per_env = T_STEPS
    tc.runner.save_interval = 2
    env = registry.make_env(task, cfg, num_envs=num_envs,
                            num_steps_per_env=T_STEPS, device="cpu")
    return registry.make_runner(task, env, tc, device="cpu")


def snapshot(runner, rs):
    """Every tensor of the train state and the runner state, and the
    generators' states, as one flat dict."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Generator):
            out[prefix] = x.get_state()
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = x.clone()
    walk("alg", runner.alg.train_state_dict())
    walk("rs", rs)
    return out


def assert_resume_is_exact(task, tmp_path):
    a = plane_runner(task)
    rs = a.init_runner_state(0, init_at_random_ep_len=True)
    rs, _ = a.train_step(rs)
    a.current_iteration = 1
    path = str(tmp_path / "model_1.pt")
    a.save(rs, path)
    rs_a, m_a = a.train_step(rs)

    b = plane_runner(task)
    rs_b = b.load(b.init_runner_state(5), path)
    assert b.current_iteration == 1
    rs_b, m_b = b.train_step(rs_b)
    sa, sb = snapshot(a, rs_a), snapshot(b, rs_b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    return rs_a


def assert_load_params_across_env_counts(task, tmp_path):
    r16 = plane_runner(task, 16)
    rs = r16.init_runner_state(0)
    path = str(tmp_path / "model_0.pt")
    r16.save(rs, path)
    want = r16.get_inference_params()
    r8 = plane_runner(task, 8)
    rs8 = r8.init_runner_state(3)
    got = r8.load_params(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="load_params"):
        r8.load(rs8, path)


def test_go2_resume_is_exact(tmp_path):
    rs = assert_resume_is_exact("go2", tmp_path)
    assert rs.memory == () and rs.history.shape == (8, 1, NUM_OBS)


def test_go2_load_params_across_env_counts(tmp_path):
    assert_load_params_across_env_counts("go2", tmp_path)


def test_go2_learn_logs_the_ppo_tags(tmp_path):
    """With episodes ending, learn logs Train/mean_reward and
    Train/mean_episode_length for PPO (JAX runner.py:506-509), and no
    teacher / student tags."""
    import json
    from go2_rl_gym_tpu_torch.utils import registry
    cfg, tc = registry.get_cfgs("go2")
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    tc.runner.num_steps_per_env = T_STEPS
    env = registry.make_env("go2", cfg, num_envs=8, num_steps_per_env=T_STEPS,
                            device="cpu")
    runner = TRunner(env, tc, log_dir=str(tmp_path), device="cpu")
    rs = runner.init_runner_state(0)
    rs = rs._replace(env_state=rs.env_state._replace(
        episode_length=torch.full((8,), env.max_episode_length - 1,
                                  dtype=torch.int32)))
    runner.learn(rs, 1, log_every=1)
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"]: r["value"] for r in rows}
    # every env times out in the rollout's second step
    assert tags["Train/mean_episode_length"] == 2.0
    assert np.isfinite(tags["Train/mean_reward"])
    assert not any("teacher" in t or "student" in t for t in tags)
