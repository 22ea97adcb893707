"""PyTorch port: recurrent PPO (agents/recurrent.py, agents/recurrent_ppo.py)
and the go2_lstm task's train iteration against the JAX package, on the CPU.

* The LSTM and GRU cells against flax's OptimizedLSTMCell / GRUCell, with
  flax's parameters carried across by importer.params_from_jax (the gate
  names map one to one): one step and 7 chained steps, atol 1e-5.
* `ActorCriticRecurrent` at the go2_lstm widths (hidden 256, MLPs (256,
  256, 128)), LSTM and GRU: mu, std, value and both memories over 3 steps,
  atol 1e-5.
* `split_and_pad_trajectories` / `unpad_trajectories`: exactly JAX's.
* The replay invariant of tests/test_recurrent.py:64-96 on the port: the
  update's sequence replay regenerates the rollout's mu and values.
* `RecurrentPPO.update` against JAX's jitted update for both cell types,
  from warm Adam moments, a seeded non-zero rollout-start memory and JAX's
  env permutation: atol 1e-4 after one minibatch and after 5 x 4, the
  learning rates equal. (One minibatch is not held at 1e-5 as PPO's is:
  JAX's jitted entropy of the replayed std = 1 comes out 6e-5 above
  12 * (0.5 + 0.5 log 2 pi), which the port computes to the ulp.)
* Init statistics: std = init_noise_std, hidden kernels orthogonal, input
  kernels truncated normal at variance 1/fan_in, biases zero.
* One full go2_lstm `train_step` against the JAX runner's jitted step on
  the parity config (tolerances of tests/test_torch_ppo.py), exact resume
  with the memory, `load_params` across env counts.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.agents import common as jcommon
from go2_rl_gym_tpu.agents import recurrent as jrec
from go2_rl_gym_tpu.agents import recurrent_ppo as jrppo
from go2_rl_gym_tpu.agents.ppo import Transition as JTransition
from go2_rl_gym_tpu.env import config as jconfig
from go2_rl_gym_tpu_torch.agents import recurrent as trec
from go2_rl_gym_tpu_torch.agents import recurrent_ppo as trppo
from go2_rl_gym_tpu_torch.agents.networks import init_params
from go2_rl_gym_tpu_torch.agents.ppo import Transition as TTransition
from go2_rl_gym_tpu_torch.env import config as tconfig
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.tools import card_check
from test_torch_env import N
from test_torch_ppo import (assert_load_params_across_env_counts,
                            assert_resume_is_exact, assert_train_step_matches,
                            assert_update_matches, jax_iteration,
                            port_runner_from, warm_adam)

NUM_OBS, NUM_PRIV, NUM_ACT, H = 45, 263, 12, 256
RNN = ["lstm", "gru"]


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
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=err_msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the cells and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rnn_type", RNN)
def test_cell_matches_flax(rnn_type):
    B, D, Hs = 6, 19, 32
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(7, B, D)).astype(np.float32)
    h0, c0 = (0.5 * rng.normal(size=(2, B, Hs))).astype(np.float32)
    if rnn_type == "lstm":
        fcell, tcell = fnn.OptimizedLSTMCell(Hs), trec.LSTMCell(D, Hs, "cpu")
        carry = (jnp.asarray(c0), jnp.asarray(h0))
    else:
        fcell, tcell = fnn.GRUCell(Hs), trec.GRUCell(D, Hs, "cpu")
        carry = jnp.asarray(h0)
    params = fcell.init(jax.random.PRNGKey(1), carry, xs[0])
    # flax initialises the biases to zero: give them values, so that where
    # each bias enters (GRU's hn inside the reset gate's product) counts
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.normal(size=x.shape), jnp.float32)
                         if path[-1].key == "bias" else x), params)
    # the gate names are flax's: ii/if/ig/io without bias, hi/hf/hg/ho with
    # (LSTM); ir/iz/in with bias, hr/hz without, hn with (GRU)
    want_names = sorted("/".join(p) for p in _flat_paths(params["params"]))
    got_names = sorted(n.replace(".weight", "/kernel").replace(".", "/")
                       for n, _ in tcell.named_parameters())
    assert got_names == want_names
    timp.params_from_jax(_np(params), tcell)
    state = trec.LSTMState(h=_t(h0), c=_t(c0))
    apply = jax.jit(fcell.apply)
    with torch.no_grad():
        for t in range(7):
            carry, out = apply(params, carry, xs[t])
            state = tcell(_t(xs[t]), state)
            jh = out
            _close(state.h, jh, 1e-5, f"h after {t + 1} steps")
            if rnn_type == "lstm":
                _close(state.c, carry[0], 1e-5, f"c after {t + 1} steps")
            else:
                _close(state.c, c0, 0.0, "GRU carries c unchanged")
    assert float(np.abs(np.asarray(jh) - h0).max()) > 0.1


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _pc(rnn_type):
    pc = tconfig.go2_lstm_train_cfg().policy
    pc.rnn_type = rnn_type
    jpc = jconfig.go2_lstm_train_cfg().policy
    jpc.rnn_type = rnn_type
    return jpc, pc


@pytest.mark.parametrize("rnn_type", RNN)
def test_actor_critic_recurrent_matches_jax(rnn_type):
    B = 16
    jpc, pc = _pc(rnn_type)
    jm = jrec.ActorCriticRecurrent(
        num_actions=NUM_ACT, actor_hidden_dims=jpc.actor_hidden_dims,
        critic_hidden_dims=jpc.critic_hidden_dims, rnn_hidden_size=H,
        rnn_type=rnn_type)
    z = jrec.Memory.zero_state(1, H)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, NUM_OBS)),
                     jnp.zeros((1, NUM_PRIV)), z, z)
    tm = trec.ActorCriticRecurrent(
        NUM_OBS, NUM_PRIV, NUM_ACT, pc.actor_hidden_dims,
        pc.critic_hidden_dims, H, rnn_type, device="cpu")
    timp.params_from_jax(_np(params), tm)
    assert sum(x.size for x in jax.tree.leaves(_np(params))) == \
        sum(p.numel() for p in tm.parameters())
    rng = np.random.default_rng(3)
    ja = jc = jrec.Memory.zero_state(B, H)
    ta = tc = trec.Memory.zero_state(B, H)
    fwd = jax.jit(jm.apply)
    for t in range(3):
        obs = rng.normal(size=(B, NUM_OBS)).astype(np.float32)
        priv = rng.normal(size=(B, NUM_PRIV)).astype(np.float32)
        jmu, jstd, jv, ja, jc = fwd(params, obs, priv, ja, jc)
        with torch.no_grad():
            mu, std, ta = tm.actor_dist(_t(obs), ta)
            v, tc = tm.value(_t(priv), tc)
        for name, g, w in (("mu", mu, jmu), ("std", std, jstd), ("v", v, jv),
                           ("a.h", ta.h, ja.h), ("a.c", ta.c, ja.c),
                           ("c.h", tc.h, jc.h), ("c.c", tc.c, jc.c)):
            _close(g, w, 1e-5, f"{name} at step {t}")
    dones = torch.tensor([True, False] * (B // 2))
    r = trec.ActorCriticRecurrent.reset_state(ta, dones)
    assert not r.h[dones].any() and not r.c[dones].any()
    assert torch.equal(r.h[~dones], ta.h[~dones])


@pytest.mark.parametrize("rnn_type", RNN)
def test_recurrent_init_statistics(rnn_type):
    _, pc = _pc(rnn_type)
    pc.init_noise_std = 0.8
    m = trec.ActorCriticRecurrent(
        NUM_OBS, NUM_PRIV, NUM_ACT, pc.actor_hidden_dims,
        pc.critic_hidden_dims, H, rnn_type, init_noise_std=0.8,
        device="cpu")
    init_params(m, torch.Generator().manual_seed(0))
    assert torch.equal(m.std.detach(), torch.full((NUM_ACT,), 0.8))
    eye = torch.eye(H)
    n_in = n_h = 0
    with torch.no_grad():
        for mem, fan_in in ((m.memory_a, NUM_OBS), (m.memory_c, NUM_PRIV)):
            for name, lin in mem.cell.named_children():
                w = lin.weight
                if name[0] == "h":      # orthogonal
                    torch.testing.assert_close(w @ w.T, eye, atol=1e-5,
                                               rtol=0)
                    n_h += 1
                else:                   # lecun_normal: variance 1/fan_in
                    assert w.shape[1] == fan_in
                    var = float(w.var())
                    assert abs(var * fan_in - 1.0) < 0.1, (name, var)
                    bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
                    assert float(w.abs().max()) <= bound * (1 + 1e-6)
                    n_in += 1
                if lin.bias is not None:
                    assert not lin.bias.any()
        # the MLPs keep the torch-Linear init
        assert float(m.actor.fc0.weight.abs().max()) <= 1 / np.sqrt(H)
    gates = 4 if rnn_type == "lstm" else 3
    assert n_in == n_h == 2 * gates
    # the same seed gives the same weights
    m2 = trec.ActorCriticRecurrent(
        NUM_OBS, NUM_PRIV, NUM_ACT, pc.actor_hidden_dims,
        pc.critic_hidden_dims, H, rnn_type, init_noise_std=0.8,
        device="cpu")
    init_params(m2, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))


def test_split_and_pad_matches_jax():
    T, N_ = 6, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, N_, 3)).astype(np.float32)
    dones = np.zeros((T, N_), bool)
    dones[2, 0] = dones[4, 0] = dones[5, 1] = dones[0, 3] = True
    jp, jmask = jrec.split_and_pad_trajectories(jnp.asarray(x),
                                                jnp.asarray(dones))
    tp, tmask = trec.split_and_pad_trajectories(_t(x), _t(dones))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert int(tmask.sum()) == T * N_
    back = trec.unpad_trajectories(tp, _t(dones))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jrec.unpad_trajectories(jp,
                                                         jnp.asarray(dones))))


@pytest.mark.parametrize("rnn_type", RNN)
def test_replay_reproduces_rollout(rnn_type):
    """The update's sequence replay regenerates the rollout's mu / std /
    values at unchanged params (tests/test_recurrent.py:64-96)."""
    T, N_, num_obs, num_priv = 7, 5, 9, 11
    pc = tconfig.PolicyCfg(actor_hidden_dims=(32,), critic_hidden_dims=(32,),
                           rnn_hidden_size=16, rnn_type=rnn_type)
    alg = trppo.RecurrentPPO(num_obs, num_priv, 3, pc, tconfig.AlgorithmCfg(),
                             "cpu")
    init_params(alg.model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    obs = torch.randn((T, N_, num_obs), generator=g)
    priv = torch.randn((T, N_, num_priv), generator=g)
    dones = torch.rand((T, N_), generator=g) < 0.2
    mem0 = mem = alg.zero_memory(N_)
    mus, stds, vals = [], [], []
    for t in range(T):
        _, v, _, mu, std, mem = alg.act(obs[t], priv[t], mem, gen=g)
        mus.append(mu)
        stds.append(std)
        vals.append(v)
        mem = alg.reset_memory(mem, dones[t])
    assert dones.any()
    with torch.no_grad():
        mu_r, std_r, v_r = alg._replay(obs, priv, dones.float(), mem0)
    torch.testing.assert_close(mu_r, torch.stack(mus), atol=1e-5, rtol=0)
    torch.testing.assert_close(std_r, torch.stack(stds), atol=0, rtol=0)
    torch.testing.assert_close(v_r, torch.stack(vals), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# RecurrentPPO.update
# ---------------------------------------------------------------------------


def _algs(rnn_type, epochs, nmb):
    kw = dict(num_learning_epochs=epochs, num_mini_batches=nmb)
    jpc, pc = _pc(rnn_type)
    jalg = jrppo.RecurrentPPO(NUM_OBS, NUM_PRIV, NUM_ACT, jpc,
                              jconfig.AlgorithmCfg(**kw))
    talg = trppo.RecurrentPPO(NUM_OBS, NUM_PRIV, NUM_ACT, pc,
                              tconfig.AlgorithmCfg(**kw), "cpu")
    return jalg, talg


def _update_inputs(talg, N_, T, seed):
    """A seeded batch (old policy = the current one replayed from a seeded
    non-zero memory, shifted by half a std) with JAX's GAE, and that
    memory in both packages' types."""
    rng = np.random.default_rng(seed)
    f = np.float32
    obs = rng.normal(size=(T, N_, NUM_OBS)).astype(f)
    priv = rng.normal(size=(T, N_, NUM_PRIV)).astype(f)
    dones = rng.random((T, N_)) < 0.2
    hc = (0.5 * rng.normal(size=(4, N_, H))).astype(f)
    jmem = jrppo.Memory(a=jrec.LSTMState(h=hc[0], c=hc[1]),
                        c=jrec.LSTMState(h=hc[2], c=hc[3]))
    tmem = trppo.Memory(*[trec.LSTMState(*[_t(x) for x in s]) for s in jmem])
    with torch.no_grad():
        mu, std, _ = (x.numpy() for x in talg._replay(_t(obs), _t(priv),
                                                       _t(dones), tmem))
    old_mu = (mu + 0.5 * std).astype(f)
    actions = (old_mu + std * rng.normal(size=mu.shape)).astype(f)
    logp = np.asarray(jcommon.gaussian_log_prob(old_mu, std, actions))
    rewards = rng.normal(size=(T, N_)).astype(f)
    values = rng.normal(size=(T, N_)).astype(f)
    fields = dict(obs=obs, critic_obs=priv, actions=actions, rewards=rewards,
                  dones=dones, values=values, log_probs=logp, mu=old_mu,
                  sigma=std)
    ret, adv = jcommon.compute_gae(
        *map(jnp.asarray, (rewards, values, dones,
                           rng.normal(size=N_).astype(f))), 0.99, 0.95)
    return fields, np.asarray(ret), np.asarray(adv), jmem, tmem


@pytest.fixture(scope="module", params=RNN)
def rnn_init(request):
    jalg, _ = _algs(request.param, 1, 1)
    return request.param, jax.jit(jalg.init)(jax.random.PRNGKey(0))


@pytest.mark.parametrize("epochs,nmb", [(1, 1), (5, 4)],
                         ids=["one_minibatch", "full_5x4"])
def test_recurrent_update_matches_jax(rnn_init, epochs, nmb):
    rnn_type, ts = rnn_init
    atol = 1e-4
    N_, T = 8, 4
    jalg, talg = _algs(rnn_type, epochs, nmb)
    timp.params_from_jax(_np(ts.params), talg.model)
    fields, ret, adv, jmem, tmem = _update_inputs(talg, N_, T, seed=7)
    ts = warm_adam(ts, talg, seed=8)
    key = jax.random.PRNGKey(5)
    ts2, jm = jax.jit(jalg.update)(ts, JTransition(**fields), ret, adv, key,
                                   jmem)
    perm = np.asarray(jax.random.permutation(key, N_))
    tm = talg.update(TTransition(**{k: _t(v) for k, v in fields.items()}),
                     _t(ret), _t(adv), tmem, perms=perm)
    assert_update_matches(talg, ts2, jm, tm, epochs, nmb, atol)
    moved = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()),
                         ts2.params, _np(ts.params))
    # the memory cells' input and hidden kernels all learned
    assert min(jax.tree.leaves(moved["params"]["memory_a"])) > 10 * atol


@pytest.mark.parametrize("rnn_type", RNN)
def test_recurrent_update_check_agrees_with_itself_on_the_cpu(rnn_type):
    worst = card_check.recurrent_update_card_vs_cpu(
        device="cpu", num_envs=16, rnn_type=rnn_type)
    assert worst == dict.fromkeys(("params", "opt.mu", "opt.nu", "metrics"),
                                  0.0)


def test_recurrent_update_needs_an_explicit_shuffle():
    _, talg = _algs("lstm", 1, 1)
    init_params(talg.model, torch.Generator().manual_seed(0))
    fields, ret, adv, _, tmem = _update_inputs(talg, 4, 3, seed=1)
    batch = TTransition(**{k: _t(v) for k, v in fields.items()})
    with pytest.raises(ValueError, match="gen or perms"):
        talg.update(batch, _t(ret), _t(adv), tmem)
    m = talg.update(batch, _t(ret), _t(adv), tmem,
                    gen=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in m.values())


# ---------------------------------------------------------------------------
# the go2_lstm train iteration, resume, load_params
# ---------------------------------------------------------------------------


def test_go2_lstm_train_step_matches_jax():
    out = jax_iteration(jconfig.go2_lstm_train_cfg())
    jr, rs = out[:2]
    assert jr.is_recurrent
    mem = trppo.Memory(*[trec.LSTMState(*[_t(x) for x in s])
                         for s in rs.memory])
    tr, trs = port_runner_from(tconfig.go2_lstm_train_cfg(), rs, mem)
    assert tr.is_recurrent and tr.history_length == 1
    trs2 = assert_train_step_matches(
        out, tr, trs, lambda k: np.asarray(jax.random.permutation(k, N)))
    rs2 = out[2]
    for g, w, name in zip((*trs2.memory.a, *trs2.memory.c),
                          (*rs2.memory.a, *rs2.memory.c),
                          ("a.h", "a.c", "c.h", "c.c")):
        _close(g, w, 5e-3, name)
    assert float(trs2.memory.a.h.abs().max()) > 0.0


def test_go2_lstm_rollout_resets_memory_and_values_from_it():
    """Envs whose episode ends in the rollout's last step enter the next
    iteration with zeroed memory, and the last values (GAE's bootstrap)
    come from that reset memory (JAX runner.py:207-208, 259-260)."""
    from test_torch_ppo import plane_runner
    runner = plane_runner("go2_lstm")
    rs = runner.init_runner_state(0)
    ends = torch.zeros(8, dtype=torch.bool)
    ends[[2, 5]] = True
    rs = rs._replace(env_state=rs.env_state._replace(
        episode_length=torch.where(
            ends, runner.env.max_episode_length - runner.num_steps + 1,
            rs.env_state.episode_length)))
    rs2, ro = runner.rollout(rs)
    assert torch.equal(ro.traj.dones[-1], ends) and ro.ep_stats[2] == 2
    assert ro.ep_stats.shape == (3,)
    for x in (*rs2.memory.a, *rs2.memory.c):
        assert not x[ends].any() and x[~ends].abs().min() > 0
    torch.testing.assert_close(
        ro.last_values, runner.alg.value(rs2.priv_obs, rs2.memory),
        atol=0, rtol=0)


def test_go2_lstm_resume_is_exact(tmp_path):
    rs = assert_resume_is_exact("go2_lstm", tmp_path)
    assert float(rs.memory.a.h.abs().max()) > 0.0


def test_go2_lstm_load_params_across_env_counts(tmp_path):
    assert_load_params_across_env_counts("go2_lstm", tmp_path)
