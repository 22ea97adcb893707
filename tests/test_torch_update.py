"""PyTorch port: the update half of the CTS algorithm against the JAX package.

* agents/common: GAE, entropy, log-prob, the clipped losses, the adaptive-KL
  LR and the optimizer (optax clip-by-global-norm + Adam), on seeded numpy
  inputs at atol 1e-6.
* CTS.update for all six algorithms at small widths (as
  tests/test_agents.py:130-163), from the same weights (the JAX init carried
  across by importer.params_from_jax), the same batch and the permutations
  recomputed from JAX's key (cts.py:196-199). Params, both Adam moments and
  counts, the learning rate and every metric are compared after one PPO +
  one distillation minibatch (1 epoch x 1 minibatch, atol 1e-5) and after
  the full 5 x 4 update (atol 1e-4).
  Both Adam states start warm, as after 10 earlier steps (seeded first
  moments, second moments with sqrt(v_hat) in [1e-4, 1e-3]), carried across
  like the params. From a fresh state Adam's first step is g / (|g| + 1e-8):
  at the few elements whose gradient fp32 leaves within a few 1e-9 of zero
  (the two packages' gradients agree to ~1e-9) it amplifies rounding by up
  to lr / eps = 1e5, which is a property of Adam, not of the port. The fresh
  state is held to JAX in test_torch_train.py's train step.
  The batch's old policy is the current one shifted by half a std
  (old_mu = mu + 0.5 std, old_sigma = std), with actions drawn from the old
  policy: the KL starts at 12 * 0.5**2 / 2 = 1.5, 75 times the upper
  threshold 2 * desired_kl = 0.02, and the few-1e-3 moves of the update
  keep it there, so both packages divide the LR by 1.5 at every minibatch
  (down to its floor 1e-5) and never sit near a threshold; the final LRs
  must be equal.
* The act/value forwards of the four families this slice adds, at full
  width, with JAX's normal draws injected (atol 1e-5)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from go2_rl_gym_tpu.agents import common as jcommon
from go2_rl_gym_tpu.agents import cts as jcts
from go2_rl_gym_tpu.agents.networks import make_cts_model as j_make
from go2_rl_gym_tpu.env import config as jconfig
from go2_rl_gym_tpu_torch.agents import common as tcommon
from go2_rl_gym_tpu_torch.agents import cts as tcts
from go2_rl_gym_tpu_torch.env import config as tconfig
from go2_rl_gym_tpu_torch.export import importer as timp

NUM_OBS, NUM_PRIV, NUM_ACT, HIST = 45, 263, 12, 5
MASK = tuple([True] * 6 + [False] * 3 + [True] * 36)
SMALL = dict(actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 16),
             teacher_encoder_hidden_dims=(32,),
             student_encoder_hidden_dims=(32, 16), obs_no_goal_mask=MASK)
ALGOS = ["CTS", "MoECTS", "MoENGCTS", "MCPCTS", "ACMoECTS", "DualMoECTS"]


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
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=err_msg)


# ---------------------------------------------------------------------------
# agents/common
# ---------------------------------------------------------------------------


def test_gae_matches_jax():
    """Dones mid-window and a batch whose advantages have a std far from 1
    (the normalization is the population std, as jnp.std)."""
    rng = np.random.default_rng(0)
    T, N = 6, 5
    rewards = (3.0 * rng.normal(size=(T, N)) + 1.0).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.25
    last = rng.normal(size=N).astype(np.float32)
    jr, ja = jcommon.compute_gae(jnp.asarray(rewards), jnp.asarray(values),
                                 jnp.asarray(dones), jnp.asarray(last),
                                 0.99, 0.95)
    tr, ta = tcommon.compute_gae(_t(rewards), _t(values), _t(dones), _t(last),
                                 0.99, 0.95)
    assert dones.any() and float(jnp.std(jr - values)) > 2.0
    _close(tr, jr, 1e-6)
    _close(ta, ja, 1e-6)


def test_distribution_and_losses_match_jax():
    rng = np.random.default_rng(1)
    f = np.float32
    # 3 action dims keep the log-prob's magnitude (and its fp32 ulp) small
    mu = rng.normal(size=(16, 3)).astype(f)
    std = (0.5 + rng.random((16, 3))).astype(f)
    act = (mu + std * rng.normal(size=(16, 3))).astype(f)
    _close(tcommon.gaussian_log_prob(_t(mu), _t(std), _t(act)),
           jcommon.gaussian_log_prob(mu, std, act), 1e-6)
    _close(tcommon.gaussian_entropy(_t(std)), jcommon.gaussian_entropy(std),
           1e-6)
    # log-ratios spread over +-1 so the ratio leaves [0.8, 1.2] both ways
    logp = rng.normal(size=64).astype(f)
    old = rng.normal(size=64).astype(f)
    adv = rng.normal(size=64).astype(f)
    ratio = np.exp(logp - old)
    assert (ratio < 0.8).any() and (ratio > 1.2).any()
    _close(tcommon.surrogate_loss(_t(logp), _t(old), _t(adv), 0.2),
           jcommon.surrogate_loss(logp, old, adv, 0.2), 1e-6)
    v, v_old, ret = (rng.normal(size=64).astype(f) for _ in range(3))
    for clipped in (True, False):
        _close(tcommon.clipped_value_loss(_t(v), _t(v_old), _t(ret), 0.2,
                                          clipped),
               jcommon.clipped_value_loss(v, v_old, ret, 0.2, clipped), 1e-6)


@pytest.mark.parametrize("shift,lr", [(3.0, 1e-3), (1e-4, 1e-3), (0.1, 1e-3),
                                      (3.0, 1.2e-5), (1e-4, 9e-3)])
def test_adaptive_kl_lr_matches_jax(shift, lr):
    """KL above 2 x desired (LR down, and its floor), below desired / 2 (LR
    up, and its cap), and between (LR kept)."""
    rng = np.random.default_rng(2)
    mu = rng.normal(size=(8, 12)).astype(np.float32)
    sig = (0.5 + rng.random((8, 12))).astype(np.float32)
    args = (mu, sig, mu + np.float32(shift) * sig, sig)
    jl, jk = jcommon.adaptive_kl_lr(jnp.float32(lr), *args, 0.01)
    tl, tk = tcommon.adaptive_kl_lr(torch.tensor(lr, dtype=torch.float32),
                                    *map(_t, args), 0.01)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert float(tl) == float(jl)
    _close(tk, jk, 1e-6)


@pytest.mark.parametrize("scale", [1e-4, 1e-2], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    """The clip alone, at a max_norm (1e-3) small enough that a different
    rule (torch's g * max / (norm + 1e-6)) would show at atol 1e-9."""
    rng = np.random.default_rng(5)
    grads = [(scale * rng.normal(size=s)).astype(np.float32)
             for s in [(7, 5), (5,), (3, 4, 2)]]
    clip = optax.clip_by_global_norm(1e-3)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    got = tcommon.clip_by_global_norm([_t(g) for g in grads], 1e-3)
    assert (float(optax.global_norm(grads)) < 1e-3) == (scale < 1e-3)
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["below", "above"])
def test_optimizer_matches_optax(scale):
    """clip_by_global_norm + Adam over 5 steps with a changing LR, with the
    gradients' global norm below and above max_grad_norm = 1."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = jcommon.make_optimizer(1.0, 1e-3)
    jp = [jnp.asarray(p) for p in params]
    jstate = opt.init(jp)
    tp = [_t(p).clone() for p in params]
    tstate = tcommon.adam_init(tp)
    for i, lr in enumerate([1e-3, 1.5e-3, 1e-2, 4e-4, 1e-3]):
        grads = [(scale * rng.normal(size=s)).astype(np.float32)
                 for s in shapes]
        jg = [jnp.asarray(g) for g in grads]
        norm = float(optax.global_norm(jg))
        assert (norm < 1.0) == (scale < 1.0)
        jstate = jcommon.set_lr(jstate, jnp.float32(lr))
        upd, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = tcommon.adam_step(tp, [_t(g) for g in grads], tstate,
                                   torch.tensor(lr, dtype=torch.float32), 1.0)
    adam = jstate.inner_state[1][0]
    assert int(tstate.count) == int(adam.count) == 5
    for a, b, m, jm, n, jn in zip(tp, jp, tstate.mu, adam.mu, tstate.nu,
                                  adam.nu):
        _close(a, b, 1e-6)
        _close(m, jm, 1e-6)
        _close(n, jn, 1e-6)


# ---------------------------------------------------------------------------
# CTS.update, all six algorithms
# ---------------------------------------------------------------------------


def _algs(algo, epochs, nmb, N, load_balance_coef=1.0):
    """Both packages' CTS at SMALL widths; the load-balance coefficient is
    raised from 0.01 to 1 so that the MoE balance terms move the weights
    well past the tolerance."""
    kw = dict(num_learning_epochs=epochs, num_mini_batches=nmb,
              load_balance_coef=load_balance_coef)
    ja, ta = jconfig.AlgorithmCfg(**kw), tconfig.AlgorithmCfg(**kw)
    jalg = jcts.CTS(algo, NUM_OBS, NUM_PRIV, NUM_ACT, N, HIST,
                    jconfig.PolicyCfg(**SMALL), ja)
    talg = tcts.CTS(algo, NUM_OBS, NUM_PRIV, NUM_ACT, N, HIST,
                    tconfig.PolicyCfg(**SMALL), ta, "cpu")
    return jalg, talg


@functools.cache
def _jax_init(algo):
    """JAX's CTS train state at SMALL widths from PRNGKey(0), made once per
    algorithm (it does not depend on the epoch or minibatch counts)."""
    jalg, _ = _algs(algo, 1, 1, 8)
    return jax.jit(jalg.init)(jax.random.PRNGKey(0))


def update_batch(talg, N, T, seed):
    """A seeded numpy batch whose old policy is the current one (`talg`'s
    model, loaded with the JAX weights) shifted by half a std (see the
    module docstring), with returns and advantages from JAX's GAE. Returns
    (batch fields as numpy, returns, advantages)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    obs = rng.normal(size=(T, N, NUM_OBS)).astype(f)
    priv = rng.normal(size=(T, N, NUM_PRIV)).astype(f)
    hist = rng.normal(size=(T, N, NUM_OBS * HIST)).astype(f)
    zero = torch.zeros((N, NUM_ACT))
    mu, std = (np.stack(x) for x in zip(*[
        [y.numpy() for y in talg.act(_t(obs[t]), _t(priv[t]), _t(hist[t]),
                                     noise=zero)[3:]] for t in range(T)]))
    old_mu = (mu + 0.5 * std).astype(f)
    actions = (old_mu + std * rng.normal(size=mu.shape)).astype(f)
    logp = np.asarray(jcommon.gaussian_log_prob(old_mu, std, actions))
    rewards = rng.normal(size=(T, N)).astype(f)
    values = rng.normal(size=(T, N)).astype(f)
    dones = rng.random((T, N)) < 0.1
    fields = dict(obs=obs, critic_obs=priv, history=hist, actions=actions,
                  rewards=rewards, dones=dones, values=values, log_probs=logp,
                  mu=old_mu, sigma=std)
    ret, adv = jcommon.compute_gae(
        *map(jnp.asarray, (rewards, values, dones,
                           rng.normal(size=N).astype(f))), 0.99, 0.95)
    return fields, np.asarray(ret), np.asarray(adv)


def warm_adam(ts, talg, seed):
    """`ts` with both Adam states as after 10 steps (see the module
    docstring); the same states set on `talg`."""
    rng = np.random.default_rng(seed)
    bc = np.float32(1 - 0.999 ** 10)

    def warm(opt_state):
        adam = opt_state.inner_state[1][0]
        mu = jax.tree.map(lambda x: jnp.asarray(
            1e-4 * rng.normal(size=x.shape), jnp.float32), adam.mu)
        nu = jax.tree.map(lambda x: jnp.asarray(
            bc * rng.uniform(1e-4, 1e-3, size=x.shape) ** 2, jnp.float32),
            adam.nu)
        adam = adam._replace(count=jnp.asarray(10, jnp.int32), mu=mu, nu=nu)
        inner = opt_state.inner_state
        return opt_state._replace(
            inner_state=(inner[0], (adam,) + tuple(inner[1][1:])))

    ts = ts._replace(opt1_state=warm(ts.opt1_state),
                     opt2_state=warm(ts.opt2_state))
    (n1, _), (n2, _) = tcts.split_params(talg.model)
    talg.opt1, talg.opt2 = (
        tcommon.AdamState(torch.tensor(10, dtype=torch.int32),
                          timp.tensors_from_tree(names, adam.mu),
                          timp.tensors_from_tree(names, adam.nu))
        for names, adam in ((n1, ts.opt1_state.inner_state[1][0]),
                            (n2, ts.opt2_state.inner_state[1][0])))
    return ts


def jax_perms(key, jalg, T):
    """The teacher and student permutations JAX's update draws from `key`
    (cts.py:197-199)."""
    kt, ks = jax.random.split(key)
    return (np.asarray(jax.random.permutation(kt, jalg.num_teacher * T)),
            np.asarray(jax.random.permutation(ks, jalg.num_student * T)))


@pytest.mark.parametrize("epochs,nmb,atol", [(1, 1, 1e-5), (5, 4, 1e-4)],
                         ids=["one_minibatch", "full_5x4"])
@pytest.mark.parametrize("algo", ALGOS)
def test_cts_update_matches_jax(algo, epochs, nmb, atol):
    N, T = 8, 4
    jalg, talg = _algs(algo, epochs, nmb, N)
    ts = _jax_init(algo)
    timp.params_from_jax(jax.tree.map(np.asarray, jcts.merge_params(
        ts.params1, ts.params2)), talg.model)
    fields, ret, adv = update_batch(talg, N, T, seed=7)
    ts = warm_adam(ts, talg, seed=8)
    key = jax.random.PRNGKey(5)
    ts2, jm = jax.jit(jalg.update)(ts, jcts.Transition(**fields), ret, adv,
                                   key)
    tm = talg.update(tcts.Transition(**{k: _t(v) for k, v in fields.items()}),
                     _t(ret), _t(adv), perms=jax_perms(key, jalg, T))

    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k].detach(), jm[k], atol, err_msg=k)
    # every minibatch divided the LR by 1.5 (down to its floor), in both
    lr = np.float32(1e-3)
    for _ in range(epochs * nmb):
        lr = max(np.float32(1e-5), np.float32(lr / np.float32(1.5)))
    assert float(talg.lr) == float(ts2.lr) == float(jm["learning_rate"]) \
        == float(lr)
    (n1, _), (n2, _) = tcts.split_params(talg.model)
    want = {"params": {**ts2.params1["params"], **ts2.params2["params"]}}
    got = timp.tree_from_named(talg.model.named_parameters())
    pairs = [(got, want, "params")]
    for names, topt, jopt, tag in ((n1, talg.opt1, ts2.opt1_state, "opt1"),
                                   (n2, talg.opt2, ts2.opt2_state, "opt2")):
        adam = jopt.inner_state[1][0]
        assert int(topt.count) == int(adam.count) == 10 + epochs * nmb
        pairs.append((timp.tree_from_named(zip(names, topt.mu)), adam.mu,
                      f"{tag} mu"))
        pairs.append((timp.tree_from_named(zip(names, topt.nu)), adam.nu,
                      f"{tag} nu"))
    for g, w, tag in pairs:
        gl = jax.tree_util.tree_leaves_with_path(g)
        wl = dict(jax.tree_util.tree_leaves_with_path(w))
        assert len(gl) == len(wl), tag
        for path, v in gl:
            _close(v, wl[path], atol, err_msg=f"{tag} "
                   f"{jax.tree_util.keystr(path)}")
    # both passes moved their group
    moved = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()),
                         want, jax.tree.map(np.asarray, jcts.merge_params(
                             ts.params1, ts.params2)))
    assert max(jax.tree.leaves(moved["params"]["student_encoder"])) > 0
    assert max(jax.tree.leaves(moved["params"]["actor"])) > 0


def test_update_needs_an_explicit_shuffle():
    jalg, talg = _algs("CTS", 1, 1, 8)
    ts = _jax_init("CTS")
    timp.params_from_jax(jax.tree.map(np.asarray, jcts.merge_params(
        ts.params1, ts.params2)), talg.model)
    fields, ret, adv = update_batch(talg, 8, 4, seed=1)
    batch = tcts.Transition(**{k: _t(v) for k, v in fields.items()})
    with pytest.raises(ValueError, match="gen or perms"):
        talg.update(batch, _t(ret), _t(adv))
    g = torch.Generator().manual_seed(0)
    m = talg.update(batch, _t(ret), _t(adv), gen=g)
    assert all(bool(torch.isfinite(v)) for v in m.values())


# ---------------------------------------------------------------------------
# the four families of this slice at full width: forwards and act/value
# ---------------------------------------------------------------------------

NEW = {"MoENGCTS": "go2_moe_ng_cts_train_cfg", "MCPCTS": "go2_mcp_cts_train_cfg",
       "ACMoECTS": "go2_ac_moe_cts_train_cfg",
       "DualMoECTS": "go2_dual_moe_cts_train_cfg"}


@pytest.mark.parametrize("algo", sorted(NEW))
def test_new_family_act_matches_jax(algo):
    B = 64
    jc, tc = (getattr(m, NEW[algo])() for m in (jconfig, tconfig))
    family = jcts.ALGO_TO_FAMILY[algo]
    assert tcts.ALGO_TO_FAMILY[algo] == family
    jalg = jcts.CTS(algo, NUM_OBS, NUM_PRIV, NUM_ACT, B, HIST, jc.policy,
                    jc.algorithm)
    talg = tcts.CTS(algo, NUM_OBS, NUM_PRIV, NUM_ACT, B, HIST, tc.policy,
                    tc.algorithm, "cpu")
    ts = jax.jit(jalg.init)(jax.random.PRNGKey(3))
    params = jcts.merge_params(ts.params1, ts.params2)
    timp.params_from_jax(jax.tree.map(np.asarray, params), talg.model)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in talg.model.parameters())
    assert ("std" in ts.params1["params"]) == hasattr(talg.model, "std")

    rng = np.random.default_rng(4)
    obs, priv, hist = (rng.normal(size=(B, d)).astype(np.float32)
                       for d in (NUM_OBS, NUM_PRIV, NUM_OBS * HIST))
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (B, NUM_ACT)))
    j_out = jalg.act(ts.params1, ts.params2, key, obs, priv, hist)
    t_out = talg.act(_t(obs), _t(priv), _t(hist), noise=_t(noise))
    for name, j, t in zip(("actions", "values", "logp", "mu", "std"), j_out,
                          t_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-6, err_msg=name)
    _close(talg.value(_t(obs), _t(priv), _t(hist)),
           jalg.value(ts.params1, ts.params2, obs, priv, hist), 1e-5)

    jm = j_make(family, NUM_OBS, NUM_PRIV, NUM_ACT, jc.policy, HIST)
    js_lat, jgate = jm.apply(params, hist, method="s_latent")
    jmu, jstd, jw = jm.apply(params, js_lat, obs, method="dist")
    jval, jvw = jm.apply(params, js_lat, priv, obs, method="val")
    with torch.no_grad():
        s_lat, gate = talg.model.s_latent(_t(hist))
        mu, std, w = talg.model.dist(s_lat, _t(obs))
        val, vw = talg.model.val(s_lat, _t(priv), _t(obs))
    for name, j, t in (("s_latent", js_lat, s_lat), ("gate", jgate, gate),
                       ("mu", jmu, mu), ("std", jstd, std),
                       ("actor_w", jw, w), ("val", jval, val),
                       ("val_w", jvw, vw)):
        assert (j is None) == (t is None), name
        if j is not None:
            _close(t.detach(), j, 1e-5, err_msg=name)


def test_mcp_clips_log_std_like_jax():
    """MCP's experts with the log_std half of their head scaled by 40, so
    that log_std leaves [-5, 2] on both sides and the clip decides sigma."""
    B = 64
    jc, tc = jconfig.go2_mcp_cts_train_cfg(), tconfig.go2_mcp_cts_train_cfg()
    jm = j_make("mcp_cts", NUM_OBS, NUM_PRIV, NUM_ACT, jc.policy, HIST)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(6), jnp.zeros((1, NUM_OBS)),
        jnp.zeros((1, NUM_PRIV)), jnp.zeros((1, NUM_OBS * HIST))))
    head = params["params"]["actor"]["experts"]
    head["head_kernel"] = head["head_kernel"].copy()
    head["head_kernel"][..., NUM_ACT:] *= np.float32(40.0)
    from go2_rl_gym_tpu_torch.agents.networks import make_cts_model
    tm = make_cts_model("mcp_cts", NUM_OBS, NUM_PRIV, NUM_ACT, tc.policy, HIST,
                        device="cpu")
    timp.params_from_jax(params, tm)
    rng = np.random.default_rng(7)
    lat = rng.normal(size=(B, 32)).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=1, keepdims=True)
    obs = rng.normal(size=(B, NUM_OBS)).astype(np.float32)
    with torch.no_grad():
        x_ng = torch.cat([_t(lat), _t(obs)[:, tm.no_goal_idx]], dim=-1)
        log_std = tm.actor.experts(x_ng)[..., NUM_ACT:]
        mu, sigma, w = tm.dist(_t(lat), _t(obs))
    assert float(log_std.max()) > 2.0 and float(log_std.min()) < -5.0
    jmu, jsigma, jw = jm.apply(params, lat, obs, method="dist")
    for name, j, t in (("mu", jmu, mu), ("sigma", jsigma, sigma),
                       ("w", jw, w)):
        _close(t, j, 1e-5, err_msg=name)


@pytest.mark.parametrize("family", ["moe_ng_cts", "mcp_cts"])
def test_goal_mask_is_required(family):
    from go2_rl_gym_tpu_torch.agents.networks import make_cts_model
    with pytest.raises(ValueError, match="obs_no_goal_mask"):
        make_cts_model(family, NUM_OBS, NUM_PRIV, NUM_ACT, tconfig.PolicyCfg(),
                       HIST, device="cpu")


def test_update_check_agrees_with_itself_on_the_cpu():
    """The card-vs-CPU update check of tools/card_check.py, run with the
    CPU on both sides: the same state must give bit-identical results."""
    from go2_rl_gym_tpu_torch.tools import card_check
    worst = card_check.update_card_vs_cpu(device="cpu", num_envs=16)
    assert worst == dict.fromkeys(worst, 0.0)
    assert set(worst) == {"params", "opt1.mu", "opt1.nu", "opt2.mu",
                          "opt2.nu", "metrics"}
