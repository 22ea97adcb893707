"""PyTorch port, export (go2_rl_gym_tpu_torch/export/{exporter,onnx_native,
native}.py) against the JAX package's export on the same seeded trees.

* TorchScript: for the six CTS families and `lstm`, the port's export of a
  port model holding `params_from_jax(tree)` equals the JAX exporter's
  export of `tree` on a 7-step obs sequence (the same build functions on
  the same weights: expected bitwise, held at 1e-6), and both are within
  2e-5 of the port model's own student `mu` (tests/test_export.py:60's
  tolerance);
  `reset()` gives the first action back.
* ONNX: the port's file is byte-identical to the JAX package's for the six
  families and ppo, and the port's OnnxPolicy matches
  `build_torch_policy_stacked` within 1e-5.
* .g2p: byte-identical for cts and moe_cts; the port's NativePolicy (the
  shim built into build/native/) runs the .g2p and the .onnx files within
  1e-5 + 1e-4 rel of the TorchScript (tests/test_native_infer.py:45, 95).
* pkl: each package's `load_policy_params` reads the other's file exactly.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.agents import recurrent as jrec
from go2_rl_gym_tpu.agents.networks import ActorCritic as JActorCritic
from go2_rl_gym_tpu.agents.networks import make_cts_model as j_make
from go2_rl_gym_tpu.env import config as jconfig
from go2_rl_gym_tpu.export import exporter as jexp
from go2_rl_gym_tpu.export import native as jnative
from go2_rl_gym_tpu_torch.agents import recurrent as trec
from go2_rl_gym_tpu_torch.agents.networks import ActorCritic as TActorCritic
from go2_rl_gym_tpu_torch.agents.networks import make_cts_model as t_make
from go2_rl_gym_tpu_torch.env import config as tconfig
from go2_rl_gym_tpu_torch.export import exporter as texp
from go2_rl_gym_tpu_torch.export import importer as timp
from go2_rl_gym_tpu_torch.export import native as tnative
from go2_rl_gym_tpu_torch.export import onnx_native as tonnx

NUM_OBS, NUM_PRIV, NUM_ACT, HIST = 45, 263, 12, 5
MASK = tuple([True] * 6 + [False] * 3 + [True] * 36)
SMALL = dict(actor_hidden_dims=(32, 32), critic_hidden_dims=(32, 16),
             teacher_encoder_hidden_dims=(32,),
             student_encoder_hidden_dims=(32, 16), obs_no_goal_mask=MASK)
FAMILIES = ["cts", "moe_cts", "moe_ng_cts", "mcp_cts", "ac_moe_cts",
            "dual_moe_cts"]
SEQ = 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(params, seed):
    """A flax init with seeded noise on every leaf: the zero biases of the
    init would hide where a bias goes."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32) + 0.1 * rng.
                        standard_normal(np.shape(x)).astype(np.float32),
                        params)


def cts_pair(family, seed=0):
    """(JAX-layout tree, port CTS model holding it) for `family`."""
    jm = j_make(family, NUM_OBS, NUM_PRIV, NUM_ACT,
                jconfig.PolicyCfg(**SMALL), HIST)
    tree = _perturbed(jm.init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, NUM_OBS)),
                              jnp.zeros((1, NUM_PRIV)),
                              jnp.zeros((1, HIST * NUM_OBS))), seed)
    tm = t_make(family, NUM_OBS, NUM_PRIV, NUM_ACT,
                tconfig.PolicyCfg(**SMALL), HIST, device="cpu")
    return tree, timp.params_from_jax(tree, tm)


def lstm_pair(seed=0):
    jm = jrec.ActorCriticRecurrent(num_actions=NUM_ACT,
                                   actor_hidden_dims=(32, 16),
                                   critic_hidden_dims=(32, 16),
                                   rnn_hidden_size=16)
    mem = jrec.LSTMState(h=jnp.zeros((1, 16)), c=jnp.zeros((1, 16)))
    tree = _perturbed(jm.init(jax.random.PRNGKey(seed),
                              jnp.zeros((1, NUM_OBS)),
                              jnp.zeros((1, NUM_PRIV)), mem, mem), seed)
    tm = trec.ActorCriticRecurrent(NUM_OBS, NUM_PRIV, NUM_ACT, (32, 16),
                                   (32, 16), rnn_hidden_size=16,
                                   device="cpu")
    return tree, timp.params_from_jax(tree, tm)


def obs_seq(seed=1, n=SEQ):
    return np.random.default_rng(seed).standard_normal(
        (n, NUM_OBS)).astype(np.float32)


@torch.no_grad()
def student_mu(model, seq):
    """The port model's own deterministic path, step by step: the CTS
    student (`s_latent` on the ring buffer, then `dist`) or the recurrent
    actor (`actor_dist` carrying its memory)."""
    out = []
    if isinstance(model, trec.ActorCriticRecurrent):
        state = trec.Memory.zero_state(1, 16)
        for o in seq:
            mu, _, state = model.actor_dist(torch.as_tensor(o)[None], state)
            out.append(mu[0])
        return torch.stack(out).numpy()
    hist = torch.zeros(1, HIST, NUM_OBS)
    for o in seq:
        o = torch.as_tensor(o)[None]
        hist = torch.cat([hist[:, 1:], o[:, None]], dim=1)
        lat, _ = model.s_latent(hist.reshape(1, -1))
        mu, _, _ = model.dist(lat, o)
        out.append(mu[0])
    return torch.stack(out).numpy()


@torch.no_grad()
def run_jit(policy, seq):
    """Every output of a TorchScript policy over the sequence, flattened
    per step, and the action of the first step after reset()."""
    outs = []
    for o in seq:
        r = policy(torch.as_tensor(o)[None])
        parts = [r] if isinstance(r, torch.Tensor) else [r[0], *r[1]]
        outs.append(torch.cat([p.reshape(-1) for p in parts]).numpy())
    policy.reset()
    r = policy(torch.as_tensor(seq[0])[None])
    first = (r if isinstance(r, torch.Tensor) else r[0])[0].numpy()
    return np.stack(outs), first


def stacked_by_term(frames, term_dims=(3, 3, 3, 12, 12, 12)):
    off = np.cumsum((0,) + term_dims)
    return np.concatenate([frames[None, :, off[t]:off[t + 1]].reshape(1, -1)
                           for t in range(len(term_dims))], axis=1)


@pytest.mark.parametrize("family", FAMILIES + ["lstm"])
def test_torchscript_matches_jax_exporter(family, tmp_path):
    tree, model = lstm_pair() if family == "lstm" else cts_pair(family)
    tpath = texp.export_model(model, "jit", family, str(tmp_path / "t"))
    jpath = jexp.export_policy_as_jit(tree, family, str(tmp_path / "j"),
                                      obs_no_goal_mask=MASK)
    seq = obs_seq()
    got, got_first = run_jit(torch.jit.load(tpath), seq)
    want, want_first = run_jit(torch.jit.load(jpath), seq)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    mu = student_mu(model, seq)
    np.testing.assert_allclose(got[:, :NUM_ACT], mu, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(want[:, :NUM_ACT], mu, atol=2e-5, rtol=1e-4)
    # reset() clears the ring buffer (or the memory): the first action again
    np.testing.assert_array_equal(got_first, got[0, :NUM_ACT])
    np.testing.assert_array_equal(want_first, want[0, :NUM_ACT])


def test_export_model_reads_the_model(tmp_path):
    """export_model takes the mask and widths from the model and refuses an
    unknown kind or a family without a .g2p layout."""
    _, model = cts_pair("moe_ng_cts")
    assert texp.model_no_goal_mask(model) == MASK
    _, cts = cts_pair("cts")
    assert texp.model_no_goal_mask(cts) == MASK
    _, lstm = lstm_pair()
    assert texp.model_no_goal_mask(lstm) is None
    with pytest.raises(ValueError, match="kind"):
        texp.export_model(model, "tflite", "moe_ng_cts", str(tmp_path))
    with pytest.raises(ValueError, match="native export"):
        texp.export_model(model, "g2p", "moe_ng_cts", str(tmp_path))


@pytest.mark.parametrize("family", FAMILIES + ["ppo"])
def test_onnx_file_is_the_jax_packages(family, tmp_path):
    if family == "ppo":
        jm = JActorCritic(num_actions=NUM_ACT, actor_hidden_dims=(32, 16),
                          critic_hidden_dims=(32, 16))
        tree = _perturbed(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, NUM_OBS)),
                                  jnp.zeros((1, NUM_PRIV))), 0)
        model = timp.params_from_jax(tree, TActorCritic(
            NUM_OBS, NUM_PRIV, NUM_ACT, (32, 16), (32, 16), device="cpu"))
    else:
        tree, model = cts_pair(family)
    tpath = texp.export_model(model, "onnx", family, str(tmp_path / "t"))
    jpath = jexp.export_policy_as_onnx(tree, family, str(tmp_path / "j"),
                                       obs_no_goal_mask=MASK)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    if family == "ppo":
        return
    x = stacked_by_term(obs_seq(2, HIST))
    got = tonnx.OnnxPolicy(tpath)(x)
    stacked = texp.build_torch_policy_stacked(tree, family, NUM_OBS, HIST,
                                              MASK)
    with torch.no_grad():
        want = stacked(torch.as_tensor(x))
    got = got[0] if isinstance(got, tuple) else got
    want = (want[0] if isinstance(want, tuple) else want).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", ["cts", "moe_cts"])
def test_stacked_adapter_matches_ring_buffer(family):
    """The ONNX-interface adapter (stacked-by-term history) equals feeding
    the same frames through the ring-buffer policy in order."""
    tree, _ = cts_pair(family)
    ring = texp.build_torch_policy(tree, family, NUM_OBS, HIST, MASK)
    stacked = texp.build_torch_policy_stacked(tree, family, NUM_OBS, HIST,
                                              MASK)
    frames = obs_seq(3, HIST)
    with torch.no_grad():
        for f in frames:
            want = ring(torch.as_tensor(f)[None])
        got = stacked(torch.as_tensor(stacked_by_term(frames)))
    if isinstance(want, tuple):
        want, got = want[0], got[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="term_dims"):
        texp.build_torch_policy_stacked(tree, family, NUM_OBS, HIST, MASK,
                                        term_dims=(3, 3, 3, 12, 12))


@pytest.fixture(scope="module")
def shim():
    """The C++ shim, built by the port into build/native/."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    return tnative.build_library()


def test_shim_is_built_beside_the_port_not_the_sources(shim):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert shim == os.path.join(root, "build", "native", "libgo2_infer.so")
    # up to date: a second call builds nothing
    mtime = os.path.getmtime(shim)
    assert tnative.build_library() == shim
    assert os.path.getmtime(shim) == mtime


@pytest.mark.parametrize("family", ["cts", "moe_cts"])
def test_g2p_file_is_the_jax_packages(family, tmp_path, shim):
    tree, model = cts_pair(family)
    tpath = texp.export_model(model, "g2p", family, str(tmp_path / "t"))
    jpath = jnative.export_policy_as_native(tree, family,
                                            str(tmp_path / "j"))
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    seq = obs_seq()
    want, _ = run_jit(torch.jit.load(
        texp.export_model(model, "jit", family, str(tmp_path))), seq)
    pol = tnative.NativePolicy(tpath, shim)
    assert (pol.num_obs, pol.num_actions) == (NUM_OBS, NUM_ACT)
    got = np.stack([pol(o) for o in seq])
    np.testing.assert_allclose(got, want[:, :NUM_ACT], atol=1e-5, rtol=1e-4)
    pol.reset()
    np.testing.assert_allclose(pol(seq[0]), want[0, :NUM_ACT], atol=1e-5,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="entries"):
        pol(seq[0][:10])
    pol.close()


@pytest.mark.parametrize("family", FAMILIES)
def test_native_onnx_runtime_runs_the_port_onnx(family, tmp_path, shim):
    tree, model = cts_pair(family)
    path = texp.export_model(model, "onnx", family, str(tmp_path))
    seq = obs_seq()
    want, _ = run_jit(torch.jit.load(
        texp.export_model(model, "jit", family, str(tmp_path))), seq)
    pol = tnative.NativePolicy(path, shim)
    got = np.stack([pol(o) for o in seq])
    np.testing.assert_allclose(got, want[:, :NUM_ACT], atol=1e-5, rtol=1e-4)


def test_native_rejects_garbage(tmp_path, shim):
    bad = tmp_path / "bad.g2p"
    bad.write_bytes(b"not a policy")
    with pytest.raises(RuntimeError):
        tnative.NativePolicy(str(bad), shim)


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + (k,))
        else:
            yield pre + (k,), v


def assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert isinstance(fa[k], np.ndarray), k
        np.testing.assert_array_equal(fa[k], np.asarray(fb[k]), err_msg=str(k))


@pytest.mark.parametrize("family", ["moe_cts", "lstm"])
def test_pkl_reads_both_ways(family, tmp_path):
    tree, model = lstm_pair() if family == "lstm" else cts_pair(family)
    meta = {"task": "t", "algorithm": family}
    tpath = texp.export_model(model, "pkl", family, str(tmp_path / "t"),
                              meta=meta)
    params, m = jexp.load_policy_params(tpath)
    assert m == meta
    assert_trees_equal(params, tree)
    jpath = jexp.export_policy_as_pkl(tree, meta, str(tmp_path / "j"))
    params, m = texp.load_policy_params(jpath)
    assert m == meta
    assert_trees_equal(params, tree)
    # and back into a port model, bit for bit
    _, fresh = lstm_pair(5) if family == "lstm" else cts_pair(family, 5)
    timp.params_from_jax(params, fresh)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
