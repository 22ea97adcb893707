"""Hold the card against the port's CPU path.

The port's CPU path is held to the JAX package by `tests/test_torch_*.py`;
these checks carry that to the card:

* `env_card_vs_cpu`: a small rough-terrain env (the parity config of those
  tests) takes 4 steps from one state on both devices; obs, privileged obs,
  rewards and dones must agree within the env parity tolerances.
* `update_card_vs_cpu`: one `CTS.update` (5 epochs x 4 minibatches) of the
  flagship go2_moe_cts model at full width on a seeded batch of 64 envs x 4
  steps, from the same weights, Adam states and permutations on both
  devices; params, Adam moments and metrics must agree within UPDATE_ATOL
  and the learning rates exactly.
* `ppo_update_card_vs_cpu` and `recurrent_update_card_vs_cpu`: the same
  for `PPO.update` of the go2 task and `RecurrentPPO.update` of the go2_lstm
  task (LSTM, or GRU with rnn_type="gru"), the latter replaying from a
  seeded non-zero rollout-start memory.

`chip_smoke.py` runs both, and so do the card-only tests in
`tests/test_torch_kernels.py`.

    python -m go2_rl_gym_tpu_torch.tools.card_check
"""
from __future__ import annotations

import copy
import json

import numpy as np
import torch

# the domain randomization, pushes and action delay that the parity config
# turns off, so that no random draw enters a compared value
DR_FLAGS = ("randomize_friction", "randomize_base_mass", "randomize_link_mass",
            "randomize_base_com", "randomize_restitution", "randomize_pd_gains",
            "randomize_motor_zero_offset", "randomize_motor_strength",
            "push_robots", "randomize_action_delay")

# (atol, rtol) per step output: obs atol is the physics' qd tolerance of 0.1
# times the 0.05 dof_vel scale
TOLERANCES = {"obs": (5e-3, 0.0), "privileged_obs": (5e-3, 0.0),
              "rew": (1e-6, 1e-2)}
# after the 5 x 4 update: the tolerance tests/test_torch_update.py holds the
# CPU path to against the JAX package
UPDATE_ATOL = 1e-4


def parity_cfg(cfg, num_envs=8, plane=False):
    """Cut `cfg` (a Go2Cfg of this package, or of the JAX package for the
    tests; the fields are the same) to the parity config: `num_envs` envs on
    3 x 9 sub-terrains with a 3 m border, or on the plane, with DR, pushes,
    the action delay and observation noise off. Returns `cfg`."""
    cfg.env.num_envs = num_envs
    if plane:
        cfg.terrain.mesh_type = "plane"
        cfg.terrain.measure_heights = False
        cfg.terrain.curriculum = False
    else:
        cfg.terrain.num_rows = 3
        cfg.terrain.num_cols = 9
        cfg.terrain.border_size = 3.0
    for name in DR_FLAGS:
        setattr(cfg.domain_rand, name, False)
    cfg.noise.add_noise = False
    return cfg


def tree_to(tree, device):
    """Copy a NamedTuple / dict / list / tensor tree to `device`. A
    generator becomes a fresh one there: the parity config draws nothing in
    a step without a reset."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.Generator):
        return torch.Generator(device=device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_to(v, device) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def env_card_vs_cpu(steps=4, seed=0, device="cuda"):
    """Step the parity env on the CPU and on `device` from one state with
    the same actions. Raises AssertionError on a disagreement; returns the
    largest absolute difference of each compared output."""
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env

    env_c = Go2Env(parity_cfg(Go2Cfg()), device="cpu")
    env_g = Go2Env(parity_cfg(Go2Cfg()), device=device)
    s_c = env_c.init_state(seed)
    s_c, _ = env_c.step(s_c, torch.zeros((env_c.num_envs, 12)))
    s_g = tree_to(s_c, env_g.device)
    rng = np.random.default_rng(seed)
    worst = {k: 0.0 for k in TOLERANCES}
    for _ in range(steps):
        a = torch.as_tensor(
            (0.3 * rng.normal(size=(env_c.num_envs, 12))).astype(np.float32))
        s_c, o_c = env_c.step(s_c, a)
        s_g, o_g = env_g.step(s_g, a.to(env_g.device))
        for k, (atol, rtol) in TOLERANCES.items():
            got, want = getattr(o_g, k).cpu(), getattr(o_c, k)
            worst[k] = max(worst[k], float((got - want).abs().max()))
            torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                                       msg=lambda m, k=k: f"{k}: {m}")
        if not torch.equal(o_g.done.cpu(), o_c.done):
            raise AssertionError("done differs between the card and the CPU")
    return worst


def _update_inputs(alg, N, T, rng):
    """A seeded batch for `alg` (CTS, PPO or RecurrentPPO) whose old policy
    is its current one shifted by half a std (so the KL, 1.5, is far above
    the adaptive-LR thresholds and every minibatch divides the LR by 1.5),
    with its GAE; Adam states as after 10 steps, one per parameter group
    (second moments well above Adam's eps, where fp32 rounding of near-zero
    gradients would be amplified by lr / eps); and the update's
    permutations. RecurrentPPO's old policy is replayed from a seeded
    non-zero rollout-start memory. Returns (batch, returns, advantages,
    the update's extra arguments ((memory,) or ()), Adam states, perms)."""
    from go2_rl_gym_tpu_torch.agents import common, cts, ppo
    from go2_rl_gym_tpu_torch.agents.recurrent import LSTMState
    from go2_rl_gym_tpu_torch.agents.recurrent_ppo import Memory

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    is_cts = isinstance(alg, cts.CTS)
    recurrent = hasattr(alg, "zero_memory")
    obs, priv = normal(T, N, alg.num_obs), normal(T, N, alg.num_critic_obs)
    dones = torch.as_tensor(rng.random((T, N)) < 0.1)
    extra, fields = (), {}
    with torch.no_grad():
        if is_cts:
            hist = fields["history"] = normal(
                T, N, alg.num_obs * alg.history_length)
            zero = torch.zeros((N, alg.num_actions))
            mu, std = (torch.stack(x) for x in zip(*[
                alg.act(obs[t], priv[t], hist[t], noise=zero)[3:]
                for t in range(T)]))
        elif recurrent:
            extra = (Memory(*[LSTMState(*[0.5 * normal(N, alg.hidden)
                                          for _ in range(2)])
                              for _ in range(2)]),)
            mu, std, _ = alg._replay(obs, priv, dones, extra[0])
        else:
            mu, std = alg.model.actor_dist(obs)
    old_mu, std = mu + 0.5 * std, std.contiguous()
    actions = old_mu + std * normal(*mu.shape)
    rewards, values = normal(T, N), normal(T, N)
    batch = (cts.Transition if is_cts else ppo.Transition)(
        obs=obs, critic_obs=priv, actions=actions, rewards=rewards,
        dones=dones, values=values,
        log_probs=common.gaussian_log_prob(old_mu, std, actions),
        mu=old_mu, sigma=std, **fields)
    ret, adv = common.compute_gae(rewards, values, dones, normal(N),
                                  alg.cfg.gamma, alg.cfg.lam)
    bc = 1 - 0.999 ** 10
    groups = (alg.param_groups() if is_cts
              else [list(alg.model.parameters())])
    opts = [common.AdamState(
        torch.tensor(10, dtype=torch.int32),
        [1e-4 * normal(*p.shape) for p in params],
        [torch.as_tensor((bc * rng.uniform(1e-4, 1e-3, size=tuple(p.shape))
                          ** 2).astype(np.float32)) for p in params])
        for params in groups]
    if is_cts:
        perms = (rng.permutation(alg.num_teacher * T),
                 rng.permutation(alg.num_student * T))
    else:
        perms = rng.permutation(N if recurrent else T * N)
    return batch, ret, adv, extra, opts, perms


def _card_vs_cpu(make_alg, seed, device, num_envs, steps):
    """One update of the algorithm `make_alg(device)` builds, on the CPU and
    on `device` from the same weights, batch, Adam states and permutations
    (see the module docstring)."""
    from go2_rl_gym_tpu_torch.agents.networks import init_params
    from go2_rl_gym_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cpu, card = make_alg("cpu"), make_alg(dev)
    init_params(cpu.model, torch.Generator().manual_seed(seed))
    card.model.load_state_dict(cpu.model.state_dict())
    batch, ret, adv, extra, opts, perms = _update_inputs(
        cpu, num_envs, steps, np.random.default_rng(seed))
    tags = ("opt1", "opt2") if len(opts) == 2 else ("opt",)
    # a copy: on one device `to` would alias the moments updated in place
    for tag, o, oc in zip(tags, opts, tree_to(copy.deepcopy(opts), dev)):
        setattr(cpu, tag, o)
        setattr(card, tag, oc)
    m_cpu = cpu.update(batch, ret, adv, *extra, perms=perms)
    m_card = card.update(tree_to(batch, dev), ret.to(dev), adv.to(dev),
                         *tree_to(extra, dev), perms=perms)
    if float(card.lr) != float(cpu.lr):
        raise AssertionError(f"learning rate {float(card.lr)} on the card, "
                             f"{float(cpu.lr)} on the CPU")
    pairs = {"params": (list(card.model.parameters()),
                        list(cpu.model.parameters()))}
    for tag in tags:
        a, b = getattr(card, tag), getattr(cpu, tag)
        pairs[f"{tag}.mu"] = (a.mu, b.mu)
        pairs[f"{tag}.nu"] = (a.nu, b.nu)
    pairs["metrics"] = ([m_card[k].reshape(1) for k in sorted(m_cpu)],
                        [m_cpu[k].reshape(1) for k in sorted(m_cpu)])
    worst = {}
    for tag, (got, want) in pairs.items():
        worst[tag] = 0.0
        for g, w in zip(got, want):
            g = g.detach().cpu()
            worst[tag] = max(worst[tag], float((g - w.detach()).abs().max()))
            torch.testing.assert_close(g, w.detach(), atol=UPDATE_ATOL,
                                       rtol=0.0,
                                       msg=lambda m, t=tag: f"{t}: {m}")
    return worst


def update_card_vs_cpu(seed=0, device="cuda", num_envs=64, steps=4):
    """One CTS.update of the flagship go2_moe_cts model on both devices
    from the same state. Raises AssertionError on a disagreement; returns
    the largest absolute difference of params, Adam moments and
    metrics."""
    from go2_rl_gym_tpu_torch.agents.cts import CTS
    from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg

    tc = go2_moe_cts_train_cfg()
    return _card_vs_cpu(
        lambda d: CTS(tc.runner.algorithm_class_name, 45, 263, 12, num_envs,
                      tc.history_length, tc.policy, tc.algorithm, d),
        seed, device, num_envs, steps)


def ppo_update_card_vs_cpu(seed=0, device="cuda", num_envs=64, steps=4):
    """One PPO.update of the go2 task's model on both devices from the same
    state; as update_card_vs_cpu."""
    from go2_rl_gym_tpu_torch.agents.ppo import PPO
    from go2_rl_gym_tpu_torch.env.config import go2_ppo_train_cfg

    tc = go2_ppo_train_cfg()
    return _card_vs_cpu(
        lambda d: PPO(45, 263, 12, tc.policy, tc.algorithm, d),
        seed, device, num_envs, steps)


def recurrent_update_card_vs_cpu(seed=0, device="cuda", num_envs=64,
                                 steps=4, rnn_type="lstm"):
    """One RecurrentPPO.update (env-sliced minibatches replayed from a
    seeded memory) of the go2_lstm task's model, its memory cell set to
    `rnn_type`, on both devices from the same state; as
    update_card_vs_cpu."""
    from go2_rl_gym_tpu_torch.agents.recurrent_ppo import RecurrentPPO
    from go2_rl_gym_tpu_torch.env.config import go2_lstm_train_cfg

    tc = go2_lstm_train_cfg()
    tc.policy.rnn_type = rnn_type
    return _card_vs_cpu(
        lambda d: RecurrentPPO(45, 263, 12, tc.policy, tc.algorithm, d),
        seed, device, num_envs, steps)


if __name__ == "__main__":
    print(json.dumps({
        "env_max_abs_err": env_card_vs_cpu(),
        "update_max_abs_err": update_card_vs_cpu(),
        "ppo_update_max_abs_err": ppo_update_card_vs_cpu(),
        "recurrent_update_max_abs_err": {
            t: recurrent_update_card_vs_cpu(rnn_type=t)
            for t in ("lstm", "gru")}}))
