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
    """A seeded batch whose old policy is `alg`'s current one shifted by
    half a std (so the KL, 1.5, is far above the adaptive-LR thresholds and
    every minibatch divides the LR by 1.5), with its GAE, and Adam states
    as after 10 steps (second moments well above Adam's eps, where fp32
    rounding of near-zero gradients would be amplified by lr / eps)."""
    from go2_rl_gym_tpu_torch.agents import common
    from go2_rl_gym_tpu_torch.agents.cts import Transition

    f = np.float32
    obs = torch.as_tensor(rng.normal(size=(T, N, alg.num_obs)).astype(f))
    priv = torch.as_tensor(rng.normal(size=(T, N, alg.num_critic_obs))
                           .astype(f))
    hist = torch.as_tensor(rng.normal(
        size=(T, N, alg.num_obs * alg.history_length)).astype(f))
    zero = torch.zeros((N, alg.num_actions))
    mu, std = zip(*[alg.act(obs[t], priv[t], hist[t], noise=zero)[3:]
                    for t in range(T)])
    mu, std = torch.stack(mu), torch.stack(std)
    old_mu = mu + 0.5 * std
    actions = old_mu + std * torch.as_tensor(
        rng.normal(size=tuple(mu.shape)).astype(f))
    rewards = torch.as_tensor(rng.normal(size=(T, N)).astype(f))
    values = torch.as_tensor(rng.normal(size=(T, N)).astype(f))
    dones = torch.as_tensor(rng.random((T, N)) < 0.1)
    batch = Transition(
        obs=obs, critic_obs=priv, history=hist, actions=actions,
        rewards=rewards, dones=dones, values=values,
        log_probs=common.gaussian_log_prob(old_mu, std, actions),
        mu=old_mu, sigma=std)
    ret, adv = common.compute_gae(
        rewards, values, dones, torch.as_tensor(rng.normal(size=N).astype(f)),
        alg.cfg.gamma, alg.cfg.lam)
    bc = 1 - 0.999 ** 10
    opts = []
    for params in alg.param_groups():
        opts.append(common.AdamState(
            torch.tensor(10, dtype=torch.int32),
            [torch.as_tensor(1e-4 * rng.normal(size=tuple(p.shape)).astype(f))
             for p in params],
            [torch.as_tensor((bc * rng.uniform(1e-4, 1e-3, size=tuple(p.shape))
                              ** 2).astype(f)) for p in params]))
    perms = (rng.permutation(alg.num_teacher * T),
             rng.permutation(alg.num_student * T))
    return batch, ret, adv, opts, perms


def update_card_vs_cpu(seed=0, device="cuda", num_envs=64, steps=4):
    """One CTS.update of the flagship model on both devices from the same
    state (see the module docstring). Raises AssertionError on a
    disagreement; returns the largest absolute difference of params, Adam
    moments and metrics."""
    from go2_rl_gym_tpu_torch.agents.cts import CTS
    from go2_rl_gym_tpu_torch.agents.networks import init_params
    from go2_rl_gym_tpu_torch.device import resolve_device
    from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg

    dev = resolve_device(device)
    tc = go2_moe_cts_train_cfg()
    algs = [CTS(tc.runner.algorithm_class_name, 45, 263, 12, num_envs,
                tc.history_length, tc.policy, tc.algorithm, d)
            for d in ("cpu", dev)]
    cpu, card = algs
    init_params(cpu.model, torch.Generator().manual_seed(seed))
    card.model.load_state_dict(cpu.model.state_dict())
    batch, ret, adv, opts, perms = _update_inputs(
        cpu, num_envs, steps, np.random.default_rng(seed))
    cpu.opt1, cpu.opt2 = opts
    # a copy: on one device `to` would alias the moments updated in place
    card.opt1, card.opt2 = tree_to(copy.deepcopy(opts), dev)
    m_cpu = cpu.update(batch, ret, adv, perms=perms)
    m_card = card.update(tree_to(batch, dev), ret.to(dev), adv.to(dev),
                         perms=perms)
    if float(card.lr) != float(cpu.lr):
        raise AssertionError(f"learning rate {float(card.lr)} on the card, "
                             f"{float(cpu.lr)} on the CPU")
    worst = {}
    pairs = {"params": (list(card.model.parameters()),
                        list(cpu.model.parameters()))}
    for tag in ("opt1", "opt2"):
        a, b = getattr(card, tag), getattr(cpu, tag)
        pairs[f"{tag}.mu"] = (a.mu, b.mu)
        pairs[f"{tag}.nu"] = (a.nu, b.nu)
    pairs["metrics"] = ([m_card[k].reshape(1) for k in sorted(m_cpu)],
                        [m_cpu[k].reshape(1) for k in sorted(m_cpu)])
    for tag, (got, want) in pairs.items():
        worst[tag] = 0.0
        for g, w in zip(got, want):
            g = g.detach().cpu()
            worst[tag] = max(worst[tag], float((g - w.detach()).abs().max()))
            torch.testing.assert_close(g, w.detach(), atol=UPDATE_ATOL,
                                       rtol=0.0,
                                       msg=lambda m, t=tag: f"{t}: {m}")
    return worst


if __name__ == "__main__":
    print(json.dumps({"env_max_abs_err": env_card_vs_cpu(),
                      "update_max_abs_err": update_card_vs_cpu()}))
