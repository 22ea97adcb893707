"""Learning-failure diagnostics: zero-action and random-action probes with
termination telemetry by cause.

Twin of tools/diagnose_learning.py. Probes the spawn -> land -> die
pipeline: runs zero-action and random-action (std 1) rollouts of the go2
task on a flat plane or on rough terrain and reports terminations by cause
(base contact, non-finite state, runaway speed, below the terrain,
timeout), the base contact-force profile and base and foot height traces.

Usage:
    python -m go2_rl_gym_tpu_torch.tools.diagnose_learning \\
        [--terrain plane|heightfield] [--steps 200] [--num_envs 64] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

CAUSES = ("contact", "bad_finite", "bad_speed", "below_terrain", "timeout")


def probe_cfgs(terrain: str, n: int = 64):
    """go2's configs at `n` envs on `terrain` (4 x 4 sub-terrains off the
    plane)."""
    from go2_rl_gym_tpu_torch.utils import registry
    env_cfg, train_cfg = registry.get_cfgs("go2")
    env_cfg.env.num_envs = n
    env_cfg.terrain.mesh_type = terrain
    if terrain != "plane":
        env_cfg.terrain.num_rows = 4
        env_cfg.terrain.num_cols = 4
    return env_cfg, train_cfg


def make_env(terrain, n=64, device="cuda"):
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    env_cfg, train_cfg = probe_cfgs(terrain, n)
    return Go2Env(env_cfg,
                  num_steps_per_env=train_cfg.runner.num_steps_per_env,
                  device=device)


def zero_policy(env):
    def policy(state, t):
        return torch.zeros((env.num_envs, env.num_actions), device=env.device)
    return policy


def random_policy(env, seed=123):
    """Standard-normal actions from a generator seeded with `seed`."""
    gen = torch.Generator(device=env.device).manual_seed(seed)

    def policy(state, t):
        return torch.randn((env.num_envs, env.num_actions), generator=gen,
                           device=env.device)
    return policy


@torch.no_grad()
def probe(env, policy, steps=200, label="", seed=0, state=None):
    """Roll `policy(state, t) -> actions` for `steps` env steps from `state`
    (the env's init from `seed` when None) and attribute every termination
    to its cause. Prints the summary; returns the counts by cause."""
    from go2_rl_gym_tpu_torch.sim import engine
    N = env.num_envs
    if state is None:
        state = env.init_state(seed)
    term_counts = {k: 0 for k in CAUSES}
    base_f_hist, base_h_hist, min_feet_h = [], [], []
    done_total = 0
    ep_lens = []
    cur_len = np.zeros(N, np.int64)
    for t in range(steps):
        state, out = env.step(state, policy(state, t))
        sim = state.sim
        # state.sim is post-reset; contact_forces is the pre-reset cache, so
        # the causes other than contact and timeout are approximated, the
        # residual counting as below-terrain (as the JAX tool does)
        cf = state.contact_forces.cpu().numpy()
        base_f = np.linalg.norm(cf[:, 0, :], axis=-1)
        contact_term = base_f > 1.0
        pos, quat = sim.base_pos.cpu().numpy(), sim.base_quat.cpu().numpy()
        fin = ~(np.isfinite(pos).all(axis=1) & np.isfinite(quat).all(axis=1)
                & np.isfinite(sim.qd.cpu().numpy()).all(axis=1))
        speed = ((np.abs(sim.base_lin_vel.cpu().numpy()) >= 30.0).any(axis=1)
                 | (np.abs(sim.base_ang_vel.cpu().numpy()) >= 60.0).any(axis=1))
        ground_z = engine.terrain_height(env.terrain,
                                         sim.base_pos[:, :2]).cpu().numpy()
        done = out.done.cpu().numpy()
        to = out.time_outs.cpu().numpy()
        term_counts["contact"] += int((done & contact_term).sum())
        term_counts["timeout"] += int((done & to).sum())
        term_counts["bad_finite"] += int((done & fin).sum())
        term_counts["bad_speed"] += int((done & speed).sum())
        residual = done & ~contact_term & ~to & ~fin & ~speed
        term_counts["below_terrain"] += int(residual.sum())
        done_total += int(done.sum())
        cur_len += 1
        for i in np.nonzero(done)[0]:
            ep_lens.append(cur_len[i])
            cur_len[i] = 0
        base_f_hist.append(base_f)
        base_h_hist.append(pos[:, 2] - ground_z)
        min_feet_h.append(state.foot_pos[:, :, 2].cpu().numpy().min(axis=1))

    base_f_hist = np.stack(base_f_hist)   # (T, N)
    base_h_hist = np.stack(base_h_hist)
    min_feet_h = np.stack(min_feet_h)
    print(f"\n=== {label} ({steps} steps x {N} envs) ===")
    print(f"  dones total: {done_total}  ({done_total / steps:.1f}/step)")
    print(f"  causes: {term_counts}")
    if ep_lens:
        print(f"  episode length: mean {np.mean(ep_lens):.1f} "
              f"median {np.median(ep_lens):.0f} max {np.max(ep_lens)}")
    marks = [t for t in (5, 20, 50, steps - 1) if t < steps]
    print("  base height (m): " + ", ".join(
        f"t={t} {base_h_hist[t].mean():.3f}" for t in marks))
    print(f"  base |F|: mean {base_f_hist.mean():.2f} N, "
          f"p99 {np.percentile(base_f_hist, 99):.2f} N, "
          f"max {base_f_hist.max():.2f} N, "
          f"frac>1N {(base_f_hist > 1.0).mean():.4f}")
    t_mid = min(20, steps - 1)
    print(f"  min foot z rel terrain-ish: t={t_mid} "
          f"{min_feet_h[t_mid].mean():.3f}")
    return term_counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--terrain", default="plane")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--num_envs", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env = make_env(args.terrain, args.num_envs, args.device)
    probe(env, zero_policy(env), args.steps, f"zero-action / {args.terrain}")
    probe(env, random_policy(env), args.steps,
          f"random-action(std=1) / {args.terrain}")


if __name__ == "__main__":
    main()
