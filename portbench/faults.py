"""Faults planted under a training step, for the checks that `correct`
comes out false: each wraps one object of the program or of the reference
(an algorithm or an env) in place, so that the rollout and the update call
the broken method.

- `freeze`: the update leaves the parameters and the Adam states as they
  were (a step that returns its state unchanged);
- `half_batch`: the update sees the first half of the envs twice, so its
  means are taken over that half alone;
- `alter`: the env's rewards come out scaled by 1 + `share` where they are
  produced.
"""
from __future__ import annotations

import torch

from portbench import compare


def freeze(alg):
    update = alg.update

    def frozen(*args, **kwargs):
        keep = [t.detach().clone() for t in _train_state(alg)]
        out = update(*args, **kwargs)
        with torch.no_grad():
            for t, k in zip(_train_state(alg), keep):
                t.copy_(k)
        return out
    alg.update = frozen


def half_batch(alg):
    update = alg.update

    def halved(batch, returns, advantages, *args, **kwargs):
        half = batch.rewards.shape[1] // 2

        def dup(x):
            x = x.clone()
            x[:, half:2 * half] = x[:, :half]
            return x
        batch = type(batch)(*[dup(x) for x in batch])
        return update(batch, dup(returns), dup(advantages), *args, **kwargs)
    alg.update = halved


def alter(env, share: float = 1e-2):
    step = env.step

    def altered(state, actions):
        state, out = step(state, actions)
        return state, out._replace(rew=out.rew * (1.0 + share))
    env.step = altered


def _train_state(alg):
    out = [p for p in alg.model.parameters()]
    out += [getattr(alg, k) for k in ("lr", "lr2") if hasattr(alg, k)]
    for opt, _ in compare.adam_groups(alg):
        out += [opt.count, *opt.mu, *opt.nu]
    return out


PLANT = {"freeze": lambda alg, env: freeze(alg),
         "half_batch": lambda alg, env: half_batch(alg),
         "alter": lambda alg, env: alter(env)}
