"""Stateful VecEnv adapter over the functional Go2Env
(PyTorch port of go2_rl_gym_tpu/env/vec_env.py).

Counterpart of the reference's abstract batched-env contract
(rsl_rl/rsl_rl/env/vec_env.py:36-60): `step(actions) -> (obs, priv_obs, rew,
reset, extras)`, `reset()`, `get_observations`, `get_privileged_observations`,
attrs num_envs/num_obs/num_privileged_obs/num_actions/max_episode_length/
episode_length_buf/extras. The training path uses the functional API
directly; this wrapper serves reference-style runners and custom eval loops.

`step` runs `env.step` as one CUDA graph on the card (`utils/graphs.py`
`EnvStep`, the JAX adapter's `jax.jit(env.step)`) and returns copies of its
outputs. Randomness: the integer `seed` seeds one torch.Generator; every `reset`
draws the seed of the env's next init state from it. `device` (the card by
default) must be the env's device; it raises otherwise, as the runner does.
"""
from __future__ import annotations

import torch

from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
from go2_rl_gym_tpu_torch.utils import graphs


class VecEnvAdapter:
    def __init__(self, env: Go2Env, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env lives on {env.device}, adapter on "
                             f"{self.device}")
        self.env = env
        self.num_envs = env.num_envs
        self.num_obs = env.num_obs
        self.num_privileged_obs = env.num_privileged_obs
        self.num_actions = env.num_actions
        self.max_episode_length = env.max_episode_length
        self.extras = {}
        self._gen = torch.Generator()
        self._gen.manual_seed(seed)
        self._step = graphs.EnvStep(env)
        self._state = None
        self._obs = None
        self._priv = None
        self.reset()

    @property
    def episode_length_buf(self):
        return self._state.episode_length

    @episode_length_buf.setter
    def episode_length_buf(self, value):
        self._state = self._state._replace(
            episode_length=torch.as_tensor(value, dtype=torch.int32,
                                           device=self.device))

    @torch.no_grad()
    def reset(self):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))
        self._state = self.env.init_state(seed)
        zero = torch.zeros((self.num_envs, self.num_actions),
                           device=self.device)
        self._state, out = self.env.step(self._state, zero)
        self._obs, self._priv = out.obs, out.privileged_obs
        return self._obs, self._priv

    @torch.no_grad()
    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32,
                                  device=self.device)
        self._state, out = self._step(self._state, actions)
        out = graphs.copy_tree(out)
        self._obs, self._priv = out.obs, out.privileged_obs
        self.extras = {"episode": out.metrics, "time_outs": out.time_outs}
        return out.obs, out.privileged_obs, out.rew, out.done, self.extras

    def get_observations(self):
        return self._obs

    def get_privileged_observations(self):
        return self._priv
