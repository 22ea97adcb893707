"""Per-episode state/reward accumulator for play/analysis tooling.

Counterpart of reference legged_gym/utils/logger.py:1-38. Copy of
go2_rl_gym_tpu/utils/logger.py (numpy only), so that the port does not import
the JAX package.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


class Logger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key, value):
        self.state_log[key].append(np.asarray(value))

    def log_states(self, d):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d, num_episodes):
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(float(np.sum(v)) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()
        self.num_episodes = 0

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean:.4f}")
        print(f"Total number of episodes: {self.num_episodes}")
