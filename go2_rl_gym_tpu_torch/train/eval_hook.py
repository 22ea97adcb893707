"""Asynchronous sim2sim evaluation during training
(PyTorch port of go2_rl_gym_tpu/train/eval_hook.py).

Counterpart of the reference's RoboGauge client integration
(rsl_rl/runners/on_policy_runner.py:104-111, 252-295): every
``eval_interval`` iterations the current policy is exported (TorchScript) and
scored in MuJoCo in a background subprocess
(``python -m go2_rl_gym_tpu_torch.scripts.evaluate``); results land in
``<log_dir>/eval_results/results_<iter>.yaml`` and are logged as ``Eval/*``
scalars when they arrive. ``wait_all`` blocks at the end of training for the
final model's score (the reference blocks the same way,
on_policy_runner.py:271-291).

The evaluator runs on the host with no card visible
(``CUDA_VISIBLE_DEVICES=""``): it runs the TorchScript export on the CPU, as
the robot does, and leaves the card to training. An evaluation that fails
leaves no results file and is dropped without a word, as in the JAX package.
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class AsyncEvaluator:
    def __init__(self, log_dir: str,
                 scenes=("flat", "stairs", "cross_slope"),
                 duration_s: float = 8.0,
                 python: Optional[str] = None):
        self.log_dir = log_dir
        self.results_dir = os.path.join(log_dir, "eval_results")
        os.makedirs(self.results_dir, exist_ok=True)
        self.scenes = list(scenes)
        self.duration_s = duration_s
        self.python = python or sys.executable
        self._jobs: List[tuple] = []   # (iteration, Popen, out_path)

    # max concurrent eval subprocesses: an eval can take longer than the
    # submit cadence, and an unbounded queue starves the host CPU. Newer
    # submissions are DROPPED when the cap is hit — this is a monitoring
    # signal, freshest-wins, same spirit as the reference running RoboGauge
    # on a sampled subset of checkpoints.
    max_pending = 3

    def command(self, policy_path: str, out: str) -> List[str]:
        return [self.python, "-m", "go2_rl_gym_tpu_torch.scripts.evaluate",
                "--policy", policy_path, "--scenes", *self.scenes,
                "--duration", str(self.duration_s), "--out", out]

    def child_env(self) -> Dict[str, str]:
        """The evaluator's environment: no card, and the repo root in front
        of any PYTHONPATH so that the port imports from any directory."""
        path = [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]
        return {**os.environ, "CUDA_VISIBLE_DEVICES": "",
                "PYTHONPATH": os.pathsep.join(path)}

    def _spawn(self, cmd: List[str], env: Dict[str, str]) -> subprocess.Popen:
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, env=env)

    def submit(self, policy_path: str, iteration: int):
        running = sum(1 for _, p, _ in self._jobs if p.poll() is None)
        if running >= self.max_pending:
            return
        out = os.path.join(self.results_dir, f"results_{iteration}.yaml")
        proc = self._spawn(self.command(policy_path, out), self.child_env())
        self._jobs.append((iteration, proc, out))

    def poll(self) -> Dict[int, Dict[str, float]]:
        """Collect finished evaluations (non-blocking)."""
        done = {}
        still = []
        for it, proc, out in self._jobs:
            if proc.poll() is None:
                still.append((it, proc, out))
                continue
            if os.path.exists(out):
                try:
                    with open(out) as f:
                        done[it] = yaml.safe_load(f)
                except (OSError, yaml.YAMLError):
                    pass
        self._jobs = still
        return done

    def wait_all(self, timeout: Optional[float] = None):
        for it, proc, out in self._jobs:
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        return self.poll()
