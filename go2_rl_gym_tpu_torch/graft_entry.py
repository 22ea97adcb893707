"""Graft entry points of the port: a single-card forward check and a
multi-rank dry run of the train step (twin of __graft_entry__.py).

* `entry(device)` returns `(forward, example_args)`: the flagship model's
  go2_moe_cts student inference path (history -> MoE latent -> actor ->
  action mean) at batch 256, weights from a seeded init.
* `dryrun_multichip(n, device)` runs the full go2_moe_cts train step
  (rollout + PPO + distillation) on tiny rough-terrain shapes over n ranks,
  each one a process of distributed/check.py: gloo on the CPU, NCCL on
  cards (rank r on card r). Each rank runs the compiled step
  (`mesh.make_sharded_train_step`, the twin of __graft_entry__.py:60-62):
  on cards one CUDA graph per rank. It prints `dryrun_multichip(n) OK —
  value_loss=...` and returns every rank's result.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 256
DRYRUN_STEPS = 4


def entry(device="cuda"):
    """(forward, example_args): `forward(model, obs, history)` is the
    student's action mean; the example batch is zeros of (256, 45) and
    (256, 225)."""
    from go2_rl_gym_tpu_torch.agents.networks import (init_params,
                                                      make_cts_model)
    from go2_rl_gym_tpu_torch.device import resolve_device
    from go2_rl_gym_tpu_torch.env.config import go2_moe_cts_train_cfg

    dev = resolve_device(device)
    tc = go2_moe_cts_train_cfg()
    model = make_cts_model("moe_cts", 45, 263, 12, tc.policy,
                           tc.history_length, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(0))

    @torch.no_grad()
    def forward(model, obs, history):
        latent, _ = model.s_latent(history)
        mu, _, _ = model.dist(latent, obs)
        return mu

    example_args = (model, torch.zeros((BATCH, 45), device=dev),
                    torch.zeros((BATCH, 45 * tc.history_length), device=dev))
    return forward, example_args


def dryrun_multichip(n_devices: int, device="cuda", timeout_s: float = 600.0):
    """The full go2_moe_cts train step over `n_devices` ranks on tiny
    shapes: a 2 x 9 rough terrain with a 2 m border, 4 steps per env,
    max(8n, 16) envs, domain randomization and the curriculum on
    (__graft_entry__.py:31-67), through the compiled step: its first call
    (on cards the eager warm-up and the capture) gives the metrics, and a
    second call (a replay) must be finite too. Returns the ranks' results
    (metrics, patch launches, whether the step was a graph, the rank's
    output); raises if a rank fails, times out or reports a non-finite
    metric."""
    from go2_rl_gym_tpu_torch.device import resolve_device
    from go2_rl_gym_tpu_torch.distributed.mesh import free_port
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards; "
                           f"{torch.cuda.device_count()} are visible")
    job = dict(kind="dryrun", task="go2_moe_cts",
               num_envs=max(8 * n_devices, 16), steps=DRYRUN_STEPS,
               terrain="dryrun")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as tmp:
        job_path = os.path.join(tmp, "job.pt")
        out = os.path.join(tmp, "out")
        torch.save({"jobs": [job]}, job_path)
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "go2_rl_gym_tpu_torch.distributed.check",
             "--job", job_path, "--out", out, "--backend", backend,
             "--device", dev.type, "--coordinator", f"localhost:{port}",
             "--world", str(n_devices), "--rank", str(r), "--threads", "1",
             "--timeout", str(timeout_s)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout_s)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:"
                                   f"\n{log[-4000:]}")
        results = [dict(torch.load(f"{out}.rank{r}", weights_only=True)[0],
                        log=log) for r, log in enumerate(logs)]
    if not all(res["finite"] for res in results):
        raise RuntimeError("non-finite metrics in the dry run")
    value_loss = float(results[0]["metrics"]["value_loss"])
    print(f"dryrun_multichip({n_devices}) OK — value_loss={value_loss:.4f}")
    return results

