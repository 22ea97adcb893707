"""One rank of a data-parallel check: run jobs over the ranks of a process
group and write what this rank computed.

    python -m go2_rl_gym_tpu_torch.distributed.check --job JOB.pt \\
        --out OUT --backend gloo|nccl --device cpu|cuda[:k] \\
        [--coordinator localhost:PORT --world W --rank R] [--threads 1]

Every rank runs the same command; without --coordinator the ranks come from
torch.distributed.run's environment. JOB.pt (torch.save) holds {"jobs":
[...]}; this rank writes the list of its results to OUT.rank<R>. The jobs:

* "step": one `train_step` of the task from a global RunnerState ("state",
  packed as a checkpoint packs it) and a train state ("train_state", the
  algorithm's `train_state_dict`), with the act noise of the global batch
  (T, N, A) and the update's permutations. The result: this rank's state after the step, the
  metrics, parameters, learning rate and the update's returns and
  advantages. `run_step(job, device)` is the same in one process.
* "curriculum": one env step with the command curriculum on, from a global
  env state ("env_state"); the result holds `cmd_range_x`.
* "resume": one seeded `train_step` and `save`; a fresh runner `load`s
  the file at once, and both take one more step. The result holds both
  ends (bit-identical for an exact resume), the checkpoint's path and the
  inference parameters at the save.
* "train": the task built through the registry at its full config,
  `iterations` timed train iterations; the result holds their host-clock
  times, env-steps/s of the rank and of all ranks, the patch kernel's
  launches per iteration, the metrics and the parameters. With
  "checkpoint" (a path) the ranks then `save` there and `load` it back,
  and the result says whether every tensor and generator came back equal;
  with "profile" one more iteration runs with torch.profiler on from the
  rollout's end (GAE, update, metrics: every collective of it).
* "dryrun": the graft dry run (graft_entry.dryrun_multichip): the runner
  of the job's config, `init_runner_state(0)` and one `train_step`; the
  result holds the metrics, the patch kernel's launches in the step and
  whether every metric is finite.

A job's config is the task's with `num_envs` global envs, `steps` per
iteration, `terrain` "parity" (card_check.parity_cfg's 3 x 9 sub-terrains),
"dryrun" (2 x 9 sub-terrains, a 2 m border: __graft_entry__.py:50-53),
"plane" or "flagship", and `randomness` False for DR, pushes, the action
delay and observation noise off, `curriculum` True for the command
curriculum on. The tests (tests/test_torch_distributed.py) and chip_smoke.py
spawn this module.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from go2_rl_gym_tpu_torch.agents import common
from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
from go2_rl_gym_tpu_torch.ops import terrain_patches
from go2_rl_gym_tpu_torch.tools import card_check
from go2_rl_gym_tpu_torch.train.runner import _pack, _unpack
from go2_rl_gym_tpu_torch.utils import registry


def job_cfgs(job):
    """(env cfg, train cfg) of a job (see the module docstring)."""
    env_cfg, tc = registry.get_cfgs(job["task"])
    env_cfg.env.num_envs = job["num_envs"]
    tc.runner.num_steps_per_env = job.get("steps",
                                          tc.runner.num_steps_per_env)
    terrain = job.get("terrain", "flagship")
    if terrain == "parity":
        card_check.parity_cfg(env_cfg, job["num_envs"])
    elif terrain == "dryrun":
        env_cfg.terrain.num_rows = 2
        env_cfg.terrain.num_cols = 9
        env_cfg.terrain.border_size = 2.0
    elif terrain == "plane":
        env_cfg.terrain.mesh_type = "plane"
        env_cfg.terrain.measure_heights = False
        env_cfg.terrain.curriculum = False
    if not job.get("randomness", True):
        for name in card_check.DR_FLAGS:
            setattr(env_cfg.domain_rand, name, False)
        env_cfg.noise.add_noise = False
    if job.get("curriculum"):
        env_cfg.commands.curriculum = True
    return env_cfg, tc


def build(job, device, mesh=None):
    """The job's runner on `device`, a rank's of `mesh` if given."""
    env_cfg, tc = job_cfgs(job)
    env = registry.make_env(job["task"], env_cfg,
                            num_steps_per_env=tc.runner.num_steps_per_env,
                            device=device, mesh=mesh)
    return registry.make_runner(job["task"], env, tc, device=device)


def flat(tree, prefix=""):
    """Every tensor of a (NamedTuple / dict / list) tree by dotted path, on
    the CPU; a generator becomes its state."""
    out = {}
    if isinstance(tree, torch.Generator):
        out[prefix] = tree.get_state()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            out.update(flat(v, f"{prefix}.{k}"))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}.{i}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().clone()
    return out


def warm_adam(alg, seed):
    """Give `alg`'s Adam states seeded moments as after 10 steps (first
    moments ~1e-4, sqrt(v_hat) in [1e-4, 1e-3]). From a fresh state Adam's
    first step is g / (|g| + 1e-8), which amplifies fp32 gradient noise by
    lr / eps; parity at 1e-5 starts from warm moments."""
    g = torch.Generator().manual_seed(seed)
    bc = 1 - 0.999 ** 10

    def warm(opt):
        return common.AdamState(
            count=torch.full_like(opt.count, 10),
            mu=[(1e-4 * torch.randn(m.shape, generator=g)).to(m.device)
                for m in opt.mu],
            nu=[(bc * (1e-4 + 9e-4 * torch.rand(v.shape, generator=g)) ** 2
                 ).to(v.device) for v in opt.nu])
    for name in ("opt", "opt1", "opt2"):
        if hasattr(alg, name):
            setattr(alg, name, warm(getattr(alg, name)))


def _global_to_rank(template, packed, device, mesh):
    """A packed state of the global batch, shaped like `template`, as this
    rank's slice on `device` (the whole of it without a mesh)."""
    if mesh is None:
        return _unpack(template, packed, device)
    return mesh_lib.shard_runner_state(mesh, _unpack(template, packed, "cpu"))


def _params(runner):
    return {k: v.cpu() for k, v in runner.get_inference_params().items()}


def run_step(job, device, mesh=None):
    runner = build(job, device, mesh)
    template = runner.init_runner_state(0)
    runner.alg.load_train_state_dict(job["train_state"])
    rs = _global_to_rank(template, job["state"], device, mesh)
    noise = job["noise"].to(device)
    if mesh is not None:
        noise = noise[:, mesh.env_slice]
    captured = {}
    update = runner.alg.update

    def spy(traj, returns, advantages, *args, **kwargs):
        captured.update(returns=returns, advantages=advantages,
                        dones=traj.dones)
        return update(traj, returns, advantages, *args, **kwargs)
    runner.alg.update = spy
    rs, m = runner.train_step(rs, noise=noise, perms=job["perms"])
    return {"state": flat(_pack(rs)),
            "metrics": {k: v.detach().cpu() for k, v in m.items()},
            "params": _params(runner), "lr": runner.alg.lr.cpu(),
            **{k: v.cpu() for k, v in captured.items()}}


def run_curriculum(job, device, mesh=None):
    env_cfg, tc = job_cfgs(dict(job, curriculum=True))
    env = registry.make_env(job["task"], env_cfg, device=device, mesh=mesh)
    template = env.init_state(0)
    state = _global_to_rank(template, job["env_state"], device, mesh)
    with torch.no_grad():
        state, out = env.step(state, torch.zeros(
            (env.num_envs, env.num_actions), device=device))
    return {"cmd_range_x": state.cmd_range_x.cpu(), "done": out.done.cpu()}


def run_resume(job, device, mesh=None):
    path = job["path"]
    a = build(job, device, mesh)
    rs = a.init_runner_state(job["seed"], init_at_random_ep_len=True)
    rs, _ = a.train_step(rs)
    a.current_iteration = 1
    a.save(rs, path)
    saved_params = _params(a)
    # loaded at once: `save` returns on every rank once the file is whole
    b = build(job, device, mesh)
    rs_b = b.load(b.init_runner_state(job["seed"] + 5), path)
    rs_a, m_a = a.train_step(rs)
    rs_b, m_b = b.train_step(rs_b)
    ends = [flat({"alg": r.alg.train_state_dict(), "rs": s, "metrics": m})
            for r, s, m in ((a, rs_a, m_a), (b, rs_b, m_b))]
    return {"a": ends[0], "b": ends[1], "iteration": b.current_iteration,
            "saved_params": saved_params}


def parity_job(task, num_envs, steps, device, seed=0):
    """A "step" job on `device` on the flagship terrain with randomness off:
    the task's seeded initial state, warm Adam moments (`warm_adam`), seeded
    standard-normal act noise and permutations; its tensors on the CPU."""
    job = dict(kind="step", task=task, num_envs=num_envs, steps=steps,
               terrain="flagship", randomness=False)
    runner = build(job, device)
    rs = runner.init_runner_state(seed)
    warm_adam(runner.alg, seed)
    g = torch.Generator().manual_seed(seed + 1)
    noise = torch.randn((steps, num_envs, runner.env.num_actions),
                        generator=g)
    alg = runner.alg
    if runner.is_cts:
        perms = tuple(torch.randperm(n * steps, generator=g)
                      for n in (alg.num_teacher, alg.num_student))
    else:
        perms = torch.randperm(
            num_envs * (1 if runner.is_recurrent else steps), generator=g)
    return dict(job, noise=noise, perms=perms,
                state=card_check.tree_to(_pack(rs), "cpu"),
                train_state=card_check.tree_to(alg.train_state_dict(), "cpu"))


def run_train(job, device, mesh=None):
    env_cfg, tc = registry.get_cfgs(job["task"])
    env = registry.make_env(job["task"], env_cfg, num_envs=job["num_envs"],
                            num_steps_per_env=tc.runner.num_steps_per_env,
                            device=device, mesh=mesh)
    runner = registry.make_runner(job["task"], env, tc, device=device)
    rs = runner.init_runner_state(tc.seed, init_at_random_ep_len=True)
    sync = (torch.cuda.synchronize if runner.device.type == "cuda"
            else (lambda: None))
    times, launches = [], []
    for _ in range(job["iterations"]):
        sync()
        for k in terrain_patches.LAUNCHES:
            terrain_patches.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        rs, m = runner.train_step(rs)
        sync()
        times.append(time.perf_counter() - t0)
        launches.append(dict(terrain_patches.LAUNCHES))
    samples = tc.runner.num_steps_per_env * env.num_envs
    roundtrip = None
    if job.get("checkpoint"):
        runner.save(rs, job["checkpoint"])
        back = runner.load(rs, job["checkpoint"])
        want, got = flat(rs), flat(back)
        roundtrip = sorted(want) == sorted(got) and all(
            torch.equal(want[k], got[k]) for k in want)
    profile = _profile_iteration(runner, rs, sync) if job.get("profile") \
        else None
    return {"times": times, "launches": launches, "profile": profile,
            "checkpoint_roundtrip": roundtrip,
            "rank_env_steps_per_s": [samples / t for t in times],
            "total_env_steps_per_s": [samples * (mesh.world if mesh else 1)
                                      / t for t in times],
            "metrics": {k: v.detach().cpu() for k, v in m.items()},
            "params": _params(runner),
            "obs_finite": bool(torch.isfinite(rs.obs).all())}


def run_dryrun(job, device, mesh=None):
    runner = build(job, device, mesh)
    rs = runner.init_runner_state(0)
    for k in terrain_patches.LAUNCHES:
        terrain_patches.LAUNCHES[k] = 0
    rs, m = runner.train_step(rs)
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    metrics = {k: v.detach().cpu() for k, v in m.items()}
    return {"metrics": metrics, "launches": dict(terrain_patches.LAUNCHES),
            "finite": all(bool(torch.isfinite(v).all())
                          for v in metrics.values())}


def _profile_iteration(runner, rs, sync):
    """One more train iteration with torch.profiler on from the rollout's
    end (GAE, the update and the metrics: every collective of the
    iteration, without the rollout's ~180k launches): its wall time, the
    device's busy time and launches, the NCCL kernels among them, and the
    host time of the collective calls by name."""
    from go2_rl_gym_tpu_torch.tools.profile_rollout import _device_us, _kernels
    acts = [torch.profiler.ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    t0 = []

    def mark(name):
        if name == "rollout":
            sync()
            prof.start()
            t0.append(time.perf_counter())
    runner.train_step(rs, mark=mark)
    sync()
    wall_ms = (time.perf_counter() - t0[0]) * 1e3
    prof.stop()
    kernels = _kernels(prof)
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    calls = {e.key: [e.count, e.cpu_time_total / 1e3]
             for e in prof.key_averages()
             if any(w in e.key for w in ("all_reduce", "allreduce",
                                         "all_gather", "allgather",
                                         "broadcast"))}
    return {"wall_ms": wall_ms,
            "device_busy_ms": sum(_device_us(e) for e in kernels) / 1e3,
            "launches": sum(e.count for e in kernels),
            "nccl_device_ms": sum(_device_us(e) for e in nccl) / 1e3,
            "nccl_launches": sum(e.count for e in nccl),
            "collective_calls_host_ms": calls}


JOBS = {"step": run_step, "curriculum": run_curriculum,
        "resume": run_resume, "train": run_train, "dryrun": run_dryrun}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--job", required=True)
    p.add_argument("--out", required=True,
                   help="this rank writes OUT.rank<R>")
    p.add_argument("--backend", default=None, choices=[None, "gloo", "nccl"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--coordinator", default=None, help="host:port")
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds a collective may wait")
    p.add_argument("--threads", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    device = mesh_lib.initialize_multihost(
        args.coordinator, args.world, args.rank, device=args.device,
        backend=args.backend, timeout_s=args.timeout)
    try:
        jobs = torch.load(args.job, weights_only=True)["jobs"]
        results = [JOBS[j["kind"]](j, device,
                                   mesh_lib.make_mesh(j["num_envs"], device))
                   for j in jobs]
        rank = torch.distributed.get_rank()
        tmp = f"{args.out}.rank{rank}.tmp"
        torch.save(results, tmp)
        os.replace(tmp, f"{args.out}.rank{rank}")
    finally:
        mesh_lib.shutdown()


if __name__ == "__main__":
    main()
