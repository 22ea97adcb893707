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
  rollout's end (GAE, update, metrics: every collective of it; with the
  launches whose kernel its trace lacks; the window opens after a lead-in,
  `profile_rollout.open_window`).
* "dryrun": the graft dry run (graft_entry.dryrun_multichip): the runner
  of the job's config, `init_runner_state(0)` and the compiled step
  (`mesh.make_sharded_train_step`) called twice: one iteration (on the card
  under NCCL the eager warm-up, then the capture) and one more (a replay);
  the result holds the first call's metrics, the patch kernel's launches,
  whether the step was a graph, and whether every metric is finite.
* "graph": the compiled step against eager `train_step`s from one state
  (the registry's task at `num_envs` global envs, from random episode
  lengths, seeded by the task's seed), with deterministic algorithms on:
  `iterations` K eager iterations, then K of the compiled step (under
  NCCL on a card the warm-up, the capture and K - 1 replays; else K eager
  calls of the in-place step). The result holds both ends (parameters,
  Adam states, learning rates, the RunnerState with its generators, the
  stacked metrics; `end_state`), the mode, the captures, the patch launches of
  warm-up, capture and replays, capture s and pool bytes; with "timed" n,
  n eager (deterministic algorithms off) / compiled (as captured, with
  them on) pairs alternating (host ms ending in a synchronize, the device
  ms of each compiled call by CUDA events), the update's
  gathers (shapes, bytes, device ms of one by CUDA events) and the NCCL
  and memcpy rows of one profiled compiled call (with the launches whose
  kernel its trace lacks; the window opens after one more compiled call as
  its lead-in, `profile_rollout.window`); with "learn" n, `learn`
  of n iterations on the same runner (saving under "log_root" if given)
  and rank 0's logged metrics; "seconds" times each part. With "no_mesh"
  the rank runs all of it on one process's runner of the `num_envs` envs
  (no collectives).
* "learn": `learn` of `iterations` iterations from a global state and
  train state (as "step"), the act noise of each iteration injected; the
  result holds rank 0's logged metrics, the final parameters and the
  train mode.
* "host_reads": two `train_step`s of the task, the second under the
  capture-safety sentinel (`utils.graphs.HostReads`); the result holds
  what it recorded.

A job's config is the task's with `num_envs` global envs, `steps` per
iteration, `terrain` "parity" (card_check.parity_cfg's 3 x 9 sub-terrains),
"dryrun" (2 x 9 sub-terrains, a 2 m border: __graft_entry__.py:50-53),
"plane" or "flagship", `randomness` False for DR, pushes, the action
delay and observation noise off, `curriculum` True for the command
curriculum on, and `mini_batches` the update's minibatch count. The tests
(tests/test_torch_distributed.py, tests/test_torch_mesh_graph.py) and
chip_smoke.py spawn this module.
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
from go2_rl_gym_tpu_torch.utils import graphs, registry, spans


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
    if job.get("mini_batches"):
        tc.algorithm.num_mini_batches = job["mini_batches"]
    return env_cfg, tc


def build(job, device, mesh=None):
    """The job's runner on `device`, a rank's of `mesh` if given."""
    env_cfg, tc = job_cfgs(job)
    env = registry.make_env(job["task"], env_cfg,
                            num_steps_per_env=tc.runner.num_steps_per_env,
                            device=device, mesh=mesh)
    return registry.make_runner(job["task"], env, tc, device=device,
                                log_root=job.get("log_root"))


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


def _reset_launches():
    for k in terrain_patches.LAUNCHES:
        terrain_patches.LAUNCHES[k] = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _metrics(runner, vec):
    """A compiled step's (T,) metric vector as a dict of CPU tensors."""
    offs = [0]
    for n in runner.metric_sizes:
        offs.append(offs[-1] + n)
    vec = vec.detach().cpu()
    return {k: vec[offs[i]] if runner.metric_sizes[i] == 1
            else vec[offs[i]:offs[i + 1]].clone()
            for i, k in enumerate(runner.metric_keys)}


def run_dryrun(job, device, mesh=None):
    runner = build(job, device, mesh)
    rs = runner.init_runner_state(0)
    _reset_launches()
    step = mesh_lib.make_sharded_train_step(runner, mesh, rs)
    first = step().clone()
    again = step().clone()
    _sync(runner.device)
    metrics = _metrics(runner, first)
    return {"metrics": metrics, "launches": dict(terrain_patches.LAUNCHES),
            "graphed": isinstance(step, graphs.StepGraph),
            "mode": runner.train_mode(),
            "finite": all(bool(torch.isfinite(v).all())
                          for v in metrics.values())
            and bool(torch.isfinite(again).all())}


# the algorithms' train state besides the parameters: PPO's or CTS's
TRAIN_STATE = ("opt", "opt1", "opt2", "lr", "lr2")


def end_state(runner, rs, rows):
    """A run's end on the CPU by category: "params", "adam" (moments and
    counts), "lr", "runner_state" (the RunnerState's tensors),
    "generators" (their states) and "metrics" (the stacked (K, T) metric
    vectors)."""
    alg = runner.alg
    out = {"params": _params(runner), "adam": {}, "lr": {},
           "runner_state": {}, "generators": {}}
    for n in (n for n in TRAIN_STATE if hasattr(alg, n)):
        for path, x in graphs.leaves(getattr(alg, n)):
            key = ".".join(map(str, (n,) + path))
            out["lr" if n.startswith("lr") else "adam"][key] = x.cpu().clone()
    for path, x in graphs.leaves(rs):
        key = ".".join(map(str, path))
        if isinstance(x, torch.Generator):
            out["generators"][key] = x.get_state()
        else:
            out["runner_state"][key] = x.cpu().clone()
    out["metrics"] = {"stacked": torch.stack(rows).cpu()}
    return out


def run_graph(job, device, mesh=None):
    if job.get("no_mesh"):
        mesh = None
    runner = build(job, device, mesh)
    alg, k = runner.alg, job.get("iterations", 3)
    rs0 = graphs.copy_tree(runner.init_runner_state(
        job.get("seed", runner.cfg.seed), init_at_random_ep_len=True))
    params0 = {n: p.detach().clone() for n, p in alg.model.named_parameters()}
    owned0 = {n: graphs.copy_tree(getattr(alg, n)) for n in TRAIN_STATE
              if hasattr(alg, n)}

    def restore():
        with torch.no_grad():
            for n, p in alg.model.named_parameters():
                p.copy_(params0[n])
        for n, v in owned0.items():
            graphs.assign(getattr(alg, n), v)
        return graphs.copy_tree(rs0)

    def flat_metrics(m):
        return graphs.flat_metrics(graphs.metric_layout(m)[0])(m)

    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        rs, rows = restore(), []
        for _ in range(k):
            rs, m = runner.train_step(rs)
            rows.append(flat_metrics(m))
        _sync(runner.device)
        eager = end_state(runner, rs, rows)
        seconds = {"eager": lap()}

        step = mesh_lib.make_sharded_train_step(runner, mesh,
                                                restore())
        graphed = isinstance(step, graphs.StepGraph)
        _reset_launches()
        if graphed:
            rows = [step._warm_up().clone()]
            warm = terrain_patches.LAUNCHES["extract_patches"]
            _reset_launches()
            step._capture()
            captured = terrain_patches.LAUNCHES["extract_patches"]
        else:
            rows, warm, captured = [], 0, 0
        _reset_launches()
        while len(rows) < k:
            rows.append(step().clone())
        _sync(runner.device)
        replayed = terrain_patches.LAUNCHES["extract_patches"]
        compiled = end_state(runner, step.state, rows)
        seconds["compiled"] = lap()
    finally:
        torch.use_deterministic_algorithms(False)
    out = {"mode": runner.train_mode(), "graphed": graphed,
           "eager": eager, "compiled": compiled,
           "launches": {"warm_up": warm, "capture": captured,
                        "replays": replayed},
           "captures": getattr(step, "captures", 0),
           "capture_s": getattr(step, "capture_s", float("nan")),
           "pool_bytes": getattr(step, "pool_bytes", 0),
           "local_envs": runner.env.num_envs,
           "steps": runner.num_steps}
    if job.get("timed"):
        out.update(_time_compiled(runner, step, job["timed"], mesh))
        seconds["timed"] = lap()
    if job.get("learn"):
        out["learn"] = _learn(runner, step.state, job["learn"])
        seconds["learn"] = lap()
    out["seconds"] = seconds
    return out


def _time_compiled(runner, step, pairs, mesh):
    """Eager train_steps (deterministic algorithms off) and calls of the
    compiled step (its graph captured with them on) alternating on the
    runner, the update's gathers timed alone, and one compiled call under
    torch.profiler (`profile_rollout.window`, one more call as its
    lead-in)."""
    from go2_rl_gym_tpu_torch.tools.profile_rollout import (
        _device_us, _kernels, launches_without_kernel, window)
    dev = runner.device
    cuda = dev.type == "cuda"
    rs = graphs.copy_tree(step.state)
    times = {"eager_ms": [], "compiled_ms": [], "compiled_device_ms": []}
    for _ in range(pairs):
        _sync(dev)
        t = time.perf_counter()
        rs, _ = runner.train_step(rs)
        _sync(dev)
        times["eager_ms"].append((time.perf_counter() - t) * 1e3)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        if cuda:
            start.record()
        step()
        if cuda:
            end.record()
        _sync(dev)
        times["compiled_ms"].append((time.perf_counter() - t) * 1e3)
        if cuda:
            times["compiled_device_ms"].append(start.elapsed_time(end))

    # the update's gathers: their shapes in one eager iteration, then each
    # timed alone on a buffer of that shape
    shapes, gather = [], mesh_lib.gather_samples

    def spy(mesh_, x):
        shapes.append(tuple(x.shape))
        return gather(mesh_, x)
    mesh_lib.gather_samples = spy
    try:
        runner.train_step(rs)
    finally:
        mesh_lib.gather_samples = gather
    gathers = []
    for shape in shapes:
        x = torch.zeros(shape, device=dev)
        y = gather(mesh, x)
        ms = float("nan")
        if cuda:
            _sync(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                gather(mesh, x)
            end.record()
            _sync(dev)
            ms = start.elapsed_time(end) / 5
        gathers.append({"shape": list(shape),
                        "bytes": y.numel() * y.element_size(),
                        "device_ms": ms})
        del x, y

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def lead_in():
        step()
        _sync(dev)
    with window(acts, lead_in) as prof:
        step()
        _sync(dev)
    kernels = _kernels(prof)
    rows = [[e.key, e.count, _device_us(e) / 1e3] for e in kernels
            if "nccl" in e.key.lower() or "memcpy" in e.key.lower()]
    return {"times": times, "gathers": gathers, "profiled": {
        "launches": sum(e.count for e in kernels),
        "device_ms": sum(_device_us(e) for e in kernels) / 1e3,
        "lost_launches": len(launches_without_kernel(prof.events())),
        "nccl_or_memcpy": rows}}


class _Scalars:
    """A metrics sink for `learn` that keeps what it logs: tag -> {step:
    value}."""

    def __init__(self):
        self.logged = {}

    def add_scalar(self, tag, value, step):
        self.logged.setdefault(tag, {})[int(step)] = float(value)

    def flush(self):
        pass


def _learn(runner, rs, iterations):
    """`learn` with rank 0's logged scalars kept (`_Scalars`); returns them
    without the per-chunk timings (Perf/*), {} on the other ranks."""
    if runner.is_main:
        runner.writer = _Scalars()
    runner.learn(rs, iterations)
    if not runner.is_main:
        return {}
    return {k: v for k, v in runner.writer.logged.items()
            if not k.startswith("Perf/")}


def run_learn(job, device, mesh=None):
    runner = build(job, device, mesh)
    template = runner.init_runner_state(0)
    runner.alg.load_train_state_dict(job["train_state"])
    rs = _global_to_rank(template, job["state"], device, mesh)
    noise = iter(job["noise"])
    train_step = runner.train_step

    def injected(r, **kwargs):
        n = next(noise).to(device)
        if mesh is not None:
            n = n[:, mesh.env_slice]
        return train_step(r, noise=n, **kwargs)
    runner.train_step = injected
    return {"logged": _learn(runner, rs, job["iterations"]),
            "params": _params(runner), "mode": runner.train_mode()}


def run_host_reads(job, device, mesh=None):
    runner = build(job, device, mesh)
    rs = runner.init_runner_state(0, init_at_random_ep_len=True)
    rs, _ = runner.train_step(rs)           # the first fills lazy caches
    mode = graphs.HostReads()
    with mode:
        runner.train_step(rs)
    return {"hits": mode.hits}


def _profile_iteration(runner, rs, sync):
    """One more train iteration with torch.profiler on from the rollout's
    end (GAE, the update and the metrics: every collective of the
    iteration, without the rollout's ~180k launches; the window opens at
    the end of the `rollout` span, which a span listener sees, after a
    small kernel as its lead-in, `open_window`, and the
    wall clock starts after its pad): its wall time, the
    device's busy time and launches, the NCCL kernels among them, and the
    host time of the collective calls by name, and the launches whose
    kernel the trace lacks."""
    from go2_rl_gym_tpu_torch.tools.profile_rollout import (
        _device_us, _kernels, launches_without_kernel, lead_in_on,
        open_window)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    t0 = []

    def mark(name, kind):
        if (name, kind) == ("rollout", spans.END):
            sync()
            open_window(prof, lead_in_on(runner.device))
            t0.append(time.perf_counter())
    with spans.recording(runner.device), spans.listen(mark):
        runner.train_step(rs)
    sync()
    wall_ms = (time.perf_counter() - t0[0]) * 1e3
    prof.stop_trace()
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
            "lost_launches": len(launches_without_kernel(prof.events())),
            "nccl_device_ms": sum(_device_us(e) for e in nccl) / 1e3,
            "nccl_launches": sum(e.count for e in nccl),
            "collective_calls_host_ms": calls}


JOBS = {"step": run_step, "curriculum": run_curriculum,
        "resume": run_resume, "train": run_train, "dryrun": run_dryrun,
        "graph": run_graph, "learn": run_learn, "host_reads": run_host_reads}


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
