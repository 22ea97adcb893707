"""On-policy runner for PPO, recurrent PPO and the six CTS algorithms
(PyTorch port of go2_rl_gym_tpu/train/runner.py).

Counterpart of reference rsl_rl/runners/on_policy_runner.py:60-309 and
on_policy_runner_cts.py:63-355; `train_cfg.runner.algorithm_class_name`
selects the algorithm (JAX runner.py:65-84): "PPO" (agents/ppo.py),
"RecurrentPPO" (agents/recurrent_ppo.py), else a CTS variant
(agents/cts.py). One train iteration (`train_step`) is the 24-step rollout
(with the student's obs-history buffer for CTS, the RNN memory for
recurrent PPO), GAE, and the update; `learn` loops over iterations on the
host, logs, checkpoints, and (with `eval_interval`) exports the policy and
scores it in MuJoCo in the background.

Where the state lives: everything the env and the rollout carry is in
`RunnerState`; the train state (the model's parameters, the Adam states,
the adaptive learning rate) lives in the runner's algorithm object
(`runner.alg`), whose parameters are updated in place. `save` writes both,
so `load` resumes exactly.

Data-parallel training (`attach_mesh`, distributed/mesh.py): each rank runs
this runner on its shard of the global env batch; the parameters start from
rank 0's and stay equal on every rank, an iteration's metrics are
all-reduced once, and a checkpoint holds the global batch in global env
order plus every rank's generator states.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import yaml

from go2_rl_gym_tpu_torch.agents import common
from go2_rl_gym_tpu_torch.agents import cts as cts_lib
from go2_rl_gym_tpu_torch.agents import ppo as ppo_lib
from go2_rl_gym_tpu_torch.agents import recurrent_ppo
from go2_rl_gym_tpu_torch.agents.networks import init_params
from go2_rl_gym_tpu_torch.device import resolve_device
from go2_rl_gym_tpu_torch.distributed import mesh as mesh_lib
from go2_rl_gym_tpu_torch.env.config import TrainCfg
from go2_rl_gym_tpu_torch.env.go2_env import EnvState, Go2Env
from go2_rl_gym_tpu_torch.export import exporter
from go2_rl_gym_tpu_torch.train.eval_hook import AsyncEvaluator
from go2_rl_gym_tpu_torch.train.metrics import MetricsWriter
from go2_rl_gym_tpu_torch.utils import graphs, spans


class RunnerState(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor
    priv_obs: torch.Tensor
    history: torch.Tensor            # (N, L, num_obs); L = 1 if not CTS
    gen: torch.Generator             # action noise (this rank's)
    # episode bookkeeping (reference on_policy_runner.py:142-143)
    cur_reward_sum: torch.Tensor     # (N,)
    cur_episode_length: torch.Tensor  # (N,)
    # recurrent PPO's RNN memory (recurrent_ppo.Memory); () for the others
    memory: Any = ()
    # the update's shuffle: the same state on every rank of a mesh
    perm_gen: Optional[torch.Generator] = None


class Rollout(NamedTuple):
    traj: NamedTuple                 # stacked (T, N, ...) Transition
    last_values: torch.Tensor        # (N,) value of the state after step T
    # CTS: [teacher reward sum, teacher length sum, teacher episodes,
    #       student reward sum, student length sum, student episodes];
    # PPO and recurrent PPO: [reward sum, length sum, episodes]
    ep_stats: torch.Tensor           # (6,) or (3,) over episodes ended
    metrics: Dict[str, torch.Tensor]  # env metrics, (T,) per name


# metrics that are the same on every rank, left out of an iteration's sum
REPLICATED_METRICS = frozenset({"learning_rate", "mean_noise_std",
                                "max_command_x"})


def _split_seed(seed: int, n: int):
    g = torch.Generator()
    g.manual_seed(seed)
    return [int(s) for s in torch.randint(0, 2 ** 62, (n,), generator=g)]


def _rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator of a stream seeded `seed`; rank 0
    keeps `seed`, so that one rank draws as one process does."""
    return (seed + rank * 0x9E3779B97F4A7C15) % 2 ** 63


def _pack(tree):
    """A RunnerState as nested dicts of tensors (torch.save-able with
    weights_only): generators become their states, NamedTuples dicts."""
    if isinstance(tree, torch.Generator):
        return {"generator_state": tree.get_state()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _pack(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    return tree


def _unpack(template, data, device):
    """Inverse of `_pack`, shaped by `template` (a RunnerState of the same
    runner); generators are made anew on their template's device."""
    if isinstance(template, torch.Generator):
        g = torch.Generator(device=template.device)
        g.set_state(data["generator_state"])
        return g
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        def field(k, v):
            # a field may be missing only where the template holds an empty
            # tuple: RunnerState.memory of a run saved before it existed
            if k not in data and isinstance(v, tuple) and not v:
                return ()
            return data[k]
        return type(template)(*[_unpack(v, field(k, v), device)
                                for k, v in zip(template._fields, template)])
    if isinstance(template, tuple):
        if len(template) != len(data):
            raise ValueError(f"checkpoint holds {len(data)} entries where "
                             f"{len(template)} are expected")
        return tuple(_unpack(t, d, device) for t, d in zip(template, data))
    if isinstance(template, dict):
        return {k: _unpack(template[k], data[k], device) for k in template}
    return data.to(device)


class OnPolicyRunner:
    """Runner for PPO, recurrent PPO and the six CTS variants (selected by
    train_cfg.runner.algorithm_class_name).

    `device` defaults to the card and must be the env's device. With a
    `log_dir`, `learn` writes metrics and checkpoints there (rank 0's only,
    under a mesh). With a `log_dir` and an `eval_interval`, rank 0 exports
    the policy every `eval_interval` iterations and scores it in MuJoCo in
    the background (`train/eval_hook.py`, CTS algorithms only, as in the JAX
    package). An env that is a rank's shard (`Go2Env(mesh=...)`) makes the
    runner data-parallel over its mesh (`attach_mesh`)."""

    def __init__(self, env: Go2Env, train_cfg: TrainCfg,
                 log_dir: Optional[str] = None, device="cuda",
                 eval_interval: int = 0,
                 eval_scenes=("flat", "stairs", "cross_slope")):
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env lives on {env.device}, runner on "
                             f"{self.device}")
        self.env = env
        self.cfg = train_cfg
        self.log_dir = log_dir
        # async sim2sim eval (RoboGauge counterpart); 0 = disabled
        self.eval_interval = eval_interval
        self.num_steps = train_cfg.runner.num_steps_per_env
        self.save_interval = train_cfg.runner.save_interval
        alg_name = train_cfg.runner.algorithm_class_name
        self.is_recurrent = alg_name == "RecurrentPPO"
        self.is_cts = alg_name not in ("PPO", "RecurrentPPO")
        self.history_length = train_cfg.history_length if self.is_cts else 1
        num_critic_obs = env.num_privileged_obs or env.num_obs
        if self.is_cts:
            self.alg = cts_lib.CTS(
                alg_name, env.num_obs, num_critic_obs, env.num_actions,
                env.num_envs_global, train_cfg.history_length,
                train_cfg.policy, train_cfg.algorithm, device=self.device)
        else:
            cls = (recurrent_ppo.RecurrentPPO if self.is_recurrent
                   else ppo_lib.PPO)
            self.alg = cls(env.num_obs, num_critic_obs, env.num_actions,
                           train_cfg.policy, train_cfg.algorithm,
                           device=self.device)
        self.current_iteration = 0
        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.mesh: Optional[mesh_lib.Mesh] = None
        self.is_main = env.mesh is None or env.mesh.rank == 0
        self.writer = MetricsWriter(log_dir) if log_dir and self.is_main \
            else None
        if log_dir and self.is_main:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "config.yaml"), "w") as f:
                yaml.safe_dump({
                    "train_cfg": dataclasses.asdict(train_cfg),
                    "env_cfg": dataclasses.asdict(env.cfg),
                }, f)
        if env.mesh is not None:
            self.attach_mesh(env.mesh)
        self.evaluator = None
        if eval_interval and log_dir and self.is_main:
            self.evaluator = AsyncEvaluator(log_dir, scenes=eval_scenes)
        # learn's execution (train_mode, compiled_step): with debug_nans,
        # eagerly under anomaly detection, checked for non-finite values
        self.debug_nans = False
        self._compiled = None
        self._mode_printed = False
        self.metric_keys = self.metric_sizes = None

    def attach_mesh(self, mesh: mesh_lib.Mesh):
        """Switch to data-parallel execution as rank `mesh.rank` (JAX
        runner.py:101-119): the env becomes this rank's shard of the global
        batch, the algorithm takes this rank's members of every global
        minibatch, and `train_step` all-reduces the gradients and the
        metrics. Every rank calls it with its own mesh of one process group,
        before `init_runner_state`, which then builds this rank's shard
        (`mesh_lib.shard_runner_state` cuts a global RunnerState to it)."""
        if mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the "
                             f"runner on {self.device}")
        if self.env.mesh is not mesh:
            self.env.attach_mesh(mesh)
        self.alg.attach_mesh(mesh)
        self.mesh = mesh
        self.is_main = mesh.rank == 0

    def init_runner_state(self, seed: int = 0,
                          init_at_random_ep_len=False) -> RunnerState:
        """Seeded env state, policy weights (with a fresh train state), noise
        and shuffle generators, then the first observation via a
        zero-action step (reference BaseTask.reset, base_task.py:72-77).

        Under a mesh: the weights are rank 0's (broadcast), the env and the
        act noise draw from generators seeded by (seed, rank), and the
        shuffle generator is seeded alike on every rank."""
        env = self.env
        N = env.num_envs
        rank = self.mesh.rank if self.mesh else 0
        s_env, s_alg, s_run, s_perm = _split_seed(seed, 4)
        alg_gen = torch.Generator(device=self.device)
        alg_gen.manual_seed(s_alg)
        init_params(self.alg.model, alg_gen)
        with torch.no_grad():
            mesh_lib.broadcast_(self.mesh, list(self.alg.model.parameters()))
        self.alg.reset_train_state()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_rank_seed(s_run, rank))
        perm_gen = torch.Generator(device=self.device)
        perm_gen.manual_seed(s_perm)

        with torch.no_grad():
            env_state = env.init_state(_rank_seed(s_env, rank))
            if init_at_random_ep_len:
                # reference on_policy_runner.py:127-128
                rand_len = torch.randint(
                    0, env.max_episode_length, (N,), generator=gen,
                    device=self.device, dtype=torch.int32)
                env_state = env_state._replace(episode_length=rand_len)
            env_state, out = env.step(
                env_state, torch.zeros((N, env.num_actions), device=self.device))
            history = torch.zeros((N, self.history_length, env.num_obs),
                                  device=self.device)
            history = torch.cat([history[:, 1:], out.obs[:, None]], dim=1)
        return RunnerState(
            env_state=env_state, obs=out.obs, priv_obs=out.privileged_obs,
            history=history, gen=gen,
            cur_reward_sum=torch.zeros(N, device=self.device),
            cur_episode_length=torch.zeros(N, device=self.device),
            memory=self.alg.zero_memory(N) if self.is_recurrent else (),
            perm_gen=perm_gen)

    # ------------------------------------------------------------------

    def act(self, obs, priv, history, memory, gen=None, noise=None):
        """One policy step of the runner's algorithm on the obs, privileged
        obs, obs history (N, L, num_obs) and RNN memory (() unless
        recurrent). Returns (actions, values, logp, mu, std, new memory)."""
        if self.is_recurrent:
            return self.alg.act(obs, priv, memory, gen=gen, noise=noise)
        if self.is_cts:
            out = self.alg.act(obs, priv, history.reshape(len(obs), -1),
                               gen=gen, noise=noise)
        else:
            out = self.alg.act(obs, priv, gen=gen, noise=noise)
        return (*out, memory)

    def value(self, obs, priv, history, memory):
        """The value of the runner's algorithm on the same inputs as act."""
        if self.is_recurrent:
            return self.alg.value(priv, memory)
        if self.is_cts:
            return self.alg.value(obs, priv, history.reshape(len(obs), -1))
        return self.alg.value(priv)

    @torch.no_grad()
    def rollout(self, rs: RunnerState,
                noise: Optional[torch.Tensor] = None):
        """num_steps_per_env policy steps (JAX runner.py:192-262). `noise`
        (T, N, A), if given, replaces the standard-normal action noise drawn
        from rs.gen. Returns (RunnerState after the rollout, Rollout)."""
        env, alg = self.env, self.alg
        gamma = self.cfg.algorithm.gamma
        N = env.num_envs
        if self.is_cts:
            is_student = alg.is_student.to(torch.float32)
        obs, priv, history = rs.obs, rs.priv_obs, rs.history
        env_state, mem = rs.env_state, rs.memory
        rew_sum, ep_len = rs.cur_reward_sum, rs.cur_episode_length
        steps, ep_stats, metrics = [], [], []
        for t in range(self.num_steps):
            hist_flat = history.reshape(N, -1)
            with spans.span("act"):
                actions, values, logp, mu, std, mem = self.act(
                    obs, priv, history, mem, gen=rs.gen,
                    noise=None if noise is None else noise[t])
            with spans.span("env"):
                env_state, out = env.step(env_state, actions)
            if self.is_recurrent:
                mem = alg.reset_memory(mem, out.done)
            rewards = alg.process_rewards(out.rew, values, out.time_outs, gamma)
            if self.is_cts:
                steps.append(cts_lib.Transition(
                    obs=obs, critic_obs=priv, history=hist_flat,
                    actions=actions, rewards=rewards, dones=out.done,
                    values=values, log_probs=logp, mu=mu, sigma=std))
            else:
                steps.append(ppo_lib.Transition(
                    obs=obs, critic_obs=priv, actions=actions,
                    rewards=rewards, dones=out.done, values=values,
                    log_probs=logp, mu=mu, sigma=std))
            # history: zero on done, then append the new obs
            # (on_policy_runner_cts.py:155-156)
            history = torch.where(out.done[:, None, None], 0.0, history)
            history = torch.cat([history[:, 1:], out.obs[:, None]], dim=1)
            # episode statistics
            rew_sum = rew_sum + out.rew
            ep_len = ep_len + 1.0
            done_f = out.done.to(torch.float32)
            if self.is_cts:
                sd = done_f * is_student
                td = done_f * (1.0 - is_student)
                ep_stats.append(torch.stack([
                    torch.sum(rew_sum * td), torch.sum(ep_len * td),
                    torch.sum(td), torch.sum(rew_sum * sd),
                    torch.sum(ep_len * sd), torch.sum(sd)]))
            else:
                ep_stats.append(torch.stack([
                    torch.sum(rew_sum * done_f), torch.sum(ep_len * done_f),
                    torch.sum(done_f)]))
            rew_sum = rew_sum * (1.0 - done_f)
            ep_len = ep_len * (1.0 - done_f)
            obs, priv = out.obs, out.privileged_obs
            metrics.append(out.metrics)

        # recurrent: from the memory after the last step's reset
        last_values = self.value(obs, priv, history, mem)
        traj = type(steps[0])(*[torch.stack(xs) for xs in zip(*steps)])
        new_rs = rs._replace(env_state=env_state, obs=obs, priv_obs=priv,
                             history=history, cur_reward_sum=rew_sum,
                             cur_episode_length=ep_len, memory=mem)
        return new_rs, Rollout(
            traj=traj, last_values=last_values,
            ep_stats=torch.stack(ep_stats).sum(dim=0),
            metrics={k: torch.stack([m[k] for m in metrics])
                     for k in metrics[0]})

    def train_step(self, rs: RunnerState,
                   noise: Optional[torch.Tensor] = None, perms=None):
        """One train iteration: rollout, GAE, update (JAX runner.py:182-295).

        `noise` is passed to `rollout` (drawn from rs.gen when not given)
        and `perms` to the algorithm's `update` (drawn from rs.perm_gen when
        not given); recurrent PPO's update replays from the rollout-start
        memory. The iteration is the span `train_step`, and its phases the
        spans `rollout`, `gae` and `update` (utils/spans.py: stamped on the
        device while a recorder is on; `spans.listen` sees their edges).
        Returns (RunnerState, metrics as tensors on the device): env
        metrics, `rew_*` and `done_count` summed over the rollout and the
        others averaged, `ep_stats` summed, the update's losses and
        learning rate, and `mean_noise_std` where the model has a `std`
        parameter. Under a mesh the metrics are the global batch's,
        all-reduced once."""
        with spans.span("train_step"):
            mem0 = rs.memory        # rollout-start RNN memory for the replay
            with spans.span("rollout"):
                rs, ro = self.rollout(rs, noise)
            traj = ro.traj
            cfg = self.cfg.algorithm
            with spans.span("gae"):
                returns, advantages = common.compute_gae(
                    traj.rewards, traj.values, traj.dones, ro.last_values,
                    cfg.gamma, cfg.lam, self.mesh)
            with spans.span("update"):
                if self.is_recurrent:
                    loss_metrics = self.alg.update(traj, returns, advantages,
                                                   mem0, gen=rs.perm_gen,
                                                   perms=perms)
                else:
                    loss_metrics = self.alg.update(traj, returns, advantages,
                                                   gen=rs.perm_gen,
                                                   perms=perms)

            agg = {}
            for name, vals in ro.metrics.items():
                if name.startswith("rew_") or name == "done_count":
                    agg[name] = torch.sum(vals, dim=0)
                elif self.mesh is not None and vals.dim() == 2:
                    agg[name] = vals     # per-step (sum, count) pairs
                else:
                    agg[name] = torch.mean(vals, dim=0)
            agg["ep_stats"] = ro.ep_stats
            agg.update(loss_metrics)
            if hasattr(self.alg.model, "std"):
                agg["mean_noise_std"] = torch.mean(
                    self.alg.model.std.detach())
            if self.mesh is not None:
                agg = self._global_metrics(agg)
            return rs, agg

    def _global_metrics(self, agg):
        """The ranks' metrics summed in one all_reduce (the replicated ones
        kept); the env's per-type (sum, count) pairs are divided per step,
        then averaged over the rollout."""
        names = [k for k in agg if k not in REPLICATED_METRICS]
        reduced = mesh_lib.all_reduce(self.mesh, [agg[k] for k in names])
        agg = {**agg, **dict(zip(names, reduced))}
        pairs = {k: v for k, v in agg.items() if v.dim() == 2}
        agg.update({k: torch.mean(v, dim=0)
                    for k, v in self.env.finish_metrics(pairs).items()})
        return agg

    # ------------------------------------------------------------------

    def train_mode(self):
        """How `learn` runs the train step: ("graph", why) on the card,
        where one CUDA graph of the iteration is captured and replayed
        (utils/graphs.py), under a mesh too when its process group is NCCL
        (one graph per rank, its collectives captured); else ("eager",
        why): under a gloo mesh (gloo's collectives run on the host and
        cannot be captured), on the CPU, or with `debug_nans`."""
        if self.debug_nans:
            return "eager", ("debug_nans: anomaly detection, checked per "
                             "iteration")
        if self.mesh is not None and dist.get_backend() != "nccl":
            return "eager", f"{dist.get_backend()} cannot be captured"
        if self.device.type != "cuda":
            return "eager", f"on {self.device}"
        if self.mesh is not None:
            return "graph", (f"one CUDA graph per iteration on "
                             f"{self.device}, rank {self.mesh.rank} of "
                             f"{self.mesh.world} over NCCL")
        return "graph", f"one CUDA graph per iteration on {self.device}"

    def compiled_step(self, rs: RunnerState):
        """The in-place train step on `rs`'s values: a callable that runs
        one iteration on fixed storage (its `step.state` holds the
        RunnerState) and returns the iteration's metrics as one (T,) f32
        vector in the JAX order (`metric_keys`, `metric_sizes`). Where
        `train_mode` says "graph" (on the card, without debug_nans, under an
        NCCL mesh too: the twin of `jax.jit(train_step, in_shardings=...)`,
        `mesh_lib.make_sharded_train_step`) it is a `graphs.StepGraph`: the
        first call runs eagerly (under the sync debug mode "error"),
        captures, and later calls replay; a failed capture raises. It is
        made once per runner and kept, and made anew only for a state of
        another structure, or where its graph was captured under another
        span recorder than the one on now (`spans.current()`: a graph's
        stamps write the ring of the recorder on at its capture, and a
        graph captured with none has no stamps); a later `rs` is loaded
        into its storage. The parameters, Adam states and learning rates
        are updated in place (`load` and `reset_train_state` write into
        them too), so they never move."""
        mode, _ = self.train_mode()
        made = self._compiled
        if made is None or made[0] != mode or not graphs.same_structure(
                made[1].state, rs) or (
                isinstance(made[2], graphs.StepGraph)
                and made[2].graph is not None
                and made[2].recorder is not spans.current()):
            def fn(r):
                r, m = self.train_step(r)
                if self.metric_keys is None:
                    self.metric_keys, self.metric_sizes = \
                        graphs.metric_layout(m)
                return r, graphs.flat_metrics(self.metric_keys)(m)
            inplace = graphs.InPlaceStep(fn, rs)
            run = inplace
            if mode == "graph":
                run = graphs.StepGraph(inplace, "train_step")
            self._compiled = made = (mode, inplace, run)
        _, inplace, run = made
        inplace.set_state(rs)
        return run

    def _check_finite(self, it, vec, state):
        """debug_nans: raise at an iteration whose metrics, runner state or
        parameters hold a non-finite value, naming it and them."""
        bad = []
        offs = np.cumsum([0] + self.metric_sizes)
        ok = torch.isfinite(vec).cpu().numpy()
        bad += [k for i, k in enumerate(self.metric_keys)
                if not ok[offs[i]:offs[i + 1]].all()]
        bad += ["state." + ".".join(map(str, p))
                for p, x in graphs.leaves(state)
                if isinstance(x, torch.Tensor) and x.is_floating_point()
                and not bool(torch.isfinite(x).all())]
        bad += [f"param.{k}" for k, p in self.alg.model.named_parameters()
                if not bool(torch.isfinite(p).all())]
        if bad:
            raise FloatingPointError(f"iteration {it}: non-finite {bad}")

    def learn(self, rs: RunnerState, num_iterations: int,
              log_every: int = 10, print_every: int = 50) -> RunnerState:
        """`num_iterations` train iterations from `current_iteration` (JAX
        runner.py:337-463): iterations run in chunks of min(log_every,
        num_iterations), each cut to end where a save or an eval is due, so
        that checkpoint names and eval iterations are those of one iteration
        at a time. On the card a chunk is replays of the iteration's CUDA
        graph (`compiled_step`; the first iteration of the runner is the
        eager warm-up, and capture executes nothing, so `learn` runs exactly
        `num_iterations` iterations), each writing its metrics into a row of
        one (chunk, T) buffer that is copied to pinned host memory once per
        chunk; the previous chunk's metrics are processed on the host while
        the current chunk runs, and `learn` blocks only at saves, evals and
        the end. `GO2_SYNC_TRAIN=1` runs one iteration per chunk and blocks
        after each. Under an NCCL mesh every rank replays its graph in the
        same chunks (the twin of the sharded `_jit_train_chunk`), rank 0
        logs, and saves, with their all_gathers, run eagerly between chunks
        on the same communicator. On the CPU, under a gloo mesh or with
        `debug_nans` the same loop runs the in-place step eagerly.

        Logs every `log_every` iterations (and the last), prints every
        `print_every`, saves model_<it>.pt after iteration <it> when <it> is
        a multiple of save_interval, and the final model_<end>.pt. With an
        evaluator (CTS only), exports jit_models/policy_jit_<it>.pt after
        iteration <it> when <it> is a multiple of eval_interval and after
        the last, submits each to the evaluator, logs its scores as Eval/*
        as they arrive, and waits up to 600 s for the outstanding ones at
        the end. Iteration times are per chunk, as in the JAX loop, with
        saves and exports left out. While a span recorder is on
        (utils/spans.py), each call of the step is the host span
        `learn.launch`, the ring of the device's stamps is copied to pinned
        memory beside each chunk's metrics, and each logged iteration also
        logs its spans as `Perf/phase/<span>_ms` (device ms; `env` without
        its physics, `uncovered` the iteration less its phases,
        `learn.launch` host ms). Returns a copy of the final state."""
        rewbuffer = deque(maxlen=100)
        lenbuffer = deque(maxlen=100)
        srewbuffer = deque(maxlen=100)
        slenbuffer = deque(maxlen=100)
        start_iter = self.current_iteration
        tot_iter = start_iter + num_iterations
        # GO2_SYNC_TRAIN=1: one iteration per chunk, blocking after each
        # (the JAX package's A/B instrument)
        sync_mode = os.environ.get("GO2_SYNC_TRAIN", "") == "1"
        chunk = 1 if sync_mode else max(1, min(log_every, num_iterations))
        mode, why = self.train_mode()
        if self.is_main and not self._mode_printed:
            print(f"learn: {mode} ({why})", flush=True)
            self._mode_printed = True
        step = self.compiled_step(rs)
        state = step.state
        pinned = self.device.type == "cuda"
        rec = spans.current()

        def launch():
            with spans.host("learn.launch"):
                return step()

        def run_chunk(first_it, c):
            """Enqueue `c` iterations; returns their (c, T) metrics in host
            memory (pinned, filled asynchronously), the event after which
            they are there, and with a span recorder on, the copy of its
            ring and the chunk's host ms in `learn.launch`."""
            mat = None
            for j in range(c):
                if self.debug_nans:
                    try:
                        with torch.autograd.set_detect_anomaly(True):
                            vec = launch()
                    except RuntimeError as e:
                        raise FloatingPointError(
                            f"iteration {first_it + j}: {e}") from e
                    self._check_finite(first_it + j, vec, state)
                else:
                    vec = launch()
                if mat is None:
                    mat = torch.empty((c, vec.numel()), device=vec.device)
                mat[j].copy_(vec)
            stamps = None if rec is None else \
                (rec.copy(), rec.host_ms("learn.launch", c))
            if not pinned:
                return mat.numpy(), None, stamps
            host = torch.empty(mat.shape, pin_memory=True)
            host.copy_(mat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done, stamps

        t_window = time.time()

        def _process(first_it, c, host, done, stamps):
            """Wait for one chunk's metrics and run the per-iteration
            stats / log / print bookkeeping."""
            nonlocal t_window
            if done is not None:
                done.synchronize()
                host = host.numpy()
            phases = [None] * c
            if stamps is not None:
                # the chunk's last iterations, where the ring held fewer
                got = rec.iterations(stamps[0], c)
                phases[c - len(got):] = got
                for j, ms in zip(range(c - len(stamps[1]), c), stamps[1]):
                    phases[j] = dict(phases[j] or {}, **{"learn.launch": ms})
            now = time.time()
            dt_iter = (now - t_window) / c
            self.tot_time += now - t_window
            t_window = now
            sizes = self.metric_sizes
            offs = np.cumsum([0] + sizes)
            for j in range(c):
                pit = first_it + j
                row = host[j]
                pmetrics = {k: row[offs[i]] if sizes[i] == 1
                            else row[offs[i]:offs[i + 1]]
                            for i, k in enumerate(self.metric_keys)}
                ep = pmetrics.pop("ep_stats")
                if ep[2] > 0:
                    rewbuffer.append(ep[0] / ep[2])
                    lenbuffer.append(ep[1] / ep[2])
                if self.is_cts and ep[5] > 0:
                    srewbuffer.append(ep[3] / ep[5])
                    slenbuffer.append(ep[4] / ep[5])
                if self.writer and (pit % log_every == 0
                                    or pit == tot_iter - 1):
                    self._log(pit, dict(pmetrics), dt_iter, rewbuffer,
                              lenbuffer, srewbuffer, slenbuffer, phases[j])
                if self.is_main and pit % print_every == 0:
                    fps = int(self.num_steps * self.env.num_envs_global
                              / dt_iter)
                    mr = np.mean(rewbuffer) if rewbuffer else float("nan")
                    print(
                        f"it {pit}/{tot_iter} | {fps} steps/s | "
                        f"mean_rew {mr:.3f} | "
                        f"vloss {float(pmetrics.get('value_loss', 0)):.4f} | "
                        f"surr "
                        f"{float(pmetrics.get('surrogate_loss', 0)):.4f}",
                        flush=True)

        do_save = bool(self.log_dir and self.save_interval)
        do_eval = bool(self.evaluator is not None and self.is_cts
                       and self.eval_interval)

        def _next_boundary(i):
            """The earliest iteration >= i after which a save or an eval is
            due: a chunk ends there, so that model_<it> holds the parameters
            after iteration <it>, as in the per-iteration loop."""
            b = tot_iter - 1
            if do_save:
                b = min(b, i + (-i) % self.save_interval)
            if do_eval:
                b = min(b, i + (-i) % self.eval_interval)
            return b

        prev = None               # (first_it, c, host metrics, event)
        it = start_iter
        while it < tot_iter:
            c = min(chunk, tot_iter - it, _next_boundary(it) - it + 1)
            host, done, stamps = run_chunk(it, c)
            self.tot_timesteps += self.num_steps * self.env.num_envs_global * c
            first_it, last_it = it, it + c - 1
            it += c
            self.current_iteration = it
            need_save = do_save and last_it % self.save_interval == 0
            need_eval = do_eval and last_it % self.eval_interval == 0
            # the previous chunk's metrics while this one runs on the card
            if prev is not None:
                _process(*prev)
            prev = (first_it, c, host, done, stamps)
            if need_save or need_eval or sync_mode or it >= tot_iter:
                _process(*prev)
                prev = None
            if need_save:
                self.save(state, os.path.join(self.log_dir,
                                              f"model_{last_it}.pt"))
            if need_eval:
                self._submit_eval(last_it)
            if prev is None and self.evaluator is not None:
                self._log_eval(self.evaluator.poll())
            if need_save or need_eval:
                t_window = time.time()   # exclude save/eval from timing
        if prev is not None:
            _process(*prev)
        if self.log_dir:
            self.save(state, os.path.join(
                self.log_dir, f"model_{self.current_iteration}.pt"))
        if self.evaluator is not None:
            if self.is_cts:
                self._submit_eval(self.current_iteration)
            # block for the final model's score (reference
            # on_policy_runner.py:271-291)
            self._log_eval(self.evaluator.wait_all(timeout=600))
        return graphs.copy_tree(state)

    def _submit_eval(self, it: int):
        """Export the policy as jit_models/policy_jit_<it>.pt and submit it
        (JAX runner.py:465-475)."""
        family = cts_lib.ALGO_TO_FAMILY[self.cfg.runner.algorithm_class_name]
        path = exporter.export_model(
            self.alg.model, "jit", family,
            os.path.join(self.log_dir, "jit_models"),
            filename=f"policy_jit_{it}.pt")
        self.evaluator.submit(path, it)

    def _log_eval(self, results):
        for eit, scores in results.items():
            for k, v in scores.items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(f"Eval/{k}", v, eit)
        if results:
            self.writer.flush()

    def _log(self, it, metrics, dt_iter, rewbuffer, lenbuffer, srew, slen,
             phases=None):
        w = self.writer
        fps = int(self.num_steps * self.env.num_envs_global / dt_iter)
        done_count = float(metrics.pop("done_count", 0.0))
        for name, val in metrics.items():
            if name.startswith("rew_"):
                if done_count > 0:
                    w.add_scalar(f"Episode/{name}", float(val) / done_count, it)
            elif name.startswith("terrain_level"):
                w.add_scalar(f"Terrain/{name}", float(val), it)
            elif name == "mean_noise_std":
                w.add_scalar("Policy/mean_noise_std", float(val), it)
            elif name == "learning_rate":
                w.add_scalar("Loss/learning_rate", float(val), it)
            elif name.endswith("loss") or name == "entropy":
                w.add_scalar(f"Loss/{name.replace('_loss', '')}", float(val), it)
            else:
                w.add_scalar(f"Train/{name}", float(val), it)
        w.add_scalar("Perf/total_fps", fps, it)
        w.add_scalar("Perf/iteration_time", dt_iter, it)
        for name, ms in (phases or {}).items():
            w.add_scalar(f"Perf/phase/{name}_ms", ms, it)
        if not self.is_cts:
            if rewbuffer:
                w.add_scalar("Train/mean_reward", np.mean(rewbuffer), it)
                w.add_scalar("Train/mean_episode_length", np.mean(lenbuffer),
                             it)
        else:
            if rewbuffer:
                w.add_scalar("Train/mean_teacher_reward", np.mean(rewbuffer),
                             it)
                w.add_scalar("Train/mean_teacher_episode_length",
                             np.mean(lenbuffer), it)
            if srew:
                w.add_scalar("Train/mean_student_reward", np.mean(srew), it)
                w.add_scalar("Train/mean_student_episode_length",
                             np.mean(slen), it)
        w.flush()

    # ------------------------------------------------------------------

    def save(self, rs: RunnerState, path: str):
        """Checkpoint everything (torch.save): the train state (parameters,
        Adam states, the learning rate), the runner state (env state with its
        generator, obs, history, episode sums, the RNN memory, the noise and
        shuffle generators) and the iteration, so that `load` resumes
        exactly.

        Under a mesh every rank must call it: the env state is gathered in
        global env order, so that the file holds what one process's
        checkpoint of the N envs holds (with rank 0's generators), plus every
        rank's generator states under "rank_generators"; rank 0 writes it,
        and every rank returns once the file is complete."""
        ck = {"iteration": self.current_iteration,
              "train_state": self.alg.train_state_dict()}
        if self.mesh is not None:
            ck["world"] = self.mesh.world
            ck["rank_generators"] = mesh_lib.gather_generator_states(
                self.mesh, rs)
            rs = mesh_lib.gather_runner_state(self.mesh, rs)
        if self.is_main:
            torch.save(dict(ck, runner_state=_pack(rs)), path)
        mesh_lib.barrier(self.mesh)

    def load(self, rs: RunnerState, path: str) -> RunnerState:
        """Restore a checkpoint of `save` into this runner's train state;
        returns the saved RunnerState, shaped like `rs` (this runner's, of
        the same global env count). A checkpoint of a run over W ranks
        resumes over W ranks, each with its own generators."""
        # on the CPU first: a generator's state must be a CPU tensor, and
        # every other tensor is moved to the device as it is restored
        ck = torch.load(path, map_location="cpu", weights_only=True)
        n = ck["runner_state"]["obs"].shape[0]
        if n != self.env.num_envs_global:
            raise ValueError(f"checkpoint has {n} envs, the runner "
                             f"{self.env.num_envs_global}; use load_params")
        world = self.mesh.world if self.mesh else 1
        if ck.get("world", 1) != world:
            raise ValueError(f"checkpoint of a run over {ck.get('world', 1)} "
                             f"ranks, this one has {world}; use load_params")
        self.alg.load_train_state_dict(ck["train_state"])
        self.current_iteration = int(ck["iteration"])
        if self.mesh is None:
            return _unpack(rs, ck["runner_state"], self.device)
        # the global state unpacked on the CPU, then this rank's slice
        out = mesh_lib.shard_runner_state(
            self.mesh, _unpack(rs, ck["runner_state"], "cpu"))
        mesh_lib.set_generator_states(self.mesh, out, ck["rank_generators"])
        return out

    def load_params(self, path: str) -> Dict[str, torch.Tensor]:
        """Restore ONLY the model parameters of a checkpoint, whatever its
        env count (the play/eval path: a 4096-env training checkpoint loads
        into a 16-env session, reference play.py:38-40). Returns
        get_inference_params()."""
        ck = torch.load(path, map_location="cpu", weights_only=True)
        self.alg.model.load_state_dict(ck["train_state"]["model"])
        return self.get_inference_params()

    def get_inference_params(self) -> Dict[str, torch.Tensor]:
        """A copy of the model's parameters by name (for CTS, both
        groups)."""
        return {k: p.detach().clone()
                for k, p in self.alg.model.named_parameters()}
