"""Data-parallel training over several ranks (PyTorch port of
go2_rl_gym_tpu/distributed/mesh.py).

The JAX package runs its whole train step under a `jax.sharding.Mesh`: the
env batch shards on dim 0 over a `data` axis, the train state, the keys and
the few global env scalars are replicated (mesh.py:37-43), and XLA inserts
the collectives. Here each rank is one process, on one card (NCCL) or on
the CPU (gloo), that owns the envs [r*N/W, (r+1)*N/W) of the global batch of
N. What was one program over N envs makes its collectives explicit:

* the env inits its shard by global env index and all-reduces the two sums
  of the command curriculum (env/go2_env.py);
* GAE normalises the advantages by the global mean and population std
  (agents/common.py);
* the update draws its permutations from a generator seeded alike on every
  rank; once per update every rank all_gathers the samples the update
  reads into one buffer of the global batch (`gather_samples`), and takes
  a static share of each global minibatch: members [r*c, (r+1)*c), c =
  ceil(m / W), the rows past m padding with clamped indices and loss
  weight 0 (`share`, `share_index`). The losses divide by the global
  counts, and the gradients are sum-all-reduced before the clip, so that
  the W shares add up to the one-process minibatch loss, clip and Adam
  run identically and the parameters stay equal on every rank without a
  broadcast; the MoE load-balance terms, nonlinear in a minibatch mean,
  all-reduce their weighted usage sums inside autograd (agents/{cts,ppo,
  recurrent_ppo}.py). At W = 1 the share is the whole minibatch in its
  order. Every shape is fixed and nothing is read back, so the iteration
  is captured as one CUDA graph per rank under NCCL
  (`make_sharded_train_step`);
* the runner all-reduces an iteration's metrics once, and gathers the env
  state in global env order for its checkpoints (train/runner.py).

Designs not taken for the shares: every rank computing the whole minibatch
with the other ranks' rows weighted 0 costs W times the update's compute;
a permutation stratified by rank (each minibatch drawn from every rank's
envs alike) changes which samples meet in a minibatch, which is not the
JAX package's semantics. The gather costs 4 * F bytes per sample of the
global batch (F = 573 floats for go2_moe_cts: ~225 MB at 4096 envs x 24
steps) on every rank.

torch cannot reproduce threefry, so the statement is: W ranks compute what
one process computes on the same N envs, given the same act noise and
permutations, with the env's randomness off. With it on, each rank draws
from generators seeded by (seed, rank).

Only all_reduce, broadcast and all_gather are used, so that the same code
runs under NCCL and under gloo, on CUDA tensors too. Every helper takes the
mesh or None: without a mesh it returns its input, and at any world size,
one included, it issues its collective.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import os
import socket
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# RunnerState leaves that are the same on every rank (the twin of
# mesh.py:37-43; the train state lives in the algorithm object, the keys are
# generators): every other tensor leaf is env-batched on dim 0, a 0-d one
# replicated
_REPLICATED_FIELDS = frozenset({"cmd_range_x", "common_step_counter"})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a data-parallel run: its rank, the world size,
    its device, and its slice of the global env batch of `num_envs`."""
    rank: int
    world: int
    device: torch.device
    num_envs: int

    def __post_init__(self):
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} of world {self.world}")
        if self.num_envs % self.world:
            raise ValueError(f"{self.world} ranks do not divide "
                             f"num_envs={self.num_envs}")

    @property
    def local_envs(self) -> int:
        return self.num_envs // self.world

    @property
    def env_slice(self) -> slice:
        start = self.rank * self.local_envs
        return slice(start, start + self.local_envs)

    def env_ids(self) -> np.ndarray:
        """The global env index of each of this rank's envs."""
        return np.arange(self.num_envs)[self.env_slice]


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         backend: Optional[str] = None,
                         timeout_s: float = 600.0) -> torch.device:
    """torch.distributed bring-up (the twin of mesh.py:97-106); call it once
    per process, before any CUDA work. Returns this rank's device.

    Without `coordinator` it reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT; with it, the rank joins "host:port" as
    process `process_id` of `num_processes`. `device` "cuda" becomes
    cuda:<LOCAL_RANK> (made the current device); an explicit "cuda:k" or
    "cpu" is kept. The backend is NCCL on a card and gloo on the CPU unless
    `backend` says otherwise (gloo on CUDA tensors runs several ranks on one
    card). A collective that waits `timeout_s` fails instead of hanging."""
    from go2_rl_gym_tpu_torch.device import resolve_device
    if coordinator is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no coordinator given and {missing} unset: launch with "
                f"python -m torch.distributed.run --nproc_per_node W ...")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        rank, world, local_rank = process_id, num_processes, process_id
        init_method = f"tcp://{coordinator}"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants {dev}, but "
                               f"{torch.cuda.device_count()} cards are "
                               f"visible")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(num_envs: int, device) -> Mesh:
    """The mesh of the initialised process group over a global batch of
    `num_envs` envs; raises unless the world size divides it."""
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                device=torch.device(device), num_envs=num_envs)


def make_sharded_train_step(runner, mesh: Mesh, rs):
    """The runner's compiled train step over `mesh` (the twin of
    mesh.py:90-94, `jax.jit(train_step, in_shardings=...)`): the in-place
    step on `rs`, this rank's shard, captured as one CUDA graph under NCCL
    on a card (`OnPolicyRunner.compiled_step`, `train_mode`). `mesh` None
    is a runner without one."""
    if runner.mesh is not mesh:
        raise ValueError("the runner is not attached to this mesh")
    return runner.compiled_step(rs)


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shutdown():
    """Destroy the process group, after freeing every CUDA graph that is no
    longer referenced: on 4 H100s, ranks whose graph of NCCL collectives
    outlived the communicator finished their work and never exited."""
    if dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce(mesh: Optional[Mesh],
               tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, as one flat fp32 all_reduce; new
    tensors of the inputs' shapes and dtypes (the inputs themselves
    without a mesh)."""
    tensors = list(tensors)
    if mesh is None:
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat)
    pieces = flat.split([t.numel() for t in tensors])
    return [p.view(t.shape).to(t.dtype) for p, t in zip(pieces, tensors)]


def barrier(mesh: Optional[Mesh]):
    """Return once every rank has reached this call: an all_reduce whose
    result the host reads (NCCL's calls return before their work ends)."""
    if mesh is not None:
        float(all_reduce(mesh, [torch.ones((), device=mesh.device)])[0])


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' incoming
    gradients (the gradient of each rank's input is every rank's gradient
    of the common result)."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_autograd(mesh: Optional[Mesh], x: torch.Tensor):
    """`x` summed over the ranks inside autograd: the backward sums the
    ranks' gradients of the result, so a loss term that every rank computes
    from the sum must enter each rank's loss divided by the world size."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x)


def broadcast_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor],
               src: int = 0):
    """Overwrite each tensor, in place, with rank `src`'s."""
    if mesh is None:
        return
    for t in tensors:
        dist.broadcast(t, src)


def all_gather(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (the same shape on all) concatenated along dim 0 in
    rank order. Bools travel as uint8 (not every backend takes them), and
    every buffer is contiguous (NCCL takes no other)."""
    if mesh is None:
        return x
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(y, memory_format=torch.contiguous_format)
             for _ in range(mesh.world)]
    dist.all_gather(parts, y)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# minibatch shares
# ---------------------------------------------------------------------------


class Share(NamedTuple):
    """A rank's share of a global minibatch of `m` members: the members
    [start, start + size), of which the first `valid` exist; the rest is
    padding."""
    start: int
    size: int
    valid: int


def share(m: int, world: int, rank: int) -> Share:
    """Rank `rank`'s static share of a minibatch of `m` members: c =
    ceil(m / world) members from r * c on, the same size on every rank, so
    that the W shares cover the minibatch once, in order, and only the last
    ranks' shares hold padding."""
    size = -(-m // world)
    start = rank * size
    return Share(start, size, max(0, min(size, m - start)))


def share_index(mesh: Optional[Mesh], m: int, device):
    """This rank's share of a minibatch of `m` members on `device`:
    (positions (size,) int64 in the minibatch, padding clamped to m - 1;
    weights (size,) fp32, 1 for a member and 0 for padding, or None where
    the share has no padding). Without a mesh: every member, no weights."""
    sh = share(m, mesh.world if mesh else 1, mesh.rank if mesh else 0)
    cols = torch.arange(sh.start, sh.start + sh.size, device=device)
    cols = torch.clamp(cols, max=m - 1)
    if sh.valid == sh.size:
        return cols, None
    weight = (torch.arange(sh.size, device=device) < sh.valid).to(
        torch.float32)
    return cols, weight


def _gather_single(out, x):
    # torch >= 2.13 names the single-buffer all_gather all_gather_single
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x)


def gather_samples(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Every rank's (T, n, F) samples as one (W * T * n, F) tensor, rank
    after rank, each rank's block t-major (`sample_rows` addresses it); one
    all_gather into a single buffer. Without a mesh, `x` as (T * n, F)."""
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    if mesh is None:
        return flat
    out = torch.empty((mesh.world * flat.shape[0], flat.shape[1]),
                      dtype=flat.dtype, device=flat.device)
    _gather_single(out, flat)
    return out


def sample_rows(env, t, steps: int, n_local: int):
    """The row of `gather_samples`' result that holds step `t` of global env
    `env` (tensors, broadcast), when each rank holds `n_local` envs for
    `steps` steps: the rank's block, then t-major within it."""
    return (env // n_local * steps + t) * n_local + env % n_local


# ---------------------------------------------------------------------------
# RunnerState by global env index
# ---------------------------------------------------------------------------


def _map(fn, tree, path=()):
    """`fn(path, leaf)` over the tensors and generators of a NamedTuple /
    dict / tuple tree; the structure is kept."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)])
    if isinstance(tree, tuple):
        return tuple(_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _env_batched(path, leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.dim() > 0
            and not _REPLICATED_FIELDS.intersection(path))


def shard_runner_state(mesh: Mesh, rs):
    """This rank's slice of a RunnerState of the global batch (the twin of
    `runner_shardings` / `shard_runner_state`, mesh.py:61-82): env-batched
    leaves are cut to the rank's envs and moved to its device, replicated
    ones copied there; generators are kept as they are."""
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if _env_batched(path, leaf):
            leaf = leaf[mesh.env_slice]
        return leaf.to(mesh.device, copy=True)
    return _map(one, rs)


def gather_runner_state(mesh: Mesh, rs):
    """The RunnerState of the global batch, in global env order, on every
    rank (all_gather of each env-batched leaf); replicated leaves and
    generators are this rank's."""
    def one(path, leaf):
        return all_gather(mesh, leaf) if _env_batched(path, leaf) else leaf
    return _map(one, rs)


def generators(rs) -> Dict[str, torch.Generator]:
    """The generators of a RunnerState by dotted path."""
    out = {}

    def one(path, leaf):
        if isinstance(leaf, torch.Generator):
            out[".".join(path)] = leaf
        return leaf
    _map(one, rs)
    return out


def gather_generator_states(mesh: Mesh, rs) -> Dict[str, torch.Tensor]:
    """Every rank's state of each generator of `rs`: path -> (W, n) uint8 on
    the CPU (the states travel on the mesh's device: NCCL takes no CPU
    tensor)."""
    return {path: all_gather(mesh, g.get_state().to(mesh.device)[None]).cpu()
            for path, g in generators(rs).items()}


def set_generator_states(mesh: Mesh, rs, states: Dict[str, torch.Tensor]):
    """Restore this rank's row of `gather_generator_states`' result into the
    generators of `rs`, in place."""
    for path, g in generators(rs).items():
        g.set_state(states[path][mesh.rank].clone())
