"""The compiled step: one CUDA graph per call, replayed (PyTorch port of
the JAX package's `jax.jit(train_step)`, train/runner.py:99/117/167, and of
the `jax.jit(env.step)` of env/vec_env.py:30 and scripts/play.py:83).

XLA compiles the JAX package's train iteration into one program. The port's
counterpart on the card is a CUDA graph of the iteration's ops and kernels,
captured once and replayed: a replay issues the whole iteration (some 190k
kernels at 4096 envs) in one call from the host.

A graph replays fixed addresses, so the step runs in place (`InPlaceStep`):
from a fixed set of state tensors (its own copies, made once), it calls the
step function and writes every result back into the storage it read, with
`copy_` (the RunnerState and EnvState fields are new tensors each call;
the algorithm's parameters, Adam states and learning rates are updated in
place by the step itself). The outputs of a call are tensors the next call
overwrites. The in-place step runs eagerly on any device; on the card
`StepGraph` captures it after one eager call that serves as warm-up.

Randomness: every `torch.Generator` in the state is registered with the
graph, so a replay draws what the eager call would have drawn, and the
generators advance as they would eagerly. Capture executes nothing, so a
graphed run of n calls is the eager run of n calls.

`CAPTURES` counts captures per kind. A capture or replay error raises;
nothing falls back to eager execution.
"""
from __future__ import annotations

import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# captures made, by kind ("train_step", "env_step")
CAPTURES: Dict[str, int] = {"train_step": 0, "env_step": 0}


# ---------------------------------------------------------------------------
# state trees: NamedTuples, dicts, tuples and lists of tensors and generators
# ---------------------------------------------------------------------------


def leaves(tree, path=()):
    """(path, leaf) of every tensor and generator of a tree, in order."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from leaves(v, path + (k,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    elif tree is not None:
        raise TypeError(f"unexpected {type(tree).__name__} in a state tree "
                        f"at {path}")


def _name(path) -> str:
    return ".".join(str(p) for p in path) or "<root>"


def _new_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def copy_tree(tree, generators: bool = True):
    """A copy of a tree in fresh, contiguous storage, no two tensors
    sharing memory; with `generators`, each generator is a new one in the
    same state, else the same object."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone(memory_format=torch.contiguous_format)
    if isinstance(tree, torch.Generator):
        return _new_generator(tree) if generators else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[copy_tree(v, generators) for v in tree])
    if isinstance(tree, dict):
        return {k: copy_tree(v, generators) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(copy_tree(v, generators) for v in tree)
    return tree


def _pairs(dst_tree, src_tree):
    """(path, dst, src) of two trees of one structure."""
    dst, src = list(leaves(dst_tree)), list(leaves(src_tree))
    if [p for p, _ in dst] != [p for p, _ in src]:
        raise ValueError("the step changed the structure of its state")
    return [(p, d, s) for (p, d), (_, s) in zip(dst, src)]


def write_back(pairs):
    """Copy each src into its dst (`(path, dst, src)` triples). A src that
    shares memory with any dst is copied aside first, so that the order of
    the copies does not matter; a generator must be its dst."""
    dst_mem = {d.untyped_storage().data_ptr() for _, d, _ in pairs
               if isinstance(d, torch.Tensor)}
    todo = []
    for path, d, s in pairs:
        if s is d:
            continue
        if isinstance(d, torch.Generator) or isinstance(s, torch.Generator):
            raise ValueError(f"the step replaced the generator at "
                             f"{_name(path)}")
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"{_name(path)}: the step returned "
                             f"{tuple(s.shape)} {s.dtype} for "
                             f"{tuple(d.shape)} {d.dtype}")
        if s.untyped_storage().data_ptr() in dst_mem:
            s = s.clone()
        todo.append((d, s))
    for d, s in todo:
        d.copy_(s)


def assign(dst_tree, src_tree):
    """Load a state tree's values into another of the same structure:
    tensors by `copy_`, generators by their state."""
    for path, d, s in _pairs(dst_tree, src_tree):
        if s is d:
            continue
        if isinstance(d, torch.Generator):
            d.set_state(s.get_state())
        else:
            if d.shape != s.shape:
                raise ValueError(f"{_name(path)}: {tuple(s.shape)} where "
                                 f"{tuple(d.shape)} is expected")
            d.copy_(s)


def generators(tree) -> List[torch.Generator]:
    return [g for _, g in leaves(tree) if isinstance(g, torch.Generator)]


def same_structure(a, b) -> bool:
    la, lb = list(leaves(a)), list(leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        type(x) is type(y) and (isinstance(x, torch.Generator)
                                or (x.shape == y.shape and x.dtype == y.dtype))
        for (_, x), (_, y) in zip(la, lb))


# ---------------------------------------------------------------------------
# the in-place step and its graph
# ---------------------------------------------------------------------------


class InPlaceStep:
    """`fn(state, *inputs) -> (new state, outputs)` run on fixed storage.

    `state` and `inputs` are copied once into storage of this object's own
    (`self.state`, `self.inputs`); the state's generators stay the caller's
    objects. A call runs `fn` on that storage and writes the new state back
    into it. Returns `fn`'s outputs; under a graph, tensors that the next
    replay overwrites."""

    def __init__(self, fn: Callable, state, inputs: Sequence = ()):
        self.fn = fn
        self.state = copy_tree(state, generators=False)
        self.inputs = [copy_tree(x) for x in inputs]

    def set_state(self, state):
        """Load `state` (a tree like this step's) into the storage."""
        if state is not self.state:
            assign(self.state, state)

    def set_inputs(self, *inputs):
        for d, s in zip(self.inputs, inputs):
            if s is not d:
                assign(d, s)

    def __call__(self):
        new_state, out = self.fn(self.state, *self.inputs)
        write_back(_pairs(self.state, new_state))
        return out


class StepGraph:
    """An `InPlaceStep` captured as one CUDA graph and replayed.

    The first call runs the step eagerly on a side stream (a real call: the
    warm-up, under `torch.cuda.set_sync_debug_mode("error")`, so that a host
    synchronisation left on the step raises), then captures it, which
    executes nothing. Every later call replays the graph. Every generator
    of the state is registered with the graph.
    `kind` names the capture in `CAPTURES`. Attributes after the capture:
    `capture_s` (capture and instantiation), `pool_bytes` (device memory
    the capture reserved), `captures` (this object's). Under an NCCL
    process group the collectives are captured with the rest, in the
    default ("global") capture mode: the communicator exists before the
    capture and the warm-up has issued every collective once."""

    def __init__(self, step: InPlaceStep, kind: str):
        self.step = step
        self.kind = kind
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.captures = 0
        self.capture_s = float("nan")
        self.pool_bytes = 0

    def _warm_up(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.step()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for g in generators(self.step.state):
            graph.register_generator_state(g)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        t = time.perf_counter()
        with torch.cuda.graph(graph):
            out = self.step()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t
        self.pool_bytes = torch.cuda.memory_reserved() - before
        self.graph, self.out = graph, out
        self.captures += 1
        CAPTURES[self.kind] += 1

    @property
    def state(self):
        """The step's state storage (`InPlaceStep.state`)."""
        return self.step.state

    def __call__(self):
        if self.graph is None:
            out = self._warm_up()
            self._capture()
            return out
        self.graph.replay()
        return self.out


class HostReads(TorchDispatchMode):
    """The capture-safety sentinel: a dispatch mode that records every op
    that reads the device from the host (`aten._local_scalar_dense`),
    builds a tensor from host data (`aten.lift_fresh`) or takes a
    data-dependent shape (`aten.nonzero`, a boolean-mask index), with the
    port's innermost source line. A step on which it records nothing can be
    captured."""

    OPS = {"aten._local_scalar_dense.default", "aten.lift_fresh.default",
           "aten.nonzero.default"}

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        mask = name == "aten.index.Tensor" and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1] if i is not None)
        if name in self.OPS or mask:
            lines = [f"{f.filename.split('go2_rl_gym_tpu_torch/')[-1]}:"
                     f"{f.lineno}" for f in traceback.extract_stack()
                     if "go2_rl_gym_tpu_torch" in f.filename
                     and not f.filename.endswith("utils/graphs.py")]
            self.hits.append((name, lines[-1] if lines else "?"))
        return func(*args, **(kwargs or {}))


def flat_metrics(keys: List[str]):
    """An iteration's metrics dict -> one (T,) f32 vector in the JAX order:
    sorted keys, each flattened (JAX runner.py:316-323)."""
    def flatten(m):
        return torch.cat([m[k].to(torch.float32).reshape(-1) for k in keys])
    return flatten


def metric_layout(m: Dict[str, torch.Tensor]):
    """(keys, sizes) of an iteration's metrics: sorted(m), each one's
    element count (1 for a 0-d metric)."""
    keys = sorted(m)
    return keys, [max(1, m[k].numel()) for k in keys]


class EnvStep:
    """`env.step(state, actions)` through one CUDA graph on the card, the
    port's `jax.jit(env.step)` (env/vec_env.py:30, scripts/play.py:83): the
    first call runs eagerly (the warm-up) and captures, later calls load
    the state and the actions into the graph's storage and replay. On the
    CPU the same in-place step runs eagerly. Returns (state, StepOutput):
    the state is the step's storage and the outputs the graph's tensors,
    both overwritten by the next call; a caller that keeps them copies
    them (`copy_tree`)."""

    def __init__(self, env):
        self.env = env
        self.graphed = env.device.type == "cuda"
        self.step: Optional[InPlaceStep] = None
        self.run = None

    def __call__(self, state, actions):
        if self.step is None or not same_structure(self.step.state, state):
            self.step = InPlaceStep(self.env.step, state, (actions,))
            self.run = (StepGraph(self.step, "env_step") if self.graphed
                        else self.step)
        self.step.set_state(state)
        self.step.set_inputs(actions)
        return self.step.state, self.run()
