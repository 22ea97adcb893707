"""Spans: the phases of a train iteration, timed on the device's own clock,
inside the captured CUDA graph too.

A span is entered with `span(name)` where its work is launched (`NAMES`):
`train_step` round `OnPolicyRunner.train_step`; `rollout`, `gae` and
`update` inside it; `act` and `env` round each policy step's `act` and
`env.step`; `physics` round the env step's physics. While a `Recorder` is
on (`recording`, a context manager), a span's entry and exit
each launch a stamp (ops/csrc/stamp.cu) on the current stream: one thread
reads the device's %globaltimer and writes it into the next slot of the
recorder's ring. Stamps launched while a graph is captured are nodes of
the graph, so every replay writes its own, with no host work. On the CPU
a stamp is `time.perf_counter_ns()` on the host, where every op has
finished when it returns.

Spans record only inside a `train_step` span: an iteration is the unit,
and a span entered outside one (the env step of `init_runner_state`, of
play) records nothing. The recorder keeps the `schedule` of the last whole
iteration seen: its ordered (name, BEGIN | END) edges, the same in every
iteration and in every replay of a graph of it. Each iteration therefore
advances the ring's cursor by exactly len(schedule), and its stamps decode
by position (`decode`).

With no recorder on, `span` launches nothing and opens nothing: a graph
captured then is the graph without spans, node for node. While
torch.profiler is on, a recorded span also opens the profiler range
PREFIX + name on the host, and the stamps appear in the device trace as
kernels named STAMP_KERNEL, in schedule order within each replay.

`host(name)` is a span on the host clock alone (`learn.launch`, round each
call of the train step in `learn`), kept in the recorder's `host_spans`
(the latest HOST_SPANS).
`listen(fn)` calls fn(name, BEGIN | END) at each recorded span edge of
eager calls (never while a graph is captured).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from go2_rl_gym_tpu_torch.ops import cuda_build

ROOT = "train_step"
NAMES = ("train_step", "rollout", "act", "env", "physics", "gae", "update")
# the phases that cover an iteration without overlapping, each without the
# phases inside it (env without its physics); the rest is "uncovered"
PHASES = ("physics", "env", "act", "gae", "update")
UNCOVERED = "uncovered"
BEGIN, END = "begin", "end"
PREFIX = "go2."
STAMP_KERNEL = "go2_span_stamp"
# stamps the ring holds: 215 iterations of 152 stamps (24-step rollouts)
CAPACITY = 1 << 15
# host spans the recorder keeps, the latest
HOST_SPANS = 1024
SOURCE = "ops/csrc/stamp.cu"

_recorder: Optional["Recorder"] = None
_listeners: List[Callable[[str, str], None]] = []


@functools.cache
def _launch_fn():
    return cuda_build.load(SOURCE, "span_stamp_launch",
                           [ctypes.c_void_p, ctypes.c_ulonglong,
                            ctypes.c_void_p])


class Recorder:
    """One device's ring of stamps and the schedule of one iteration.

    `buf` is one int64 tensor on the device: the cursor (stamps written
    since the recorder was made) and then the ring of CAPACITY stamps,
    stamp k at buf[1 + k % CAPACITY]."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.buf = torch.zeros(CAPACITY + 1, dtype=torch.int64,
                                   device=self.device)
        else:
            # written with numpy, so that no op of torch runs per stamp
            self._host = np.zeros(CAPACITY + 1, np.int64)
            self.buf = torch.from_numpy(self._host)
        self.schedule: Tuple[Tuple[str, str], ...] = ()
        self.host_spans: deque = deque(maxlen=HOST_SPANS)
        self._issuing: Optional[List[Tuple[str, str]]] = None

    def _stamp(self):
        if not self.cuda:
            h = self._host
            h[1 + h[0] % CAPACITY] = time.perf_counter_ns()
            h[0] += 1
            return
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _launch_fn()(self.buf.data_ptr(), CAPACITY, stream)
        if err != 0:
            raise RuntimeError(f"span stamp: kernel launch failed with "
                               f"cudaError {err}")

    def _edge(self, name: str, kind: str):
        if name == ROOT and kind == BEGIN:
            self._issuing = []
        self._issuing.append((name, kind))
        self._stamp()
        if name == ROOT and kind == END:
            self.schedule = tuple(self._issuing)
            self._issuing = None

    def copy(self) -> torch.Tensor:
        """`buf` in host memory: on the card a pinned copy enqueued on the
        current stream without blocking (read it once the stream's next
        event has completed); on the CPU a copy."""
        if not self.cuda:
            return self.buf.clone()
        out = torch.empty(self.buf.shape, dtype=torch.int64, pin_memory=True)
        out.copy_(self.buf, non_blocking=True)
        return out

    def iterations(self, copied: torch.Tensor, count: int
                   ) -> List[Dict[str, float]]:
        """`decode` of the last `count` iterations of a `copy`."""
        b = copied.numpy()
        return decode(b[1:], int(b[0]), count * len(self.schedule),
                      self.schedule)

    def host_ms(self, name: str, count: int) -> List[float]:
        """Milliseconds of the last `count` host spans named `name`."""
        got = [(t1 - t0) / 1e6 for n, t0, t1 in self.host_spans if n == name]
        return got[-count:] if count > 0 else []


def current() -> Optional[Recorder]:
    """The recorder that is on, or None."""
    return _recorder


@contextlib.contextmanager
def recording(device):
    """A new recorder on for `device` for the block; the one before it on
    again after."""
    global _recorder
    before = _recorder
    _recorder = rec = Recorder(device)
    try:
        yield rec
    finally:
        _recorder = before


@contextlib.contextmanager
def listen(fn: Callable[[str, str], None]):
    """Call fn(name, BEGIN | END) at each recorded span edge of an eager
    call, on the host, for the block."""
    _listeners.append(fn)
    try:
        yield
    finally:
        _listeners.remove(fn)


def _profiler_range(name: str):
    # entered only under torch.profiler: a range costs host time per call
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return contextlib.nullcontext()


def _tell(rec: Recorder, name: str, kind: str):
    if _listeners and not (rec.cuda
                           and torch.cuda.is_current_stream_capturing()):
        for fn in list(_listeners):
            fn(name, kind)


@contextlib.contextmanager
def span(name: str):
    """The block as the span `name` (see the module docstring)."""
    rec = _recorder
    if rec is None or (rec._issuing is None and name != ROOT):
        yield
        return
    with _profiler_range(name):
        rec._edge(name, BEGIN)
        _tell(rec, name, BEGIN)
        yield
        rec._edge(name, END)
        _tell(rec, name, END)


@contextlib.contextmanager
def host(name: str):
    """The block as a span `name` on the host clock (perf_counter_ns),
    kept in the recorder's `host_spans`, while a recorder is on."""
    rec = _recorder
    if rec is None:
        yield
        return
    with _profiler_range(name):
        t0 = time.perf_counter_ns()
        yield
        rec.host_spans.append((name, t0, time.perf_counter_ns()))


def pairs(schedule: Sequence[Tuple[str, str]]
          ) -> List[Tuple[str, int, int, int]]:
    """(name, index of its BEGIN, index of its END, index in this list of
    the span it lies directly in or -1) of each span of a schedule, in the
    order they begin. Raises on edges that do not nest."""
    out, open_ = [], []
    for i, (name, kind) in enumerate(schedule):
        if kind == BEGIN:
            out.append([name, i, -1, open_[-1] if open_ else -1])
            open_.append(len(out) - 1)
        else:
            if not open_ or out[open_[-1]][0] != name:
                raise ValueError(f"span {name!r} ends at edge {i} while "
                                 f"{out[open_[-1]][0] if open_ else None!r}"
                                 f" is open")
            out[open_.pop()][2] = i
    if open_:
        raise ValueError(f"spans {[out[k][0] for k in open_]} never end")
    return [tuple(x) for x in out]


def decode(ring: np.ndarray, cursor: int, count: int,
           schedule: Sequence[Tuple[str, str]]) -> List[Dict[str, float]]:
    """Per iteration, milliseconds by span name, from the last `count`
    stamps before `cursor` in a ring of len(ring) slots, each iteration
    having written `schedule`: only whole iterations that end at the cursor
    are read, so an iteration that the ring has partly overwritten is
    dropped. A name's spans in an iteration are summed; a phase (`PHASES`)
    leaves out the phases directly inside it (env without its physics);
    UNCOVERED is `train_step` less every phase."""
    L = len(schedule)
    if not L:
        return []
    n = min(count, cursor, len(ring)) // L
    pos = (cursor - n * L + np.arange(n * L)) % len(ring)
    t = ring[pos].reshape(n, L)
    spans = pairs(schedule)
    ns = (t[:, [e for _, _, e, _ in spans]]
          - t[:, [b for _, b, _, _ in spans]]).astype(np.float64)
    own = ns.copy()
    for k, (name, _, _, parent) in enumerate(spans):
        if parent >= 0 and name in PHASES and spans[parent][0] in PHASES:
            own[:, parent] -= ns[:, k]
    out = {}
    for k, (name, *_) in enumerate(spans):
        col = own[:, k] if name in PHASES else ns[:, k]
        out[name] = out.get(name, 0.0) + col
    if ROOT in out:
        out[UNCOVERED] = out[ROOT] - sum(out[p] for p in PHASES if p in out)
    return [{k: float(v[i]) / 1e6 for k, v in out.items()} for i in range(n)]
