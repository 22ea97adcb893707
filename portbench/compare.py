"""What `correct` compares: the program's first STEPS train iterations,
each against the plain reference's iteration from the same start.

The rollout is chaotic: a change in the last bit of one contact grows, within
one 24-step rollout, into a different trajectory for a few envs, and after
one update into a different policy everywhere. Two runs from the seed that
differ in rounding alone then read as far apart as the TF32 control does.
So the reference follows the program iteration by iteration: iteration 1
from its own start, built from the seed (the start check), and iteration
k > 1 from the program's own state at the start of that iteration (its env
and runner state and its train state, `snapshot`). Each side gives one
`Iteration` per iteration:

- `losses`: the iteration's reported losses;
- `grad`: the norm, per parameter, of Adam's first moment after the
  iteration: its gradients as the optimizer holds them;
- `dparam`: the norm, per parameter, of the change of the parameters over
  the iteration;
- `obs`: the observation of every env after the iteration.

`numbers` turns the two lists into the numbers compared, each against its
limit from the cell's limits file:

- `loss.<k>`: the largest relative gap |p - r| / |r| over the limits file's
  `losses` keys at iteration k;
- `obs.<k>`: the share of envs whose observation after iteration k differs
  from the reference's by more than OBS_GAP in some entry;
- `grad.1` and `dparam.<k>`: the worst parameter's gap of norms,
  | |p| - |r| | / max(|r|, the median parameter's |r|), since some
  gradients are all but zero. `dparam` leaves out the parameters whose
  reference gradient norm (that iteration's) is under a thousandth of the
  median parameter's: those move under Adam by round-off alone (a key's
  bias under softmax).

A limit of null marks a number as read and not compared.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, NamedTuple

import torch

STEPS = 3               # train iterations compared
NOUGHT = 1e-3           # gradient share below which a parameter is left out
OBS_GAP = 1e-3          # an observation entry this far off marks its env


class Iteration(NamedTuple):
    losses: Dict[str, float]          # metric -> value
    grad: Dict[str, float]            # parameter -> |Adam m| after it
    dparam: Dict[str, float]          # parameter -> |p_after - p_before|
    obs: torch.Tensor                 # (N, num_obs) after it


def iteration(alg, losses: Dict[str, float], before: Dict[str, torch.Tensor],
              obs: torch.Tensor) -> Iteration:
    """An `Iteration` read from an algorithm just after it, `before` its
    parameters at its start (`params`)."""
    return Iteration(losses, grad_norms(alg), change_norms(before, alg),
                     obs.detach().clone())


def plain(tree):
    """A copy of a state tree (tensors, generators, named tuples, dicts,
    lists) in plain containers: named tuples become dicts by field,
    generators their states."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, torch.Generator):
        return tree.get_state().clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [plain(v) for v in tree]
    return tree


def fill(template, values):
    """`template`'s tree (the reference's own state) holding `values` (a
    `plain` copy of the program's): every field of the template must be
    there, with the same shape and type; fields the template lacks are
    left out."""
    if isinstance(template, torch.Tensor):
        if (not isinstance(values, torch.Tensor)
                or values.shape != template.shape
                or values.dtype != template.dtype):
            raise ValueError(f"{getattr(values, 'shape', values)} for a "
                             f"{template.dtype} tensor of {template.shape}")
        return values.to(template.device)
    if isinstance(template, torch.Generator):
        g = torch.Generator(device=template.device)
        g.set_state(values)
        return g
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[fill(getattr(template, f), values[f])
                                for f in template._fields])
    if isinstance(template, dict):
        return {k: fill(v, values[k]) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        if len(values) != len(template):
            raise ValueError("a sequence of another length")
        return type(template)(fill(t, v) for t, v in zip(template, values))
    return values


def snapshot(state, alg):
    """The start of an iteration as the other side loads it: the runner
    state and the train state (`train_state_dict`), copied."""
    return {"state": plain(state), "train": plain(alg.train_state_dict())}


def adam_groups(alg):
    """(Adam state, [(parameter name, parameter)]) of an algorithm's
    optimizers: CTS's two groups, or PPO's one."""
    names = {id(p): n for n, p in alg.model.named_parameters()}
    if hasattr(alg, "param_groups"):
        pairs = zip((alg.opt1, alg.opt2), alg.param_groups())
    else:
        pairs = [(alg.opt, list(alg.model.parameters()))]
    return [(opt, [(names[id(p)], p) for p in params])
            for opt, params in pairs]


def grad_norms(alg) -> Dict[str, float]:
    """|Adam first moment| per parameter name."""
    out = {}
    for opt, named in adam_groups(alg):
        for (name, _), m in zip(named, opt.mu):
            out[name] = float(torch.linalg.vector_norm(m.float()))
    return out


def params(alg) -> Dict[str, torch.Tensor]:
    """A copy of every parameter by name."""
    return {n: p.detach().clone() for n, p in alg.model.named_parameters()}


def change_norms(before: Dict[str, torch.Tensor],
                 alg) -> Dict[str, float]:
    """|p - before[p]| per parameter name."""
    return {n: float(torch.linalg.vector_norm((p.detach() - before[n])
                                              .float()))
            for n, p in alg.model.named_parameters()}


def _rel(p: float, r: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    if p == r:
        return 0.0
    return abs(p - r) / abs(r) if r != 0 else math.inf


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep) -> float:
    names = [n for n in ref if keep(n)]
    if not names or set(prog) != set(ref):
        return math.inf
    median = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        p, r = prog[n], ref[n]
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        scale = max(r, median)
        gap = abs(p - r) / scale if scale > 0 else (0.0 if p == r
                                                     else math.inf)
        worst = max(worst, gap)
    return worst


def numbers(prog: List[Iteration], ref: List[Iteration],
            loss_keys: List[str]) -> Dict[str, float]:
    """The numbers compared (see the module docstring), by name."""
    out = {}
    for k in range(STEPS):
        if k >= len(prog) or k >= len(ref):
            out[f"loss.{k + 1}"] = out[f"obs.{k + 1}"] = math.inf
            continue
        p, r = prog[k], ref[k]
        out[f"loss.{k + 1}"] = max(_rel(p.losses.get(key, math.nan),
                                        r.losses.get(key, math.nan))
                                   for key in loss_keys)
        out[f"obs.{k + 1}"] = obs_share(p.obs, r.obs)
    out["grad.1"] = (_worst_leaf(prog[0].grad, ref[0].grad, lambda n: True)
                     if prog and ref else math.inf)
    for k in range(STEPS):
        if k >= len(prog) or k >= len(ref):
            out[f"dparam.{k + 1}"] = math.inf
            continue
        grad = ref[k].grad
        median = statistics.median(grad.values()) if grad else 0.0
        out[f"dparam.{k + 1}"] = _worst_leaf(
            prog[k].dparam, ref[k].dparam,
            lambda n: grad.get(n, 0.0) >= NOUGHT * median)
    return out


def obs_share(p: torch.Tensor, r: torch.Tensor) -> float:
    """The share of rows (envs) of `p` with an entry more than OBS_GAP from
    `r`'s, or not finite; 1 where the shapes differ."""
    if p.shape != r.shape:
        return 1.0
    r = r.to(p.device)
    off = ((p - r).abs() > OBS_GAP) | ~torch.isfinite(p)
    return float(off.any(dim=1).float().mean())


def check(values: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit, ok)] for every number; a number whose limit is
    None is read and not compared (ok). A number the limits lack fails."""
    rows = []
    for name, value in values.items():
        if name not in limits:
            rows.append((name, value, None, False))
            continue
        limit = limits[name]
        ok = limit is None or (math.isfinite(value) and value <= limit)
        rows.append((name, value, limit, ok))
    return rows
