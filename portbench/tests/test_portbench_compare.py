"""The comparison's pieces: a state copied across to the reference's own
tree, the share of envs off, the numbers, and the control's readings at a
tiny size on the CPU."""
import math
from typing import NamedTuple

import pytest
import torch

from portbench import compare, control, spec


class Inner(NamedTuple):
    x: torch.Tensor
    gen: torch.Generator


class Outer(NamedTuple):
    inner: Inner
    n: torch.Tensor
    pairs: tuple


class Program(NamedTuple):
    inner: Inner
    n: torch.Tensor
    pairs: tuple
    memory: tuple = ()


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return Program(Inner(torch.randn(3, 2, generator=g), g),
                   torch.arange(4, dtype=torch.int32),
                   (torch.ones(2), torch.zeros(1)))


def test_a_snapshot_fills_the_reference_tree():
    prog = _tree(1)
    copied = compare.plain(prog)
    x0 = prog.inner.x.clone()
    prog.inner.x.add_(1.0)                      # the copy is its own
    torch.randn(5, generator=prog.inner.gen)    # and so is the generator
    template = Outer(*_tree(2)[:3])
    got = compare.fill(template, copied)
    assert type(got) is Outer and type(got.inner) is Inner
    assert torch.equal(got.inner.x, x0)
    assert torch.equal(got.n, prog.n) and got.n.dtype == torch.int32
    again = torch.Generator().manual_seed(1)
    torch.randn(3, 2, generator=again)
    assert torch.equal(torch.randn(4, generator=got.inner.gen),
                       torch.randn(4, generator=again))
    with pytest.raises(ValueError):
        compare.fill(template, compare.plain(prog._replace(
            n=torch.arange(5, dtype=torch.int32))))
    with pytest.raises(KeyError):
        compare.fill(Program(*_tree(3)), compare.plain(Outer(*_tree(1)[:3])))


def test_obs_share_counts_envs_off():
    r = torch.zeros(4, 3)
    p = r.clone()
    p[1, 2] = 2 * compare.OBS_GAP
    p[3, 0] = 0.5 * compare.OBS_GAP
    assert compare.obs_share(p, r) == 0.25
    p[2, 1] = math.nan
    assert compare.obs_share(p, r) == 0.5
    assert compare.obs_share(torch.zeros(3, 3), r) == 1.0


def _it(loss, grad, dparam, obs):
    return compare.Iteration({"value_loss": loss}, grad, dparam, obs)


def test_numbers_by_hand():
    obs = torch.zeros(4, 2)
    off = obs.clone()
    off[0, 0] = 1.0
    grad = {"a": 1.0, "b": 2.0, "c": 1e-6}
    ref = [_it(2.0, grad, {"a": 1.0, "b": 1.0, "c": 1.0}, obs)] * 3
    prog = [_it(2.2, {"a": 1.0, "b": 2.5, "c": 1e-6},
                {"a": 1.0, "b": 1.5, "c": 9.0}, off)] * 3
    got = compare.numbers(prog, ref, ["value_loss"])
    for k in (1, 2, 3):
        assert got[f"loss.{k}"] == pytest.approx(0.1)
        assert got[f"obs.{k}"] == 0.25
        # "c" is left out: its gradient is under NOUGHT of the median
        assert got[f"dparam.{k}"] == pytest.approx(0.5)
    # |2.5 - 2| / max(2, median 1)
    assert got["grad.1"] == pytest.approx(0.25)
    short = compare.numbers(prog[:1], ref, ["value_loss"])
    assert short["loss.2"] == short["obs.3"] == short["dparam.2"] == math.inf
    rows = compare.check(got, {k: 1.0 for k in got})
    assert all(ok for *_, ok in rows)


def test_control_readings_on_the_cpu(tiny_root):
    """The control's path at a tiny size: a fault planted in the reference
    put in the program's place reads far off, a change of rounding in the
    physics' sums reads near."""
    cell = spec.load_cell(tiny_root, "tiny.go2_ppo")
    got = control.readings(cell, 5, torch.device("cpu"),
                           kinds=("half_batch", "reorder"))
    assert got["half_batch"]["loss.1"] > 1e-2
    assert max(got["reorder"].values()) < 1e-1
    assert set(got["reorder"]) == set(cell.limits["numbers"])
