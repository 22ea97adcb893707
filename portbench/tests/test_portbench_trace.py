"""The trace reductions on hand-made events: busy time, kernels per
replay, lost launches, idle gaps, and device time by range."""
import pytest
import torch

from portbench import trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, note=False):
        self._v = (name, dev, start, dur, corr, note)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_reduce_counts_replays_busy_time_and_gaps():
    ev = [Ev("cudaGraphLaunch", CPU, 0, 5, corr=1),
          Ev("cudaGraphLaunch", CPU, 100, 5, corr=2),
          Ev("cudaDeviceSynchronize", CPU, 140, 100),
          Ev("k_a", CUDA, 10, 20, corr=1), Ev("k_b", CUDA, 25, 10, corr=1),
          Ev("Memcpy DtoD", CUDA, 40, 5, corr=1),
          Ev("k_a", CUDA, 110, 20, corr=2), Ev("k_b", CUDA, 160, 10, corr=2),
          Ev("Memcpy DtoD", CUDA, 175, 5, corr=2),
          Ev("range", CUDA, 0, 500, corr=9, note=True)]
    r = trace.reduce(ev, 1e-6, 2)
    # union: [10,35] [40,45] [110,130] [160,170] [175,180] = 25+5+20+10+5
    assert r["busy_s"] == 65 / 1e9
    # the device's own span of the replays, not the host's 1e-6 s
    assert r["window_s"] == 170 / 1e9 and r["host_s"] == 1e-6
    # replay 1 spans [10,45] busy 30, replay 2 [110,180] busy 35
    assert r["replay_s"] == 105 / 1e9
    assert r["replay_idle_s"] == 40 / 1e9
    assert r["between_s"] == [65 / 1e9]
    assert r["per_replay"] == [2, 2] and r["kernels"] == 4
    assert r["lost"] == 0
    assert r["by_name"]["k_a"] == {"ns": 40, "count": 2}
    assert r["gaps"][0] == ["host (no runtime call)", 65 / 1e9]
    assert r["gaps"][1] == ["cudaDeviceSynchronize", 30 / 1e9]


def test_device_metrics_read_the_device_clock():
    from types import SimpleNamespace

    from conftest import ROOT
    from portbench import spec
    ev = [Ev("cudaGraphLaunch", CPU, 0, 5, corr=1),
          Ev("cudaGraphLaunch", CPU, 100, 5, corr=2),
          Ev("k", CUDA, 10, 20, corr=1), Ev("k", CUDA, 40, 10, corr=1),
          Ev("k", CUDA, 60, 30, corr=2),
          # a copy before the first launch: outside the replays' span
          Ev("Memcpy HtoD", CUDA, 0, 2, corr=7)]
    ctx = SimpleNamespace(profile=trace.reduce(ev, 5.0, 2))
    assert ctx.profile["window_s"] == 80 / 1e9
    assert ctx.profile["busy_s"] == 60 / 1e9
    cell = spec.load_cell(ROOT, "ppo.rough.4096")

    def read(name):
        return spec.metric_reader(cell, name)(ctx)
    # span [10,90]: busy 60; replay 1 [10,50] idle 10, replay 2 [60,90]
    assert read("device.idle_pct") == pytest.approx(100.0 * (1 - 60 / 80))
    assert read("device.idle_in_replay_pct") == pytest.approx(100 * 10 / 70)
    assert read("device.between_replays_ms") == pytest.approx(10 / 1e6)
    empty = SimpleNamespace(profile=trace.reduce([], 5.0, 0))
    assert spec.metric_reader(cell, "device.idle_pct")(empty) is None
    assert spec.metric_reader(cell, "device.between_replays_ms")(empty) is None


def test_reduce_counts_lost_kernels():
    ev = [Ev("cudaGraphLaunch", CPU, 0, 5, corr=1),
          Ev("cudaGraphLaunch", CPU, 100, 5, corr=2),
          Ev("cudaLaunchKernel", CPU, 200, 5, corr=3),
          Ev("k", CUDA, 10, 5, corr=1), Ev("k", CUDA, 20, 5, corr=1),
          Ev("k", CUDA, 110, 5, corr=2)]
    r = trace.reduce(ev, 1e-6, 2)
    assert r["lost"] == 1 + 1


def test_attribute_by_innermost_range():
    ev = [Ev("portbench.env", CPU, 0, 100), Ev("portbench.sim", CPU, 20, 30),
          Ev("portbench.update", CPU, 200, 50),
          Ev("cudaLaunchKernel", CPU, 10, 1, corr=1),
          Ev("cudaLaunchKernel", CPU, 25, 1, corr=2),
          Ev("cudaMemcpyAsync", CPU, 60, 1, corr=3),
          Ev("cudaLaunchKernel", CPU, 150, 1, corr=4),
          Ev("cudaLaunchKernel", CPU, 210, 1, corr=5),
          Ev("cudaLaunchKernel", CPU, 220, 1, corr=6),
          Ev("k1", CUDA, 12, 7, corr=1), Ev("k2", CUDA, 30, 11, corr=2),
          Ev("Memcpy HtoD", CUDA, 70, 3, corr=3),
          Ev("k4", CUDA, 155, 2, corr=4), Ev("k5", CUDA, 215, 13, corr=5),
          Ev("portbench.sim", CUDA, 30, 11, corr=7, note=True)]
    got = trace.attribute(ev)
    assert got["ns"] == {"env": 10, "sim": 11, "other": 2, "update": 13}
    assert got["lost"] == 1


def test_ranges_wrap_and_restore():
    class Obj:
        def f(self, x):
            return x + 1
    o = Obj()
    o.g = lambda x: 2 * x
    before_g = o.g
    with trace.ranges([(o, "f", "a"), (o, "g", "b")]):
        assert o.f(1) == 2 and o.g(2) == 4
        assert "f" in o.__dict__
    assert "f" not in o.__dict__ and o.g is before_g


def test_a_window_that_lost_kernels_is_taken_again():
    from portbench import harness
    got = iter([{"lost": 2}, {"lost": 1}, {"lost": 0}, {"lost": 0}])
    assert harness.whole(lambda: next(got)) == ({"lost": 0}, 3)
    always = iter([{"lost": 1, "k": i} for i in range(5)])
    assert harness.whole(lambda: next(always)) == ({"lost": 1, "k": 2}, 3)
    assert harness.whole(lambda: {"lost": 0}) == ({"lost": 0}, 1)
