"""The span call's readers (`*_graph_ms_per_iter`,
`learn.launch_host_ms_per_iter`): each on a hand-made context, nothing for
a program without spans, the pairing of stamp kernels with the schedule
and the naming of idle gaps on hand-made raw events, and the span call
itself on a tiny cell on the CPU."""
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from portbench import spans_call, spec
from test_portbench_trace import CPU, CUDA, Ev

from go2_rl_gym_tpu_torch.utils import spans

READERS = {"sim.graph_ms_per_iter": "physics",
           "env.graph_ms_per_iter": "env",
           "agents.act_graph_ms_per_iter": "act",
           "agents.gae_graph_ms_per_iter": "gae",
           "agents.update_graph_ms_per_iter": "update",
           "learn.launch_host_ms_per_iter": "learn.launch"}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_span(name):
    cell = spec.load_cell(ROOT, "moe_cts.rough.8192")
    assert name in {m["name"] for m in cell.per_layer}
    read = spec.metric_reader(cell, name)
    median = {span: float(i + 1) for i, span in enumerate(READERS.values())}
    ctx = SimpleNamespace(spans_call={"median": median})
    assert read(ctx) == median[READERS[name]]
    assert read(SimpleNamespace(spans_call=None)) is None
    assert read(SimpleNamespace(spans_call={"median": {}})) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "go2_rl_gym_tpu_torch.utils.spans",
                        None)
    ctx = SimpleNamespace(cell=None, device_name="cpu")
    assert spans_call.metric(ctx, "physics") is None
    assert ctx.spans_call is None


def _schedule():
    B, E = spans.BEGIN, spans.END
    return (("train_step", B), ("env", B), ("physics", B), ("physics", E),
            ("env", E), ("update", B), ("update", E), ("train_step", E))


def _replay_events(corr, t0):
    """A graph replay launched at t0 with the launch's correlation id: 8
    stamps (listed out of order) around kernels, an idle gap of 10 inside
    the physics (30-40), one of 19 between env and update (71-90)."""
    stamps = [0, 5, 10, 60, 70, 90, 130, 140]
    ev = [Ev("cudaGraphLaunch", CPU, t0, 4, corr=corr)]
    ev += [Ev(spans.STAMP_KERNEL, CUDA, t0 + s, 1, corr=corr)
           for s in reversed(stamps)]
    ev += [Ev("k_phys", CUDA, t0 + 11, 19, corr=corr),    # 11-30
           Ev("k_phys", CUDA, t0 + 40, 20, corr=corr),    # 40-60: gap 30-40
           Ev("k_env", CUDA, t0 + 61, 4, corr=corr),      # 61-65
           Ev("k_upd", CUDA, t0 + 91, 39, corr=corr)]     # 91-130
    return ev


def test_stamps_pair_with_the_schedule_and_gaps_are_named():
    ev = (_replay_events(1, 1000) + _replay_events(2, 2000)
          + [Ev("go2.learn.launch", CPU, 1990, 20),
             Ev("cudaDeviceSynchronize", CPU, 1100, 800),
             Ev("range", CUDA, 0, 5000, corr=9, note=True)])
    replays = spans_call.device_spans(ev, _schedule(), spans)
    assert len(replays) == 2
    assert replays[0] == [("train_step", 1000, 1140), ("env", 1005, 1070),
                          ("physics", 1010, 1060), ("update", 1090, 1130)]
    gaps = spans_call.idle_gaps(ev, replays)
    # between the replays: 1141-2000; then per replay 71-90 and 30-40
    assert gaps[0] == [859 / 1e6, spans_call.OUTSIDE,
                       "cudaDeviceSynchronize"]
    assert [g[:2] for g in gaps[1:5]] == [[19 / 1e6, "train_step"],
                                         [19 / 1e6, "train_step"],
                                         [10 / 1e6, "physics"],
                                         [10 / 1e6, "physics"]]
    # a replay whose stamps the trace lacks is left out
    short = [e for e in ev if not (e.correlation_id() == 2
                                   and e.name() == spans.STAMP_KERNEL
                                   and e.start_ns() == 2000)]
    assert len(spans_call.device_spans(short, _schedule(), spans)) == 1
    assert spans_call.idle_gaps(ev, []) == []


def test_the_span_call_on_a_tiny_cell(tiny_root, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--seed", str(2 ** 40)])
    assert spans_call.run_seed() == 2 ** 40
    cell = spec.load_cell(tiny_root, "tiny.go2_ppo")
    ctx = SimpleNamespace(cell=cell, device_name="cpu")
    got = spans_call.of(ctx)
    assert spans_call.of(ctx) is got
    line = got["line"]
    L = 2 * (3 * 4 + 4)
    assert line["stamps_per_replay"] == L
    assert line["cursor_steps"] == [L] * (spans_call.CALL_ITERS + 1
                                          + spans_call.TRACED)
    for name in READERS.values():
        assert got["median"][name] >= 0
    assert all(0.5 < r <= 1.0 for r in line["span_over_event"])
    assert set(line["traced"]) == set(line["untraced"])
    assert line["gaps"] == [] and line["traced_replays_paired"] == 0
    assert "spans_ms {" in capsys.readouterr().err
    assert spans.current() is None
