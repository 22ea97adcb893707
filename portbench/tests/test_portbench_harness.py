"""The harness: cells, configurations and metrics found by name, the result
line, a cell added as new files, and `correct` under planted faults."""
import json
import math
import os
import re

import pytest
import torch

from conftest import ROOT
from portbench import harness, spec

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_with_its_files(workload):
    cell = spec.load_cell(ROOT, workload)
    assert cell.workload["name"] == workload
    assert {m["name"] for m in cell.end_to_end} >= {
        "env_steps_per_s", "iter_ms_p90", "setup_s"}
    assert cell.per_layer
    assert set(cell.limits["numbers"]) == {
        "loss.1", "loss.2", "loss.3", "obs.1", "obs.2", "obs.3", "grad.1",
        "dparam.1", "dparam.2", "dparam.3"}
    assert cell.traffic["num_envs"] > 0
    for m in cell.per_layer:
        assert callable(spec.metric_reader(cell, m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_file_is_the_task_as_run(config):
    """The file holds every field of the task's configs, as the port's
    registry builds them: `apply` writes it and finds nothing left over."""
    from go2_rl_gym_tpu_torch.utils import registry
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, entry["file"])) as f:
        values = json.load(f)
    env_cfg, train_cfg = registry.get_cfgs(values["task"])
    import dataclasses
    assert json.loads(json.dumps(dataclasses.asdict(env_cfg))) == \
        values["env_cfg"]
    assert json.loads(json.dumps(dataclasses.asdict(train_cfg))) == \
        values["train_cfg"]
    spec.apply(env_cfg, values["env_cfg"])
    assert entry["source"] == values["source"]
    assert entry["reduced"] == values["reduced"]


def test_apply_refuses_a_file_that_differs():
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg
    cfg = Go2Cfg()
    with pytest.raises(KeyError):
        spec.apply(cfg, {"no_such_field": 1})
    import dataclasses
    values = json.loads(json.dumps(dataclasses.asdict(Go2Cfg())))
    del values["env"]["num_envs"]
    with pytest.raises(ValueError):
        spec.apply(Go2Cfg(), values)


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_without_a_card_the_command_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", BENCH["workloads"][0]["name"],
                       "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_program_is_refused(tmp_path):
    """Only BENCHMARK.json and portbench/: the program found elsewhere on
    the path is not measured."""
    harness.check_program(ROOT)
    with pytest.raises((RuntimeError, ImportError)):
        harness.check_program(str(tmp_path))


def test_p90_is_the_nearest_rank():
    assert harness.p90(list(range(1, 11))) == 9
    assert harness.p90(list(range(1, 101))) == 90
    assert harness.p90([5.0]) == 5.0


def _check_line(result, traced):
    line = json.dumps(result)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert isinstance(back["correct"], bool)
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    dev = back["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(back["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("config", ["go2_ppo", "go2_moe_cts"])
def test_a_cell_added_as_files_runs_in_a_copy(tiny_root, config):
    """The tiny cells exist only as files added to a copy (no file of the
    benchmark edited); the harness finds and runs them, and the program
    and the reference agree on the CPU."""
    for rel in ("portbench/harness.py", "portbench/spec.py",
                "portbench/configs/go2_moe_cts.json"):
        with open(os.path.join(ROOT, rel)) as a, \
                open(os.path.join(tiny_root, rel)) as b:
            assert a.read() == b.read()
    cell = spec.load_cell(tiny_root, "tiny." + config)
    res = harness.run_cell(cell, 2 ** 31 + 12345, 0.5, True, "cpu")
    _check_line(res, True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert all(c["value"] == 0.0 for c in res["checks"].values())
    assert "learn.host_ms_per_iter" in res["metrics"]
    res = harness.run_cell(cell, 7, 0.5, False, "cpu")
    _check_line(res, False)
    assert set(res["metrics"]) == {"env_steps_per_s", "iter_ms_p90",
                                   "setup_s"}


@pytest.mark.parametrize("fault", ["freeze", "half_batch", "alter"])
def test_a_broken_step_is_not_correct(tiny_root, fault):
    """The timed path broken underneath (the fault planted in the
    program's algorithm or env): `correct` comes out false."""
    cell = spec.load_cell(tiny_root, "tiny.go2_ppo")
    res = harness.run_cell(cell, 11, 0.5, False, "cpu", fault=fault)
    assert res["correct"] is False, res["checks"]
    if fault == "freeze":
        assert res["checks"]["dparam.3"]["value"] == pytest.approx(1.0)
