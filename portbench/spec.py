"""The benchmark's data: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it:

- configs/<config>.json       the configuration as it is run (the `file`
                              of its BENCHMARK.json entry)
- traffic/<traffic>.json      the traffic mix: env count and start state
- limits/<workload>.json      the limit of each number `correct` compares
- metrics/<metric>.py         the reader of a per-layer metric

A later cell, configuration or metric is added by adding such files and
BENCHMARK.json entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


class Cell(NamedTuple):
    """One workload of BENCHMARK.json with everything it names."""
    root: str                   # the checkout that holds BENCHMARK.json
    bench_dir: str              # its benchmark folder (`paths`[0])
    workload: Dict[str, Any]    # its entry in `workloads`
    config: Dict[str, Any]      # the configuration file's contents
    traffic: Dict[str, Any]     # the traffic file's contents
    limits: Dict[str, Any]      # the limits file's contents
    end_to_end: List[Dict[str, Any]]   # the end-to-end metrics it reports
    per_layer: List[Dict[str, Any]]    # the per-layer metrics it reports


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict[str, Any], name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json. Raises KeyError for a name
    the file lacks and FileNotFoundError for a file it names that is
    missing."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    bench_dir = os.path.join(root, bench["paths"][0])
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    limits = _read_json(os.path.join(bench_dir, "limits", name + ".json"))
    return Cell(root=root, bench_dir=bench_dir, workload=w, config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def metric_reader(cell: Cell, name: str):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = os.path.join(cell.bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _as_field(value, current):
    """A JSON value in the type of the dataclass field it replaces: lists
    become tuples where the field holds a tuple."""
    if isinstance(current, tuple) and isinstance(value, list):
        return tuple(_as_field(v, c) for v, c in
                     zip(value, current + (None,) * len(value)))
    return value


def apply(obj, values: Dict[str, Any]):
    """Write a configuration file's values into a config dataclass in place
    (nested dataclasses field by field), then check that the dataclass now
    reads exactly as the file: a key the file has and the dataclass lacks,
    or one the dataclass has and the file lacks, raises. Returns `obj`."""
    for key, value in values.items():
        if not hasattr(obj, key):
            raise KeyError(f"{type(obj).__name__} has no field {key!r}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current):
            apply(current, value)
        else:
            setattr(obj, key, _as_field(value, current))
    got = json.loads(json.dumps(dataclasses.asdict(obj)))
    if got != values:
        diff = sorted(k for k in set(got) | set(values)
                      if got.get(k) != values.get(k))
        raise ValueError(f"{type(obj).__name__} differs from the "
                         f"configuration file at {diff}")
    return obj


def build_cfgs(registry, cell: Cell):
    """(env cfg, train cfg) of the cell from a task registry (the port's
    or the reference's): the task's configs, the configuration file's
    values written into them, the traffic's env count over them."""
    env_cfg, train_cfg = registry.get_cfgs(cell.config["task"])
    apply(env_cfg, cell.config["env_cfg"])
    apply(train_cfg, cell.config["train_cfg"])
    env_cfg.env.num_envs = int(cell.traffic["num_envs"])
    return env_cfg, train_cfg
