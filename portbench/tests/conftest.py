"""Tests of the benchmark harness (CPU; `gpu`-marked tests decide inside
themselves whether a card is there). Imports no JAX.

    python -m pytest -p no:cacheprovider portbench/tests -q
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a tiny version of each configuration: 2 x 4 sub-terrains with a 3 m
# border, 4 steps per iteration, 16 envs
TINY = {"go2_moe_cts": "moe_cts.rough.8192", "go2_ppo": "ppo.rough.4096"}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")


def add_tiny_cells(root):
    """Add a tiny cell per configuration to the checkout at `root` as new
    files and BENCHMARK.json entries only: configs/tiny_<config>.json,
    traffic/tiny.json, limits/tiny.<config>.json (the full cell's loss keys,
    every limit 1e-6: on the CPU both sides compute alike)."""
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, full in TINY.items():
        with open(os.path.join(bench_dir, "configs", name + ".json")) as f:
            cfg = json.load(f)
        cfg["env_cfg"]["terrain"].update(num_rows=2, num_cols=4,
                                         border_size=3.0)
        cfg["train_cfg"]["runner"]["num_steps_per_env"] = 4
        with open(os.path.join(bench_dir, "configs",
                               f"tiny_{name}.json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(bench_dir, "limits", full + ".json")) as f:
            limits = json.load(f)
        limits["numbers"] = {k: 1e-6 for k in limits["numbers"]}
        with open(os.path.join(bench_dir, "limits",
                               f"tiny.{name}.json"), "w") as f:
            json.dump(limits, f)
        entry = next(c for c in bench["configs"] if c["name"] == name)
        bench["configs"].append(dict(entry, name="tiny_" + name,
                                     file=f"portbench/configs/tiny_{name}"
                                          ".json"))
        bench["workloads"].append({"name": "tiny." + name,
                                   "config": "tiny_" + name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "a CPU test's size"})
    with open(os.path.join(bench_dir, "traffic", "tiny.json"), "w") as f:
        json.dump({"num_envs": 16, "random_start": True}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark (BENCHMARK.json and portbench/, the frozen
    reference left out: it is imported from this checkout) with the tiny
    cells added."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("reference", "__pycache__",
                                                  "tests"))
    add_tiny_cells(root)
    return root
