"""Nothing the benchmark runs imports JAX or the JAX package, and the
frozen reference imports nothing of the program: every import statement of
every module, compared by whole top-level names (`go2_rl_gym_tpu_torch`
begins with `go2_rl_gym_tpu` and is not it)."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness

BENCH = os.path.join(ROOT, "portbench")
JAX = {"jax", "jaxlib", "flax", "go2_rl_gym_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules(under):
    for d, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(modules(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted(modules(os.path.join(BENCH,
                                                             "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"go2_rl_gym_tpu_torch"})


def test_whole_names_are_compared():
    assert top_level_imports(__file__) & JAX == set()
    sys.modules.setdefault("go2_rl_gym_tpu_torch_fake", sys)
    try:
        assert "go2_rl_gym_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["go2_rl_gym_tpu_torch_fake"]


def test_a_run_loads_none_of_them():
    """The modules a run imports, the program's and the reference's, leave
    none of JAX's names in sys.modules (a fresh interpreter)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, follow, control\n"
            "import go2_rl_gym_tpu_torch.train.runner, "
            "go2_rl_gym_tpu_torch.utils.registry\n"
            "import portbench.reference.train.runner, "
            "portbench.reference.utils.registry\n"
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
