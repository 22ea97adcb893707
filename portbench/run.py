"""The benchmark of go2_rl_gym_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, on a machine with
the card(s) the cell asks for (see portbench/harness.py and PERF.md).
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# nothing of the run is written inside the checkout but the kernel build
# (build/kernels/, where the port keeps it)
sys.dont_write_bytecode = True
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root heads the path in place of this folder, so that
# `portbench.trace` cannot stand in for the standard library's `trace`
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]
# kernel caches at fixed paths inside the checkout, should anything build
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
