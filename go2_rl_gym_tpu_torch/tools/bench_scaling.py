"""One-card env-count sweep of the port's benchmark (the PyTorch twin of the
JAX package's tools/bench_scaling.sh).

Runs `python -m go2_rl_gym_tpu_torch.bench` at 2048, 4096, 8192 and 16384
envs, each size in a subprocess of its own with a timeout of TIMEOUT_S
seconds (one process per size, as the JAX script runs them: a CUDA
graph's memory pool must not outlive its size), and writes each size's
JSON line wrapped as the JAX script wraps it,
`{"num_envs": N, "bench": {...}}`, to
build/bench_scaling.jsonl. The JAX package's record,
doc/evidence/bench_scaling.jsonl, is never written. A size that fails or
times out gets a line whose `bench` holds its `error` (the bench's own
error line where it printed one); the script exits with 1 after the other
sizes have run. BENCH_ITERS and BENCH_REPS pass through to the bench.

Usage:
    python -m go2_rl_gym_tpu_torch.tools.bench_scaling
        [--sizes 2048 4096 8192 16384] [--out build/bench_scaling.jsonl]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from go2_rl_gym_tpu_torch.bench import METRIC, UNIT

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZES = (2048, 4096, 8192, 16384)
OUT = os.path.join(ROOT, "build", "bench_scaling.jsonl")
TIMEOUT_S = 900.0   # seconds allowed to each size's process


def bench_line(num_envs: int, device: str):
    """Run the bench at `num_envs` in a subprocess. Returns (its JSON
    object, whether it succeeded); a failure's object carries `error`."""
    env = {**os.environ, "BENCH_NUM_ENVS": str(num_envs)}
    cmd = [sys.executable, "-m", "go2_rl_gym_tpu_torch.bench",
           "--device", device]
    try:
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"metric": METRIC, "value": 0.0, "unit": UNIT,
                "error": f"timed out after {TIMEOUT_S} s"}, False
    lines = p.stdout.strip().splitlines()
    try:
        bench = json.loads(lines[-1]) if lines else None
    except ValueError:
        bench = None
    if p.returncode == 0 and isinstance(bench, dict) and "error" not in bench:
        return bench, True
    if isinstance(bench, dict) and "error" in bench:
        return bench, False
    tail = (p.stderr.strip().splitlines() or ["no output"])[-1]
    return {"metric": METRIC, "value": 0.0, "unit": UNIT,
            "error": f"exit code {p.returncode}: {tail}"}, False


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = []
    with open(args.out, "w") as f:
        for n in args.sizes:
            print(f"=== BENCH_NUM_ENVS={n} ===", flush=True)
            bench, ok = bench_line(n, args.device)
            if not ok:
                failed.append(n)
            f.write(json.dumps({"num_envs": n, "bench": bench}) + "\n")
            f.flush()
    with open(args.out) as f:
        print(f.read(), end="", flush=True)
    if failed:
        print(f"bench_scaling: failed at {failed} envs", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
