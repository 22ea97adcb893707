"""The readings that set a cell's limits: the control, the planted faults
and sound variants, each put in the program's place and followed by the
sound reference as the program is (`compare`), on the card at the cell's
own size.

For each seed and kind, the plain reference runs its `compare.STEPS`
iterations as the kind says, in the program's place, and the sound
reference follows it from its starts; the kinds:

- `tf32`: the control, the reference with TF32 on for its matmuls (the
  nearest precision below the configuration's fp32 with TF32 off);
- `half_batch` and `alter`: the faults of `faults.PLANT` planted in the
  reference put in the program's place;
- the sound variants, no fault, which show what a change of rounding
  alone reads (the lower side of a limit): `deterministic`, the reference
  with torch's deterministic algorithms on; `reorder`, the physics'
  T-layout contractions (`tmath`'s dot, norm, mv, mtv, mm, mtm, mmt) summing
  their terms in the reverse order, as a fused physics kernel may; and
  `fp64_nets`, the networks' matmuls (`F.linear`, `torch.einsum`) in fp64,
  rounded back to fp32;

and prints one JSON line per (seed, kind) with `compare.numbers` of the
broken or varied run against the sound one. A step that leaves its state
unchanged (`freeze`) reads 1 on `dparam` by construction and needs no run.
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--kinds tf32 half_batch alter deterministic reorder fp64_nets]
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.dont_write_bytecode = True
# cuBLAS's deterministic workspace, before its first call (`deterministic`)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root heads the path in place of this folder, so that
# `portbench.trace` cannot stand in for the standard library's `trace`
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) != HERE]

import torch  # noqa: E402

from portbench import compare, faults, follow, spec  # noqa: E402

KINDS = ("tf32", "half_batch", "alter", "deterministic", "reorder",
         "fp64_nets")


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def reorder():
    """The reference's T-layout contractions sum their terms last to first
    (the same terms in fp32, another rounding)."""
    from portbench.reference.sim import tmath as tm

    def summed(x, dim):
        return torch.sum(torch.flip(x, (dim,)), dim=dim)
    swap = {
        "dot": lambda a, b: summed(a * b, -2),
        "norm": lambda a, eps=0.0: torch.sqrt(summed(a * a, -2) + eps),
        "mv": lambda M, v: summed(M * v[..., None, :, :], -2),
        "mtv": lambda M, v: summed(M * v[..., :, None, :], -3),
        "mm": lambda A, B: summed(A[..., :, :, None, :]
                                  * B[..., None, :, :, :], -3),
        "mtm": lambda A, B: summed(A[..., :, :, None, :]
                                   * B[..., :, None, :, :], -4),
        "mmt": lambda A, B: summed(A[..., :, None, :, :]
                                   * B[..., None, :, :, :], -2),
    }
    saved = {k: getattr(tm, k) for k in swap}
    for k, f in swap.items():
        setattr(tm, k, f)
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(tm, k, f)


@contextlib.contextmanager
def fp64_nets():
    """The networks' matmuls (every `F.linear`, `torch.einsum`) of fp32
    operands computed in fp64 and rounded back to fp32."""
    import torch.nn.functional as F
    linear, einsum = F.linear, torch.einsum

    def linear64(x, w, b=None):
        if x.dtype != torch.float32:
            return linear(x, w, b)
        return linear(x.double(), w.double(),
                      None if b is None else b.double()).float()

    def einsum64(eq, *ops):
        if not all(o.dtype == torch.float32 for o in ops):
            return einsum(eq, *ops)
        return einsum(eq, *[o.double() for o in ops]).float()
    F.linear, torch.einsum = linear64, einsum64
    try:
        yield
    finally:
        F.linear, torch.einsum = linear, einsum


SOUND = {"deterministic": deterministic, "reorder": reorder,
         "fp64_nets": fp64_nets}


def readings(cell, seed, device, kinds=KINDS):
    """{kind: numbers of that broken or varied run against the sound
    reference that follows it}."""
    out = {}
    for kind in kinds:
        with SOUND.get(kind, contextlib.nullcontext)():
            broken, starts = follow.run(
                cell, seed, device, tf32=kind == "tf32",
                fault=kind if kind in faults.PLANT else None, keep=True)
        sound, _ = follow.run(cell, seed, device, starts=starts)
        out[kind] = compare.numbers(broken, sound, cell.limits["losses"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=list(KINDS),
                   choices=KINDS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        for kind, values in readings(cell, seed, torch.device("cuda"),
                                     args.kinds).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "numbers": values,
                              "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
