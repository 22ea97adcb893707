"""The substep's rigid-body dynamics as one hand-written CUDA kernel.

``rigid_body_cuda`` launches ``csrc/rigid_body.cu``: from the batch-last
state it computes what sim/tengine.py's ``rigid_body_plain`` computes (the
world kinematics, the geoms, the joint-limit spring, CRBA/RNEA and the
block-Schur factors) in one launch. sim/tengine.py's ``rigid_body`` takes it
for CUDA tensors and the plain version for CPU tensors; there is no fallback
from one to the other.

``tables`` packs the model's constants for the kernel once, when the physics
step is built: nothing is copied from the host in a substep, so the launch
is captured into a CUDA graph like any other kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from go2_rl_gym_tpu_torch.ops import cuda_build

NLEG = 4
DEPTH = 3
NBODY = 1 + NLEG * DEPTH
# the float table: axes (4,3,3), origins (4,3,3), lower (12,), upper (12,),
# gravity (3,), then the geom offsets (G,3); the int table: each body's
# first entry in the geom order (14,), then the geoms sorted by body (G,)
_TABLE_HEAD = 99
_ITABLE_HEAD = NBODY + 1

SOURCE = "ops/csrc/rigid_body.cu"

# launches of the CUDA kernel, counted where it is launched and nowhere else
LAUNCHES = {"rigid_body": 0}


def tables(axes, origins, dof_lower, dof_upper, gravity, geom_body,
           geom_offset, device):
    """The kernel's float and int tables on `device` from the model's
    arrays: axes and origins (NLEG, DEPTH, 3), joint limits (12,), gravity
    (3,), geom_body (G,), geom_offset (G, 3)."""
    axes = np.asarray(axes, np.float32)
    origins = np.asarray(origins, np.float32)
    if axes.shape != (NLEG, DEPTH, 3) or origins.shape != (NLEG, DEPTH, 3):
        raise ValueError(f"the kernel takes {NLEG} legs of {DEPTH} joints, "
                         f"got axes {axes.shape} and origins "
                         f"{origins.shape}")
    gb = np.asarray(geom_body, np.int64)
    if gb.size and (gb.min() < 0 or gb.max() >= NBODY):
        raise ValueError(f"geom bodies must lie in [0, {NBODY})")
    table = np.concatenate([
        axes.ravel(), origins.ravel(),
        np.asarray(dof_lower, np.float32).ravel(),
        np.asarray(dof_upper, np.float32).ravel(),
        np.asarray(gravity, np.float32).ravel(),
        np.asarray(geom_offset, np.float32).ravel()]).astype(np.float32)
    if table.size != _TABLE_HEAD + 3 * gb.size:
        raise ValueError("joint limits must be (12,), gravity (3,) and geom "
                         "offsets (G, 3)")
    order = np.argsort(gb, kind="stable")
    start = np.searchsorted(gb[order], np.arange(NBODY + 1))
    itable = np.concatenate([start, order]).astype(np.int32)
    return (torch.as_tensor(table, device=device),
            torch.as_tensor(itable, device=device))


def scalars(dt, armature, stiffness, damping):
    """The kernel's scalars as the plain version's float32 ops read the
    Python numbers: dt, armature, the joint-limit stiffness k, k dt and
    k dt + the joint-limit damping."""
    return [float(np.float32(x)) for x in (
        dt, armature, stiffness, stiffness * dt, stiffness * dt + damping)]


def output_shapes(G):
    """The outputs' shapes without the trailing env axis: gpos, gvel, jpos,
    axis_w, Rbase, rhs0, B, Dinv, Sinv."""
    return [(G, 3), (G, 3), (12, 3), (12, 3), (3, 3), (18,),
            (NLEG, DEPTH, 6), (NLEG, DEPTH, 3), (6, 6)]


def c_args(strided, mass, com, inertia, table, itable, outs, scalars):
    """The C entry points' arguments: the pointer array (the 8 strided
    (rows, N) inputs, mass, com, inertia, the tables, the 9 outputs), the
    strided inputs' strides and the 5 scalars."""
    ptrs = (ctypes.c_void_p * 22)(
        *[x.data_ptr() for x in strided], mass.data_ptr(), com.data_ptr(),
        inertia.data_ptr(), table.data_ptr(), itable.data_ptr(),
        *[o.data_ptr() for o in outs])
    strides = (ctypes.c_longlong * 16)(*[s for x in strided
                                         for s in x.stride()])
    return ptrs, strides, (ctypes.c_float * 5)(*scalars)


@functools.cache
def _launch_fn():
    return cuda_build.load(
        SOURCE, "rigid_body_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p])


def _check(name, x, shape, device, contiguous=False):
    if x.dtype != torch.float32:
        raise TypeError(f"rigid_body: {name} must be float32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"rigid_body: {name} lies on {x.device}, not "
                         f"{device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"rigid_body: {name} must be {shape}, got "
                         f"{tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"rigid_body: {name} must be contiguous")


def rigid_body_cuda(state, tau, damping, mass, com, inertia, table, itable,
                    scalars):
    """Hand-written Hopper kernel (csrc/rigid_body.cu).

    state: (pos (3,N), quat (4,N), q (12,N), lin (3,N), ang (3,N),
    qd (12,N)), any strides; tau and damping (12,N), any strides; mass
    (13,N), com (13,3,N), inertia (13,3,3,N), contiguous; `table`, `itable`
    from `tables`; `scalars` from `scalars`. Returns gpos, gvel (G,3,N),
    jpos, axis_w (12,3,N), Rbase (3,3,N), rhs0 (18,N), B (4,3,6,N), Dinv
    (4,3,3,N), Sinv (6,6,N), equal bit for bit to `rigid_body_plain`'s on
    the card.

    Replaces no TPU kernel (the JAX package leaves the physics to XLA).
    Memory-bound: 3.76 KB an env (30.8 MB at 8192 envs)."""
    rows = (3, 4, 12, 3, 3, 12)
    names = ("pos", "quat", "q", "lin", "ang", "qd")
    if len(state) != len(rows):
        raise ValueError(f"rigid_body: state must hold {names}")
    dev = state[0].device
    N = state[0].shape[-1]
    for name, x, r in zip(names, state, rows):
        _check(name, x, (r, N), dev)
    _check("tau", tau, (12, N), dev)
    _check("damping", damping, (12, N), dev)
    _check("mass", mass, (NBODY, N), dev, contiguous=True)
    _check("com", com, (NBODY, 3, N), dev, contiguous=True)
    _check("inertia", inertia, (NBODY, 3, 3, N), dev, contiguous=True)
    G = (table.numel() - _TABLE_HEAD) // 3
    _check("table", table, (_TABLE_HEAD + 3 * G,), dev, contiguous=True)
    if itable.dtype != torch.int32 or itable.device != dev or tuple(
            itable.shape) != (_ITABLE_HEAD + G,) or not itable.is_contiguous():
        raise ValueError(f"rigid_body: itable must be contiguous int32 "
                         f"({_ITABLE_HEAD + G},) on {dev}")
    if len(scalars) != 5:
        raise ValueError("rigid_body: scalars are dt, armature, k, k dt and "
                         "k dt + damping")
    if dev.type != "cuda":
        raise ValueError("rigid_body_cuda takes CUDA tensors")

    outs = tuple(torch.empty(shape + (N,), dtype=torch.float32, device=dev)
                 for shape in output_shapes(G))
    ptrs, strides, sc = c_args((*state, tau, damping), mass, com, inertia,
                               table, itable, outs, scalars)
    # under torch.profiler a range marks the ctypes launch, which no op of
    # torch makes (see terrain_patches.extract_patches_cuda)
    profiled = torch.autograd._profiler_enabled()
    with torch.cuda.device(dev), (
            torch.profiler.record_function("rigid_body") if profiled
            else contextlib.nullcontext()):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch_fn()(ptrs, strides, N, sc, stream)
    if err != 0:
        raise RuntimeError(f"rigid_body: kernel launch failed with cudaError "
                           f"{err}")
    LAUNCHES["rigid_body"] += 1
    return outs
