"""Native (.g2p) policy export + ctypes loader for the C++ inference shim
(PyTorch port of go2_rl_gym_tpu/export/native.py).

The reference deploys through the TorchScript C++ runtime; the project's
native deployment path is `native/go2_infer` (dependency-free C++). This
module writes the .g2p binary the shim consumes and wraps the shared library
for in-process use / testing. The library is built from the sources in
`native/go2_infer/` into `build/native/libgo2_infer.so`, never next to the
sources.

Binary layout (little-endian):
    u32 magic "G2P1" | u32 family | u32 num_obs | u32 num_actions | u32 hist
    family 0 (cts):      MLP student
    family 1 (moe_cts):  u32 E | u32 H | u32 latent | MLP backbone |
                         f32 head_w[E*H*latent] | f32 head_b[E*latent] |
                         MLP gating
    then: MLP actor
    MLP: u32 n_layers | u32 last_activation | n x (u32 in | u32 out |
         f32 w[out*in] row-major | f32 b[out])
"""
from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile
from typing import Optional

import numpy as np

MAGIC = 0x47325031
FAMILY_IDS = {"cts": 0, "moe_cts": 1}

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC_DIR = os.path.join(_ROOT, "native", "go2_infer")
_SOURCES = ("go2_infer.cpp", "onnx_runtime.cpp")
_HEADERS = ("onnx_runtime.h",)
_SO = os.path.join(_ROOT, "build", "native", "libgo2_infer.so")


def _write_mlp(f, fparams, last_activation=False):
    keys = sorted(fparams.keys(), key=lambda k: int(k[2:]))
    f.write(struct.pack("<II", len(keys), int(last_activation)))
    for k in keys:
        kern = np.asarray(fparams[k]["kernel"], np.float32)   # (in, out)
        bias = np.asarray(fparams[k]["bias"], np.float32)
        inn, out = kern.shape
        f.write(struct.pack("<II", inn, out))
        f.write(np.ascontiguousarray(kern.T).tobytes())       # row-major (out, in)
        f.write(bias.tobytes())


def export_policy_as_native(params, family: str, out_dir: str,
                            filename: str = "policy.g2p", num_obs: int = 45,
                            num_actions: int = 12,
                            history_length: int = 5) -> str:
    if family not in FAMILY_IDS:
        raise ValueError(f"native export supports {sorted(FAMILY_IDS)}, "
                         f"got {family!r}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    p = params["params"]
    with open(path, "wb") as f:
        f.write(struct.pack("<IIIII", MAGIC, FAMILY_IDS[family], num_obs,
                            num_actions, history_length))
        if family == "cts":
            _write_mlp(f, p["student_encoder"])
        else:
            moe = p["student_encoder"]["moe"]
            head_w = np.asarray(moe["experts"]["head_kernel"], np.float32)
            head_b = np.asarray(moe["experts"]["head_bias"], np.float32)
            E, H, L = head_w.shape
            f.write(struct.pack("<III", E, H, L))
            _write_mlp(f, moe["experts"]["backbone"], last_activation=True)
            f.write(np.ascontiguousarray(head_w).tobytes())
            f.write(np.ascontiguousarray(head_b).tobytes())
            _write_mlp(f, moe["gating"])
        _write_mlp(f, p["actor"])
    return path


def build_library(force: bool = False) -> str:
    """Compile the C++ shim with g++ into build/native/libgo2_infer.so,
    again when a source or header is newer than the library. The library
    is written under a temporary name and renamed, so that a process that
    builds at the same time never loads a half-written file."""
    srcs = [os.path.join(_SRC_DIR, f) for f in _SOURCES]
    newest_src = max(os.path.getmtime(os.path.join(_SRC_DIR, f))
                     for f in _SOURCES + _HEADERS)
    if os.path.exists(_SO) and not force and (
            os.path.getmtime(_SO) >= newest_src):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                        "-o", tmp, *srcs], check=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


class NativePolicy:
    """ctypes wrapper over libgo2_infer for in-process inference/testing:
    a .g2p file (cts, moe_cts) or an .onnx file of export/onnx_native.py
    (every family)."""

    def __init__(self, g2p_path: str, lib_path: Optional[str] = None):
        lib_path = lib_path or build_library()
        self._lib = ctypes.CDLL(lib_path)
        self._lib.go2_policy_load.restype = ctypes.c_void_p
        self._lib.go2_policy_load.argtypes = [ctypes.c_char_p]
        self._lib.go2_policy_infer.restype = ctypes.c_int
        self._lib.go2_policy_infer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        self._lib.go2_policy_reset.restype = None
        self._lib.go2_policy_reset.argtypes = [ctypes.c_void_p]
        self._lib.go2_policy_free.restype = None
        self._lib.go2_policy_free.argtypes = [ctypes.c_void_p]
        self._lib.go2_policy_num_obs.restype = ctypes.c_int
        self._lib.go2_policy_num_obs.argtypes = [ctypes.c_void_p]
        self._lib.go2_policy_num_actions.restype = ctypes.c_int
        self._lib.go2_policy_num_actions.argtypes = [ctypes.c_void_p]
        self._h = self._lib.go2_policy_load(g2p_path.encode())
        if not self._h:
            raise RuntimeError(f"failed to load {g2p_path}")
        self.num_obs = self._lib.go2_policy_num_obs(self._h)
        self.num_actions = self._lib.go2_policy_num_actions(self._h)

    def reset(self):
        self._lib.go2_policy_reset(self._h)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32).reshape(-1)
        if obs.size != self.num_obs:
            raise ValueError(f"obs has {obs.size} entries, the policy reads "
                             f"{self.num_obs}")
        out = np.zeros(self.num_actions, np.float32)
        rc = self._lib.go2_policy_infer(
            self._h,
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError("inference failed")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.go2_policy_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
