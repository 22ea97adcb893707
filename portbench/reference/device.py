"""Device selection for the port's entry points.

Every entry point (``Go2Env``, ``OnPolicyRunner``, ``scripts.play.play``)
takes a ``device`` argument that defaults to ``"cuda"``. Without a card that
default raises: nothing falls back to the CPU silently. Tests and CPU runs pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is no
    card. On CUDA, turn TF32 off for matmuls and convolutions: the physics
    and the policy run in full fp32, as the JAX reference computes its
    one-hot contractions at HIGHEST precision (sim/tengine.py:385-390,
    ops/terrain_patches.py:257-264)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
