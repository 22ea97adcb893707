"""Patch-based terrain pipeline (PyTorch port of go2_rl_gym_tpu/ops/terrain_patches.py).

1. At terrain build, ``build_channels`` precomputes a channel-major (3, C', R')
   grid [hmin, dx, dy] (x minor): hmin is the reference's min-of-3 height
   (legged_robot.py:1218-1222), dx/dy are centred slopes with the riser snap.
2. Once per policy step, ``extract_patches`` cuts one (3, 32, 32) window
   around each env's base into a dense (N, 3, 1024) tensor. One window
   serves the contact lookups of all 4 substeps and the 187-point height
   scan.
3. Every query is then an in-patch ``lookup``: a gather over the flattened
   1024 axis.

In this frozen copy ``extract_patches`` is the plain PyTorch version on
every device (the port launches its CUDA kernel on a CUDA tensor).
"""
from __future__ import annotations

import numpy as np
import torch

PATCH = 32

# Slopes above this are risers/cliffs, not walkable inclines: the reference
# corrects them to vertical surfaces when converting the heightfield to the
# PhysX trimesh (legged_robot_config.py:40 `slope_treshold = 0.75`). Wherever
# any ONE-CELL height jump exceeds this grade the contact normal snaps to the
# vertical tread normal.
RISER_SLOPE_THRESHOLD = 0.75

# The channel grid keeps the reference's padding (C' to a multiple of 8 and
# >= 40, R' to a multiple of 128 and >= 256, edge-replicated). The kernel
# does not need it, but compute_origins clamps to the padded extent, so an
# env near the grid edge gets the same window as in the JAX package.
_LANE = 128
_SUB = 8
_WIN_X = 2 * _LANE
_WIN_Y = PATCH + _SUB


def _pad_to(n, m):
    return ((n + m - 1) // m) * m


def build_channels(height_m: np.ndarray, horizontal_scale: float,
                   riser_threshold: float = RISER_SLOPE_THRESHOLD
                   ) -> np.ndarray:
    """(R, C) heights -> channel-major (3, C', R') [hmin, dx, dy] grid.

    Bit-exact with the JAX package's build_channels (numpy, same operations
    in the same order) at the default `riser_threshold`; the JAX package
    reads its module global instead, and inf turns the snap off."""
    h = np.asarray(height_m, np.float32)
    hx = np.roll(h, -1, axis=0)
    hx[-1] = h[-1]
    hy = np.roll(h, -1, axis=1)
    hy[:, -1] = h[:, -1]
    hmin = np.minimum(np.minimum(h, hx), hy)
    # centred differences of hmin (what the direct path's normal computes)
    pad = np.pad(hmin, 1, mode="edge")
    dx = (pad[2:, 1:-1] - pad[:-2, 1:-1]) / (2 * horizontal_scale)
    dy = (pad[1:-1, 2:] - pad[1:-1, :-2]) / (2 * horizontal_scale)
    # riser snap: detection uses ONE-CELL jumps (the centred difference
    # halves a single-cell riser's grade and would miss it)
    ddx = np.abs(np.diff(pad, axis=0)) / horizontal_scale    # (R+1, C+2)
    ddy = np.abs(np.diff(pad, axis=1)) / horizontal_scale    # (R+2, C+1)
    riser = ((np.maximum(ddx[:-1, 1:-1], ddx[1:, 1:-1])
              > riser_threshold)
             | (np.maximum(ddy[1:-1, :-1], ddy[1:-1, 1:])
                > riser_threshold))
    dx = np.where(riser, 0.0, dx).astype(np.float32)
    dy = np.where(riser, 0.0, dy).astype(np.float32)
    ch = np.ascontiguousarray(np.stack([hmin, dx, dy], axis=0)
                              .transpose(0, 2, 1))
    C, R = ch.shape[1:]
    Cp = _pad_to(max(C, _WIN_Y), _SUB)
    Rp = _pad_to(max(R, _WIN_X), _LANE)
    if (Cp, Rp) == (C, R):
        return ch
    out = np.zeros((3, Cp, Rp), np.float32)
    out[:, :C, :R] = ch
    out[:, C:, :R] = ch[:, -1:, :]          # edge-replicate
    out[:, :, R:] = out[:, :, R - 1:R]
    return out


def compute_origins(base_ix, base_iy, R, C):
    """Clamped patch-corner cells. base_ix/iy: (N,) int32 -> (N, 2) int32."""
    ox = torch.clamp(base_ix - PATCH // 2, 0, R - PATCH)
    oy = torch.clamp(base_iy - PATCH // 2, 0, C - PATCH)
    return torch.stack([ox, oy], dim=1).to(torch.int32)


def extract_patches_plain(channels: torch.Tensor,
                          origins: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (3, C, R), (N, 2) -> (N, 3, PATCH*PATCH).

    Origins are placed as jax.lax.dynamic_slice places a start index (a
    negative one counts once from the end, then every one is clamped into
    [0, R-32] x [0, C-32]), so it equals the JAX package's
    extract_patches_xla for any origin."""
    C, R = channels.shape[1:]
    N = origins.shape[0]
    ox = origins[:, 0].long()
    oy = origins[:, 1].long()
    ox = torch.clamp(torch.where(ox < 0, ox + R, ox), 0, R - PATCH)
    oy = torch.clamp(torch.where(oy < 0, oy + C, oy), 0, C - PATCH)
    ar = torch.arange(PATCH, device=channels.device)
    rows = (oy[:, None] + ar)[:, :, None]            # (N, 32, 1)
    cols = (ox[:, None] + ar)[:, None, :]            # (N, 1, 32)
    out = channels[:, rows, cols]                    # (3, N, 32, 32)
    return out.permute(1, 0, 2, 3).reshape(N, 3, PATCH * PATCH)


def extract_patches(channels: torch.Tensor,
                    origins: torch.Tensor) -> torch.Tensor:
    """(3, C, R), (N, 2) -> (N, 3, PATCH*PATCH) patch windows: the plain
    version on every device."""
    return extract_patches_plain(channels, origins)


def lookup(patches: torch.Tensor, origins: torch.Tensor, ix: torch.Tensor,
           iy: torch.Tensor):
    """In-patch query: (N, 3, PATCH*PATCH) x (N, P) cells -> 3 x (N, P).

    ix/iy are absolute grid cells, clamped into the patch window. A gather
    over the flattened window replaces the reference's one-hot contraction
    (exact in both)."""
    lx = torch.clamp(ix - origins[:, 0:1], 0, PATCH - 1)
    ly = torch.clamp(iy - origins[:, 1:2], 0, PATCH - 1)
    lin = (ly * PATCH + lx).long()                  # patches are (y, x)
    N, P = lin.shape
    vals = torch.gather(patches, 2, lin[:, None, :].expand(N, 3, P))
    return vals[:, 0], vals[:, 1], vals[:, 2]
