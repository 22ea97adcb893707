"""Procedural terrain generation (host-side, numpy; device array afterwards).

Copy of go2_rl_gym_tpu/terrain/generator.py: seeded identically, it must give
a bit-identical heightfield. Replacement for ``isaacgym.terrain_utils`` + the reference's
``Terrain`` builder (reference legged_gym/utils/terrain.py:9-197). Produces the
same artifact the engine and env consume: one big int16 heightfield of
``num_rows`` (difficulty levels) x ``num_cols`` (terrain types) sub-terrains
with a border and inter-terrain spacing, plus per-subterrain spawn origins and
terrain-type/column maps for per-terrain-type logging and command caps.

Nine terrain types (reference terrain.py:111-153):
[wave, slope, rough_slope, stairs_up, stairs_down, obstacles, stepping_stones,
 gap, flat], selected by column proportion; difficulty = row / num_rows with
the reference's "IS_HARD" scaling (slope <= 29.6deg, step <= 0.257 m,
obstacle <= 0.275 m; terrain.py:93-98).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

TERRAIN_NAMES = [
    "wave", "slope", "rough_slope", "stairs_up", "stairs_down",
    "obstacles", "stepping_stones", "gap", "flat",
]


# ---------------------------------------------------------------------------
# Sub-terrain primitives. Each operates on an int16 (L, W) patch in units of
# vertical_scale, mirroring isaacgym.terrain_utils behavior.
# ---------------------------------------------------------------------------


def random_uniform(hf, rng, hs, vs, min_height, max_height, step, downsampled_scale):
    """Coarse random noise upsampled to the fine grid (additive)."""
    L, W = hf.shape
    lo = int(min_height / vs)
    hi = int(max_height / vs)
    st = max(int(step / vs), 1)
    heights_range = np.arange(lo, hi + st, st)
    coarse_l = max(int(L * hs / downsampled_scale), 2)
    coarse_w = max(int(W * hs / downsampled_scale), 2)
    coarse = rng.choice(heights_range, (coarse_l, coarse_w))
    # bilinear upsample
    xi = np.linspace(0, coarse_l - 1, L)
    yi = np.linspace(0, coarse_w - 1, W)
    x0 = np.floor(xi).astype(int)
    y0 = np.floor(yi).astype(int)
    x1 = np.minimum(x0 + 1, coarse_l - 1)
    y1 = np.minimum(y0 + 1, coarse_w - 1)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    up = (coarse[np.ix_(x0, y0)] * (1 - fx) * (1 - fy)
          + coarse[np.ix_(x1, y0)] * fx * (1 - fy)
          + coarse[np.ix_(x0, y1)] * (1 - fx) * fy
          + coarse[np.ix_(x1, y1)] * fx * fy)
    hf += up.astype(np.int16)


def pyramid_slope(hf, hs, vs, slope, platform_size):
    """Pyramid rising (slope>0) or sinking toward the center with a flat top."""
    L, W = hf.shape
    cx, cy = L // 2, W // 2
    x = (cx - np.abs(cx - np.arange(L))) / cx
    y = (cy - np.abs(cy - np.arange(W))) / cy
    max_height = int(slope * (hs / vs) * (L / 2))
    hf += (max_height * x[:, None] * y[None, :]).astype(np.int16)
    ps = int(platform_size / hs / 2)
    x1, x2 = L // 2 - ps, L // 2 + ps
    y1, y2 = W // 2 - ps, W // 2 + ps
    min_h = min(int(hf[x1, y1]), 0)
    max_h = max(int(hf[x1, y1]), 0)
    np.clip(hf, min_h, max_h, out=hf)


def pyramid_stairs(hf, hs, vs, step_width, step_height, platform_size):
    """Concentric rectangular steps toward the center."""
    L, W = hf.shape
    sw = int(step_width / hs)
    sh = int(step_height / vs)
    ps = int(platform_size / hs)
    height = 0
    x1, x2, y1, y2 = 0, L, 0, W
    while (x2 - x1) > ps and (y2 - y1) > ps:
        x1 += sw
        x2 -= sw
        y1 += sw
        y2 -= sw
        height += sh
        hf[x1:x2, y1:y2] = height


def wave(hf, hs, vs, num_waves, amplitude):
    L, W = hf.shape
    amp = int(0.5 * amplitude / vs)
    if num_waves > 0:
        div = W / (num_waves * np.pi * 2)
        x = np.arange(L)[:, None]
        y = np.arange(W)[None, :]
        hf += (amp * np.cos(y / div) + amp * np.sin(x / div)).astype(np.int16)


def discrete_obstacles(hf, rng, hs, vs, max_height, min_size, max_size,
                       num_rects, platform_size):
    L, W = hf.shape
    mh = int(max_height / vs)
    mins = int(min_size / hs)
    maxs = int(max_size / hs)
    ps = int(platform_size / hs)
    heights = [-mh, -mh // 2, mh // 2, mh]
    sizes = np.arange(mins, maxs, 4)
    for _ in range(num_rects):
        w = int(rng.choice(sizes))
        l = int(rng.choice(sizes))
        sx = int(rng.choice(np.arange(0, max(L - w, 1), 4)))
        sy = int(rng.choice(np.arange(0, max(W - l, 1), 4)))
        hf[sx:sx + w, sy:sy + l] = int(rng.choice(heights))
    x1, x2 = (L - ps) // 2, (L + ps) // 2
    y1, y2 = (W - ps) // 2, (W + ps) // 2
    hf[x1:x2, y1:y2] = 0


def stepping_stones(hf, rng, hs, vs, stone_size, stone_distance, max_height,
                    platform_size, depth=-10.0):
    L, W = hf.shape
    ss = max(int(stone_size / hs), 1)
    sd = int(stone_distance / hs)
    mh = int(max_height / vs)
    ps = int(platform_size / hs)
    heights = np.arange(-mh - 1, mh + 1)
    hf[:, :] = int(depth / vs)
    sy = 0
    while sy < W:
        ey = min(W, sy + ss)
        sx = int(rng.integers(0, ss))
        ex0 = max(0, sx - sd)
        hf[0:ex0, sy:ey] = int(rng.choice(heights))
        while sx < L:
            ex = min(L, sx + ss)
            hf[sx:ex, sy:ey] = int(rng.choice(heights))
            sx += ss + sd
        sy += ss + sd
    x1, x2 = (L - ps) // 2, (L + ps) // 2
    y1, y2 = (W - ps) // 2, (W + ps) // 2
    hf[x1:x2, y1:y2] = 0


def gap(hf, hs, vs, gap_size, platform_size):
    """Ring-shaped gap around a central platform (reference terrain.py:176-188)."""
    L, W = hf.shape
    gs = int(gap_size / hs)
    ps = int(platform_size / hs)
    cx, cy = L // 2, W // 2
    x1 = (L - ps) // 2
    x2 = x1 + gs
    y1 = (W - ps) // 2
    y2 = y1 + gs
    hf[cx - x2:cx + x2, cy - y2:cy + y2] = -1000
    hf[cx - x1:cx + x1, cy - y1:cy + y1] = 0


def pit(hf, hs, vs, depth, platform_size):
    """Central platform at -depth (reference terrain.py:190-197)."""
    L, W = hf.shape
    d = int(depth / vs)
    ps = int(platform_size / hs / 2)
    x1, x2 = L // 2 - ps, L // 2 + ps
    y1, y2 = W // 2 - ps, W // 2 + ps
    hf[x1:x2, y1:y2] = -d


# ---------------------------------------------------------------------------
# Full terrain grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TerrainGrid:
    height_field: np.ndarray      # (tot_rows, tot_cols) int16
    env_origins: np.ndarray       # (num_rows, num_cols, 3) float, world meters
    name2cols: dict               # terrain name -> list of column indices
    cols2id: np.ndarray           # (num_cols,) terrain type id per column
    horizontal_scale: float
    vertical_scale: float
    border_size: float
    env_length: float
    env_width: float
    num_rows: int
    num_cols: int

    @property
    def heights_m(self) -> np.ndarray:
        return self.height_field.astype(np.float32) * self.vertical_scale


def _difficulty_params(difficulty: float, hard: bool = True):
    """Reference terrain.py:93-109 difficulty scaling (IS_HARD=True branch)."""
    if hard:
        slope = 0.1 + difficulty * 0.52
        step_height = 0.05 + 0.23 * difficulty
        obstacle_height = 0.05 + difficulty * 0.25
    else:
        slope = difficulty * 0.4
        step_height = 0.05 + 0.18 * difficulty
        obstacle_height = 0.05 + difficulty * 0.2
    stones_size = 1.5 * (1.05 - difficulty)
    stone_distance = 0.05 if difficulty == 0 else 0.1
    gap_size = 1.0 * difficulty
    amplitude = 0.1 + 0.2 * difficulty
    return dict(slope=slope, step_height=step_height,
                obstacle_height=obstacle_height, stones_size=stones_size,
                stone_distance=stone_distance, gap_size=gap_size,
                amplitude=amplitude)


def make_subterrain(hf, rng, hs, vs, choice, difficulty, proportions, hard=True):
    """Fill one (L, W) patch; returns (name, type_id).

    Type selection thresholds follow reference terrain.py:111-153.
    """
    p = _difficulty_params(difficulty, hard)
    cum = np.cumsum(proportions)
    if choice < cum[0]:
        wave(hf, hs, vs, num_waves=5, amplitude=p["amplitude"])
        random_uniform(hf, rng, hs, vs, -0.05, 0.05, 0.005, 0.2)
        return "wave", 0
    if choice < cum[1]:
        slope = p["slope"]
        if choice < (cum[0] + cum[1]) / 2:
            slope = -slope
        pyramid_slope(hf, hs, vs, slope, platform_size=3.0)
        return "slope", 1
    if choice < cum[2]:
        pyramid_slope(hf, hs, vs, p["slope"], platform_size=3.0)
        random_uniform(hf, rng, hs, vs, -0.05, 0.05, 0.005, 0.2)
        return "rough_slope", 2
    if choice < cum[4]:
        step_h = p["step_height"]
        name, tid = "stairs_down", 4
        if choice < cum[3]:
            step_h = -step_h
            name, tid = "stairs_up", 3
        pyramid_stairs(hf, hs, vs, step_width=0.31, step_height=step_h, platform_size=3.0)
        return name, tid
    if choice < cum[5]:
        discrete_obstacles(hf, rng, hs, vs, p["obstacle_height"], 1.0, 2.0, 20,
                           platform_size=3.0)
        return "obstacles", 5
    if choice < cum[6]:
        stepping_stones(hf, rng, hs, vs, p["stones_size"], p["stone_distance"],
                        0.0, platform_size=4.0)
        return "stepping_stones", 6
    if choice < cum[7]:
        gap(hf, hs, vs, p["gap_size"], platform_size=3.0)
        return "gap", 7
    pit(hf, hs, vs, 0.0, platform_size=4.0)
    return "flat", 8


def build_terrain(cfg, seed: int = 0) -> TerrainGrid:
    """Build the full terrain grid.

    cfg duck-types the reference terrain config (legged_robot_config.py:15-41):
    fields terrain_length/width, horizontal/vertical_scale, border_size,
    num_rows, num_cols, terrain_spacing, terrain_proportions, curriculum.
    """
    rng = np.random.default_rng(seed)
    hs = cfg.horizontal_scale
    vs = cfg.vertical_scale
    Lpx = int(cfg.terrain_length / hs)
    Wpx = int(cfg.terrain_width / hs)
    spacing_px = int(cfg.terrain_spacing / hs)
    border = int(cfg.border_size / hs)
    tot_rows = cfg.num_rows * Lpx + max(0, cfg.num_rows - 1) * spacing_px + 2 * border
    tot_cols = cfg.num_cols * Wpx + max(0, cfg.num_cols - 1) * spacing_px + 2 * border

    field = np.zeros((tot_rows, tot_cols), dtype=np.int16)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
    name2cols = defaultdict(list)
    # empty in randomized mode (reference terrain.py:34, 51-59: cols2id=[])
    cols2id = (np.zeros(cfg.num_cols, dtype=np.int32) if cfg.curriculum
               else np.zeros(0, dtype=np.int32))

    for j in range(cfg.num_cols):
        for i in range(cfg.num_rows):
            if cfg.curriculum:
                difficulty = i / cfg.num_rows
                choice = j / cfg.num_cols + 0.001
            else:
                difficulty = float(rng.choice([0.5, 0.75, 0.9]))
                choice = float(rng.uniform(0, 1))
            patch = np.zeros((Lpx, Wpx), dtype=np.int16)
            name, tid = make_subterrain(patch, rng, hs, vs, choice, difficulty,
                                        cfg.terrain_proportions)
            sx = border + i * (Lpx + spacing_px)
            sy = border + j * (Wpx + spacing_px)
            field[sx:sx + Lpx, sy:sy + Wpx] = patch

            # spawn origin: center of the patch, z = max height of the central
            # 2x2 m region (reference terrain.py:167-174)
            ox = (i + 0.5) * cfg.terrain_length + i * cfg.terrain_spacing
            oy = (j + 0.5) * cfg.terrain_width + j * cfg.terrain_spacing
            x1 = int((cfg.terrain_length / 2.0 - 1) / hs)
            x2 = int((cfg.terrain_length / 2.0 + 1) / hs)
            y1 = int((cfg.terrain_width / 2.0 - 1) / hs)
            y2 = int((cfg.terrain_width / 2.0 + 1) / hs)
            oz = np.max(patch[x1:x2, y1:y2]) * vs
            origins[i, j] = [ox, oy, oz]
        if cfg.curriculum:
            # curriculum: `choice` depends only on the column, so the
            # column-level maps are well defined (reference terrain.py:61-70
            # records them from the inner loop's last terrain). In randomized
            # mode the reference leaves BOTH empty (terrain.py:51-59) — each
            # cell has its own type, so per-column ids would be mislabeled —
            # and downstream per-terrain caps/logging are disabled
            # (legged_robot.py:863-870, 1074-1075).
            name2cols[name].append(j)
            cols2id[j] = tid

    return TerrainGrid(
        height_field=field,
        env_origins=origins,
        name2cols=dict(name2cols),
        cols2id=cols2id,
        horizontal_scale=hs,
        vertical_scale=vs,
        border_size=cfg.border_size,
        env_length=cfg.terrain_length,
        env_width=cfg.terrain_width,
        num_rows=cfg.num_rows,
        num_cols=cfg.num_cols,
    )
