"""MuJoCo sim2sim evaluation — cross-simulator validation + RoboGauge-style
scoring (PyTorch port of go2_rl_gym_tpu/deploy/mujoco_eval.py).

Counterpart of reference deploy/deploy_mujoco/deploy_go2.py:63-275 (headless):
500 Hz MuJoCo physics (simulation_dt=0.002), 50 Hz policy
(control_decimation=10), host-side PD ``tau = (q* - q) kp - qd kd``
(deploy_go2.py:45-47), and the exact 45-dim observation assembly of the
training env (deploy_go2.py:226-231). Policies can be TorchScript exports
(reference-compatible, including MoE's ``action, (weights, latent)`` tuples;
run on the CPU, as on the robot) or a port model (`ModelPolicy`).

The reference scores policies through the external RoboGauge HTTP service
(on_policy_runner.py:252-295) whose scorer is closed; `evaluate_policy` is an
in-repo replacement producing per-command tracking / safety / quality scores
in [0, 1] over a command sweep, in the spirit of the README score table
(reference README.md:56-67).
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from go2_rl_gym_tpu_torch.device import resolve_device

GO2_SCENES = {
    "flat": "flat.xml",
    "stairs": "stairs.xml",
    "race_track": "race_track.xml",
    "cross_stairs": "cross_stairs.xml",
    "cross_slope": "cross_slope.xml",
}

_SCENE_ROOTS = (
    os.environ.get("GO2_SCENE_ROOT", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "resources",
                 "robots", "go2"),
)

DEFAULT_ANGLES = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                           0.1, 1.0, -1.5, -0.1, 1.0, -1.5], np.float32)


def find_scene(name: str) -> str:
    fname = GO2_SCENES.get(name, name)
    for root in _SCENE_ROOTS:
        if root and os.path.exists(os.path.join(root, fname)):
            return os.path.join(root, fname)
    raise FileNotFoundError(f"scene {name} not found; set GO2_SCENE_ROOT")


def load_scene_model(name: str):
    """Load an MJCF scene, dropping *visual* meshes whose .obj files are
    missing from the asset tree (physics geoms are primitives and unaffected)."""
    import re
    import xml.etree.ElementTree as ET

    import mujoco

    path = find_scene(name)
    scene_dir = os.path.dirname(path)

    def collect(p, seen):
        tree = ET.parse(p)
        root = tree.getroot()
        missing = set()
        meshdir = "assets"
        for comp in root.iter("compiler"):
            meshdir = comp.get("meshdir", meshdir)
        for mesh in root.iter("mesh"):
            f = mesh.get("file")
            if f and not os.path.exists(os.path.join(scene_dir, meshdir, f)):
                missing.add(mesh.get("name") or os.path.splitext(f)[0])
        texdir = "assets"
        for comp in root.iter("compiler"):
            texdir = comp.get("texturedir", comp.get("assetdir", texdir))
        for tex in root.iter("texture"):
            f = tex.get("file")
            if (f and not os.path.exists(os.path.join(scene_dir, texdir, f))
                    and not os.path.exists(os.path.join(scene_dir, f))):
                # MuJoCo auto-names file assets by basename sans extension
                missing.add("texture:" + (
                    tex.get("name")
                    or os.path.splitext(os.path.basename(f))[0]))
        return missing

    missing = set()
    main_xml = open(path).read()
    missing |= collect(path, missing)
    for inc in re.findall(r'<include\s+file="([^"]+)"', main_xml):
        missing |= collect(os.path.join(scene_dir, inc), missing)
    if not missing:
        return mujoco.MjModel.from_xml_path(path)

    def strip(p):
        tree = ET.parse(p)
        root = tree.getroot()
        for parent in root.iter():
            for child in list(parent):
                if child.tag == "mesh":
                    nm = child.get("name") or os.path.splitext(
                        child.get("file", ""))[0]
                    if nm in missing:
                        parent.remove(child)
                elif child.tag == "geom" and child.get("mesh") in missing:
                    parent.remove(child)
                elif child.tag == "texture":
                    nm = "texture:" + (child.get("name") or os.path.splitext(
                        os.path.basename(child.get("file", "")))[0])
                    if nm in missing:
                        parent.remove(child)
                elif (child.tag == "material"
                      and ("texture:" + (child.get("texture") or "")) in missing):
                    # material referencing a dropped texture: keep material
                    # (geoms reference it) but drop the texture link
                    del child.attrib["texture"]
        return ET.tostring(root, encoding="unicode")

    # inline includes with stripped content
    xml = strip(path)

    def repl(match):
        return ""
    assets = {}
    for inc in re.findall(r'<include\s+file="([^"]+)"\s*/>', xml):
        assets[inc] = strip(os.path.join(scene_dir, inc)).encode()
    # collect referenced asset files
    for root_, _, files in os.walk(scene_dir):
        for f in files:
            if f.endswith((".obj", ".png", ".stl")):
                rel = os.path.relpath(os.path.join(root_, f), scene_dir)
                # mujoco keys assets by basename; one entry per file name
                with open(os.path.join(root_, f), "rb") as fh:
                    assets.setdefault(f, fh.read())
    return mujoco.MjModel.from_xml_string(xml, assets)


def gravity_orientation(quat_wxyz):
    """Projected gravity from a wxyz quaternion: [0,0,-1] when upright
    (matches the reference deploy helper; deploy_go2.py get_gravity_orientation)."""
    w, x, y, z = quat_wxyz
    return np.array([
        2 * (-z * x + w * y),
        -2 * (z * y + w * x),
        1 - 2 * (w * w + z * z),
    ], np.float32)


def quat_rotate_inverse_wxyz(q, v):
    w, x, y, z = q
    q_vec = np.array([x, y, z])
    a = v * (2.0 * w * w - 1.0)
    b = np.cross(q_vec, v) * w * 2.0
    c = q_vec * np.dot(q_vec, v) * 2.0
    return a - b + c


class TorchPolicy:
    """Wraps a TorchScript export (ours or the reference's).

    For MoE exports (``action, (weights, latent)``) the per-step gating
    weights and latents are recorded when ``record_moe=True`` — the headless
    counterpart of the reference's MoE-weight HUD / latent dumping
    (deploy_go2.py:236-253, deploy_go2_moe.py)."""

    def __init__(self, path: str, record_moe: bool = False):
        self.torch = torch
        self.policy = torch.jit.load(path, map_location="cpu")
        if hasattr(self.policy, "reset"):
            self.policy.reset()
        self.record_moe = record_moe
        self.moe_weights = []
        self.moe_latents = []

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        t = self.torch.from_numpy(obs.astype(np.float32)).unsqueeze(0)
        with self.torch.no_grad():
            result = self.policy(t)
        if isinstance(result, tuple):
            action, extras = result
            if self.record_moe and isinstance(extras, tuple):
                self.moe_weights.append(
                    extras[0].detach().numpy().squeeze().copy())
                self.moe_latents.append(
                    extras[1].detach().numpy().squeeze().copy())
            result = action
        return result.detach().cpu().numpy().squeeze()

    def save_moe_traces(self, out_path: str):
        np.savez(out_path, weights=np.asarray(self.moe_weights),
                 latents=np.asarray(self.moe_latents))


class ModelPolicy:
    """Single-env student-path inference of a port CTS model (`s_latent`
    then `dist`'s mean) with its own obs-history ring buffer, on `device`
    (the card by default; the model must live there)."""

    def __init__(self, model, device="cuda"):
        device = resolve_device(device)
        # the buffer's device names the card by index ("cuda" -> "cuda:0"),
        # as the model's parameters do
        self.history = torch.zeros(1, model.history_length, model.num_obs,
                                   device=device)
        self.device = self.history.device
        p = next(model.parameters())
        if p.device != self.device:
            raise ValueError(f"the model lives on {p.device}, the policy "
                             f"runs on {self.device}")
        self.model = model

    def reset(self):
        self.history.zero_()

    @torch.no_grad()
    def __call__(self, obs: np.ndarray) -> np.ndarray:
        o = torch.as_tensor(np.asarray(obs, np.float32),
                            device=self.device)[None]
        self.history = torch.cat([self.history[:, 1:], o[:, None]], dim=1)
        lat, _ = self.model.s_latent(self.history.reshape(1, -1))
        mu, _, _ = self.model.dist(lat, o)
        return mu[0].cpu().numpy()


def run_episode(policy: Callable, scene: str = "flat",
                cmd=(1.0, 0.0, 0.0), duration_s: float = 10.0,
                simulation_dt: float = 0.002, control_decimation: int = 10,
                kp: float = 20.0, kd: float = 0.5, action_scale: float = 0.25,
                seed: int = 0, video_path: Optional[str] = None,
                video_fps: int = 25) -> Dict[str, float]:
    """One sim2sim episode. Returns tracking/safety metrics.

    video_path: offscreen-render the episode to an .mp4 (the headless
    counterpart of the reference's --save-video, deploy_go2.py:199-206)."""
    import mujoco

    m = load_scene_model(scene)
    m.opt.timestep = simulation_dt
    renderer = writer = None
    if video_path:
        try:
            import imageio
            renderer = mujoco.Renderer(m, height=360, width=640)
            writer = imageio.get_writer(video_path, fps=video_fps)
            frame_skip = max(int(1.0 / (video_fps * simulation_dt)), 1)
        except Exception as e:  # no offscreen GL in this environment
            print(f"[mujoco_eval] video disabled ({e})")
            renderer = writer = None
    d = mujoco.MjData(m)
    cmd = np.asarray(cmd, np.float32)
    cmd_scale = np.array([2.0, 2.0, 0.25], np.float32)

    action = np.zeros(12, np.float32)
    target = DEFAULT_ANGLES.copy()
    obs = np.zeros(45, np.float32)

    n_steps = int(duration_s / simulation_dt)
    vel_errs: List[float] = []
    ang_errs: List[float] = []
    heights: List[float] = []
    action_rates: List[float] = []
    fell = False
    last_action = np.zeros(12, np.float32)

    for counter in range(n_steps):
        tau = (target - d.qpos[7:]) * kp - d.qvel[6:] * kd
        d.ctrl[:] = tau
        mujoco.mj_step(m, d)

        if writer is not None and counter % frame_skip == 0:
            renderer.update_scene(d)
            writer.append_data(renderer.render())

        if counter % control_decimation == 0:
            quat = d.qpos[3:7]  # wxyz in mujoco
            qj = (d.qpos[7:] - DEFAULT_ANGLES) * 1.0
            dqj = d.qvel[6:] * 0.05
            ang_vel = d.qvel[3:6] * 0.25
            grav = gravity_orientation(quat)
            obs[0:3] = ang_vel
            obs[3:6] = grav
            obs[6:9] = cmd * cmd_scale
            obs[9:21] = qj
            obs[21:33] = dqj
            obs[33:45] = action
            last_action = action
            action = policy(obs.copy())
            target = action * action_scale + DEFAULT_ANGLES

            # metrics (body-frame velocities)
            v_local = quat_rotate_inverse_wxyz(quat, d.qvel[:3].copy())
            vel_errs.append(float(np.linalg.norm(cmd[:2] - v_local[:2])))
            ang_errs.append(float(abs(cmd[2] - d.qvel[5])))
            heights.append(float(d.qpos[2]))
            action_rates.append(float(np.abs(action - last_action).mean()))
            if grav[2] > -0.3 or d.qpos[2] < 0.12:   # flipped or collapsed
                fell = True
                break

    if writer is not None:
        writer.close()
    vel_err = float(np.mean(vel_errs)) if vel_errs else 10.0
    ang_err = float(np.mean(ang_errs)) if ang_errs else 10.0
    return {
        "tracking": math.exp(-vel_err / 0.25) * math.exp(-ang_err / 0.5),
        "safety": 0.0 if fell else 1.0,
        "quality": math.exp(-float(np.mean(action_rates or [1.0]))),
        "mean_height": float(np.mean(heights)) if heights else 0.0,
        "vel_err": vel_err,
        "ang_err": ang_err,
        "fell": float(fell),
        "survived_s": len(vel_errs) * simulation_dt * control_decimation,
    }


# the original 4-command sweep (kept as the prefix of EXTENDED_COMMANDS so
# r4 rows stay comparable) plus 8 more covering reverse/lateral/diagonal/yaw
# combinations across the command range — episodes are deterministic given
# (policy, scene, command), so sweep breadth IS the sample size
BASE_COMMANDS = ((1.0, 0.0, 0.0), (-0.5, 0.0, 0.0),
                 (0.5, 0.3, 0.0), (0.0, 0.0, 1.0))
EXTENDED_COMMANDS = BASE_COMMANDS + (
    (0.5, 0.0, 0.0), (1.2, 0.0, 0.0), (-0.8, 0.0, 0.0), (0.0, 0.0, -1.0),
    (0.8, -0.3, 0.0), (1.0, 0.0, 0.5), (0.3, 0.0, -0.8), (0.6, 0.4, 0.5))


def evaluate_policy(policy_factory: Callable[[], Callable],
                    scenes=("flat",),
                    commands=BASE_COMMANDS,
                    duration_s: float = 8.0) -> Dict[str, float]:
    """Command/scene sweep -> aggregate + per-scene scores.

    NOTE: this is an in-repo scorer in the spirit of the reference's
    RoboGauge table (README.md:56-67), not the RoboGauge service itself —
    numbers are comparable BETWEEN policies evaluated here, not against the
    reference's published scores."""
    rows = []
    for scene in scenes:
        for cmd in commands:
            policy = policy_factory()   # fresh history per episode
            r = run_episode(policy, scene, cmd, duration_s)
            r["scene"] = scene
            rows.append(r)
    agg = {k: float(np.mean([r[k] for r in rows]))
           for k in ("tracking", "safety", "quality")}
    agg["overall"] = (agg["tracking"] + agg["safety"] + agg["quality"]) / 3.0
    agg["episodes"] = len(rows)
    for scene in scenes:
        sr = [r for r in rows if r["scene"] == scene]
        for k in ("tracking", "safety", "quality"):
            agg[f"{scene}/{k}"] = float(np.mean([r[k] for r in sr]))
        agg[f"{scene}/overall"] = (agg[f"{scene}/tracking"]
                                   + agg[f"{scene}/safety"]
                                   + agg[f"{scene}/quality"]) / 3.0
    return agg
