"""Articulated rigid-body model description (copy of go2_rl_gym_tpu/sim/model.py).

This module replaces Isaac Gym's asset pipeline (``gym.load_asset`` + DOF/body
property queries, reference legged_gym/envs/base/legged_robot.py:961-1052) with
a host-side URDF parser producing static numpy arrays that the engine
consumes. Fixed-joint bodies are merged into their parents (the reference sets
``collapse_fixed_joints=True``, legged_robot_config.py:121), so the Go2 tree is
13 dynamic bodies: base + 4 x (hip, thigh, calf); foot/calf-lower collision
shapes attach to the calf body.

Collision handling is sphere-decomposed: every URDF primitive (sphere, box,
cylinder/capsule) becomes one or more contact sample spheres. That keeps the
terrain narrow-phase a pure gather + elementwise pipeline (no branchy GJK).
The port keeps its own copy so that it never imports the JAX package; the
parse must give arrays identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np

# Contact groups (used by the env for termination / penalty / feet logic,
# mirroring the reference's body-name matching in legged_robot.py:991-998).
GROUP_BASE = 0
GROUP_HIP = 1
GROUP_THIGH = 2
GROUP_CALF = 3
GROUP_FOOT = 4


def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64)


@dataclasses.dataclass
class RobotModel:
    """Static model arrays. All shapes are fixed; everything is float64 numpy at
    build time and cast to f32 jnp by the engine."""

    # Tree (nb bodies; body 0 is the floating base, parent[0] == -1)
    nb: int
    nv: int                      # velocity dims: 6 + num_joints
    parent: np.ndarray           # (nb,) int
    joint_axis: np.ndarray       # (nb-1, 3) axis in child (=parent at q=0) frame
    joint_origin: np.ndarray     # (nb-1, 3) joint origin in parent frame
    # Per-body spatial inertia ingredients (body frame, about body origin)
    mass: np.ndarray             # (nb,)
    com: np.ndarray              # (nb, 3) COM offset in body frame
    inertia: np.ndarray          # (nb, 3, 3) rotational inertia about COM, body frame

    # Joint limits / actuation (num_joints = nb - 1)
    dof_lower: np.ndarray
    dof_upper: np.ndarray
    dof_vel_limit: np.ndarray
    dof_effort_limit: np.ndarray
    dof_names: list

    # Collision spheres
    geom_body: np.ndarray        # (ng,) body index
    geom_offset: np.ndarray      # (ng, 3) offset in body frame
    geom_radius: np.ndarray      # (ng,)
    geom_group: np.ndarray       # (ng,) GROUP_*
    foot_geom_idx: np.ndarray    # (4,) indices of the foot spheres (FL, FR, RL, RR)
    foot_body_idx: np.ndarray    # (4,) calf body index per foot

    body_names: list = dataclasses.field(default_factory=list)

    @property
    def num_joints(self) -> int:
        return self.nb - 1


def _parse_inertial(link):
    el = link.find("inertial")
    if el is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    m = float(el.find("mass").get("value"))
    origin = el.find("origin")
    com = np.zeros(3)
    rpy = np.zeros(3)
    if origin is not None:
        com = np.array([float(x) for x in origin.get("xyz", "0 0 0").split()])
        rpy = np.array([float(x) for x in origin.get("rpy", "0 0 0").split()])
    ine = el.find("inertia")
    I = np.zeros((3, 3))
    if ine is not None:
        ixx, ixy, ixz = (float(ine.get(k, "0")) for k in ("ixx", "ixy", "ixz"))
        iyy, iyz, izz = (float(ine.get(k, "0")) for k in ("iyy", "iyz", "izz"))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    R = _rpy_matrix(rpy)
    return m, com, R @ I @ R.T


def _merge_inertia(m1, c1, I1, m2, c2, I2):
    """Combine two rigid bodies expressed in the same frame."""
    m = m1 + m2
    if m <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m
    def shift(mi, ci, Ii):
        d = ci - c
        return Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m, c, shift(m1, c1, I1) + shift(m2, c2, I2)


def _geom_spheres(geom_el, T_p, R_p):
    """Decompose one URDF collision geometry into (offset, radius) spheres,
    expressed in the dynamic-body frame via (R_p, T_p)."""
    origin = geom_el.find("origin")
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if origin is not None:
        xyz = np.array([float(x) for x in origin.get("xyz", "0 0 0").split()])
        rpy = np.array([float(x) for x in origin.get("rpy", "0 0 0").split()])
    R = R_p @ _rpy_matrix(rpy)
    p = T_p + R_p @ xyz
    g = geom_el.find("geometry")
    out = []
    sph = g.find("sphere")
    if sph is not None:
        out.append((p, float(sph.get("radius"))))
    cyl = g.find("cylinder") if g.find("cylinder") is not None else g.find("capsule")
    if cyl is not None:
        r = float(cyl.get("radius"))
        L = float(cyl.get("length"))
        axis = R @ np.array([0.0, 0.0, 1.0])
        half = max(L / 2.0 - 0.0, 0.0)
        if half <= r:
            out.append((p, r))
        else:
            # endpoints + midpoint samples
            for t in (-half, 0.0, half):
                out.append((p + t * axis, r))
    box = g.find("box")
    if box is not None:
        sx, sy, sz = (float(x) / 2 for x in box.get("size").split())
        r = min(sx, sy, sz)
        # corner spheres inscribed at the box corners
        for ex in (-1, 1):
            for ey in (-1, 1):
                for ez in (-1, 1):
                    corner = np.array([ex * (sx - r), ey * (sy - r), ez * (sz - r)])
                    out.append((p + R @ corner, r))
    return out


def parse_urdf(path: str) -> RobotModel:
    """Parse a quadruped URDF into a RobotModel.

    Dynamic bodies = base + children over revolute joints; fixed-joint subtrees
    are merged (inertia transported, collisions re-expressed in the dynamic
    parent frame).
    """
    tree = ET.parse(path)
    root = tree.getroot()
    links = {l.get("name"): l for l in root.findall("link")}
    joints = root.findall("joint")

    child_of = {}
    for j in joints:
        child_of[j.find("child").get("link")] = j

    # identify base: link that is nobody's child
    base_name = next(n for n in links if n not in child_of)

    # Build dynamic tree in URDF joint order.
    body_names = [base_name]
    parent_idx = {base_name: 0}
    parents = [-1]
    joint_axes, joint_origins = [], []
    dof_names, lowers, uppers, vels, efforts = [], [], [], [], []

    # map from any link -> (dynamic body idx, R offset, p offset) for fixed merges
    frame_of = {base_name: (0, np.eye(3), np.zeros(3))}

    def resolve(name):
        return frame_of[name]

    for j in joints:
        typ = j.get("type")
        pname = j.find("parent").get("link")
        cname = j.find("child").get("link")
        o = j.find("origin")
        xyz = np.array([float(x) for x in (o.get("xyz", "0 0 0") if o is not None else "0 0 0").split()])
        rpy = np.array([float(x) for x in (o.get("rpy", "0 0 0") if o is not None else "0 0 0").split()])
        Rj = _rpy_matrix(rpy)
        if typ in ("revolute", "continuous"):
            pbody, Rp, Tp = resolve(pname)
            assert np.allclose(Rp, np.eye(3)), "revolute joint under rotated fixed frame unsupported"
            idx = len(body_names)
            body_names.append(cname)
            parents.append(pbody)
            joint_origins.append(Tp + xyz)
            ax = np.array([float(x) for x in j.find("axis").get("xyz").split()])
            joint_axes.append(Rj @ (ax / np.linalg.norm(ax)))
            assert np.allclose(Rj, np.eye(3)), "rotated revolute joint origin unsupported"
            frame_of[cname] = (idx, np.eye(3), np.zeros(3))
            lim = j.find("limit")
            dof_names.append(j.get("name"))
            lowers.append(float(lim.get("lower", "-1e9")))
            uppers.append(float(lim.get("upper", "1e9")))
            vels.append(float(lim.get("velocity", "1e9")))
            efforts.append(float(lim.get("effort", "1e9")))
        elif typ == "fixed":
            pbody, Rp, Tp = resolve(pname)
            frame_of[cname] = (pbody, Rp @ Rj, Tp + Rp @ xyz)
        else:
            raise ValueError(f"unsupported joint type {typ}")

    nb = len(body_names)
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))

    # accumulate inertias (merging fixed children into their dynamic parent)
    for lname, link in links.items():
        if lname not in frame_of:
            continue
        bidx, R, T = frame_of[lname]
        m, c, I = _parse_inertial(link)
        if m <= 0:
            continue
        c_b = T + R @ c
        I_b = R @ I @ R.T
        mass[bidx], com[bidx], inertia[bidx] = _merge_inertia(
            mass[bidx], com[bidx], inertia[bidx], m, c_b, I_b)

    # collision spheres
    geom_body, geom_offset, geom_radius, geom_group = [], [], [], []
    foot_geom_idx, foot_body_idx = [], []
    for lname, link in links.items():
        if lname not in frame_of:
            continue
        bidx, R, T = frame_of[lname]
        lower = lname.lower()
        if "foot" in lower:
            group = GROUP_FOOT
        elif "calf" in lower:
            group = GROUP_CALF
        elif "thigh" in lower:
            group = GROUP_THIGH
        elif "hip" in lower:
            group = GROUP_HIP
        else:
            group = GROUP_BASE
        for coll in link.findall("collision"):
            for p, r in _geom_spheres(coll, T, R):
                if group == GROUP_FOOT:
                    foot_geom_idx.append(len(geom_body))
                    foot_body_idx.append(bidx)
                geom_body.append(bidx)
                geom_offset.append(p)
                geom_radius.append(r)
                geom_group.append(group)

    # order feet FL, FR, RL, RR by body index order of appearance in URDF
    order = np.argsort(foot_body_idx, kind="stable")
    foot_geom_idx = list(np.array(foot_geom_idx)[order])
    foot_body_idx = list(np.array(foot_body_idx)[order])

    return RobotModel(
        nb=nb,
        nv=6 + nb - 1,
        parent=np.array(parents, dtype=np.int32),
        joint_axis=np.array(joint_axes),
        joint_origin=np.array(joint_origins),
        mass=mass,
        com=com,
        inertia=inertia,
        dof_lower=np.array(lowers),
        dof_upper=np.array(uppers),
        dof_vel_limit=np.array(vels),
        dof_effort_limit=np.array(efforts),
        dof_names=dof_names,
        geom_body=np.array(geom_body, dtype=np.int32),
        geom_offset=np.array(geom_offset),
        geom_radius=np.array(geom_radius),
        geom_group=np.array(geom_group, dtype=np.int32),
        foot_geom_idx=np.array(foot_geom_idx, dtype=np.int32),
        foot_body_idx=np.array(foot_body_idx, dtype=np.int32),
        body_names=body_names,
    )


_GO2_URDF_CANDIDATES = (
    os.environ.get("GO2_URDF_PATH", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "resources",
                 "robots", "go2", "urdf", "go2.urdf"),
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "resources",
                 "go2.urdf"),
)

_cached_go2 = None


_GO2_JSON = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "resources", "go2_model.json")


def go2_model() -> RobotModel:
    """Load the Go2 model (cached): a URDF if available, else the repo's
    serialized model (resources/go2_model.json) for standalone use."""
    global _cached_go2
    if _cached_go2 is None:
        for path in _GO2_URDF_CANDIDATES:
            if path and os.path.exists(path):
                _cached_go2 = parse_urdf(path)
                break
        else:
            if os.path.exists(_GO2_JSON):
                _cached_go2 = load_model(_GO2_JSON)
            else:
                raise FileNotFoundError(
                    "go2 model not found; set GO2_URDF_PATH or restore "
                    "resources/go2_model.json")
    return _cached_go2


# ---------------------------------------------------------------------------
# Native model serialization (standalone distribution without the URDF)
# ---------------------------------------------------------------------------

_ARRAY_FIELDS = ("parent", "joint_axis", "joint_origin", "mass", "com",
                 "inertia", "dof_lower", "dof_upper", "dof_vel_limit",
                 "dof_effort_limit", "geom_body", "geom_offset", "geom_radius",
                 "geom_group", "foot_geom_idx", "foot_body_idx")


def save_model(model: RobotModel, path: str):
    """Serialize a parsed model to JSON (this framework's native format)."""
    import json
    blob = {"nb": model.nb, "nv": model.nv,
            "dof_names": model.dof_names, "body_names": model.body_names}
    for f in _ARRAY_FIELDS:
        blob[f] = np.asarray(getattr(model, f)).tolist()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(blob, fh)


def load_model(path: str) -> RobotModel:
    import json
    with open(path) as fh:
        blob = json.load(fh)
    kwargs = dict(nb=blob["nb"], nv=blob["nv"], dof_names=blob["dof_names"],
                  body_names=blob["body_names"])
    int_fields = ("parent", "geom_body", "geom_group", "foot_geom_idx",
                  "foot_body_idx")
    for f in _ARRAY_FIELDS:
        dtype = np.int32 if f in int_fields else np.float64
        kwargs[f] = np.asarray(blob[f], dtype)
    return RobotModel(**kwargs)
