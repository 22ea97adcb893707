"""Shared simulator types, terrain utilities and the N-major reference engine.

PyTorch port of go2_rl_gym_tpu/sim/engine.py:

* the types and heightfield queries: SimParams (with the physical-bound
  velocity clamps), SimState, SimOutputs, DynParams, QuadLayout,
  TerrainData, `terrain_height` / `terrain_normal`;
* the N-major REFERENCE engine: leg-batched forward kinematics, the
  world-frame COM-Jacobian dynamics (`world_dynamics`) and the body-frame
  CRBA/RNEA that checks it (`mass_matrix_and_bias`), the block-Schur solve,
  and `substep` / `make_batched_substep` (top-K sphere-vs-heightfield
  contacts, relaxed Jacobi impulses, semi-implicit Euler).

The JAX package writes `substep` for one env and vmaps it; here every
function takes a leading env axis N (a single env is N = 1) and otherwise
keeps the JAX signatures. The production physics is sim/tengine.py (batch-
last T layout), as in the JAX package; this engine is its independent check
(tests/test_torch_engine.py holds the two together, and the env to physical
invariants) and the engine that tools/dynamics_parity.py steps against
MuJoCo. Any solver change must be applied to both.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from go2_rl_gym_tpu_torch.core import maths
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.sim.model import RobotModel

NLEG = 4
DEPTH = 3


class SimParams(NamedTuple):
    """Static simulation parameters (python scalars)."""
    dt: float = 0.005
    gravity: float = -9.81
    num_contacts: int = 12           # top-K active contact points per env
    solver_iters: int = 8            # Jacobi iterations
    relaxation: float = 0.65
    baumgarte: float = 0.2
    contact_slop: float = 0.002      # [m]
    max_depenetration_velocity: float = 1.0   # PhysX analogue (config:256)
    bounce_threshold_velocity: float = 0.5    # PhysX analogue (config:255)
    contact_compliance: float = 2e-4          # CFM-style impulse regularization
    armature: float = 1e-3
    joint_limit_stiffness: float = 300.0
    joint_limit_damping: float = 2.0
    # Velocity clamps at PHYSICAL bounds, not the reference's nominal 1000
    # (legged_robot_config.py:131-132): the Jacobi solver can transiently
    # diverge on clustered stair-edge contacts, and these bounds cut only the
    # unphysical tail of such events (URDF maxVelocity 30.1 for hips/thighs;
    # a real base stays under a few m/s).
    max_linear_velocity: float = 25.0
    max_angular_velocity: float = 50.0
    max_joint_velocity: float = 30.1


class SimState(NamedTuple):
    """Dynamic per-env simulator state (all f32, batched N-major)."""
    base_pos: torch.Tensor      # (N, 3) world
    base_quat: torch.Tensor     # (N, 4) xyzw
    q: torch.Tensor             # (N, 12) joint angles, leg-major FL,FR,RL,RR
    base_lin_vel: torch.Tensor  # (N, 3) world
    base_ang_vel: torch.Tensor  # (N, 3) world
    qd: torch.Tensor            # (N, 12)


class SimOutputs(NamedTuple):
    """Diagnostics of the last substep the env layer consumes (world frame)."""
    contact_forces: torch.Tensor   # (N, nb, 3) net contact force per body
    foot_forces: torch.Tensor      # (N, 4, 3) force per foot sphere
    foot_pos: torch.Tensor         # (N, 4, 3) foot-sphere centres
    foot_vel: torch.Tensor         # (N, 4, 3) foot-sphere velocities


class DynParams(NamedTuple):
    """Per-env randomized physical parameters (domain randomization)."""
    mass: torch.Tensor          # (N, nb)
    com: torch.Tensor           # (N, nb, 3)
    inertia: torch.Tensor       # (N, nb, 3, 3)
    friction: torch.Tensor      # (N,) combined ground-robot friction
    restitution: torch.Tensor   # (N,) combined restitution in [0, 1]


def default_dyn_params(model: RobotModel, device="cpu") -> DynParams:
    """Unbatched defaults (nb,), (nb, 3), (nb, 3, 3), (), ()."""
    f32 = dict(dtype=torch.float32, device=device)
    return DynParams(
        mass=torch.as_tensor(model.mass, **f32),
        com=torch.as_tensor(model.com, **f32),
        inertia=torch.as_tensor(model.inertia, **f32),
        friction=torch.tensor(1.0, **f32),
        restitution=torch.tensor(0.0, **f32),
    )


def ancestor_joint_mask(model: RobotModel) -> np.ndarray:
    """(nb, nj) bool: joint j moves body b."""
    nb, nj = model.nb, model.num_joints
    mask = np.zeros((nb, nj), dtype=bool)
    for b in range(1, nb):
        cur = b
        while cur > 0:
            mask[b, cur - 1] = True
            cur = int(model.parent[cur])
    return mask


class QuadLayout(NamedTuple):
    """Static leg-chain arrays derived from RobotModel (body (l,d) = 1+3l+d)."""
    axes: np.ndarray        # (NLEG, DEPTH, 3) joint axes in child frame
    origins: np.ndarray     # (NLEG, DEPTH, 3) joint origins in parent frame
    anc_mask: np.ndarray    # (nb, 12)


def quad_layout(model: RobotModel) -> QuadLayout:
    if model.nb != 1 + NLEG * DEPTH:
        raise ValueError("engine expects base + 4x3 chains")
    for leg in range(NLEG):
        for d in range(DEPTH):
            b = 1 + leg * DEPTH + d
            expected_parent = 0 if d == 0 else b - 1
            if int(model.parent[b]) != expected_parent:
                raise ValueError("non-chain topology")
    axes = model.joint_axis.reshape(NLEG, DEPTH, 3)
    origins = model.joint_origin.reshape(NLEG, DEPTH, 3)
    return QuadLayout(axes=axes, origins=origins,
                      anc_mask=ancestor_joint_mask(model))


# ---------------------------------------------------------------------------
# Terrain interface
# ---------------------------------------------------------------------------


class TerrainData(NamedTuple):
    """Device-resident heightfield. For `flat`, a 2x2 zero grid is used.

    `channels` optionally carries the channel-major (3, C', R') [hmin, dx,
    dy] grid read by the patch path (ops/terrain_patches.py)."""
    height: torch.Tensor     # (rows, cols) f32 meters
    horizontal_scale: float
    border_offset: float     # world xy offset of the grid origin (border_size)
    is_flat: bool
    channels: Optional[torch.Tensor] = None


def flat_terrain(device="cpu") -> TerrainData:
    return TerrainData(height=torch.zeros((2, 2), device=device),
                       horizontal_scale=1.0, border_offset=0.0, is_flat=True)


def make_terrain_data(heights_m, horizontal_scale, border_size,
                      with_channels: bool = True, device="cpu",
                      riser_threshold: float = tp.RISER_SLOPE_THRESHOLD
                      ) -> TerrainData:
    """Build TerrainData (+ patch channels, snapped at `riser_threshold`)
    from a heightfield in meters."""
    channels = None
    if with_channels:
        channels = torch.as_tensor(
            tp.build_channels(np.asarray(heights_m), horizontal_scale,
                              riser_threshold), device=device)
    return TerrainData(
        height=torch.as_tensor(np.asarray(heights_m, np.float32),
                               device=device),
        horizontal_scale=horizontal_scale, border_offset=border_size,
        is_flat=False, channels=channels)


def _cells(terrain: TerrainData, x, y):
    """Truncating float->int cell indices, clamped for the min-of-3 stencil."""
    hs = terrain.height
    px = torch.clamp(((x + terrain.border_offset) / terrain.horizontal_scale)
                     .to(torch.int32), 0, hs.shape[0] - 2).long()
    py = torch.clamp(((y + terrain.border_offset) / terrain.horizontal_scale)
                     .to(torch.int32), 0, hs.shape[1] - 2).long()
    return px, py


def height_at(terrain: TerrainData, x, y):
    """Min-of-3 heightfield lookup (legged_robot.py:1212-1222) at matching
    x, y tensors of any shape."""
    if terrain.is_flat:
        return torch.zeros_like(x)
    hs = terrain.height
    px, py = _cells(terrain, x, y)
    return torch.minimum(torch.minimum(hs[px, py], hs[px + 1, py]),
                         hs[px, py + 1])


def terrain_height(terrain: TerrainData, xy: torch.Tensor) -> torch.Tensor:
    """Min-of-3 height lookup at (..., 2) points."""
    return height_at(terrain, xy[..., 0], xy[..., 1])


def normal_at(terrain: TerrainData, x, y, dim: int = -1,
              riser_threshold: float = tp.RISER_SLOPE_THRESHOLD):
    """Surface normals from central differences of the min-of-3 heights at
    matching x, y tensors, stacked along `dim`, with the riser snap: where
    any one-cell height jump exceeds `riser_threshold` (inf turns the snap
    off) the normal is the vertical tread normal (legged_robot_config.py:40)."""
    if terrain.is_flat:
        zero = torch.zeros_like(x)
        return torch.stack([zero, zero, torch.ones_like(x)], dim=dim)
    s = terrain.horizontal_scale
    h0 = height_at(terrain, x, y)
    hxp = height_at(terrain, x + s, y)
    hxm = height_at(terrain, x - s, y)
    hyp = height_at(terrain, x, y + s)
    hym = height_at(terrain, x, y - s)
    dx = (hxp - hxm) / (2 * s)
    dy = (hyp - hym) / (2 * s)
    jump = torch.maximum(
        torch.maximum(torch.abs(hxp - h0), torch.abs(h0 - hxm)),
        torch.maximum(torch.abs(hyp - h0), torch.abs(h0 - hym))) / s
    riser = jump > riser_threshold
    dx = torch.where(riser, 0.0, dx)
    dy = torch.where(riser, 0.0, dy)
    n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=dim)
    return n / torch.linalg.vector_norm(n, dim=dim, keepdim=True)


def terrain_normal(terrain: TerrainData, xy: torch.Tensor,
                   riser_threshold: float = tp.RISER_SLOPE_THRESHOLD
                   ) -> torch.Tensor:
    """Surface normal (..., 3) at (..., 2) points (see `normal_at`)."""
    return normal_at(terrain, xy[..., 0], xy[..., 1], dim=-1,
                     riser_threshold=riser_threshold)


# ---------------------------------------------------------------------------
# Small linear algebra helpers (explicit, batched over leading dims)
# ---------------------------------------------------------------------------


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Explicit 3x3 inverse via the adjugate, batched over leading dims
    (the adjugate divided by the determinant, as the JAX package rounds)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H_ = b * g - a * h
    I_ = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([A, B, C, D, E, F, G, H_, I_], dim=-1).reshape(m.shape)
    return adj / det[..., None, None]


def inv6_spd(m: torch.Tensor) -> torch.Tensor:
    """6x6 SPD inverse via one level of 3x3 block Schur complement."""
    P = m[..., :3, :3]
    Q = m[..., :3, 3:]
    R = m[..., 3:, 3:]
    Pi = inv3(P)
    T = R - Q.mT @ Pi @ Q
    Ti = inv3(T)
    PiQ = Pi @ Q
    top_left = Pi + PiQ @ Ti @ PiQ.mT
    top_right = -PiQ @ Ti
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([top_right.mT, Ti], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _mv(M, v):
    """Matrix-vector product over leading dims: (...,i,j),(...,j)->(...,i)."""
    return torch.einsum("...ij,...j->...i", M, v)


def _mtv(M, v):
    """M^T v over leading dims."""
    return torch.einsum("...ji,...j->...i", M, v)


def _spatial_inertia(m, c, I):
    """(...,6,6) body-frame spatial inertia about body origin (mcI form)."""
    Sc = maths.skew(c)
    eye = torch.eye(3, device=Sc.device).expand(Sc.shape)
    mm = m[..., None, None]
    top = torch.cat([I + mm * (Sc @ Sc.mT), mm * Sc], dim=-1)
    bot = torch.cat([mm * Sc.mT, mm * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _xmat(E, r):
    """(...,6,6) motion transform parent->child for (omega, v_origin)."""
    z = torch.zeros_like(E)
    top = torch.cat([E, z], dim=-1)
    bot = torch.cat([-E @ maths.skew(r), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _xm(E, r, v):
    """Apply motion transform: v_child = X v_parent. v: (...,6)."""
    w, u = v[..., :3], v[..., 3:]
    wc = _mv(E, w)
    uc = _mv(E, u - maths.cross(r, w))
    return torch.cat([wc, uc], dim=-1)


def _xfT(E, r, f):
    """Apply X^T to a force vector: f_parent = X^T f_child. f: (...,6)."""
    n, F = f[..., :3], f[..., 3:]
    Fp = _mtv(E, F)
    np_ = _mtv(E, n) + maths.cross(r, Fp)
    return torch.cat([np_, Fp], dim=-1)


def _mcross(v, u):
    w, vo = v[..., :3], v[..., 3:]
    w2, vo2 = u[..., :3], u[..., 3:]
    return torch.cat([maths.cross(w, w2),
                      maths.cross(w, vo2) + maths.cross(vo, w2)], dim=-1)


def _fcross(v, f):
    w, vo = v[..., :3], v[..., 3:]
    n, F = f[..., :3], f[..., 3:]
    return torch.cat([maths.cross(w, n) + maths.cross(vo, F),
                      maths.cross(w, F)], dim=-1)


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ---------------------------------------------------------------------------
# Leg-batched kinematics
# ---------------------------------------------------------------------------


def forward_kinematics(layout: QuadLayout, state: SimState):
    """World pose + velocity of all bodies, leg-axis batched.

    Returns R (N,nb,3,3), p (N,nb,3), w (N,nb,3), v (N,nb,3),
    axis_w (N,12,3), joint_pos_w (N,12,3) in flattened body order
    [base, FL_hip, FL_thigh, FL_calf, FR_..., RL_..., RR_...].
    """
    dev = state.base_pos.device
    N = state.base_pos.shape[0]
    axes = _f32(layout.axes, dev)                       # (L,D,3)
    origins = _f32(layout.origins, dev)

    R0 = maths.quat_to_matrix(state.base_quat)          # (N,3,3)
    q = state.q.reshape(N, NLEG, DEPTH)
    qd = state.qd.reshape(N, NLEG, DEPTH)

    Rs, ps, ws, vs, aw = [], [], [], [], []
    Rp = R0[:, None].expand(N, NLEG, 3, 3)
    pp = state.base_pos[:, None].expand(N, NLEG, 3)
    wp = state.base_ang_vel[:, None].expand(N, NLEG, 3)
    vp = state.base_lin_vel[:, None].expand(N, NLEG, 3)
    for d in range(DEPTH):
        Rj = maths.axis_angle_matrix(axes[:, d], q[:, :, d])   # (N,L,3,3)
        r_w = _mv(Rp, origins[:, d])
        axis_w = _mv(Rp, axes[:, d])
        Rc = Rp @ Rj
        pc = pp + r_w
        wc = wp + axis_w * qd[:, :, d:d + 1]
        vc = vp + maths.cross(wp, r_w)
        Rs.append(Rc)
        ps.append(pc)
        ws.append(wc)
        vs.append(vc)
        aw.append(axis_w)
        Rp, pp, wp, vp = Rc, pc, wc, vc

    # stack to flat body order: (N, L, D, ...) -> interleaved 1+3l+d
    def flat(xs, base):
        s = torch.stack(xs, dim=2)
        s = s.reshape((N, NLEG * DEPTH) + s.shape[3:])
        return torch.cat([base[:, None], s], dim=1)

    R = flat(Rs, R0)
    p = flat(ps, state.base_pos)
    w = flat(ws, state.base_ang_vel)
    v = flat(vs, state.base_lin_vel)
    axis_w = torch.stack(aw, dim=2).reshape(N, NLEG * DEPTH, 3)
    joint_pos_w = p[:, 1:]
    return R, p, w, v, axis_w, joint_pos_w


def geom_positions(model: RobotModel, R: torch.Tensor, p: torch.Tensor,
                   w: torch.Tensor, v: torch.Tensor):
    """World position & velocity (N, G, 3) of every collision-sphere
    center."""
    dev = p.device
    offs = _f32(model.geom_offset, dev)
    gb = torch.as_tensor(np.asarray(model.geom_body), dtype=torch.long,
                         device=dev)
    arm = torch.einsum("ngij,gj->ngi", R[:, gb], offs)
    pos = p[:, gb] + arm
    vel = v[:, gb] + maths.cross(w[:, gb], arm)
    return pos, vel


# ---------------------------------------------------------------------------
# Leg-batched CRBA + RNEA with structured (block-Schur) solve
# ---------------------------------------------------------------------------


class StructuredInertia(NamedTuple):
    """Blocks of H = [[A, B^T],[B, D]] plus precomputed inverses, per env.

    Coordinates: u = (omega_base, v_base), then 12 joint rates
    (leg-major). D is block-diagonal: (L, 3, 3) per-leg blocks.
    """
    A: torch.Tensor        # (N,6,6)
    B: torch.Tensor        # (N,L,3,6)  joint-rows x base-cols per leg
    D: torch.Tensor        # (N,L,3,3)
    Dinv: torch.Tensor     # (N,L,3,3)
    Sinv: torch.Tensor     # (N,6,6) inverse of A - sum B^T Dinv B


def dense_mass_matrix(si: StructuredInertia) -> torch.Tensor:
    """Materialize the (N,18,18) H from blocks (tests / debugging only)."""
    N = si.A.shape[0]
    B = si.B.reshape(N, NLEG * DEPTH, 6)
    top = torch.cat([si.A, B.mT], dim=-1)
    Dfull = torch.zeros((N, NLEG * DEPTH, NLEG * DEPTH), dtype=si.D.dtype,
                        device=si.D.device)
    for leg in range(NLEG):
        sl = slice(DEPTH * leg, DEPTH * (leg + 1))
        Dfull[:, sl, sl] = si.D[:, leg]
    bot = torch.cat([B, Dfull], dim=-1)
    return torch.cat([top, bot], dim=-2)


def structured_solve(si: StructuredInertia, rhs: torch.Tensor
                     ) -> torch.Tensor:
    """Solve H x = rhs per env for rhs (N, 18) or (N, 18, m)."""
    squeeze = rhs.dim() == 2
    if squeeze:
        rhs = rhs[..., None]
    N = rhs.shape[0]
    rb = rhs[:, :6]                                     # (N,6,m)
    rl = rhs[:, 6:].reshape(N, NLEG, DEPTH, -1)         # (N,L,3,m)
    y = si.Dinv @ rl                                    # (N,L,3,m)
    rb2 = rb - torch.einsum("nlji,nljm->nim", si.B, y)
    xb = si.Sinv @ rb2                                  # (N,6,m)
    xl = si.Dinv @ (rl - si.B @ xb[:, None])
    x = torch.cat([xb, xl.reshape(N, NLEG * DEPTH, -1)], dim=1)
    return x[..., 0] if squeeze else x


def _structured(A, B, D) -> StructuredInertia:
    Dinv = inv3(D)
    Smat = A - torch.einsum("nlji,nljk,nlkm->nim", B, Dinv, B)
    return StructuredInertia(A=A, B=B, D=D, Dinv=Dinv, Sinv=inv6_spd(Smat))


def world_dynamics(layout: QuadLayout, params: SimParams, dyn: DynParams,
                   state: SimState, implicit_damping: torch.Tensor,
                   fk=None):
    """World-frame dynamics via COM Jacobians.

    Generalized coordinates u = (omega_world, v_base_origin_world, qd). The
    mass matrix is H = sum_b J6_b^T diag(m_b I3, I_w_b) J6_b where J6_b
    stacks the body-b COM linear Jacobian and angular Jacobian; the bias is
    recursive Newton-Euler (velocity-product accelerations from 3-level
    leg-batched recursions, gyroscopic torques, gravity), then one J^T f
    contraction.

    Returns (StructuredInertia, bias (N,18), fk results). Equation of
    motion: H du/dt = tau_gen - bias.
    """
    if fk is None:
        fk = forward_kinematics(layout, state)
    R, p, w, v, axis_w, joint_pos_w = fk
    dev = p.device
    N = p.shape[0]
    nb = NLEG * DEPTH + 1
    nj = NLEG * DEPTH

    qd = state.qd.reshape(N, NLEG, DEPTH)
    O = state.base_pos[:, None]                                 # (N,1,3)

    # world-frame COM positions and rotational inertias
    com_w = p + _mv(R, dyn.com)                                 # (N,nb,3)
    I_w = torch.einsum("nbij,nbjk,nblk->nbil", R, dyn.inertia, R)

    # ---- bias accelerations (qdd = 0): 3-level leg-batched recursion ----
    w_leg = w[:, 1:].reshape(N, NLEG, DEPTH, 3)
    p_leg = p[:, 1:].reshape(N, NLEG, DEPTH, 3)
    a_leg = axis_w.reshape(N, NLEG, DEPTH, 3)
    w0 = state.base_ang_vel[:, None]                            # (N,1,3)

    wdot = []          # (N,L,3) per depth
    apt = []           # accel of body-origin points
    wdot_p = torch.zeros((N, NLEG, 3), device=dev)
    # base point-acceleration field evaluated at the hip joint origins
    r0 = p_leg[:, :, 0] - O
    apt_p = maths.cross(w0, maths.cross(w0, r0))
    w_p = w0.expand(N, NLEG, 3)
    pp = p_leg[:, :, 0]
    for d in range(DEPTH):
        wdot_c = wdot_p + maths.cross(w_p, a_leg[:, :, d]) * qd[:, :, d:d + 1]
        wdot.append(wdot_c)
        apt.append(apt_p)
        if d + 1 < DEPTH:
            r = p_leg[:, :, d + 1] - pp
            w_c = w_leg[:, :, d]
            apt_p = (apt_p + maths.cross(wdot_c, r)
                     + maths.cross(w_c, maths.cross(w_c, r)))
            w_p = w_c
            wdot_p = wdot_c
            pp = p_leg[:, :, d + 1]

    zero = torch.zeros((N, 1, 3), device=dev)
    wdot_all = torch.cat(
        [zero, torch.stack(wdot, dim=2).reshape(N, nj, 3)], dim=1)
    apt_all = torch.cat(
        [zero, torch.stack(apt, dim=2).reshape(N, nj, 3)], dim=1)

    # COM accelerations (velocity products only)
    r_com = com_w - p
    a_com = (apt_all + maths.cross(wdot_all, r_com)
             + maths.cross(w, maths.cross(w, r_com)))

    # ---- Newton-Euler bias forces (world, about COM) ----
    gvec = torch.tensor([0.0, 0.0, params.gravity], device=dev)
    F_b = dyn.mass[..., None] * (a_com - gvec)                  # (N,nb,3)
    Iw_w = _mv(I_w, w)
    N_b = _mv(I_w, wdot_all) + maths.cross(w, Iw_w)

    # ---- Jacobians (closed form) ----
    # J_vcom rows: d v_com / d(omega0) = -S(com - O); d/d v0 = I;
    #              d/d qd_j = a_j x (com - p_j) (ancestors only)
    # J_w rows:    d w / d(omega0) = I; d/d qd_j = a_j
    anc = _f32(layout.anc_mask, dev)[..., None]                 # (nb,nj,1)
    arm_com = com_w[:, :, None, :] - joint_pos_w[:, None, :, :]  # (N,nb,nj,3)
    axis_b = axis_w[:, None].expand(arm_com.shape)
    Jq_v = maths.cross(axis_b, arm_com) * anc
    Jq_w = axis_b * anc

    eye3 = torch.eye(3, device=dev).expand(N, nb, 3, 3)
    Jv = torch.cat([-maths.skew(com_w - O), eye3, Jq_v.mT], dim=-1)
    Jw = torch.cat([eye3, torch.zeros((N, nb, 3, 3), device=dev), Jq_w.mT],
                   dim=-1)                                      # (N,nb,3,18)

    # ---- bias + mass matrix as large contractions ----
    bias = (torch.einsum("nbae,nba->ne", Jv, F_b)
            + torch.einsum("nbae,nba->ne", Jw, N_b))
    H = (torch.einsum("nb,nbae,nbaf->nef", dyn.mass, Jv, Jv)
         + torch.einsum("nbae,nbac,nbcf->nef", Jw, I_w, Jw))

    diag_add = params.dt * implicit_damping + params.armature   # (N,12)
    H = H + torch.diag_embed(torch.cat(
        [torch.zeros((N, 6), device=dev), diag_add], dim=-1))

    # ---- block extraction for the Schur solve ----
    A = H[:, :6, :6]
    B = torch.stack([H[:, 6 + 3 * leg:9 + 3 * leg, :6]
                     for leg in range(NLEG)], dim=1)
    Dblk = torch.stack([H[:, 6 + 3 * leg:9 + 3 * leg, 6 + 3 * leg:9 + 3 * leg]
                        for leg in range(NLEG)], dim=1)
    return _structured(A, B, Dblk), bias, fk


def mass_matrix_and_bias(layout: QuadLayout, params: SimParams,
                         dyn: DynParams, state: SimState,
                         implicit_damping: torch.Tensor):
    """Leg-batched body-frame CRBA + RNEA (the independent check of
    `world_dynamics`).

    Returns (StructuredInertia, bias (N,18), R_base (N,3,3)). Dynamics:
    H du/dt = tau_gen - bias in coords u = (omega_b, v_b base-frame, qd).
    """
    dev = state.base_pos.device
    N = state.base_pos.shape[0]
    axes = _f32(layout.axes, dev)                      # (L,D,3)
    origins = _f32(layout.origins, dev)
    q = state.q.reshape(N, NLEG, DEPTH)
    qd = state.qd.reshape(N, NLEG, DEPTH)

    Rbase = maths.quat_to_matrix(state.base_quat)      # (N,3,3)
    w0 = _mtv(Rbase, state.base_ang_vel)
    u0 = _mtv(Rbase, state.base_lin_vel)
    v_base = torch.cat([w0, u0], dim=-1)                # (N,6)

    # spatial inertias (leg-shaped)
    mass, com, inert = dyn.mass, dyn.com, dyn.inertia
    I_base = _spatial_inertia(mass[:, 0], com[:, 0], inert[:, 0])
    mass_l = mass[:, 1:].reshape(N, NLEG, DEPTH)
    com_l = com[:, 1:].reshape(N, NLEG, DEPTH, 3)
    inert_l = inert[:, 1:].reshape(N, NLEG, DEPTH, 3, 3)
    I_l = [_spatial_inertia(mass_l[:, :, d], com_l[:, :, d], inert_l[:, :, d])
           for d in range(DEPTH)]                       # each (N,L,6,6)

    # chain transforms
    E, r, X, S, v = [], [], [], [], []
    vp = v_base[:, None].expand(N, NLEG, 6)
    zeros3 = torch.zeros((NLEG, 3), device=dev)
    for d in range(DEPTH):
        Rj = maths.axis_angle_matrix(axes[:, d], q[:, :, d])
        Ed = Rj.mT
        rd = origins[:, d]                              # (L,3)
        E.append(Ed)
        r.append(rd)
        X.append(_xmat(Ed, rd))
        Sd = torch.cat([axes[:, d], zeros3], dim=-1)    # (L,6)
        S.append(Sd)
        vd = _xm(Ed, rd, vp) + Sd * qd[:, :, d:d + 1]
        v.append(vd)
        vp = vd

    # ---- RNEA bias (qdd = 0; gravity folded in as base acceleration) ----
    g_base = _mtv(Rbase, torch.tensor([0.0, 0.0, params.gravity],
                                      device=dev))
    a_base = torch.cat([torch.zeros((N, 3), device=dev), -g_base], dim=-1)
    a = []
    ap = a_base[:, None].expand(N, NLEG, 6)
    for d in range(DEPTH):
        ad = _xm(E[d], r[d], ap) + _mcross(v[d], S[d] * qd[:, :, d:d + 1])
        a.append(ad)
        ap = ad
    f = [_mv(I_l[d], a[d]) + _fcross(v[d], _mv(I_l[d], v[d]))
         for d in range(DEPTH)]
    f_base = _mv(I_base, a_base) + _fcross(v_base, _mv(I_base, v_base))

    bias_l = [None] * DEPTH
    fd = f[DEPTH - 1]
    for d in range(DEPTH - 1, -1, -1):
        bias_l[d] = torch.sum(S[d] * fd, dim=-1)        # (N,L)
        fd_up = _xfT(E[d], r[d], fd)
        if d > 0:
            fd = f[d - 1] + fd_up
        else:
            f_base = f_base + torch.sum(fd_up, dim=1)
    bias = torch.cat([f_base, torch.stack(bias_l, dim=2).reshape(N, -1)],
                     dim=-1)

    # ---- CRBA ----
    Icc = [None] * DEPTH
    Icc[DEPTH - 1] = I_l[DEPTH - 1]
    for d in range(DEPTH - 2, -1, -1):
        Icc[d] = I_l[d] + X[d + 1].mT @ Icc[d + 1] @ X[d + 1]
    A = I_base + torch.sum(X[0].mT @ Icc[0] @ X[0], dim=1)

    # joint blocks: propagate F = Icc_d S_d down to base; the blocks are
    # built as lists and stacked
    Dent = [[None] * DEPTH for _ in range(DEPTH)]
    Brows = [None] * DEPTH
    for d in range(DEPTH):
        F = _mv(Icc[d], S[d])                           # (N,L,6)
        Dent[d][d] = torch.sum(S[d] * F, dim=-1)        # (N,L)
        for dd in range(d - 1, -1, -1):
            F = _xfT(E[dd + 1], r[dd + 1], F)
            val = torch.sum(S[dd] * F, dim=-1)
            Dent[d][dd] = val
            Dent[dd][d] = val
        Brows[d] = _xfT(E[0], r[0], F)
    Dblk = torch.stack([torch.stack(row, dim=-1) for row in Dent], dim=-2)
    Bblk = torch.stack(Brows, dim=2)                    # (N,L,3,6)

    diag_add = (params.dt * implicit_damping
                + params.armature).reshape(N, NLEG, DEPTH)
    Dblk = Dblk + torch.eye(DEPTH, device=dev) * diag_add[..., None]
    return _structured(A, Bblk, Dblk), bias, Rbase


# ---------------------------------------------------------------------------
# Contact impulse solver + substep
# ---------------------------------------------------------------------------


def _tangent_basis(n: torch.Tensor):
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9,
                      torch.tensor([0.0, 0.0, 1.0], device=n.device),
                      torch.tensor([1.0, 0.0, 0.0], device=n.device))
    t1 = maths.cross(n, ref)
    t1 = t1 / (torch.linalg.vector_norm(t1, dim=-1, keepdim=True) + 1e-9)
    t2 = maths.cross(n, t1)
    return t1, t2


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    to the lower index, as jax.lax.top_k breaks them: a stable descending
    sort (at rest on flat ground several contact gaps tie exactly)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class _Static(NamedTuple):
    """Per-model constant tensors of `substep`, built once on the device."""
    geom_body: torch.Tensor      # (G,) long
    geom_radius: torch.Tensor    # (G,)
    dof_lower: torch.Tensor      # (12,)
    dof_upper: torch.Tensor      # (12,)
    anc_mask: torch.Tensor       # (nb,12) f32
    foot_idx: torch.Tensor       # (4,) long


def _static(model: RobotModel, layout: QuadLayout, device) -> _Static:
    long = dict(dtype=torch.long, device=device)
    return _Static(
        geom_body=torch.as_tensor(np.asarray(model.geom_body), **long),
        geom_radius=_f32(model.geom_radius, device),
        dof_lower=_f32(model.dof_lower, device),
        dof_upper=_f32(model.dof_upper, device),
        anc_mask=_f32(layout.anc_mask, device),
        foot_idx=torch.as_tensor(np.asarray(model.foot_geom_idx), **long))


def substep(model: RobotModel, layout: QuadLayout, params: SimParams,
            dyn: DynParams, terrain: TerrainData, state: SimState,
            tau: torch.Tensor, implicit_damping: torch.Tensor,
            static: Optional[_Static] = None):
    """One dt physics substep for N envs (the JAX package's per-env
    `substep`, batched on a leading axis).

    tau, implicit_damping: (N, 12); tau already clipped to the effort
    limits by the caller. `static` (from `_static`) saves rebuilding the
    model's constant tensors on every call.
    """
    dt = params.dt
    K = params.num_contacts
    dev = state.base_pos.device
    N = state.base_pos.shape[0]
    st = static if static is not None else _static(model, layout, dev)

    fk = forward_kinematics(layout, state)
    R, p, w, vlin, axis_w, joint_pos_w = fk
    gpos, gvel = geom_positions(model, R, p, w, vlin)       # (N,G,3)

    # ---- joint limits: stiff spring made implicit by folding k*dt (the
    # linearized spring rate) plus extra damping into the mass-matrix
    # diagonal, so a hard limit (300 N*m/rad) stays stable at dt=0.005 ----
    viol_lo = torch.clamp(st.dof_lower - state.q, min=0.0)
    viol_hi = torch.clamp(state.q - st.dof_upper, min=0.0)
    in_viol = ((viol_lo > 0) | (viol_hi > 0)).to(torch.float32)
    # implicit-Euler spring: (M + (k dt + d) dt) qdd = tau - k(q-b) - k dt qd
    tau_lim = (params.joint_limit_stiffness * (viol_lo - viol_hi)
               - params.joint_limit_stiffness * dt * state.qd * in_viol)
    tau_tot = tau + tau_lim
    damping_eff = implicit_damping + in_viol * (
        params.joint_limit_stiffness * dt + params.joint_limit_damping)

    # ---- free dynamics (world coords u = (omega_w, v_w, qd)) ----
    si, bias, _ = world_dynamics(layout, params, dyn, state, damping_eff, fk)
    tau_gen = torch.cat([torch.zeros((N, 6), device=dev), tau_tot], dim=-1)

    # ---- contact candidates: top-K most penetrating ----
    h = terrain_height(terrain, gpos[..., :2])
    gap = gpos[..., 2] - st.geom_radius - h                 # (N,G)
    neg_gap, cidx = top_k(-gap, K)                          # (N,K)
    cpos = torch.take_along_dim(gpos, cidx[..., None], dim=1)
    cvel = torch.take_along_dim(gvel, cidx[..., None], dim=1)
    cbody = st.geom_body[cidx]                              # (N,K)
    n = terrain_normal(terrain, cpos[..., :2])
    active = neg_gap > -1e-4
    activef = active.to(torch.float32)
    pen = torch.clamp(neg_gap, min=0.0)
    t1, t2 = _tangent_basis(n)

    # ---- contact jacobian in world coords ----
    r_c = cpos - state.base_pos[:, None]
    Jw = -maths.skew(r_c)                                   # (N,K,3,3)
    Jv = torch.eye(3, device=dev).expand(N, K, 3, 3)
    arm_j = cpos[:, :, None, :] - joint_pos_w[:, None, :, :]  # (N,K,12,3)
    col_j = maths.cross(axis_w[:, None].expand(arm_j.shape), arm_j)
    amask = st.anc_mask[cbody]                              # (N,K,12)
    Jq = (col_j * amask[..., None]).mT                      # (N,K,3,12)
    J = torch.cat([Jw, Jv, Jq], dim=-1)                     # (N,K,3,18)

    frame = torch.stack([n, t1, t2], dim=2)                 # (N,K,3,3)
    Jc = frame @ J                                          # (N,K,3,18)
    Jc_flat = Jc.reshape(N, K * 3, 18)

    # ---- one structured solve serves free motion + contact mass ----
    rhs = torch.cat([(tau_gen - bias)[..., None], Jc_flat.mT], dim=-1)
    sol = structured_solve(si, rhs)                         # (N,18,1+3K)
    du_free = sol[..., 0]
    Binv = sol[..., 1:].mT                                  # (N,3K,18)

    u_cur = torch.cat([state.base_ang_vel, state.base_lin_vel, state.qd],
                      dim=-1)
    u_free = u_cur + dt * du_free

    # clamp: f32 roundoff on ill-conditioned H can push the J H^-1 J^T
    # diagonal slightly negative -> inverse blows up the impulse solve
    d_diag = torch.clamp(torch.sum(Jc_flat * Binv, dim=-1).reshape(N, K, 3),
                         min=0.0) + params.contact_compliance
    inv_d = 1.0 / d_diag

    vn0 = torch.sum(cvel * n, dim=-1)
    push = torch.clamp(
        params.baumgarte * torch.clamp(pen - params.contact_slop, min=0.0)
        / dt, max=params.max_depenetration_velocity)
    bounce = torch.where(-vn0 > params.bounce_threshold_velocity,
                         -dyn.restitution[:, None] * vn0, 0.0)
    v_target_n = torch.maximum(push, bounce)
    mu = dyn.friction[:, None, None]

    Bmat = Binv.reshape(N, K, 3, 18)

    # mass-splitting relaxation (see tengine._substep): fixed-omega Jacobi
    # diverges on clustered contacts; scale omega by each env's
    # active-contact count
    n_act = torch.sum(activef, dim=-1)                      # (N,)
    omega = params.relaxation * torch.clamp(
        4.0 / torch.clamp(n_act, min=1.0), max=1.0)
    omega_n, omega_t = omega[:, None], omega[:, None, None]

    lam = torch.zeros((N, K, 3), device=dev)
    for _ in range(params.solver_iters):
        du = torch.einsum("nkfe,nkf->ne", Bmat, lam)
        v_now = Jc @ (u_free + du)[:, None, :, None]        # (N,K,3,1)
        v_now = v_now[..., 0]
        dlam_n = (v_target_n - v_now[..., 0]) * inv_d[..., 0]
        lam_n = torch.clamp(lam[..., 0] + omega_n * dlam_n, min=0.0)
        lam_n = torch.where(active, lam_n, 0.0)
        dlam_t = -v_now[..., 1:] * inv_d[..., 1:]
        lam_t = lam[..., 1:] + omega_t * dlam_t
        t_norm = torch.linalg.vector_norm(lam_t, dim=-1, keepdim=True)
        max_t = mu * lam_n[..., None]
        scale = torch.clamp(max_t / (t_norm + 1e-9), max=1.0)
        lam_t = lam_t * scale * activef[..., None]
        lam = torch.cat([lam_n[..., None], lam_t], dim=-1)

    u_new = u_free + torch.einsum("nkfe,nkf->ne", Bmat, lam)

    # ---- integrate (semi-implicit Euler) ----
    new_ang = torch.clamp(u_new[:, :3], -params.max_angular_velocity,
                          params.max_angular_velocity)
    new_lin = torch.clamp(u_new[:, 3:6], -params.max_linear_velocity,
                          params.max_linear_velocity)
    new_qd = torch.clamp(u_new[:, 6:], -params.max_joint_velocity,
                         params.max_joint_velocity)
    new_pos = state.base_pos + dt * new_lin
    new_quat = maths.quat_integrate(state.base_quat, new_ang, dt)
    new_q = state.q + dt * new_qd
    new_state = SimState(new_pos, new_quat, new_q, new_lin, new_ang, new_qd)

    # ---- diagnostics (world frame) ----
    f_contact = torch.einsum("nkf,nkfa->nka", lam, frame) / dt
    is_foot = (cidx[:, None, :]
               == st.foot_idx[None, :, None]).to(torch.float32)  # (N,4,K)
    foot_forces = is_foot @ f_contact
    # foot contact is reported ONLY via foot_forces, never as calf-body
    # contact (the reference keeps feet as separate rigid bodies via
    # dont_collapse; see sim/tengine.py). Duplicate bodies in cbody sum,
    # as the JAX package's .at[].add does.
    nonfoot = 1.0 - torch.sum(is_foot, dim=1)               # (N,K)
    body_forces = torch.zeros((N, model.nb, 3), device=dev).scatter_add_(
        1, cbody[..., None].expand(N, K, 3), f_contact * nonfoot[..., None])
    outputs = SimOutputs(
        contact_forces=body_forces,
        foot_forces=foot_forces,
        foot_pos=gpos[:, st.foot_idx],
        foot_vel=gvel[:, st.foot_idx],
    )
    return new_state, outputs


def terrain_to(terrain: TerrainData, device) -> TerrainData:
    """`terrain` with its tensors on `device`."""
    ch = terrain.channels
    return terrain._replace(height=terrain.height.to(device),
                            channels=None if ch is None else ch.to(device))


def make_batched_substep(model: RobotModel, params: SimParams,
                         terrain: TerrainData, device="cuda"):
    """The batched substep over (DynParams, SimState, tau,
    implicit_damping), all with a leading N, on `device` (the card unless
    told otherwise; the terrain moves there)."""
    from go2_rl_gym_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    layout = quad_layout(model)
    terrain = terrain_to(terrain, dev)
    static = _static(model, layout, dev)

    def step(dyn, state, tau, implicit_damping):
        return substep(model, layout, params, dyn, terrain, state, tau,
                       implicit_damping, static)

    return step
