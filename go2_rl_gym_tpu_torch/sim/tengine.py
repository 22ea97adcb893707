"""Batch-last (T-layout) physics core.

PyTorch port of go2_rl_gym_tpu/sim/tengine.py, mirrored one function at a
time: leg-batched body-frame Featherstone CRBA/RNEA, the closed-form
block-Schur solve, top-K sphere-vs-heightfield contacts and a fixed-count
relaxed Jacobi impulse solve. Every internal array keeps the env batch N as
its trailing axis (see sim/tmath.py).

The reference's one-hot contractions (contact selection, the warm-start
scatter, the per-body force sum) become gathers and scatters here: exact in
fp32, where the reference needed HIGHEST matmul precision to be exact.

A substep's rigid-body stage (`rigid_body`: world kinematics, geoms, the
joint-limit spring, CRBA/RNEA and the block-Schur factors) is one
hand-written CUDA kernel on the card (ops/rigid_body.py) and
`rigid_body_plain` on the CPU; the contact stage after it is PyTorch.

Public entry: `make_physics_step(model, params, terrain, decimation)`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from go2_rl_gym_tpu_torch.ops import rigid_body as rb
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.sim import tmath as tm
from go2_rl_gym_tpu_torch.sim.engine import (DEPTH, NLEG, DynParams,
                                             QuadLayout, SimOutputs,
                                             SimParams, SimState, TerrainData,
                                             height_at, normal_at,
                                             quad_layout, top_k)
from go2_rl_gym_tpu_torch.sim.model import RobotModel


class TState(NamedTuple):
    """SimState in T layout: component axes first, batch last."""
    pos: torch.Tensor    # (3, N)
    quat: torch.Tensor   # (4, N)
    q: torch.Tensor      # (12, N)
    lin: torch.Tensor    # (3, N)
    ang: torch.Tensor    # (3, N)
    qd: torch.Tensor     # (12, N)


def to_t(state: SimState) -> TState:
    return TState(pos=state.base_pos.T, quat=state.base_quat.T,
                  q=state.q.T, lin=state.base_lin_vel.T,
                  ang=state.base_ang_vel.T, qd=state.qd.T)


def from_t(t: TState) -> SimState:
    c = torch.Tensor.contiguous
    return SimState(base_pos=c(t.pos.T), base_quat=c(t.quat.T), q=c(t.q.T),
                    base_lin_vel=c(t.lin.T), base_ang_vel=c(t.ang.T),
                    qd=c(t.qd.T))


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _terrain_height_t(terrain: TerrainData, x, y):
    """Min-of-3 heightfield lookup; x, y: (..., N)."""
    return height_at(terrain, x, y)


def _terrain_normal_t(terrain: TerrainData, x, y):
    """x, y: (..., N) -> normals (..., 3, N), with the riser snap."""
    return normal_at(terrain, x, y, dim=-2)


def _fk(layout: QuadLayout, s: TState, st):
    """World kinematics, leg-batched, T layout. `st`, a `_Static`, holds the
    layout's tensors on the device.

    Returns R (13,3,3,N), p (13,3,N), w (13,3,N), v (13,3,N),
    axis_w (12,3,N), jpos (12,3,N)."""
    axes_t, origins = st.axes, st.origins
    q = s.q.reshape(NLEG, DEPTH, -1)
    qd = s.qd.reshape(NLEG, DEPTH, -1)

    R0 = tm.quat_to_matrix(s.quat)                      # (3,3,N)
    N = s.pos.shape[-1]
    Rp = R0.expand(NLEG, 3, 3, N)
    pp = s.pos.expand(NLEG, 3, N)
    wp = s.ang.expand(NLEG, 3, N)
    vp = s.lin.expand(NLEG, 3, N)

    Rs, ps, ws, vs, aw = [], [], [], [], []
    for d in range(DEPTH):
        Rj = tm.rodrigues(axes_t[:, d], q[:, d])        # (L,3,3,N)
        r_w = tm.mv(Rp, origins[:, d].expand(NLEG, 3, N))
        axis_w = tm.mv(Rp, axes_t[:, d][..., None].expand(NLEG, 3, N))
        Rc = tm.mm(Rp, Rj)
        pc = pp + r_w
        wc = wp + axis_w * qd[:, d][:, None, :]
        vc = vp + tm.cross(wp, r_w)
        Rs.append(Rc); ps.append(pc); ws.append(wc); vs.append(vc)
        aw.append(axis_w)
        Rp, pp, wp, vp = Rc, pc, wc, vc

    def flat(xs, base):
        s_ = torch.stack(xs, dim=1)                     # (L,D,...)
        s_ = s_.reshape((NLEG * DEPTH,) + s_.shape[2:])
        return torch.cat([base[None], s_], dim=0)

    R = flat(Rs, R0)
    p = flat(ps, s.pos)
    w = flat(ws, s.ang)
    v = flat(vs, s.lin)
    axis_w = torch.stack(aw, dim=1).reshape(NLEG * DEPTH, 3, -1)
    return R, p, w, v, axis_w, p[1:]


def _spatial_inertia(m, c, I):
    """(...,N),(...,3,N),(...,3,3,N) -> (...,6,6,N) mcI form."""
    Sc = tm.skew(c)
    eye = torch.eye(3, device=m.device)[:, :, None].expand(Sc.shape)
    mI = m[..., None, None, :] * eye
    top = torch.cat([I + m[..., None, None, :] * tm.mmt(Sc, Sc),
                     m[..., None, None, :] * Sc], dim=-2)
    bot = torch.cat([m[..., None, None, :] * tm.transpose(Sc), mI], dim=-2)
    return torch.cat([top, bot], dim=-3)


def _xmat(E, r):
    """(L,3,3,N),(L,3,1 or N) -> (L,6,6,N) motion transform parent->child."""
    z = torch.zeros_like(E)
    Sr = tm.skew(r.expand(E.shape[:-3] + (3, E.shape[-1])))
    top = torch.cat([E, z], dim=-2)
    bot = torch.cat([-tm.mm(E, Sr), E], dim=-2)
    return torch.cat([top, bot], dim=-3)


def _xm(E, r, v6):
    """Motion transform applied to (L,6,N) spatial vectors."""
    w, u = v6[..., :3, :], v6[..., 3:, :]
    rb = r.expand(w.shape)
    wc = tm.mv(E, w)
    uc = tm.mv(E, u - tm.cross(rb, w))
    return torch.cat([wc, uc], dim=-2)


def _xfT(E, r, f6):
    """X^T on force vectors: child->parent."""
    n, F = f6[..., :3, :], f6[..., 3:, :]
    Fp = tm.mtv(E, F)
    rb = r.expand(Fp.shape)
    np_ = tm.mtv(E, n) + tm.cross(rb, Fp)
    return torch.cat([np_, Fp], dim=-2)


def _mcross(v, u):
    w, vo = v[..., :3, :], v[..., 3:, :]
    w2, vo2 = u[..., :3, :], u[..., 3:, :]
    return torch.cat([tm.cross(w, w2),
                      tm.cross(w, vo2) + tm.cross(vo, w2)], dim=-2)


def _fcross(v, f):
    w, vo = v[..., :3, :], v[..., 3:, :]
    n, F = f[..., :3, :], f[..., 3:, :]
    return torch.cat([tm.cross(w, n) + tm.cross(vo, F),
                      tm.cross(w, F)], dim=-2)


class TInertia(NamedTuple):
    B: torch.Tensor      # (L,3,6,N) joint-rows x base-cols
    Dinv: torch.Tensor   # (L,3,3,N)
    Sinv: torch.Tensor   # (6,6,N)


def _structured_solve(si: TInertia, rhs):
    """Solve H x = rhs; rhs (18, M, N) -> (18, M, N)."""
    rb = rhs[:6]                                        # (6,M,N)
    rl = rhs[6:].reshape(NLEG, DEPTH, *rhs.shape[1:])   # (L,3,M,N)
    y = tm.mm(si.Dinv, rl)                              # (L,3,M,N)
    # rb' = rb - sum_l B_l^T y_l : B (L,3,6,N)
    rb2 = rb - torch.sum(tm.mm(tm.transpose(si.B), y), dim=0)
    xb = tm.mm(si.Sinv, rb2)                            # (6,M,N)
    xl = tm.mm(si.Dinv, rl - tm.mm(si.B, xb[None]))
    return torch.cat([xb, xl.reshape(-1, *rhs.shape[1:])], dim=0)


def _mass_matrix_and_bias(layout, params: SimParams, dyn_t, s: TState,
                          damping_eff, st):
    """Leg-batched body-frame CRBA + RNEA in T layout. `st`, a `_Static`,
    holds the layout's tensors and the gravity vector on the device.

    dyn_t: dict(mass (13,N), com (13,3,N), inertia (13,3,3,N)).
    Returns (TInertia, bias (18,N), Rbase (3,3,N))."""
    dev = s.pos.device
    axes_t, origins = st.axes, st.origins
    q = s.q.reshape(NLEG, DEPTH, -1)
    qd = s.qd.reshape(NLEG, DEPTH, -1)
    N = s.pos.shape[-1]

    Rbase = tm.quat_to_matrix(s.quat)
    w0 = tm.mtv(Rbase, s.ang)
    u0 = tm.mtv(Rbase, s.lin)
    v_base = torch.cat([w0, u0], dim=0)                 # (6,N)

    mass = dyn_t["mass"]
    com = dyn_t["com"]
    inert = dyn_t["inertia"]
    I_base = _spatial_inertia(mass[0], com[0], inert[0])     # (6,6,N)
    mass_l = mass[1:].reshape(NLEG, DEPTH, N)
    com_l = com[1:].reshape(NLEG, DEPTH, 3, N)
    inert_l = inert[1:].reshape(NLEG, DEPTH, 3, 3, N)
    I_l = [_spatial_inertia(mass_l[:, d], com_l[:, d], inert_l[:, d])
           for d in range(DEPTH)]                        # (L,6,6,N)

    E, r, X, Sax, v = [], [], [], [], []
    vp = v_base.expand(NLEG, 6, N)
    zeros3 = torch.zeros((NLEG, 3, N), device=dev)
    for d in range(DEPTH):
        Rj = tm.rodrigues(axes_t[:, d], q[:, d])
        Ed = tm.transpose(Rj)
        rd = origins[:, d]                               # (L,3,1)
        E.append(Ed)
        r.append(rd)
        X.append(_xmat(Ed, rd))
        Sd = torch.cat([axes_t[:, d][..., None].expand(NLEG, 3, N), zeros3],
                       dim=1)                            # (L,6,N)
        Sax.append(Sd)
        vd = _xm(Ed, rd, vp) + Sd * qd[:, d][:, None, :]
        v.append(vd)
        vp = vd

    # RNEA (qdd=0, gravity as base acceleration)
    g_base = tm.mtv(Rbase, st.gravity[:, None].expand(3, N))
    a_base = torch.cat([torch.zeros((3, N), device=dev), -g_base], dim=0)
    a = []
    ap = a_base.expand(NLEG, 6, N)
    for d in range(DEPTH):
        ad = _xm(E[d], r[d], ap) + _mcross(v[d], Sax[d] * qd[:, d][:, None, :])
        a.append(ad)
        ap = ad
    f = [tm.mv(I_l[d], a[d]) + _fcross(v[d], tm.mv(I_l[d], v[d]))
         for d in range(DEPTH)]
    f_base = tm.mv(I_base, a_base) + _fcross(v_base, tm.mv(I_base, v_base))

    bias_l = []
    fd = f[DEPTH - 1]
    for d in range(DEPTH - 1, -1, -1):
        bias_l.insert(0, torch.sum(Sax[d] * fd, dim=-2))   # (L,N)
        fd_up = _xfT(E[d], r[d], fd)
        if d > 0:
            fd = f[d - 1] + fd_up
        else:
            f_base = f_base + torch.sum(fd_up, dim=0)
    bias = torch.cat(
        [f_base, torch.stack(bias_l, dim=1).reshape(NLEG * DEPTH, N)], dim=0)

    # CRBA
    Icc = [None] * DEPTH
    Icc[DEPTH - 1] = I_l[DEPTH - 1]
    for d in range(DEPTH - 2, -1, -1):
        Icc[d] = I_l[d] + tm.mtm(X[d + 1], tm.mm(Icc[d + 1], X[d + 1]))
    A = I_base + torch.sum(tm.mtm(X[0], tm.mm(Icc[0], X[0])), dim=0)

    Drows = [[None] * DEPTH for _ in range(DEPTH)]
    Brows = [None] * DEPTH
    for d in range(DEPTH):
        F = tm.mv(Icc[d], Sax[d])                        # (L,6,N)
        Drows[d][d] = torch.sum(Sax[d] * F, dim=-2)      # (L,N)
        for dd in range(d - 1, -1, -1):
            F = _xfT(E[dd + 1], r[dd + 1], F)
            val = torch.sum(Sax[dd] * F, dim=-2)
            Drows[d][dd] = val
            Drows[dd][d] = val
        Brows[d] = _xfT(E[0], r[0], F)                   # (L,6,N)

    Dblk = torch.stack([torch.stack(row, dim=1) for row in Drows], dim=1)
    # (L,3,3,N)
    Bblk = torch.stack(Brows, dim=1)                     # (L,3,6,N)

    diag = damping_eff * params.dt + params.armature     # (12,N)
    diag = diag.reshape(NLEG, DEPTH, N)
    Dblk = Dblk + (torch.eye(DEPTH, device=dev)[None, :, :, None]
                   * diag[:, :, None, :])

    Dinv = tm.inv3(Dblk)
    # S = A - sum_l B^T Dinv B
    Smat = A - torch.sum(tm.mm(tm.transpose(Bblk), tm.mm(Dinv, Bblk)), dim=0)
    Sinv = tm.inv6_spd(Smat)
    return TInertia(B=Bblk, Dinv=Dinv, Sinv=Sinv), bias, Rbase


class _Static(NamedTuple):
    """Per-model constant tensors of _substep, built once on the device."""
    geom_body: torch.Tensor      # (G,) long
    geom_offset: torch.Tensor    # (G,3,1)
    geom_radius: torch.Tensor    # (G,1)
    dof_lower: torch.Tensor      # (12,1)
    dof_upper: torch.Tensor      # (12,1)
    anc_g: torch.Tensor          # (G,12) ancestry of each geom's body
    report_w: torch.Tensor       # (G,) 1 for geoms reported per body, 0 feet
    foot_idx: torch.Tensor       # (4,) long
    axes: torch.Tensor           # (L,D,3) joint axes in the child frame
    origins: torch.Tensor        # (L,D,3,1) joint origins in the parent frame
    gravity: torch.Tensor        # (3,) [0, 0, params.gravity]
    ref_z: torch.Tensor          # (3,1) tangent-basis reference [0, 0, 1]
    ref_x: torch.Tensor          # (3,1) its fallback [1, 0, 0]
    rb_table: torch.Tensor       # the rigid-body kernel's float table
    rb_itable: torch.Tensor      # and its int table (ops/rigid_body.py)


def _static(model: RobotModel, layout: QuadLayout, device,
            gravity: float = SimParams().gravity) -> _Static:
    gb = np.asarray(model.geom_body)
    # Feet are separate rigid bodies in the reference (go2.urdf marks the
    # foot joints dont_collapse); the parser merges foot geoms into the calf
    # body, so foot contact is EXCLUDED from the per-body contact_forces
    # report (else every stance step reads as calf collision) and reported
    # through foot_forces instead.
    report = np.ones(len(gb), np.float32)
    report[np.asarray(model.foot_geom_idx)] = 0.0
    long = dict(dtype=torch.long, device=device)
    rb_table, rb_itable = rb.tables(
        layout.axes, layout.origins, model.dof_lower, model.dof_upper,
        [0.0, 0.0, gravity], gb, model.geom_offset, device)
    return _Static(
        geom_body=torch.as_tensor(gb, **long),
        geom_offset=_f32(model.geom_offset, device)[:, :, None],
        geom_radius=_f32(model.geom_radius, device)[:, None],
        dof_lower=_f32(model.dof_lower, device)[:, None],
        dof_upper=_f32(model.dof_upper, device)[:, None],
        anc_g=_f32(np.asarray(layout.anc_mask, np.float32)[gb], device),
        report_w=_f32(report, device),
        foot_idx=torch.as_tensor(np.asarray(model.foot_geom_idx), **long),
        axes=_f32(layout.axes, device),
        origins=_f32(layout.origins, device)[..., None],
        gravity=_f32([0.0, 0.0, gravity], device),
        ref_z=_f32([0.0, 0.0, 1.0], device)[:, None],
        ref_x=_f32([1.0, 0.0, 0.0], device)[:, None],
        rb_table=rb_table, rb_itable=rb_itable)


class RigidBody(NamedTuple):
    """The rigid-body stage of a substep, as the contact stage reads it."""
    gpos: torch.Tensor           # (G,3,N) geom centres, world
    gvel: torch.Tensor           # (G,3,N) geom velocities, world
    jpos: torch.Tensor           # (12,3,N) joint positions, world
    axis_w: torch.Tensor         # (12,3,N) joint axes, world
    Rbase: torch.Tensor          # (3,3,N)
    rhs0: torch.Tensor           # (18,N) tau_gen - bias
    si: TInertia


def rigid_body_plain(layout: QuadLayout, params: SimParams, dyn_t,
                     s: TState, tau, implicit_damping, st: _Static
                     ) -> RigidBody:
    """World kinematics, geoms, the joint-limit spring and CRBA/RNEA of one
    substep in plain PyTorch: the version the CPU takes, and the one the
    CUDA kernel is held to."""
    dt = params.dt
    N = s.pos.shape[-1]
    dev = s.pos.device

    R, p, w, vlin, axis_w, jpos = _fk(layout, s, st)

    # geoms
    gb = st.geom_body
    G = gb.shape[0]
    Rg = R[gb]                                           # (G,3,3,N)
    arm = tm.mv(Rg, st.geom_offset.expand(G, 3, N))
    gpos = p[gb] + arm                                   # (G,3,N)
    gvel = vlin[gb] + tm.cross(w[gb], arm)

    # joint limits (implicit spring, see engine.substep)
    viol_lo = torch.clamp(st.dof_lower - s.q, min=0.0)
    viol_hi = torch.clamp(s.q - st.dof_upper, min=0.0)
    in_viol = ((viol_lo > 0) | (viol_hi > 0)).to(torch.float32)
    tau_tot = (tau + params.joint_limit_stiffness * (viol_lo - viol_hi)
               - params.joint_limit_stiffness * dt * s.qd * in_viol)
    damping_eff = implicit_damping + in_viol * (
        params.joint_limit_stiffness * dt + params.joint_limit_damping)

    si, bias, Rbase = _mass_matrix_and_bias(layout, params, dyn_t, s,
                                            damping_eff, st)
    tau_gen = torch.cat([torch.zeros((6, N), device=dev), tau_tot], dim=0)
    return RigidBody(gpos, gvel, jpos, axis_w, Rbase, tau_gen - bias, si)


def rigid_body(layout: QuadLayout, params: SimParams, dyn_t, s: TState, tau,
               implicit_damping, st: _Static) -> RigidBody:
    """`rigid_body_plain` for CPU tensors; for CUDA tensors the kernel
    (ops/csrc/rigid_body.cu), which raises on what it cannot take. dyn_t's
    tensors are contiguous on the card (`make_physics_step` makes them so
    once a policy step). Overridable as a torch function on the card, so
    that a TorchFunctionMode names the kernel after its caller
    (tools/profile_rollout.py `SourceLines`)."""
    if not s.pos.is_cuda:
        return rigid_body_plain(layout, params, dyn_t, s, tau,
                                implicit_damping, st)
    if torch.overrides.has_torch_function((s.pos, tau)):
        return torch.overrides.handle_torch_function(
            rigid_body, (s.pos, tau), layout, params, dyn_t, s, tau,
            implicit_damping, st)
    scalars = rb.scalars(params.dt, params.armature,
                         params.joint_limit_stiffness,
                         params.joint_limit_damping)
    (gpos, gvel, jpos, axis_w, Rbase, rhs0, B, Dinv,
     Sinv) = rb.rigid_body_cuda(
        tuple(s), tau, implicit_damping, dyn_t["mass"], dyn_t["com"],
        dyn_t["inertia"], st.rb_table, st.rb_itable, scalars)
    return RigidBody(gpos, gvel, jpos, axis_w, Rbase, rhs0,
                     TInertia(B=B, Dinv=Dinv, Sinv=Sinv))


def _substep(model: RobotModel, layout: QuadLayout, params: SimParams,
             terrain: TerrainData, dyn_t, fric, rest, s: TState,
             tau, implicit_damping, lam_geom, patch_data=None, static=None):
    """One physics substep, full batch, T layout.

    tau, implicit_damping: (12, N). lam_geom: (G, 3, N) warm-start impulses
    from the previous substep, keyed by geom. Returns (TState, outputs dict,
    new lam_geom)."""
    dt = params.dt
    K = params.num_contacts
    N = s.pos.shape[-1]
    dev = s.pos.device
    st = (static if static is not None
          else _static(model, layout, dev, params.gravity))

    gpos, gvel, jpos, axis_w, Rbase, rhs0, si = rigid_body(
        layout, params, dyn_t, s, tau, implicit_damping, st)
    gb = st.geom_body
    G = gb.shape[0]

    # ---- contact candidates: top-K most penetrating ----
    if patch_data is not None:
        # patch path: one in-patch lookup yields height AND slope channels
        patches_flat, origins = patch_data
        scale = terrain.horizontal_scale
        # float->int truncates toward zero, as astype(int32) does
        ix = ((gpos[:, 0, :] + terrain.border_offset) / scale).to(torch.int32)
        iy = ((gpos[:, 1, :] + terrain.border_offset) / scale).to(torch.int32)
        hmin, dxg, dyg = tp.lookup(patches_flat, origins, ix.T, iy.T)
        h = hmin.T                                        # (G,N)
        dx_g, dy_g = dxg.T, dyg.T
    else:
        h = _terrain_height_t(terrain, gpos[:, 0, :], gpos[:, 1, :])   # (G,N)
    gap = gpos[:, 2, :] - st.geom_radius - h
    # top-K of -gap per env, ties to the lower geom index (feet at equal
    # height tie)
    neg_gap, cidx = top_k((-gap).T, K)                   # (N,K) both
    cidxT = cidx.T                                       # (K,N)

    # contact selection: gather the K chosen geoms' channels
    geom_ch = [gpos, gvel, lam_geom]                      # each (G,3,N)
    if patch_data is not None:
        geom_ch.append(torch.stack([dx_g, dy_g], dim=1))  # (G,2,N)
    geom_ch = torch.cat(geom_ch, dim=1)                   # (G,C,N)
    Cc = geom_ch.shape[1]
    cdata = torch.gather(geom_ch, 0, cidxT[:, None, :].expand(K, Cc, N))
    cpos = cdata[:, 0:3]                                  # (K,3,N)
    cvel = cdata[:, 3:6]
    lam0 = cdata[:, 6:9]
    cgap = neg_gap.T                                      # (K,N)
    if patch_data is not None:
        dx_c = cdata[:, 9]
        dy_c = cdata[:, 10]
        n = torch.stack([-dx_c, -dy_c, torch.ones_like(dx_c)], dim=1)  # (K,3,N)
        n = n / tm.norm(n)[..., None, :]
    else:
        n = _terrain_normal_t(terrain, cpos[:, 0, :], cpos[:, 1, :])
    active = cgap > -1e-4
    activef = active.to(torch.float32)
    pen = torch.clamp(cgap, min=0.0)

    # tangent basis
    ref = torch.where(torch.abs(n[:, 2:3, :]) < 0.9, st.ref_z, st.ref_x)
    t1 = tm.cross(n, ref)
    t1 = t1 / (tm.norm(t1)[..., None, :] + 1e-9)
    t2 = tm.cross(n, t1)

    # ---- contact jacobian in Featherstone base coords (w_b, v_b, qd) ----
    r_c = cpos - s.pos[None]                              # (K,3,N)
    # columns for the 12 joints, masked by ancestry
    amask = st.anc_g[cidxT].permute(0, 2, 1)              # (K,12,N)
    arm_j = cpos[:, None, :, :] - jpos[None, :, :, :]     # (K,12,3,N)
    col_j = tm.cross(axis_w[None].expand(arm_j.shape), arm_j)
    col_j = col_j * amask[:, :, None, :]                  # (K,12,3,N)
    RbK = Rbase.expand(K, 3, 3, N)

    def rows(fvec):
        # row_w = R^T (r_c x f), row_v = R^T f, row_qj = f . col_j
        fR = tm.mtv(RbK, fvec)                            # (K,3,N)
        rw = tm.mtv(RbK, tm.cross(r_c, fvec))             # (K,3,N)
        rq = torch.sum(col_j * fvec[:, None, :, :], dim=-2)  # (K,12,N)
        return torch.cat([rw, fR, rq], dim=1)             # (K,18,N)

    Jc = torch.stack([rows(n), rows(t1), rows(t2)], dim=1)   # (K,3,18,N)
    Jc_flat = Jc.reshape(K * 3, 18, N)

    # ---- one structured solve: free motion + contact columns ----
    rhs = torch.cat([rhs0[:, None, :],
                     torch.movedim(Jc_flat, 0, 1)], dim=1)  # (18,1+3K,N)
    sol = _structured_solve(si, rhs)
    du_free = sol[:, 0, :]                                # (18,N)
    Binv = torch.movedim(sol[:, 1:, :], 1, 0)             # (3K,18,N)

    w_b = tm.mtv(Rbase, s.ang)
    u_b = tm.mtv(Rbase, s.lin)
    u_cur = torch.cat([w_b, u_b, s.qd], dim=0)
    u_free = u_cur + dt * du_free

    d_diag = torch.clamp(
        torch.sum(Jc_flat * Binv, dim=1).reshape(K, 3, N), min=0.0) \
        + params.contact_compliance
    inv_d = 1.0 / d_diag

    vn0 = tm.dot(cvel, n)                                 # (K,N)
    push = torch.clamp(
        params.baumgarte * torch.clamp(pen - params.contact_slop, min=0.0) / dt,
        max=params.max_depenetration_velocity)
    bounce = torch.where(-vn0 > params.bounce_threshold_velocity,
                         -rest[None, :] * vn0, 0.0)
    v_target_n = torch.maximum(push, bounce)
    mu = fric[None, :]                                    # (1,N)

    Bmat = Binv.reshape(K, 3, 18, N)

    # Mass-splitting relaxation: omega scales down with the active-contact
    # count, so the common <=4-contact stance keeps full convergence speed
    # while clustered states (stair-edge pile-ups) stay contractive.
    n_act = torch.sum(activef, dim=0)                     # (N,)
    omega = params.relaxation * torch.clamp(
        4.0 / torch.clamp(n_act, min=1.0), max=1.0)

    lam = lam0 * activef[:, None, :]
    for _ in range(params.solver_iters):
        du = torch.sum(Bmat * lam[:, :, None, :], dim=(0, 1))      # (18,N)
        v_now = torch.sum(Jc * (u_free + du)[None, None, :, :], dim=2)  # (K,3,N)
        dlam_n = (v_target_n - v_now[:, 0, :]) * inv_d[:, 0, :]
        lam_n = torch.clamp(lam[:, 0, :] + omega[None] * dlam_n, min=0.0)
        lam_n = torch.where(active, lam_n, 0.0)
        dlam_t = -v_now[:, 1:, :] * inv_d[:, 1:, :]
        lam_t = lam[:, 1:, :] + omega[None, None] * dlam_t
        t_norm = torch.sqrt(torch.sum(lam_t * lam_t, dim=1, keepdim=True))
        max_t = (mu * lam_n)[:, None, :]
        scale = torch.clamp(max_t / (t_norm + 1e-9), max=1.0)
        lam_t = lam_t * scale * activef[:, None, :]
        lam = torch.cat([lam_n[:, None, :], lam_t], dim=1)
    # scatter back by geom (the top-K indices are distinct, so this is the
    # reference's summed one-hot contraction)
    lam_geom_new = torch.zeros((G, 3, N), device=dev).scatter_(
        0, cidxT[:, None, :].expand(K, 3, N), lam)

    u_new = u_free + torch.sum(Bmat * lam[:, :, None, :], dim=(0, 1))

    new_ang = torch.clamp(tm.mv(Rbase, u_new[:3]),
                          -params.max_angular_velocity,
                          params.max_angular_velocity)
    new_lin = torch.clamp(tm.mv(Rbase, u_new[3:6]),
                          -params.max_linear_velocity,
                          params.max_linear_velocity)
    new_qd = torch.clamp(u_new[6:], -params.max_joint_velocity,
                         params.max_joint_velocity)
    new_pos = s.pos + dt * new_lin
    new_quat = tm.quat_integrate(s.quat, new_ang, dt)
    new_q = s.q + dt * new_qd
    new_s = TState(new_pos, new_quat, new_q, new_lin, new_ang, new_qd)

    # diagnostics in T layout
    frame = torch.stack([n, t1, t2], dim=1)               # (K,3f,3c,N)
    f_contact = torch.sum(frame * lam[:, :, None, :], dim=1) / dt   # (K,3,N)
    body = gb[cidxT]                                      # (K,N)
    f_report = f_contact * st.report_w[cidxT][:, None, :]
    body_forces = torch.zeros((model.nb, 3, N), device=dev).scatter_add_(
        0, body[:, None, :].expand(K, 3, N), f_report)
    is_foot = (cidxT[None] == st.foot_idx[:, None, None]).to(torch.float32)
    # (4,K,N)
    foot_forces = torch.sum(is_foot[:, :, None, :] * f_contact[None], dim=1)
    foot_pos = gpos[st.foot_idx]                          # (4,3,N)
    foot_vel = gvel[st.foot_idx]
    outs = dict(contact_forces=body_forces, foot_forces=foot_forces,
                foot_pos=foot_pos, foot_vel=foot_vel)
    return new_s, outs, lam_geom_new


def make_physics_step(model: RobotModel, params: SimParams,
                      terrain: TerrainData, decimation: int):
    """Full decimated PD-control physics step in T layout.

    Returns step(dyn (N-major DynParams), state (N-major SimState),
                 targets (decimation, N, 12), kp (N,12), kd (N,12),
                 motor_strength (N,12), motor_offset (N,12))
        -> (SimState, SimOutputs, torques (N,12) of the last substep,
            patch_data or None).
    """
    layout = quad_layout(model)
    device = terrain.height.device
    static = _static(model, layout, device, params.gravity)
    effort = _f32(model.dof_effort_limit, device)[:, None]
    G = len(model.geom_body)

    def step(dyn: DynParams, state: SimState, targets, kp, kd,
             motor_strength, motor_offset):
        s = to_t(state)
        # batch-last and contiguous once a policy step, for every substep
        dyn_t = dict(mass=torch.movedim(dyn.mass, 0, -1).contiguous(),
                     com=torch.movedim(dyn.com, 0, -1).contiguous(),
                     inertia=torch.movedim(dyn.inertia, 0, -1).contiguous())
        fric = dyn.friction
        rest = dyn.restitution
        kpT, kdT = kp.T, kd.T
        strT, offT = motor_strength.T, motor_offset.T
        targetsT = torch.movedim(targets, -1, 1)          # (decimation,12,N)
        N = state.base_pos.shape[0]

        # --- per-policy-step terrain patches (ops/terrain_patches.py) ---
        patch_data = None
        if terrain.channels is not None and not terrain.is_flat:
            scale = terrain.horizontal_scale
            # channels is (3, C, R) - x minor
            C_, R_ = terrain.channels.shape[1:3]
            bix = ((state.base_pos[:, 0] + terrain.border_offset)
                   / scale).to(torch.int32)
            biy = ((state.base_pos[:, 1] + terrain.border_offset)
                   / scale).to(torch.int32)
            origins = tp.compute_origins(bix, biy, R_, C_)
            patches = tp.extract_patches(terrain.channels, origins)
            patch_data = (patches, origins)

        lam_geom = torch.zeros((G, 3, N), device=device)
        for i in range(decimation):
            # PD torque (reference legged_robot.py:594-618)
            tau = kpT * (targetsT[i] + offT - s.q) - kdT * s.qd
            tau = torch.clamp(tau, -effort, effort)
            tau = tau * strT
            s, outs, lam_geom = _substep(model, layout, params, terrain,
                                         dyn_t, fric, rest, s, tau, kdT,
                                         lam_geom, patch_data, static)
        outputs = SimOutputs(
            contact_forces=torch.movedim(outs["contact_forces"], -1, 0),
            foot_forces=torch.movedim(outs["foot_forces"], -1, 0),
            foot_pos=torch.movedim(outs["foot_pos"], -1, 0),
            foot_vel=torch.movedim(outs["foot_vel"], -1, 0),
        )
        return from_t(s), outputs, tau.T.contiguous(), patch_data

    return step
