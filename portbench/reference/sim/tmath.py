"""T-layout (batch-last) math for the physics engine.

PyTorch port of go2_rl_gym_tpu/sim/tmath.py. Every engine array keeps the env
batch N as its LAST axis: a position is (3, N), a rotation (3, 3, N), the
mass matrix (18, 18, N). On the GPU this puts neighbouring envs on
neighbouring addresses, so each elementwise kernel reads and writes
coalesced rows; contractions are broadcast-multiply + sum over the small
structure axes, as in the reference.

Convention: component axes lead, batch axis trails. Quaternions are xyzw.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# vectors: (..., 3, N)
# ---------------------------------------------------------------------------


def cross(a, b):
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-2)


def dot(a, b):
    """(..., 3, N) . (..., 3, N) -> (..., N)."""
    return torch.sum(a * b, dim=-2)


def norm(a, eps=0.0):
    return torch.sqrt(torch.sum(a * a, dim=-2) + eps)


# ---------------------------------------------------------------------------
# matrices: (..., r, c, N)
# ---------------------------------------------------------------------------


def mv(M, v):
    """(..., r, c, N) @ (..., c, N) -> (..., r, N)."""
    return torch.sum(M * v[..., None, :, :], dim=-2)


def mtv(M, v):
    """M^T v: (..., r, c, N), (..., r, N) -> (..., c, N)."""
    return torch.sum(M * v[..., :, None, :], dim=-3)


def mm(A, B):
    """(..., i, j, N) @ (..., j, k, N) -> (..., i, k, N)."""
    return torch.sum(A[..., :, :, None, :] * B[..., None, :, :, :], dim=-3)


def mtm(A, B):
    """A^T B: (..., i, j, N), (..., i, k, N) -> (..., j, k, N)."""
    return torch.sum(A[..., :, :, None, :] * B[..., :, None, :, :], dim=-4)


def mmt(A, B):
    """A B^T: (..., i, j, N), (..., k, j, N) -> (..., i, k, N)."""
    return torch.sum(A[..., :, None, :, :] * B[..., None, :, :, :], dim=-2)


def transpose(M):
    return torch.swapaxes(M, -3, -2)


def skew(v):
    """(..., 3, N) -> (..., 3, 3, N)."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-2),
        torch.stack([z, zero, -x], dim=-2),
        torch.stack([-y, x, zero], dim=-2),
    ]
    return torch.stack(rows, dim=-3)


def eye3(shape_like):
    """(3, 3, N) identity broadcast against a (..., N) tensor's batch."""
    N = shape_like.shape[-1]
    eye = torch.eye(3, dtype=shape_like.dtype, device=shape_like.device)
    return eye[:, :, None].expand(3, 3, N)


def inv3(M):
    """Explicit 3x3 inverse, batched (..., 3, 3, N)."""
    a, b, c = M[..., 0, 0, :], M[..., 0, 1, :], M[..., 0, 2, :]
    d, e, f = M[..., 1, 0, :], M[..., 1, 1, :], M[..., 1, 2, :]
    g, h, i = M[..., 2, 0, :], M[..., 2, 1, :], M[..., 2, 2, :]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    rows = [
        torch.stack([A, B, C], dim=-2),
        torch.stack([D, E, F], dim=-2),
        torch.stack([G, H, I], dim=-2),
    ]
    return torch.stack(rows, dim=-3) * inv_det[..., None, None, :]


def inv6_spd(M):
    """6x6 SPD inverse via 3x3 block Schur, batched (..., 6, 6, N)."""
    P = M[..., :3, :3, :]
    Q = M[..., :3, 3:, :]
    R = M[..., 3:, 3:, :]
    Pi = inv3(P)
    T = R - mm(transpose(Q), mm(Pi, Q))
    Ti = inv3(T)
    PiQ = mm(Pi, Q)
    tl = Pi + mm(PiQ, mm(Ti, transpose(PiQ)))
    tr = -mm(PiQ, Ti)
    bl = transpose(tr)
    top = torch.cat([tl, tr], dim=-2)
    bot = torch.cat([bl, Ti], dim=-2)
    return torch.cat([top, bot], dim=-3)


# ---------------------------------------------------------------------------
# quaternions: (4, N) xyzw
# ---------------------------------------------------------------------------


def quat_rotate(q, v):
    xyz = q[..., :3, :]
    w = q[..., 3:4, :]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_rotate_inverse(q, v):
    xyz = q[..., :3, :]
    w = q[..., 3:4, :]
    t = 2.0 * cross(xyz, v)
    return v - w * t + cross(xyz, t)


def quat_to_matrix(q):
    x, y, z, w = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-2),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-2),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-2),
    ]
    return torch.stack(rows, dim=-3)


def quat_mul(a, b):
    ax, ay, az, aw = a[..., 0, :], a[..., 1, :], a[..., 2, :], a[..., 3, :]
    bx, by, bz, bw = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-2)


def quat_normalize(q, eps=1e-9):
    return q / (norm(q)[..., None, :] + eps)


def quat_integrate(q, omega, dt):
    """Integrate attitude with world angular velocity (exponential map)."""
    angle = norm(omega)                               # (N,)
    safe = torch.where(angle > 1e-9, angle, torch.ones_like(angle))
    axis = omega / safe[..., None, :]
    half = 0.5 * angle * dt
    dq = torch.cat([axis * torch.sin(half)[..., None, :],
                    torch.cos(half)[..., None, :]], dim=-2)
    return quat_normalize(quat_mul(dq, q))


def rodrigues(axis_static, angle):
    """Rotation matrices about static axes.

    axis_static: (..., 3) numpy array or tensor; angle: (..., N) tensor
    -> (..., 3, 3, N).
    """
    a = torch.as_tensor(axis_static, dtype=torch.float32,
                        device=angle.device)[..., None]           # (...,3,1)
    c = torch.cos(angle)[..., None, None, :]
    s = torch.sin(angle)[..., None, None, :]
    x, y, z = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], dim=-2),
        torch.stack([z, zero, -x], dim=-2),
        torch.stack([-y, x, zero], dim=-2),
    ], dim=-3)                                                    # (...,3,3,1)
    aaT = a[..., :, None, :] * a[..., None, :, :]                 # (...,3,3,1)
    eye = torch.eye(3, device=angle.device).reshape(
        (1,) * (K.dim() - 3) + (3, 3, 1))
    return c * eye + s * K + (1.0 - c) * aaT
