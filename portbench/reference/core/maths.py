"""Quaternion / rotation helpers (PyTorch port of go2_rl_gym_tpu/core/maths.py).

Counterparts of the quaternion helpers the reference imports from
``isaacgym.torch_utils`` (reference legged_gym/envs/base/legged_robot.py:8,
legged_gym/utils/math.py:8-26, legged_gym/utils/isaacgym_utils.py:11-30).

Conventions
-----------
* Quaternions are stored ``(x, y, z, w)``.
* Every function is shape-polymorphic over leading batch dims (component axis
  last, N-major).
* The random helpers draw from an explicit ``torch.Generator`` on the device
  where the result lives; nothing touches the global RNG.
"""
from __future__ import annotations

import math

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


# ---------------------------------------------------------------------------
# Quaternion algebra (xyzw)
# ---------------------------------------------------------------------------


def quat_identity(batch_shape=(), device="cpu") -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both xyzw."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (body -> world for a body-attitude q)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^-1 (world -> body). Matches isaacgym quat_rotate_inverse."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v - w * t + cross(xyz, t)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ euler -> quaternion (isaacgym.torch_utils semantics)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw) (reference isaacgym_utils.py:11-30)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)))

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q (reference math.py:8-14)."""
    yaw_q = torch.zeros_like(q)
    yaw_q[..., 2] = q[..., 2]
    yaw_q[..., 3] = q[..., 3]
    return quat_rotate(quat_normalize(yaw_q), v)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (body -> world)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """Integrate attitude with world-frame angular velocity (exponential map)."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    axis = omega_world / torch.where(angle > 1e-9, angle,
                                     torch.ones_like(angle))
    dq = quat_from_axis_angle(axis, (angle * dt)[..., 0])
    return quat_normalize(quat_mul(dq, q))


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] (reference legged_gym/utils/math.py:16-20)."""
    a = torch.remainder(angles, 2 * math.pi)
    return torch.where(a > math.pi, a - 2 * math.pi, a)


# ---------------------------------------------------------------------------
# 3D helpers
# ---------------------------------------------------------------------------


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix: skew(v) @ u == cross(v, u)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF rpy (fixed-axis XYZ: R = Rz(y) Ry(p) Rx(r)) -> rotation matrix."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    m = torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1)
    return m.reshape(rpy.shape[:-1] + (3, 3))


def axis_angle_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula; axis assumed unit-norm."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, device=K.device, dtype=K.dtype).expand(K.shape)
    outer = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * outer


# ---------------------------------------------------------------------------
# Random sampling helpers (counterparts of isaacgym_utils samplers). Each
# takes an explicit torch.Generator and draws on that generator's device.
# ---------------------------------------------------------------------------


def rand(gen: torch.Generator, shape) -> torch.Tensor:
    """U[0, 1) of `shape` on the generator's device."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


def uniform(gen: torch.Generator, shape, lo, hi) -> torch.Tensor:
    return rand(gen, shape) * (hi - lo) + lo


def sample_disjoint_intervals(gen: torch.Generator, limit_bound: torch.Tensor,
                              lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Uniform over [lo, -limit_bound] U [limit_bound, hi].

    Counterpart of reference legged_gym/utils/isaacgym_utils.py:32-47.
    """
    width_neg = torch.relu(-limit_bound - lo)
    width_pos = torch.relu(hi - limit_bound)
    total = width_neg + width_pos + 1e-6
    u = rand(gen, limit_bound.shape) * total
    return torch.where(u < width_neg, lo + u, hi - width_pos + (u - width_neg))


def sample_single_interval(gen: torch.Generator, lo: torch.Tensor,
                           hi: torch.Tensor) -> torch.Tensor:
    """Uniform over [lo, hi] (reference isaacgym_utils.py:49-55)."""
    return lo + rand(gen, lo.shape) * (hi - lo)
