"""Quaternion operations (xyzw storage order); counterpart of
``moby_tpu/math/quaternion.py``.

All functions are shape-polymorphic over leading batch dims: quaternions are
``(..., 4)``, vectors ``(..., 3)``.
"""

from __future__ import annotations

import torch


def identity(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def mul(q1, q2):
    """Hamilton product q1 ⊗ q2 (both xyzw)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def conj(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def normalize(q, eps=1e-30):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / n.clamp_min(eps)


def rotate(q, v):
    """Rotate vector v by quaternion q (active rotation, body->world)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def inverse_rotate(q, v):
    """Rotate v by q^{-1} (world->body)."""
    return rotate(conj(q), v)


def to_matrix(q):
    """Rotation matrix R with R @ v_body = v_world. Shape (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def from_matrix(R):
    """Quaternion (xyzw) from rotation matrix. Shepperd's method, branchless.

    The sqrt arguments are floored at 1e-12 instead of 0: all four candidates
    are computed and only the max-pivot one is selected, but reverse-mode
    differentiation still pulls (zero) cotangents through the unselected
    branches, where sqrt(0) has an infinite derivative and 0*inf = NaN. The
    floor is inert for values: the selected candidate's argument is >= 1."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(x.clamp_min(1e-12)) / 2

    def den(x):
        return (4 * x).clamp_min(1e-30)

    qw0 = root(1.0 + tr)
    qx0 = (m21 - m12) / den(qw0)
    qy0 = (m02 - m20) / den(qw0)
    qz0 = (m10 - m01) / den(qw0)

    qx1 = root(1.0 + m00 - m11 - m22)
    qw1 = (m21 - m12) / den(qx1)
    qy1 = (m01 + m10) / den(qx1)
    qz1 = (m02 + m20) / den(qx1)

    qy2 = root(1.0 - m00 + m11 - m22)
    qw2 = (m02 - m20) / den(qy2)
    qx2 = (m01 + m10) / den(qy2)
    qz2 = (m12 + m21) / den(qy2)

    qz3 = root(1.0 - m00 - m11 + m22)
    qw3 = (m10 - m01) / den(qz3)
    qx3 = (m02 + m20) / den(qz3)
    qy3 = (m12 + m21) / den(qz3)

    cand = torch.stack(
        [
            torch.stack([qx0, qy0, qz0, qw0], dim=-1),
            torch.stack([qx1, qy1, qz1, qw1], dim=-1),
            torch.stack([qx2, qy2, qz2, qw2], dim=-1),
            torch.stack([qx3, qy3, qz3, qw3], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    pivots = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)
    return normalize(q[..., 0, :])


def deriv(q, omega):
    """Quaternion time derivative for angular velocity omega (world frame):
    qdot = 0.5 * quat(omega) ⊗ q (Ravelin's Quatd::deriv)."""
    ow = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    return 0.5 * mul(ow, q)


def from_rpy(rpy):
    """Quaternion from fixed-axis roll-pitch-yaw: R = Rz(yaw) Ry(pitch)
    Rx(roll), the URDF/Moby `rpy` convention."""
    rpy = torch.as_tensor(rpy)
    r, p, y = rpy.unbind(-1)
    hr, hp, hy = r / 2, p / 2, y / 2
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def from_axis_angle(axis, angle):
    axis = torch.as_tensor(axis)
    angle = torch.as_tensor(angle, dtype=axis.dtype)
    half = angle / 2
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]], dim=-1)
