"""SO(3) helpers: skew matrices, rpy, deterministic tangent bases
(counterpart of ``moby_tpu/math/so3.py``)."""

from __future__ import annotations

import torch


def hat(v):
    """Skew-symmetric cross-product matrix: hat(v) @ u == cross(v, u)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rpy_to_matrix(rpy):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (URDF / Moby fixed-axis rpy)."""
    r, p, y = torch.as_tensor(rpy).unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    m = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def orthonormal_basis(n):
    """Two unit tangents (t1, t2) completing normal n to a right-handed frame
    (Ravelin's `Vector3d::determine_orthonormal_basis`, the deterministic
    contact tangent frame):
      |n.x| > |n.y|  ->  t1 ∝ (-n.z, 0, n.x)
      else           ->  t1 ∝ (0,  n.z, -n.y)
    then t2 = n × t1.
    """
    x, y, z = n.unbind(-1)
    use_x = x.abs() > y.abs()
    zero = torch.zeros_like(x)
    t1 = torch.where(
        use_x[..., None],
        torch.stack([-z, zero, x], dim=-1),
        torch.stack([zero, z, -y], dim=-1),
    )
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True).clamp_min(1e-30)
    t2 = torch.linalg.cross(n, t1)
    t2 = t2 / torch.linalg.vector_norm(t2, dim=-1, keepdim=True).clamp_min(1e-30)
    return t1, t2
